"""in_roofline.video.int8ups: ``readers.in_roofline`` in the int8 ``ups`` video cell."""

from benchmark.readers import in_roofline as read  # noqa: F401
