"""in_roofline.video: ``readers.in_roofline`` in the bf16 video cell."""

from benchmark.readers import in_roofline as read  # noqa: F401
