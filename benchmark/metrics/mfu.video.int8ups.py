"""mfu.video.int8ups: ``readers.mfu_frames`` in the int8 ``ups`` video cell."""

from benchmark.readers import mfu_frames as read  # noqa: F401
