"""mfu.video: ``readers.mfu_frames`` in the bf16 video cell."""

from benchmark.readers import mfu_frames as read  # noqa: F401
