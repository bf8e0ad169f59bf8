"""device_idle_share.video: ``readers.idle_share`` in the bf16 video cell."""

from benchmark.readers import idle_share as read  # noqa: F401
