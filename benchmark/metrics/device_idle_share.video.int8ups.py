"""device_idle_share.video.int8ups: ``readers.idle_share`` in the int8 ``ups`` video cell."""

from benchmark.readers import idle_share as read  # noqa: F401
