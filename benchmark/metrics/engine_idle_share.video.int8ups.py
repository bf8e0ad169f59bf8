"""engine_idle_share.video.int8ups: ``program_spans.engine_idle_share`` in the int8 ``ups`` video cell."""

from benchmark.program_spans import engine_idle_share as read  # noqa: F401
