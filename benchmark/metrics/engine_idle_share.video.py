"""engine_idle_share.video: ``program_spans.engine_idle_share`` in the bf16 video cell."""

from benchmark.program_spans import engine_idle_share as read  # noqa: F401
