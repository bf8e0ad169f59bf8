"""engine_host_ms.video: ``program_spans.engine_host_ms`` in the bf16 video cell."""

from benchmark.program_spans import engine_host_ms as read  # noqa: F401
