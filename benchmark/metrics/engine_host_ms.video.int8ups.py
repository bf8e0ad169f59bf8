"""engine_host_ms.video.int8ups: ``program_spans.engine_host_ms`` in the int8 ``ups`` video cell."""

from benchmark.program_spans import engine_host_ms as read  # noqa: F401
