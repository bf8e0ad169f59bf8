"""forward_enqueue_ms.video: ``program_spans.forward_enqueue_ms`` in the bf16 video cell."""

from benchmark.program_spans import forward_enqueue_ms as read  # noqa: F401
