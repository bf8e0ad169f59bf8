"""forward_enqueue_ms.video.int8ups: ``program_spans.forward_enqueue_ms`` in the int8 ``ups`` video cell."""

from benchmark.program_spans import forward_enqueue_ms as read  # noqa: F401
