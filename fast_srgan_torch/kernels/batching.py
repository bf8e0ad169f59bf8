"""Batch chunks for the kernels that hold the sample on a grid axis of at
most 65535 blocks.

The instance-norm family's two launches and split form (``dim3(tiles, B)``)
and the s8 conv (``blockIdx.z``) put the sample on the grid's y or z axis.
Every op they compute is per sample, so a call of more samples runs over
chunks of the batch, one launch (or one pair) of at most
:data:`GRID_YZ_MAX` samples each, and splitting is exact. A batch of at
most 65535 samples is one chunk: the call launches as it did unchunked.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

#: Blocks a CUDA grid's y and z axes hold.
GRID_YZ_MAX = 65535


def batch_chunks(b: int, most: int = GRID_YZ_MAX) -> List[Tuple[int, int]]:
    """[start, stop) spans that cover ``range(b)`` in order: as few as
    chunks of at most ``most`` samples allow, their sizes differing by one
    at most (the first ones the larger). One span (0, b) where b <= most,
    also for b == 0."""
    n = max(1, -(-b // most))
    size, extra = divmod(b, n)
    spans, start = [], 0
    for i in range(n):
        stop = start + size + (i < extra)
        spans.append((start, stop))
        start = stop
    return spans


def rows(t, start: int, stop: int):
    """Samples [start, stop) of t along dim 0: t itself where that is all
    of it, None for None, each tensor of a tuple (``valid_hw``) cut alike."""
    if t is None:
        return None
    if isinstance(t, tuple):
        return tuple(rows(u, start, stop) for u in t)
    return t if start == 0 and stop == t.shape[0] else t[start:stop]


def over_chunks(spans: List[Tuple[int, int]], out: torch.Tensor,
                launch: Callable[[int, int, torch.Tensor], None], dim: int = 0) -> torch.Tensor:
    """Calls ``launch(start, stop, part)`` for each span, ``part`` being
    out's samples [start, stop) along ``dim``: out itself for one span; a
    view of out where ``dim`` is 0 (a sample is one contiguous piece); else
    a buffer of their shape that is copied into out after the launch (the
    kernels write contiguous tensors: the four phases' [4, B, H, W, C]).
    Returns out."""
    if len(spans) == 1:
        launch(*spans[0], out)
        return out
    for start, stop in spans:
        if dim == 0:
            launch(start, stop, out[start:stop])
            continue
        view = out.narrow(dim, start, stop - start)
        part = torch.empty(view.shape, dtype=out.dtype, device=out.device)
        launch(start, stop, part)
        view.copy_(part)
    return out
