"""Training checkpoints: ``torch.save`` files with an atomic rename,
resume-from-latest and retention. It replaces the JAX package's Orbax
``CheckpointIO`` (``fast_srgan_tpu/checkpoints/orbax_io.py``) with the same
interface; it is not a port of Orbax.

One directory per manager, one file per step (``step_<n>.pt``). ``save``
enqueues copies of the state tree to host memory (the caller's tensors go on
changing in place; the copies are ordered before that on the card's
stream, so the host does not wait for the card), then a background thread
waits for them, writes the tree to a temporary name and ``os.replace``s it,
so a crash leaves either the old file or the new one.
``wait`` joins the write. Retention keeps the newest ``max_to_keep`` steps and the one just written.
``saved_skeleton`` reads a file's container structure without its tensor
data (``map_location="meta"``), for the trainer's resume guard.

``defer_sigint`` is a copy of the JAX package's: SIGINT received inside the
block is re-raised when the outermost block exits, so an interrupt cannot
split a checkpoint from its bookkeeping.
"""

from __future__ import annotations

import os
import re
import signal
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

PRETRAIN_STEP = 0  # the reserved step key for the end-of-pretrain snapshot

_FILE_RE = re.compile(r"^step_(\d+)\.pt$")

_defer_lock = threading.Lock()
_defer_depth = 0
_pending_sigint = False
_prev_handler = None


@contextmanager
def defer_sigint():
    """Delay Ctrl-C delivery until this (reentrant) block exits.

    Only the main thread can retarget signal handlers; on other threads
    this is a no-op (signals are delivered to the main thread anyway).
    """
    global _defer_depth, _pending_sigint, _prev_handler
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    if _defer_depth == 0 and signal.getsignal(signal.SIGINT) is signal.SIG_IGN:
        # The process explicitly opted out of Ctrl-C (daemonized/nohup
        # runs inherit SIG_IGN): deferral must not convert an ignored
        # signal into a fatal KeyboardInterrupt.
        yield
        return

    def _record(signum, frame):
        global _pending_sigint
        _pending_sigint = True

    with _defer_lock:
        _defer_depth += 1
        if _defer_depth == 1:
            _pending_sigint = False
            _prev_handler = signal.signal(signal.SIGINT, _record)
    try:
        yield
    finally:
        with _defer_lock:
            _defer_depth -= 1
            outermost = _defer_depth == 0
            if outermost:
                signal.signal(signal.SIGINT, _prev_handler)
                fire = _pending_sigint
                _pending_sigint = False
        if outermost and fire:
            # Deliver with the ORIGINAL disposition: Python's default
            # handler raises KeyboardInterrupt; a custom handler runs as it
            # would have; a SIG_DFL process gets the signal re-sent.
            if callable(_prev_handler):
                _prev_handler(signal.SIGINT, None)
            else:
                os.kill(os.getpid(), signal.SIGINT)


def tree_skeleton(tree: Any) -> Any:
    """Container-only structure of a state tree (no leaf data): dicts keep
    their keys, lists and tuples become lists, empty containers and leaves
    become None. Two trees that load into each other have equal skeletons."""
    if isinstance(tree, dict):
        out = {k: tree_skeleton(v) for k, v in tree.items()}
        return out if out else None
    if isinstance(tree, (list, tuple)):
        seq = [tree_skeleton(v) for v in tree]
        return seq if seq else None
    return None


def to_host(tree: Any, non_blocking: bool = False) -> Any:
    """The tree with a host copy of every tensor. ``non_blocking``: CUDA
    tensors are copied into pinned memory behind the work queued on the
    stream (wait for an event recorded after this before reading them)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True, non_blocking=non_blocking and tree.is_cuda)
    if isinstance(tree, dict):
        return {k: to_host(v, non_blocking) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v, non_blocking) for v in tree)
    return tree


class CheckpointIO:
    """Step-keyed ``torch.save`` checkpoints in one directory (created here
    unless ``create`` is false: a reader that must not write, such as a
    data-parallel rank other than 0; a missing directory holds no step)."""

    def __init__(self, directory: str, max_to_keep: int = 5, create: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        if create:
            os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Dict[str, Any]) -> None:
        """Save ``tree`` at ``step``; an existing step is replaced. The
        copy to host memory happens here; the write runs in the background
        (``wait`` joins it). A previous write is drained first, and the
        whole dispatch runs with SIGINT deferred."""
        with defer_sigint():
            self.wait()
            host = to_host(tree, non_blocking=True)
            copied = None
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                copied = torch.cuda.Event()
                copied.record()
            self._writer = threading.Thread(
                target=self._write, args=(int(step), host, copied), daemon=True
            )
            self._writer.start()

    def _write(self, step: int, tree: Dict[str, Any], copied) -> None:
        final = self.path(step)
        tmp = f"{final}.tmp.{os.getpid()}"
        try:
            if copied is not None:
                copied.synchronize()
            # through a Python file: its writes release the interpreter
            # lock, so the training thread runs on beside them
            with open(tmp, "wb") as f:
                torch.save(tree, f)
            os.replace(tmp, final)
            # the newest max_to_keep steps stay; the one just written too (a
            # rerun re-saving a step behind an older run's latest)
            for old in self.all_steps()[: -self.max_to_keep]:
                if old != step:
                    os.unlink(self.path(old))
        except Exception as e:  # surfaced by wait()
            self._error = e
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def wait(self) -> None:
        """Join the write in flight; raise its error, if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write failed: {err!r}") from err

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Steps on disk, ascending."""
        steps = []
        if not os.path.isdir(self.directory):
            return steps
        for name in os.listdir(self.directory):
            m = _FILE_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def has_step(self, step: int) -> bool:
        return os.path.exists(self.path(step))

    def saved_skeleton(self, step: int) -> Optional[Any]:
        """Container structure of the tree saved at ``step``, as
        :func:`tree_skeleton` gives it, read without the tensors' data;
        None when the file is missing or unreadable."""
        try:
            tree = torch.load(self.path(step), map_location="meta", weights_only=True)
        except (OSError, RuntimeError, ValueError):
            return None
        return tree_skeleton(tree)

    def restore(self, step: int, map_location="cpu") -> Dict[str, Any]:
        return torch.load(self.path(step), map_location=map_location, weights_only=True)

    def close(self) -> None:
        self.wait()
