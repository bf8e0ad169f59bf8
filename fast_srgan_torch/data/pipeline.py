"""Host-side crop sampler with threaded prefetch: a copy of
``fast_srgan_tpu/data/pipeline.py`` (same draws, so the same seed and files
give the same batches, bit for bit).

Replaces the reference's DataLoader wiring (its train.py:57-113):
three loaders over one dataset — a sequential "validation" pass (the training
images, unshuffled) and two with-replacement random samplers sized
``iterations * batch_size`` so one pass == the configured iteration count.

Design:
  * ``CropSampler`` — mmap .npy files (copy-on-write, like the reference's
    ``np.load(mmap_mode="c")`` — dataloader.py:25) and take uniform random
    HR crops as uint8 NHWC batches. The LR synthesis + normalization happen
    on the device (``train/steps.py`` ``prepare_batch``).
  * ``PrefetchLoader`` — a bounded background-thread pipeline keeping N
    batches ready so the card never waits on the host. This replaces
    the reference's 16 worker *processes*: crops of pre-decoded uint8 arrays
    are memcpy-bound, so threads (no pickling, shared page cache) win.
  * Determinism: a single seeded ``np.random.Generator`` drives file choice
    and crop offsets (reference seeds torch/np/random — train.py:16-19,40-43);
    the native C++ crop backend (``csrc/fastsr_loader.cpp``) is used when it
    builds (``backend`` says which one runs).
  * ``shard`` splits the file list by (index, count), the JAX package's
    per-host split: a data-parallel run passes (rank, world) and each rank's
    loaders draw its slice of the global batch from its own files.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import OrderedDict
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class CropSampler:
    """Uniform random HR crops from a directory of uint8 HWC .npy files.

    `backend`: 'auto' uses the native C++ gather (csrc/fastsr_loader.cpp)
    when it builds, else numpy mmap slicing; 'numpy'/'native' force one.
    ``self.backend`` is the one that runs ("native" or "numpy"). Crop
    offsets are always drawn host-side from the seeded RNG, so batches are
    bit-identical across backends.
    """

    def __init__(
        self,
        numpy_paths: Sequence[str],
        lr_image_size: int,
        scale_factor: int,
        seed: int = 0,
        shard: Optional[Tuple[int, int]] = None,
        backend: str = "auto",
    ):
        paths = sorted(numpy_paths)
        if shard is not None:
            index, count = shard
            if not paths[index::count]:
                raise ValueError(
                    f"CropSampler got an empty file list: shard {index} of {count} (rank"
                    f" {index}) has none of the {len(paths)} files"
                )
            paths = paths[index::count]
        if not paths:
            raise ValueError("CropSampler got an empty file list")
        self.paths: List[str] = list(paths)
        self.hr_size = lr_image_size * scale_factor
        self.rng = np.random.default_rng(seed)
        # Bounded LRU of open mmaps: each live numpy mmap holds a file
        # descriptor, so an unbounded per-file cache exhausts ulimit -n on
        # datasets past ~1000 files (DIV2K's 800 hid this). 512 keeps the
        # hot set resident while staying under default fd limits.
        self._arrays: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._max_open = 512
        # PrefetchLoader workers call crop_batch concurrently; without a
        # lock, move_to_end can race popitem's eviction and KeyError, which
        # aborts training in exactly the >1000-file regime the LRU is for.
        self._arrays_lock = threading.Lock()
        self._shapes: List[Optional[Tuple[int, int]]] = [None] * len(self.paths)
        self._native = None
        if backend in ("auto", "native"):
            try:
                from fast_srgan_torch.data.native import NativeCropDataset

                self._native = NativeCropDataset(self.paths)
                self._shapes = [tuple(hw) for hw in self._native.shapes]
            except Exception:
                if backend == "native":
                    raise
                self._native = None
        self.backend = "numpy" if self._native is None else "native"

    def __len__(self) -> int:
        return len(self.paths)

    def _get(self, idx: int) -> np.ndarray:
        with self._arrays_lock:
            arr = self._arrays.get(idx)
            if arr is not None:
                self._arrays.move_to_end(idx)
                return arr
        # Load outside the lock: np.load hits the filesystem and would
        # serialize all workers behind one cache miss.
        arr = np.load(self.paths[idx], mmap_mode="c")
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(
                f"{self.paths[idx]}: expected HWC uint8 RGB, got {arr.shape}"
            )
        with self._arrays_lock:
            # A concurrent loader may have inserted idx meanwhile; keep the
            # existing entry (duplicate mmaps are harmless, fds are freed on
            # GC) and refresh recency.
            arr = self._arrays.setdefault(idx, arr)
            self._arrays.move_to_end(idx)
            if len(self._arrays) > self._max_open:
                self._arrays.popitem(last=False)  # evict LRU: frees its fd
        return arr

    def _shape(self, idx: int) -> Tuple[int, int]:
        s = self._shapes[idx]
        if s is None:
            arr = np.load(self.paths[idx], mmap_mode="c")
            s = (arr.shape[0], arr.shape[1])
            self._shapes[idx] = s
        return s

    def _draw_offsets(self, idxs, rng) -> Tuple[np.ndarray, np.ndarray]:
        """Draw (top, left) per item — the single source of crop randomness
        (matches the per-item draw order of the reference dataloader.py:27-29,
        inclusive upper bound).

        One ``integers`` call over the interleaved bounds (top0, left0,
        top1, ...): numpy's Generator draws an array of bounds element by
        element exactly as it draws the scalar calls of the JAX package's
        loop, so the crops are the same bits, and a loader thread holds the
        interpreter for one call a batch instead of two an item."""
        s = self.hr_size
        hw = np.array([self._shape(int(i)) for i in idxs], np.int64).reshape(-1, 2)
        small = np.flatnonzero((hw < s).any(axis=1))
        if small.size:
            i = int(idxs[small[0]])
            h, w = hw[small[0]]
            raise ValueError(f"{self.paths[i]}: image {h}x{w} smaller than crop {s}")
        draws = rng.integers(0, (hw - s + 1).reshape(-1)).astype(np.int32)
        return draws[0::2], draws[1::2]

    def crop(self, idx: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """One [hr, hr, 3] uint8 crop from image idx at a random offset."""
        rng = rng or self.rng
        return self.crop_batch(np.asarray([idx]), rng)[0]

    def crop_batch(
        self, idxs: np.ndarray, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        """[len(idxs), hr, hr, 3] uint8 crops; native gather when available."""
        rng = rng or self.rng
        tops, lefts = self._draw_offsets(idxs, rng)
        s = self.hr_size
        if self._native is not None:
            return self._native.crop_batch(
                np.asarray(idxs, np.int32), tops, lefts, s
            )
        out = np.empty((len(idxs), s, s, 3), np.uint8)
        for j, i in enumerate(idxs):
            img = self._get(int(i))
            t, l = int(tops[j]), int(lefts[j])
            out[j] = img[t : t + s, l : l + s, :]
        return out

    def random_batch(self, batch_size: int) -> np.ndarray:
        """With-replacement random batch (reference RandomSampler semantics,
        train.py:69-80)."""
        idxs = self.rng.integers(0, len(self.paths), size=batch_size)
        return self.crop_batch(idxs)

    def sequential_batches(
        self, batch_size: int, seed: int = 0, drop_last: bool = True
    ) -> Iterator[np.ndarray]:
        """One deterministic pass over all files (the reference's validation
        loader: unshuffled single epoch, random crops, drop_last —
        train.py:81-91). A dedicated seeded RNG makes val crops reproducible
        across calls, unlike the reference's worker-state-dependent crops."""
        rng = np.random.default_rng(seed)
        batch: List[np.ndarray] = []
        for i in range(len(self.paths)):
            batch.append(self.crop(i, rng))
            if len(batch) == batch_size:
                yield np.stack(batch)
                batch = []
        if batch and not drop_last:
            yield np.stack(batch)


class PrefetchLoader:
    """Iterator of random uint8 HR batches, produced by background threads.

    ``num_batches`` bounds the iteration count (the reference's
    ``num_samples = iterations * batch_size`` sampler, train.py:69-80).
    """

    #: seconds between a waiting thread's checks that the iteration ended
    POLL_S = 1.0

    def __init__(
        self,
        sampler: CropSampler,
        batch_size: int,
        num_batches: int,
        prefetch: int = 4,
        workers: int = 2,
    ):
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.prefetch = max(1, prefetch)
        self.workers = max(1, workers)
        # Drawn at construction (not per-iteration): loader construction
        # order is deterministic from the config seed, so a restarted
        # process derives the same per-batch plans — iteration-time draws
        # would differ once an earlier phase is skipped on resume.
        self._base_seed = int(sampler.rng.integers(0, 2**63 - 1))

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[np.ndarray]:
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator[np.ndarray]:
        """Yield batches start..num_batches-1. Per-batch RNGs derive from
        (base seed, batch index), so a resumed run consumes exactly the batch
        plans the uninterrupted run would have — deterministic regardless of
        thread interleaving, with bounded memory (worker lead is capped by a
        ticket semaphore, so the reorder buffer can't grow past
        prefetch + workers batches)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        base_seed = self._base_seed
        done = threading.Event()
        # Lead window: producer of batch b waits until b < consumed + WINDOW.
        # Keyed to the *consumer's position* (not a global ticket pool): the
        # producer of the oldest still-needed batch always passes, so the
        # window can never deadlock — a plain counting semaphore could (and
        # did, in a live SIGINT drill: workers striping batch indices
        # exhausted every ticket on later batches while the next-needed
        # batch's producer starved; training hung mid-epoch).
        window = self.prefetch + self.workers
        # One gate a worker on one lock: each consumed batch lets exactly
        # one more batch into the window, and only its producer is woken.
        # Every wake-up of a waiting thread takes the interpreter lock from
        # the training thread, which dispatches the card's work and is the
        # bottleneck of a step, so no thread is woken for nothing (a
        # notify_all woke every worker a batch) and idle waits poll
        # `done` once a second only.
        lead = threading.Lock()
        gates = [threading.Condition(lead) for _ in range(self.workers)]
        consumed = [start]
        _ERR = object()

        def _put(item) -> None:
            # put with teardown polling: a blocked producer must notice
            # `done` even when no consumer will ever drain the queue again.
            while not done.is_set():
                try:
                    q.put(item, timeout=self.POLL_S)
                    return
                except queue.Full:
                    continue

        def produce(worker_id: int) -> None:
            for b in range(start + worker_id, self.num_batches, self.workers):
                with lead:
                    while b - consumed[0] >= window and not done.is_set():
                        gates[worker_id].wait(timeout=self.POLL_S)
                if done.is_set():
                    return
                try:
                    rng = np.random.default_rng((base_seed, b))
                    idxs = rng.integers(0, len(self.sampler), self.batch_size)
                    _put((b, self.sampler.crop_batch(idxs, rng)))
                except Exception as e:  # surface to the consumer, don't hang
                    _put((_ERR, e))
                    return

        threads = [
            threading.Thread(target=produce, args=(w,), daemon=True)
            for w in range(self.workers)
        ]
        for t in threads:
            t.start()

        try:
            # Reorder-buffer so batches come out in plan order (determinism).
            received = {}
            next_idx = start
            for _ in range(self.num_batches - start):
                while next_idx not in received:
                    b, batch = q.get()
                    if b is _ERR:
                        raise batch
                    received[b] = batch
                yield received.pop(next_idx)
                next_idx += 1
                with lead:
                    consumed[0] = next_idx
                    # the batch that just entered the window, and its producer
                    gates[(next_idx + window - 1 - start) % self.workers].notify()
        finally:
            done.set()
            with lead:
                for gate in gates:
                    gate.notify_all()
            # Unblock any producer waiting in put(); they poll `done`.
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def list_numpy_files(numpy_dir: str) -> List[str]:
    return [
        os.path.join(numpy_dir, f)
        for f in sorted(os.listdir(numpy_dir))
        if f.endswith(".npy")
    ]


def resolve_val_numpy_dir(config) -> Optional[str]:
    """The held-out-validation .npy cache dir, or None when neither val key
    is set (reference behavior: validate on the training images).

    ``val_numpy_dir`` alone is honored as a prebuilt cache (no image dir to
    preprocess); ``val_image_dir`` alone derives the cache location."""
    explicit = config.data.get("val_numpy_dir")
    if explicit:
        return explicit
    if not config.data.get("val_image_dir"):
        return None
    return config.data.numpy_dir.rstrip("/") + "_val"


def make_loaders(config, shard: Optional[Tuple[int, int]] = None):
    """Build (val_sampler, pretrain_loader, train_loader) per the reference
    wiring (train.py:57-113) from a config node.

    With data.val_image_dir set, the val sampler reads the held-out cache
    (resolve_val_numpy_dir) instead of the training files — ``python -m
    fast_srgan_torch.train`` preprocesses that directory before calling
    here. The val sampler is never file-sharded (``shard`` applies only to
    the training loaders), as in the JAX package. ``training.batch_size`` is
    the global batch: a shard's loaders yield its 1/count slice."""
    paths = list_numpy_files(config.data.numpy_dir)
    sampler = CropSampler(
        paths,
        config.data.lr_image_size,
        config.data.scale_factor,
        seed=config.experiment.seed,
        shard=shard,
    )
    val_dir = resolve_val_numpy_dir(config)
    if val_dir:
        val_paths = list_numpy_files(val_dir)
        if not val_paths:
            raise ValueError(
                f"held-out validation is configured but the val cache "
                f"{val_dir!r} has no .npy files (with data.val_image_dir, "
                "python -m fast_srgan_torch.train preprocesses into it; a "
                "bare data.val_numpy_dir must point at an existing prebuilt "
                "cache)"
            )
    else:
        val_paths = paths
    val_sampler = (
        sampler
        if shard is None and val_paths is paths
        else CropSampler(
            val_paths,
            config.data.lr_image_size,
            config.data.scale_factor,
            seed=config.experiment.seed,
        )
    )
    batch = config.training.batch_size // (1 if shard is None else shard[1])
    # Honor the configured count (the reference default is 16 threads,
    # train.py:84 there); floor at 1, cap at 64 as a footgun guard only.
    workers = max(1, min(64, config.training.num_workers))
    pretrain_loader = PrefetchLoader(
        sampler, batch, config.training.pretrain_iterations, workers=workers
    )
    train_loader = PrefetchLoader(
        sampler, batch, config.training.iterations, workers=workers
    )
    return val_sampler, pretrain_loader, train_loader
