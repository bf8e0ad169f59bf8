"""Streaming video super-resolution: decode -> batched upscale -> encode.

The port of ``fast_srgan_tpu/video.py``. A decoder thread per input feeds a
bounded queue; :meth:`SRInferenceEngine.stream` runs the frames through the
card in batches with a bounded in-flight window; the encoder writes each
output as it arrives. cv2 (OpenCV, imported where it is used) does the
container and codec work; frames are converted BGR <-> RGB around the
engine (the network is trained on RGB).

    python -m fast_srgan_torch.infer --video IN.mp4 [IN2.mp4 ...] \\
        (--video_out OUT.mp4 | --output_dir DIR) [--int8] [--device cuda]
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from itertools import islice
from typing import Iterator, List, Optional

import numpy as np

from fast_srgan_torch import quant

#: Frames the int8 auto-calibration takes from the first frames of the
#: streams (``quant.calibration_batch_from_images``' default k).
CALIBRATION_FRAMES = 8


def _decode_frames(
    path: str, frame_queue: queue.Queue, limit: Optional[int], stop: threading.Event
) -> None:
    # The import and the capture's opening are inside the try: if either
    # fails, the finally still enqueues the sentinel, or the consumer would
    # block forever on get().
    cap = None
    error = None
    try:
        import cv2

        cap = cv2.VideoCapture(path)
        n = 0
        while cap.isOpened() and not stop.is_set():
            if limit is not None and n >= limit:
                break
            ok, frame_bgr = cap.read()
            if not ok:
                break
            item = frame_bgr[:, :, ::-1]  # BGR -> RGB
            # put with teardown polling: a consumer that abandoned the
            # generator must not leave this thread blocked, holding the
            # decoder and its buffered frames
            while not stop.is_set():
                try:
                    frame_queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            n += 1
    except BaseException as e:  # handed to the consumer, which raises it
        error = e
    finally:
        if cap is not None:
            cap.release()
        while True:
            try:
                frame_queue.put(error, timeout=0.1)  # None: the end
                break
            except queue.Full:
                if stop.is_set():
                    break


def iter_video_frames(
    path: str, limit: Optional[int] = None, buffer: int = 64
) -> Iterator[np.ndarray]:
    """Decode RGB uint8 frames on a background thread (a bounded queue)."""
    q: queue.Queue = queue.Queue(maxsize=max(1, buffer))
    stop = threading.Event()
    thread = threading.Thread(target=_decode_frames, args=(path, q, limit, stop), daemon=True)
    thread.start()
    try:
        while True:
            frame = q.get()
            if frame is None:
                break
            if isinstance(frame, BaseException):
                raise frame  # the decoder thread's failure (e.g. no opencv)
            yield frame
    finally:
        stop.set()  # runs on GeneratorExit too (an abandoned consumer)


def upscale_video(
    engine,
    input_path: str,
    output_path: str,
    batch_size: int = 8,
    limit: Optional[int] = None,
    codec: str = "mp4v",
) -> dict:
    """Upscale a video file. Returns {frames, fps_in, seconds}: the
    one-stream case of :func:`upscale_videos`."""
    stats = upscale_videos(
        engine, [input_path], [output_path], batch_size=batch_size, limit=limit, codec=codec
    )
    return {"frames": stats["frames"], "fps_in": stats["fps_in"][0], "seconds": stats["seconds"]}


def calibration_frames(input_paths: List[str], k: int = CALIBRATION_FRAMES) -> List[np.ndarray]:
    """The first frames of the streams for int8 calibration: ceil(k / N)
    from each stream in turn, until k are taken."""
    per = max(1, -(-k // len(input_paths)))
    first: List[np.ndarray] = []
    for path in input_paths:
        first.extend(islice(iter_video_frames(path, limit=per), per))
        if len(first) >= k:
            break
    return first[:k]


def upscale_videos(
    engine,
    input_paths: list,
    output_paths: list,
    batch_size: int = 8,
    limit: Optional[int] = None,
    codec: str = "mp4v",
) -> dict:
    """Upscale N video streams through one device pipeline.

    Frames are drawn round-robin from the active streams into shared
    batches; each stream's order is kept (``engine.stream`` yields in input
    order, so outputs unzip by the recorded draw order). All inputs must
    share one frame size; each stream ends at its own length.

    An int8 engine still on its synthetic calibration
    (``default_calibration``) is calibrated on the streams' first frames
    (:func:`calibration_frames`) and stays auto-managed; scales the caller
    chose are kept.

    Returns {frames, per_stream, fps_in, seconds}.
    """
    import cv2

    if len(input_paths) != len(output_paths):
        raise ValueError("input_paths and output_paths must pair up")
    if not input_paths:
        raise ValueError("no input videos")
    if len(set(output_paths)) != len(output_paths):
        # two writers on one file interleave into a corrupt container
        raise ValueError(f"duplicate output paths: {sorted(output_paths)}")
    in_abs = {os.path.abspath(p) for p in input_paths}
    clash = in_abs & {os.path.abspath(p) for p in output_paths}
    if clash:
        # the writers open (and truncate) their files before decoding starts
        raise ValueError(f"output would overwrite an input: {sorted(clash)}")

    sizes, fpses = [], []
    for path in input_paths:
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        fpses.append(cap.get(cv2.CAP_PROP_FPS) or 24.0)
        sizes.append((int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                      int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
        cap.release()
    if len(set(sizes)) != 1:
        raise ValueError(
            f"all streams must share one frame size, got {sorted(set(sizes))}"
            " -- group by size and call once per group"
        )
    w, h = sizes[0]

    if getattr(engine, "quantize", False) and getattr(engine, "default_calibration", False):
        batch = quant.calibration_batch_from_images(calibration_frames(input_paths))
        if batch is not None:
            engine.recalibrate([batch])
            # still auto-managed: a later call calibrates on its own streams
            engine.default_calibration = True

    # The writer's size must be the engine's scale exactly: cv2 drops
    # wrong-sized frames silently (an empty file that reports success).
    s = engine.SCALE
    writers = []
    for out_path, fps in zip(output_paths, fpses):
        wr = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*codec), fps, (s * w, s * h))
        if not wr.isOpened():
            for other in writers:
                other.release()
            raise RuntimeError(f"cannot open video writer: {out_path}")
        writers.append(wr)

    draw_order: collections.deque = collections.deque()

    def merged():
        # each stream's decode lookahead bounded so the host holds about two
        # batches in all, not N * 64 frames
        n = len(input_paths)
        its = [iter_video_frames(p, limit, buffer=max(2, (2 * batch_size + n - 1) // n))
               for p in input_paths]
        active = list(range(n))
        checked = [False] * n
        while active:
            for i in list(active):
                try:
                    frame = next(its[i])
                except StopIteration:
                    active.remove(i)
                    continue
                if not checked[i]:
                    # container headers can lie (rotation metadata); a size
                    # mismatch would make the writer drop every frame
                    if frame.shape[:2] != (h, w):
                        raise ValueError(
                            f"{input_paths[i]}: decoded frames are {frame.shape[1]}x"
                            f"{frame.shape[0]} but the container reports {w}x{h}"
                            " (rotation metadata?)"
                        )
                    checked[i] = True
                draw_order.append(i)
                yield frame

    start = time.perf_counter()
    per_stream = [0] * len(input_paths)
    try:
        for sr_rgb in engine.stream(merged(), batch_size=batch_size):
            i = draw_order.popleft()
            writers[i].write(np.ascontiguousarray(sr_rgb[:, :, ::-1]))
            per_stream[i] += 1
    finally:
        for wr in writers:
            wr.release()
    return {
        "frames": sum(per_stream),
        "per_stream": per_stream,
        "fps_in": fpses,
        "seconds": time.perf_counter() - start,
    }
