"""The port's video path (``fast_srgan_torch/video.py``) and ``infer --video``,
on the CPU: decode -> ``engine.stream`` -> encode round trips with the
writer at the engine's scale, several streams equal to one-stream runs, and
the int8 auto-calibration: on the streams' first frames (at one and two
streams the same frames JAX takes, and scales within rtol 1e-6 of JAX's
calibration of them), never over the caller's scales, and at three streams
eight frames (ceil(8 / 3) from each, where JAX's ``8 // 3`` took six).
"""

import os
from itertools import islice

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from fast_srgan_tpu import quant as jq  # noqa: E402
from fast_srgan_torch import infer, quant  # noqa: E402
from fast_srgan_torch.inference import SRInferenceEngine  # noqa: E402
from fast_srgan_torch.video import (  # noqa: E402
    calibration_frames,
    iter_video_frames,
    upscale_video,
    upscale_videos,
)
from test_torch_engine import _save_npz  # noqa: E402
from test_torch_generator import random_params  # noqa: E402

torch.set_num_threads(1)


def _make_video(path, n_frames, seed, size=(32, 16)):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24, size)
    base = np.random.default_rng(seed).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    for i in range(n_frames):
        writer.write(np.roll(base, i, axis=1))
    writer.release()
    return str(path)


def _count_frames(path):
    cap = cv2.VideoCapture(path)
    ok, frame = cap.read()
    n = int(ok)
    while cap.read()[0]:
        n += 1
    cap.release()
    return n, frame


def _engine(scale=4, seed=0, **kw):
    return SRInferenceEngine(random_params(8, 1, scale, seed=seed), device="cpu",
                             dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def tiny_video(tmp_path_factory):
    return _make_video(tmp_path_factory.mktemp("vid") / "in.mp4", 9, seed=0)


class TestVideo:
    def test_iter_frames(self, tiny_video):
        frames = list(iter_video_frames(tiny_video))
        assert len(frames) == 9
        assert frames[0].shape == (16, 32, 3) and frames[0].dtype == np.uint8
        assert len(list(iter_video_frames(tiny_video, limit=4))) == 4

    @pytest.mark.parametrize("scale", [2, 4])
    def test_round_trip_writer_at_the_engines_scale(self, tiny_video, tmp_path, scale):
        out_path = str(tmp_path / "out.mp4")
        stats = upscale_video(_engine(scale), tiny_video, out_path, batch_size=4)
        assert stats["frames"] == 9
        n, frame = _count_frames(out_path)
        assert n == 9 and frame.shape == (16 * scale, 32 * scale, 3)

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            upscale_video(_engine(), str(tmp_path / "nope.mp4"), str(tmp_path / "o.mp4"))

    def test_refuses_to_overwrite_an_input(self, tiny_video):
        with pytest.raises(ValueError, match="overwrite"):
            upscale_video(_engine(), tiny_video, tiny_video)


class TestMultiStream:
    def test_two_streams_equal_single_stream_outputs(self, tmp_path):
        a = _make_video(tmp_path / "a.mp4", 7, seed=1)
        b = _make_video(tmp_path / "b.mp4", 5, seed=2)  # shorter
        engine = _engine()
        outs = [str(tmp_path / "a4x.mp4"), str(tmp_path / "b4x.mp4")]
        stats = upscale_videos(engine, [a, b], outs, batch_size=4)
        assert stats["per_stream"] == [7, 5] and stats["frames"] == 12
        for src, multi, n in [(a, outs[0], 7), (b, outs[1], 5)]:
            single = str(tmp_path / ("ref_" + os.path.basename(src)))
            upscale_video(engine, src, single, batch_size=4)
            fm, fs = list(iter_video_frames(multi)), list(iter_video_frames(single))
            assert len(fm) == len(fs) == n
            for x, y in zip(fm, fs):
                np.testing.assert_array_equal(x, y)

    def test_mixed_sizes_rejected(self, tmp_path):
        a = _make_video(tmp_path / "a.mp4", 3, seed=1)
        c = _make_video(tmp_path / "c.mp4", 3, seed=3, size=(48, 16))
        with pytest.raises(ValueError, match="one frame size"):
            upscale_videos(_engine(), [a, c], [str(tmp_path / "x.mp4"), str(tmp_path / "y.mp4")])


def _jax_calibration(params, paths):
    """The JAX video path's calibration: 8 // N first frames of each stream
    (fast_srgan_tpu/video.py), calibrated by fast_srgan_tpu.quant."""
    per = max(1, 8 // len(paths))
    first = []
    for p in paths:
        first.extend(islice(iter_video_frames(p, limit=per), per))
    return jq.calibrate_scales(params, [jq.calibration_batch_from_images(first)], 4)


class TestInt8Calibration:
    @pytest.mark.parametrize("n_streams", [1, 2])
    def test_calibrates_on_the_frames_as_jax_does(self, tmp_path, n_streams):
        paths = [_make_video(tmp_path / f"q{i}.mp4", 9, seed=7 + i, size=(48, 48))
                 for i in range(n_streams)]
        params = random_params(8, 1, 4, seed=1)
        engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True)
        synthetic = {k: v.clone() for k, v in engine.act_scales.items()}
        outs = [str(tmp_path / f"q{i}4x.mp4") for i in range(n_streams)]
        stats = upscale_videos(engine, paths, outs, batch_size=4)
        assert stats["frames"] == 9 * n_streams
        assert engine.default_calibration  # still auto-managed
        want = _jax_calibration(params, paths)
        assert set(engine.act_scales) == set(want)
        for k in want:
            np.testing.assert_allclose(float(engine.act_scales[k]), float(want[k]), rtol=1e-6)
        assert any(not torch.equal(engine.act_scales[k], synthetic[k]) for k in synthetic)

    def test_three_streams_calibrate_on_eight_frames(self, tmp_path, monkeypatch):
        paths = [_make_video(tmp_path / f"t{i}.mp4", 5, seed=20 + i, size=(48, 48))
                 for i in range(3)]
        frames = calibration_frames(paths)
        assert len(frames) == 8  # 3 + 3 + 2
        want = [f for p in paths for f in islice(iter_video_frames(p), 3)][:8]
        for got, exp in zip(frames, want):
            np.testing.assert_array_equal(got, exp)
        engine = _engine(quantize=True)
        seen = []
        monkeypatch.setattr(engine, "recalibrate", lambda batches: seen.extend(batches))
        upscale_videos(engine, paths, [str(tmp_path / f"t{i}4x.mp4") for i in range(3)],
                       batch_size=4)
        assert len(seen) == 1 and seen[0].shape == (8, 48, 48, 3)

    def test_respects_the_callers_calibration(self, tmp_path):
        src = _make_video(tmp_path / "c.mp4", 9, seed=11, size=(48, 48))
        curated = np.random.default_rng(4).uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
        engine = _engine(quantize=True, calib_batches=[curated])
        assert engine.default_calibration is False
        before = {k: v.clone() for k, v in engine.act_scales.items()}
        assert upscale_videos(engine, [src], [str(tmp_path / "c4x.mp4")],
                              batch_size=4)["frames"] == 9
        assert all(torch.equal(engine.act_scales[k], before[k]) for k in before)

    def test_auto_engine_recalibrates_per_call(self, tmp_path):
        a = _make_video(tmp_path / "a.mp4", 9, seed=7, size=(48, 48))
        b = _make_video(tmp_path / "b.mp4", 9, seed=21, size=(48, 48))
        engine = _engine(quantize=True)
        upscale_videos(engine, [a], [str(tmp_path / "a4.mp4")], batch_size=4)
        upscale_videos(engine, [b], [str(tmp_path / "b4.mp4")], batch_size=4)
        want = quant.calibrate_scales(engine._calib_plan,
                                      [quant.calibration_batch_from_images(calibration_frames([b]))])
        assert all(torch.equal(engine.act_scales[k], want[k]) for k in want)


class TestInferCli:
    @pytest.fixture
    def checkpoint(self, tmp_path):
        path = tmp_path / "g.npz"
        _save_npz(path, random_params(8, 1, 4, seed=5))
        return str(path)

    def test_video_end_to_end(self, tiny_video, tmp_path, checkpoint):
        out = str(tmp_path / "o.mp4")
        infer.main(["--video", tiny_video, "--video_out", out, "--checkpoint", checkpoint,
                    "--fp32", "--device", "cpu", "--batch_size", "4"])
        n, frame = _count_frames(out)
        assert n == 9 and frame.shape == (64, 128, 3)

    def test_several_videos_into_output_dir(self, tmp_path, checkpoint):
        a = _make_video(tmp_path / "a.mp4", 4, seed=1)
        b = _make_video(tmp_path / "b.mp4", 3, seed=2)
        dst = tmp_path / "out"
        infer.main(["--video", a, b, "--output_dir", str(dst), "--checkpoint", checkpoint,
                    "--device", "cpu"])
        assert [_count_frames(str(dst / n))[0] for n in ("a.mp4", "b.mp4")] == [4, 3]

    @pytest.mark.parametrize("flags", [["--bucket", "16", "--video_out", "o.mp4"], []])
    def test_parser_errors(self, tiny_video, checkpoint, flags):
        # --video with --bucket, as in JAX; --video with nowhere to write
        with pytest.raises(SystemExit):
            infer.main(["--video", tiny_video, "--checkpoint", checkpoint, "--device", "cpu",
                        *flags])
