"""The port's HTTP front end (``serving.make_server``) and server CLI
(``python -m fast_srgan_torch.serve``), on the CPU.

A bucketed fp32 engine behind ``make_server`` on port 0: replies equal the
engine's own output bitwise, concurrent mixed sizes share batches, and the
error paths answer 400, 404 and 413 (tests/test_serving.py's cases). The
CLI parses the JAX ``serve.py`` flags plus ``--device``, warms its shapes,
and serves end to end with ``--device cpu``; its ``--config`` takes JAX's
rule (the default path may be absent, a path given must exist).
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from fast_srgan_torch import serve
from fast_srgan_torch.inference import SRInferenceEngine
from fast_srgan_torch.serving import make_server
from test_torch_engine import _save_npz
from test_torch_generator import random_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engine():
    return SRInferenceEngine(random_params(8, 1, 4, seed=2), device="cpu",
                             dtype=torch.float32, bucket=16)


def _start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def server(engine):
    srv = make_server(engine, host="127.0.0.1", port=0, max_wait_ms=20.0)
    thread = _start(srv)
    yield srv
    srv.shutdown()
    srv.batcher.close()
    thread.join(timeout=30)


def _url(srv, path):
    return f"http://127.0.0.1:{srv.server_address[1]}{path}"


def _png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _post(srv, body: bytes, path="/upscale"):
    req = urllib.request.Request(_url(srv, path), data=body)
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.headers["Content-Type"] == "image/png"
        return np.asarray(Image.open(io.BytesIO(resp.read())))


def _status(srv, path, body=None) -> int:
    req = urllib.request.Request(_url(srv, path), data=body)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    return e.value.code


class TestEndpoints:
    def test_healthz_and_stats(self, server):
        with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(_url(server, "/stats"), timeout=30) as r:
            stats = json.loads(r.read())
        assert {"requests", "batches", "errors", "uptime_s"} <= set(stats)

    def test_reply_equals_the_engine(self, server, engine):
        img = np.random.default_rng(0).integers(0, 256, (10, 14, 3), dtype=np.uint8)
        out = _post(server, _png(img))
        assert out.shape == (40, 56, 3)
        np.testing.assert_array_equal(out, engine.upscale_images([img])[0])

    def test_concurrent_mixed_sizes_batch_together(self, server, engine):
        rng = np.random.default_rng(1)
        images = [rng.integers(0, 256, (9 + i, 12, 3), dtype=np.uint8) for i in range(6)]
        outs = [None] * len(images)

        def call(i):
            outs[i] = _post(server, _png(images[i]))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        before = server.batcher.stats["batches"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for img, out in zip(images, outs):
            np.testing.assert_array_equal(out, engine.upscale_images([img])[0])
        # one 16x16 bucket and a 20 ms join window: some requests shared a batch
        assert server.batcher.stats["batches"] - before < 6

    def test_bad_image_400(self, server):
        assert _status(server, "/upscale", b"not an image") == 400

    def test_unknown_path_404(self, server):
        assert _status(server, "/nope") == 404
        assert _status(server, "/nope", b"x") == 404

    def test_oversized_body_413(self, engine):
        srv = make_server(engine, host="127.0.0.1", port=0, max_body_bytes=1024)
        thread = _start(srv)
        try:
            assert _status(srv, "/upscale", b"x" * 4096) == 413
        finally:
            srv.shutdown()
            srv.batcher.close()
            thread.join(timeout=30)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "g.npz"
    _save_npz(path, random_params(8, 1, 4, seed=3))
    return str(path)


class TestCli:
    def test_defaults_are_the_jax_servers(self):
        args = serve.parse_args([])
        assert (args.bucket, args.max_batch, args.max_wait_ms) == (32, 8, 5.0)
        assert (args.device, args.int8, args.fp32) == ("cuda", False, False)
        assert serve.warm_shapes(args.warm) == [
            (90, 160), (180, 320), (270, 480), (360, 640), (540, 960)]
        assert serve.warm_shapes("none") == [] and serve.warm_shapes("8X9, 4x4") == [(8, 9), (4, 4)]

    def test_builds_warms_and_serves_on_the_cpu(self, checkpoint):
        args = serve.parse_args(["--checkpoint", checkpoint, "--device", "cpu", "--fp32",
                                 "--port", "0", "--warm", "8x8,12x16"])
        srv = serve.build_server(args)
        engine = srv.batcher.engine
        assert engine.bucket == 32 and engine.forward_calls == 2  # the two warm shapes
        thread = _start(srv)
        try:
            img = np.random.default_rng(2).integers(0, 256, (7, 11, 3), dtype=np.uint8)
            np.testing.assert_array_equal(_post(srv, _png(img)), engine.upscale_images([img])[0])
        finally:
            srv.shutdown()
            srv.batcher.close()
            thread.join(timeout=30)

    def test_int8_calibrates_on_calib_dir(self, checkpoint, tmp_path):
        rng = np.random.default_rng(3)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8)).save(
                tmp_path / f"c{i}.png")
        args = serve.parse_args(["--checkpoint", checkpoint, "--device", "cpu", "--int8",
                                 "--calib_dir", str(tmp_path), "--warm", "none", "--port", "0"])
        srv = serve.build_server(args)
        try:
            eng = srv.batcher.engine
            assert eng.quantize_mode == "ups" and eng.bucket == 32
            assert not eng.default_calibration
        finally:
            srv.server_close()
            srv.batcher.close()

    def test_calib_dir_without_usable_images_exits(self, checkpoint, tmp_path):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "tiny.png")
        args = serve.parse_args(["--checkpoint", checkpoint, "--device", "cpu", "--int8",
                                 "--calib_dir", str(tmp_path), "--warm", "none"])
        with pytest.raises(SystemExit):
            serve.build_server(args)

    @pytest.mark.parametrize("given", [False, True])
    def test_config_default_may_be_absent(self, checkpoint, tmp_path, monkeypatch, given):
        monkeypatch.chdir(tmp_path)  # no configs/config.yaml here
        flags = ["--checkpoint", checkpoint, "--device", "cpu", "--warm", "none", "--port", "0"]
        if given:
            (tmp_path / "serve.yaml").write_text("inference:\n  bucket: 16\n")
            flags += ["--config", "serve.yaml"]
        srv = serve.build_server(serve.parse_args(flags))
        try:
            assert srv.batcher.engine.bucket == 32  # the flag's default, as JAX's server
        finally:
            srv.server_close()
            srv.batcher.close()

    def test_config_given_must_exist(self, checkpoint, tmp_path):
        missing = str(tmp_path / "missing.yaml")
        args = serve.parse_args(["--checkpoint", checkpoint, "--device", "cpu",
                                 "--warm", "none", "--config", missing])
        with pytest.raises(SystemExit, match="missing.yaml"):
            serve.build_server(args)
        proc = subprocess.run(
            [sys.executable, "-m", "fast_srgan_torch.serve", "--checkpoint", checkpoint,
             "--device", "cpu", "--warm", "none", "--config", missing],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO),
        )
        assert proc.returncode != 0 and "missing.yaml" in proc.stderr, proc.stderr[-2000:]

    def test_runs_on_the_card_by_default(self, checkpoint):
        if torch.cuda.is_available():
            pytest.skip("checks the CPU-only case")
        args = serve.parse_args(["--checkpoint", checkpoint, "--warm", "none"])
        with pytest.raises(RuntimeError, match="is_available"):
            serve.build_server(args)

    def test_module_serves_end_to_end(self, checkpoint):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        proc = subprocess.Popen(
            [sys.executable, "-m", "fast_srgan_torch.serve", "--checkpoint", checkpoint,
             "--device", "cpu", "--port", "0", "--warm", "8x8"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env,
        )
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("serving on "):
                    break
            assert lines and lines[-1].startswith("serving on "), "".join(lines)[-3000:]
            port = int(lines[-1].split()[2].rsplit(":", 1)[1])
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                assert json.loads(r.read()) == {"status": "ok"}
            img = np.random.default_rng(4).integers(0, 256, (6, 9, 3), dtype=np.uint8)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/upscale", data=_png(img))
            with urllib.request.urlopen(req, timeout=120) as r:
                assert np.asarray(Image.open(io.BytesIO(r.read()))).shape == (24, 36, 3)
        finally:
            proc.terminate()
            proc.wait(timeout=60)
