"""The command's contract without a card: it exits non-zero and prints no
result; with the card's look stubbed, its last line of standard output is
the one result object, the checks last in it and last on standard error;
a forbidden module loaded in the process stops the result."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.harness import ROOT


def test_without_a_card_exits_non_zero():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "x4-video-bf16",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if proc.returncode == 0:
        pytest.skip("a card is present")
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


STUB = {"correct": True, "attempted": 3, "failed": 0,
        "metrics": {"frames_per_s": {"value": 1.5, "unit": "frames/s"}},
        "device": {"platform": "gpu", "kind": "stub", "count": 1, "memory_peak_bytes": 1},
        "checks": {"rmse_counts": {"value": 0.5, "limit": 1.0}}}


def _stubbed(monkeypatch, modules=()):
    monkeypatch.setattr(harness, "_card_error", lambda chips: None)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: dict(STUB))
    for name in modules:
        monkeypatch.setitem(sys.modules, name, type(sys)(name))


def test_last_line_is_the_result(monkeypatch, capsys):
    _stubbed(monkeypatch)
    rc = harness.main(["--workload", "x4-video-bf16", "--seed", str(2**31 + 9),
                       "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0
    last = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert list(last)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check rmse_counts = 0.5 (limit 1.0)")


@pytest.mark.parametrize("module", ["jax", "jaxlib.xla_client", "flax", "fast_srgan_tpu.ops"])
def test_forbidden_module_stops_the_result(monkeypatch, capsys, module):
    _stubbed(monkeypatch, [module])
    rc = harness.main(["--workload", "x4-video-bf16", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert module in err


def test_port_name_is_not_forbidden(monkeypatch):
    monkeypatch.setitem(sys.modules, "fast_srgan_torch_extra", type(sys)("x"))
    assert "fast_srgan_torch_extra" not in harness.forbidden_modules()
