"""The six measurement scripts as ``python -m fast_srgan_torch.scripts.<name>``
processes, on the CPU.

Imported in a fresh interpreter, each script module leaves ``jax`` and
``fast_srgan_tpu`` out of ``sys.modules``: the port's scripts never load
the JAX package. Run with its default ``--device cuda`` where there is no
card, each exits non-zero with a message that says so, and prints no
result: a measurement never moves to the CPU by itself.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("eval_int8", "bench_4k", "bench_serve", "train_throughput", "profile_model", "soak")
_ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}


def _run(args):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=_ENV)


@pytest.mark.parametrize("name", SCRIPTS)
def test_module_imports_nothing_of_jax(name):
    proc = _run(["-c", "import importlib, sys\n"
                 f"importlib.import_module('fast_srgan_torch.scripts.{name}')\n"
                 "print(sorted(m for m in sys.modules\n"
                 "             if m.split('.')[0] in ('jax', 'jaxlib', 'fast_srgan_tpu')))"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", SCRIPTS)
def test_default_device_without_a_card_exits(name):
    proc = _run(["-m", f"fast_srgan_torch.scripts.{name}"])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert "{" not in proc.stdout
