"""Nothing the benchmark imports is JAX or the JAX package: every module
under benchmark/ and every driver's program modules, imported in a fresh
process, leave no module whose top-level name is jax, jaxlib, flax or
fast_srgan_tpu (compared whole: fast_srgan_torch is the program)."""

import subprocess
import sys

from benchmark.harness import ROOT

SCRIPT = r"""
import glob, os, sys
sys.path.insert(0, ".")
import benchmark.harness as h, benchmark.control, benchmark.readers, benchmark.trace
for kind in ("drivers", "metrics"):
    for path in glob.glob(f"benchmark/{kind}/*.py"):
        h.load_module(kind, os.path.basename(path)[:-3])
import fast_srgan_torch.inference, fast_srgan_torch.quant
import fast_srgan_torch.scripts.profile_model
print(",".join(h.forbidden_modules()))
"""


def test_no_forbidden_module_is_imported():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""
