"""The ctypes binding of the port's CUDA kernels, checked against the sources.

Every ``extern "C"`` function in fast_srgan_torch/csrc/*.cu must have an
entry in ``_build.ENTRY_POINTS`` with one argument type per parameter: a
pointer (and the stream) as c_void_p, an int as c_int, a long long as
c_longlong, a float as c_float. A missing or short binding would let ctypes
pass a 64-bit pointer or count as a 32-bit int, which only a card would
show.
"""

import ctypes
import re

import pytest

from fast_srgan_torch.kernels import _build

_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _declared():
    out = {}
    for path in _build.sources():
        for name, params in _EXTERN.findall(path.read_text()):
            out[name] = [p.strip() for p in params.split(",") if p.strip()]
    return out


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    if param.split()[0] == "float":
        return ctypes.c_float
    if param.split()[:2] == ["long", "long"]:
        return ctypes.c_longlong
    assert param.split()[0] == "int", param
    return ctypes.c_int


def test_every_entry_point_is_bound():
    declared = _declared()
    assert len(declared) >= 5
    assert set(declared) == set(_build.ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_binding_matches_the_signature(name):
    params = _declared()[name]
    assert _build.ENTRY_POINTS[name] == [_ctype(p) for p in params], params
