"""The port's width-sharded forward (fast_srgan_torch/parallel) against JAX.

Same numpy weights (8 filters, 2 blocks) and inputs, fp32 on the CPU, where
the port's kernels run their plain versions and the mesh is a repeated
``cpu`` device:

  * the tiled forward at 2, 4 and 8 shards against the JAX package's
    one-device Generator, for 2x/4x/8x, with the LR tail and the canonical
    tail: 2e-5 max-abs (the bar the JAX package met against the PyTorch
    reference graph);
  * against JAX's own ``build_tiled_forward`` on a 4-device CPU mesh
    (tests/conftest.py forces 8 virtual devices), one case per scale, and
    on a 2-D ("data", "sp") mesh: 2e-5;
  * the errors for a width or a batch that does not divide, and a mesh
    with no spatial axis; ``make_mesh`` beyond the CUDA devices;
  * ``tiled_upscale_u8`` against the port's engine: at most 1 uint8 count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from fast_srgan_tpu.models import Generator as JaxGenerator
from fast_srgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fast_srgan_tpu.parallel.spatial import build_tiled_forward as jax_tiled_forward
from fast_srgan_torch.inference import SRInferenceEngine
from fast_srgan_torch.parallel.mesh import Mesh, make_mesh, mesh_axes
from fast_srgan_torch.parallel.spatial import build_tiled_forward, tiled_upscale_u8
from test_torch_generator import random_params

torch.set_num_threads(1)

TOL = 2e-5
SCALES = (2, 4, 8)


def _input(shape=(2, 16, 32), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, shape + (3,)).astype(np.float32)


def _port(params, x_nhwc, mesh, lr_tail=True) -> np.ndarray:
    forward = build_tiled_forward(mesh, dtype=torch.float32, lr_tail=lr_tail)
    y = forward(params, torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


def _cpu_mesh(n: int, axis: str = "sp") -> Mesh:
    return Mesh(["cpu"] * n, (axis,))


@pytest.fixture(scope="module")
def cases():
    """Each scale's params, input and the JAX one-device output."""
    out = {}
    for scale in SCALES:
        params = random_params(8, 2, scale, seed=scale)
        x = _input(seed=scale)
        want = JaxGenerator(n_filters=8, n_layers=2, scale_factor=scale).apply(
            params, jnp.asarray(x))
        out[scale] = (params, x, np.asarray(want))
    return out


@pytest.mark.parametrize("lr_tail", [True, False])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("scale", SCALES)
def test_matches_jax_one_device(cases, scale, n_shards, lr_tail):
    params, x, want = cases[scale]
    got = _port(params, x, _cpu_mesh(n_shards), lr_tail)
    assert got.shape == want.shape == (2, 16 * scale, 32 * scale, 3)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("scale", SCALES)
def test_matches_jax_tiled_forward(cases, scale):
    params, x, _ = cases[scale]
    want = np.asarray(jax_tiled_forward(jax_make_mesh(4, axis_name="sp"), dtype=jnp.float32)(
        params, jnp.asarray(x)))
    got = _port(params, x, _cpu_mesh(4))
    assert np.abs(got - want).max() <= TOL


def test_2d_mesh_matches_jax(cases):
    params, x, one = cases[4]
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "sp"))
    want = np.asarray(jax_tiled_forward(jmesh, dtype=jnp.float32)(params, jnp.asarray(x)))
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "sp"))
    got = _port(params, x, mesh)
    assert np.abs(got - want).max() <= TOL and np.abs(got - one).max() <= TOL
    # the same grid with the axes the other way round
    got_t = _port(params, x, Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("sp", "data")))
    assert np.abs(got_t - one).max() <= TOL


def test_one_shard_is_the_one_device_forward(cases):
    params, x, want = cases[4]
    assert np.abs(_port(params, x, _cpu_mesh(1)) - want).max() <= TOL


class TestErrors:
    def test_indivisible_width(self, cases):
        params, _, _ = cases[4]
        with pytest.raises(ValueError, match="divisible"):
            _port(params, _input((1, 16, 30)), _cpu_mesh(4))

    def test_indivisible_batch(self, cases):
        params, _, _ = cases[4]
        mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "sp"))
        with pytest.raises(ValueError, match="batch 3 not divisible"):
            _port(params, _input((3, 16, 32)), mesh)

    def test_no_spatial_axis(self):
        mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
        with pytest.raises(ValueError, match="no spatial axis"):
            build_tiled_forward(mesh, dtype=torch.float32)
        with pytest.raises(ValueError, match="no spatial axis"):
            mesh_axes(mesh, "sp")

    def test_u8_needs_a_1d_mesh(self, cases):
        params, _, _ = cases[4]
        frame = np.zeros((16, 32, 3), np.uint8)
        with pytest.raises(ValueError, match="1-D mesh"):
            tiled_upscale_u8(params, frame, Mesh([["cpu", "cpu"]], ("data", "sp")))

    def test_make_mesh_counts_cuda_devices(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ValueError, match="requested 2 CUDA devices, have 0"):
            make_mesh(2, "sp")
        with pytest.raises(ValueError, match="requested 0 CUDA devices"):
            make_mesh()

    def test_mesh_shape(self):
        with pytest.raises(ValueError, match="1-D or 2-D"):
            Mesh(["cpu", "cpu"], ("data", "sp"))
        m = Mesh([["cpu", "cpu", "cpu"], ["cpu", "cpu", "cpu"]], ("data", "sp"))
        assert m.shape == {"data": 2, "sp": 3} and m.size == 6
        assert m == Mesh([["cpu"] * 3] * 2, ("data", "sp")) and hash(m) == hash(
            Mesh([["cpu"] * 3] * 2, ("data", "sp")))


def test_tiled_upscale_u8_matches_the_engine():
    params = random_params(8, 2, 4, seed=11)
    frame = np.random.default_rng(5).integers(0, 256, (16, 32, 3), dtype=np.uint8)
    want = SRInferenceEngine(params, device="cpu", dtype=torch.float32).upscale_batch(frame[None])
    got = tiled_upscale_u8(params, frame, _cpu_mesh(4), torch.float32)
    assert got.shape == (64, 128, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want[0].astype(np.int16)).max() <= 1


def test_weights_prepared_once_per_params_object():
    params = random_params(8, 2, 4, seed=12)
    forward = build_tiled_forward(_cpu_mesh(2), dtype=torch.float32)
    x = torch.zeros((1, 3, 8, 8))
    forward(params, x)
    reps = forward.replicas(params)
    forward(params, x)
    assert forward.replicas(params) is reps and len(reps) == 1  # one device
    other = random_params(8, 2, 4, seed=13)
    assert forward.replicas(other) is not reps
