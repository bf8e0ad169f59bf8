"""The port's dihedral augmentation (fast_srgan_torch/ops/augment.py)
against the JAX package's ``augment_dihedral``: on the same coins (JAX's
own draw from a key), bitwise equal to its ``jnp.where`` composition, for
square inputs (all 8 symmetries) and non-square ones (flips only)."""

import jax
import numpy as np
import pytest
import torch

from fast_srgan_torch.ops.augment import apply_dihedral, draw_coins
from fast_srgan_tpu.ops.augment import augment_dihedral

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(16, 6, 6, 3), (16, 5, 7, 3)])
@pytest.mark.parametrize("seed", [0, 3])
def test_matches_jax_on_its_coins(shape, seed):
    x = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.key(seed)
    want = np.asarray(augment_dihedral(x, key))
    coins = torch.from_numpy(np.array(jax.random.bernoulli(key, shape=(3, shape[0]))))
    got = apply_dihedral(torch.from_numpy(x), coins)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_all_eight_symmetries_on_a_square():
    """Each coin triple gives its own transform of one asymmetric image."""
    x = torch.arange(16, dtype=torch.uint8).view(1, 4, 4, 1).expand(8, 4, 4, 1)
    bits = torch.tensor([[(k >> b) & 1 for k in range(8)] for b in range(3)], dtype=torch.bool)
    out = apply_dihedral(x.contiguous(), bits)
    assert len({tuple(o.flatten().tolist()) for o in out}) == 8
    assert torch.equal(out[0], x[0])  # all coins 0: identity


def test_draw_coins_is_seeded_and_fair():
    a = draw_coins(4000, torch.Generator().manual_seed(5))
    b = draw_coins(4000, torch.Generator().manual_seed(5))
    assert a.dtype == torch.bool and a.shape == (3, 4000) and torch.equal(a, b)
    assert abs(a.float().mean().item() - 0.5) < 0.02
    with pytest.raises(ValueError, match="coins"):
        apply_dihedral(torch.zeros(2, 4, 4, 3), a[:, :3])
