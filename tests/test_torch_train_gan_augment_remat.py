"""``augment`` and ``remat`` in the GAN step against the JAX package's
``build_bundle``, on the CPU in fp32 at tests/test_torch_train.py's tiny
config: JAX's own coins and label noise from its key splits, the bars of
tests/test_torch_train_gan_options.py (metrics rtol 1e-5, the update check
for D and G)."""

import pytest
import torch

from test_torch_train import hr_batch  # noqa: F401
from test_torch_train_gan_options import assert_gan_option_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("option", ["augment", "remat"])
def test_gan_option_matches_jax(option, hr_batch):
    bundle = assert_gan_option_matches_jax({option: True}, hr_batch)
    assert bundle.augment is (option == "augment")
    assert bundle.generator.remat is (option == "remat")
