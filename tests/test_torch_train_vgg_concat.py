"""``vgg_concat`` against the JAX package's ``build_bundle``, on the CPU in
fp32 at tests/test_torch_train.py's tiny config with the fixed-seed VGG19
(JAX's weights loaded into the port's): one GAN step with one VGG forward
over cat([sr, hr]), the bars of tests/test_torch_train_gan_options.py
(metrics rtol 1e-5, the update check for D and G)."""

import torch

from test_torch_train import hr_batch  # noqa: F401
from test_torch_train_gan_options import assert_gan_option_matches_jax

torch.set_num_threads(1)


def test_vgg_concat_matches_jax(hr_batch):
    bundle = assert_gan_option_matches_jax({"vgg_weights": "init", "vgg_concat": True}, hr_batch)
    assert bundle.vgg_concat and not bundle.remat_vgg
