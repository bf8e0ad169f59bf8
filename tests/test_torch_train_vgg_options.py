"""``remat_vgg`` against the JAX package's ``build_bundle``, on the CPU in
fp32 at tests/test_torch_train.py's tiny config with the fixed-seed VGG19
(JAX's weights loaded into the port's): one GAN step, the bars of
tests/test_torch_train_gan_options.py (metrics rtol 1e-5, the update check
for D and G); ``vgg_concat`` is in tests/test_torch_train_vgg_concat.py
(each file pays JAX's first build and VGG init on the CPU). And the
concatenated VGG forward against two VGG calls, and the checkpointed term
against the plain one, in the port alone (rtol 1e-6)."""

import numpy as np
import torch

from fast_srgan_torch.config import default_config
from fast_srgan_torch.train.steps import build_bundle, prepare_batch
from test_torch_train import hr_batch, tiny  # noqa: F401
from test_torch_train_gan_options import assert_gan_option_matches_jax

torch.set_num_threads(1)


def test_remat_vgg_matches_jax(hr_batch):
    bundle = assert_gan_option_matches_jax({"vgg_weights": "init", "remat_vgg": True}, hr_batch)
    assert bundle.remat_vgg and not bundle.vgg_concat


def test_content_term_forms_agree(hr_batch):
    """One VGG forward over cat([sr, hr]) split in two, and the checkpointed
    forward, give the plain term and its gradient."""
    bundle = build_bundle(default_config(**tiny(vgg_weights="init")), "cpu")
    lr_img, hr_img = prepare_batch(torch.from_numpy(hr_batch), 8)
    sr = bundle.generator(lr_img).detach()
    out = []
    for concat, remat in ((False, False), (True, False), (False, True), (True, True)):
        bundle.vgg_concat, bundle.remat_vgg = concat, remat
        x = sr.clone().requires_grad_(True)
        loss = bundle._content(x, hr_img)
        (grad,) = torch.autograd.grad(loss, x)
        out.append((float(loss.detach()), grad))
    for loss, grad in out[1:]:
        np.testing.assert_allclose(loss, out[0][0], rtol=1e-6)
        torch.testing.assert_close(grad, out[0][1], rtol=1e-5, atol=1e-12)
