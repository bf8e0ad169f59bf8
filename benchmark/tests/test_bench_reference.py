"""The plain references against the port's own plain CPU paths at small
sizes, in fp32: the generator and the bucketed (masked) forward."""

import numpy as np
import torch

from benchmark import inputs, weights
from benchmark.harness import ROOT
from benchmark.reference.generator import generator, upscale_u8, weights_from_tree


def _tree():
    return weights.load_npz_tree(ROOT + "/models/generator_pretrained.npz")


def test_generator_matches_the_port_fp32():
    from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
    from fast_srgan_torch.models.generator import Generator

    tree = _tree()
    model = Generator()
    model.load_state_dict(state_dict_from_jax_params(tree))
    x = torch.rand(2, 3, 12, 20) * 2 - 1
    with torch.no_grad():
        got = model(x)
        want = generator(weights_from_tree(tree, "cpu"), x)
    assert torch.allclose(got, want, atol=2e-5), (got - want).abs().max()


def test_masked_engine_matches_the_reference_per_image():
    from fast_srgan_torch.inference import SRInferenceEngine

    tree = _tree()
    engine = SRInferenceEngine(tree, dtype=torch.float32, device="cpu", bucket=8)
    images = [inputs.structured_images(1, h, w, 3 + h, "cpu")[0].numpy()
              for h, w in ((13, 17), (16, 24), (9, 11))]
    outs = engine.upscale_images(images, batch_size=4)
    w = weights_from_tree(tree, "cpu")
    for im, out in zip(images, outs):
        want = upscale_u8(w, torch.from_numpy(im)[None])[0].numpy()
        assert out.shape == want.shape
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
