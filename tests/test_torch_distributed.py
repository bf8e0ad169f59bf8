"""Data-parallel training steps (fast_srgan_torch/parallel/dist.py, the
``dist=`` path of fast_srgan_torch/train/steps.py and
``trainer.evaluate_pass``) on two gloo ranks on the CPU, against the same
global batch in one process and against the JAX package's one-device step.

One world of 2 rank processes (``scripts/multihost_smoke.World``: a
``file://`` rendezvous, a 60 s limit) runs every arm below at
tests/test_torch_train.py's tiny config; this process runs the same arms as
a world of one. Bars:

  * 2 ranks against 1 process, the JAX package's own for its mesh step
    (tests/test_train_steps.py): metrics rtol 2e-5, parameters (and the
    EMA) atol 1e-5; validation PSNR and SSIM rtol 1e-6 over 5 images with
    the global batch 4 (the tail batch holds one image: rank 1 evaluates
    only padding rows), each image counted once; after the steps every
    rank's parameters are the same bits.
  * 2 ranks against JAX's one-device step on the same global batch,
    weights and label noise: tests/test_torch_train.py's bars (metrics
    rtol 1e-5, every gradient within 1e-4 of its tensor's max-abs, the
    update check).

The arms: a pretrain step; augmentation with the label noise drawn inside
(both drawn for the global batch, then sliced); grad_accum 2 with a
grad_clip far below the gradients' norm (so the update depends on the
clipped scale through Adam's eps) and ema_decay; parallel.scale_lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_torch.checkpoints.convert import (
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from fast_srgan_torch.config import default_config
from fast_srgan_torch.models.discriminator import Discriminator
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.parallel import dist as pdist
from fast_srgan_torch.scripts.multihost_smoke import World, run_case
from fast_srgan_torch.train.steps import build_bundle
from fast_srgan_tpu.config import default_config as jax_default_config
from fast_srgan_tpu.train import losses as jax_losses
from fast_srgan_tpu.train.steps import build_bundle as jax_build_bundle
from fast_srgan_tpu.train.steps import prepare_batch as jax_prepare_batch
from test_torch_train import (  # noqa: F401
    _assert_grads,
    _assert_update,
    _host,
    _jax_d_params,
    hr_batch,
    tiny,
)

torch.set_num_threads(1)

WORLD = 2
N_VAL = 5
LOSS_RTOL, PARAM_ATOL, EVAL_RTOL = 2e-5, 1e-5, 1e-6


def _batch(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, hr_batch):
    """Every arm on 2 ranks and in one process, and JAX's references."""
    jb, g_state, d_state, vgg_params = jax_build_bundle(jax_default_config(**tiny()))
    g0, d0 = _host(g_state.params), _host(d_state.params)
    init = {"g_init": state_dict_from_jax_params(g0),
            "d_init": discriminator_state_dict_from_jax_params(d0)}
    key = jax.random.key(11)
    k_d, k_g = jax.random.split(key, 2)
    k_real, k_fake = jax.random.split(k_d, 2)
    u = [np.array(jax.random.uniform(k, (4, 2, 2, 1))) for k in (k_real, k_fake, k_g)]
    noise = [[torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in u]]

    workdir = tmp_path_factory.mktemp("dp")
    val_dir = workdir / "val"
    val_dir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(N_VAL):
        np.save(val_dir / f"v{i}.npy", rng.integers(0, 256, (48, 48, 3), dtype=np.uint8))
    case = {"hr": torch.from_numpy(hr_batch), "val_dir": str(val_dir), "arms": {
        "pretrain": {"config": tiny(), "pretrain": 1, "gan": 0},
        "gan": {"config": tiny(augment=True), "pretrain": 1, "gan": 2, "hr": _batch(4, 6)},
        "accum": {"config": tiny(grad_accum=2, grad_clip=1e-7, ema_decay=0.9),
                  "pretrain": 1, "gan": 2, "hr": _batch(8, 7)},
        "scale_lr": {"config": {**tiny(), "parallel": {"scale_lr": True}},
                     "pretrain": 1, "gan": 1},
        "jax_pretrain": {"config": tiny(), "pretrain": 1, "gan": 0, **init},
        "jax_gan": {"config": tiny(), "pretrain": 0, "gan": 1, "noise": noise, **init},
    }}
    world = World(case, WORLD, "cpu", str(workdir), timeout=60)
    try:
        # JAX's steps and the one-process run while the ranks run
        lr_img, hr_img = jax_prepare_batch(jnp.asarray(hr_batch), 8)
        pre_grads = jax.jit(jax.grad(
            lambda p: jax_losses.smooth_l1_loss(jb.generator.apply(p, lr_img), hr_img)))(g0)
        # the steps donate their states: the pretrain step takes a copy
        g1, loss_j = jb.pretrain_step(jax.tree.map(jnp.copy, g_state), jnp.asarray(hr_batch))
        jax_pre = {"loss": float(loss_j), "g1": state_dict_from_jax_params(_host(g1.params)),
                   "grads": state_dict_from_jax_params(_host(pre_grads))}
        g_s, d_s, m_j = jb.gan_step(g_state, d_state, vgg_params, jnp.asarray(hr_batch), key)
        jax_gan = {"metrics": {k: float(v) for k, v in m_j.items()},
                   "g1": state_dict_from_jax_params(_host(g_s.params)),
                   "d1": discriminator_state_dict_from_jax_params(_host(d_s.params)),
                   "jb": jb, "u": u, "g0": g0, "d0": d0, "lr_img": lr_img, "hr_img": hr_img}
        single = run_case(case, "cpu")
    finally:
        ranks = world.results()
    return {"case": case, "single": single["arms"], "ranks": [r["arms"] for r in ranks],
            "jax_pretrain": jax_pre, "jax_gan": jax_gan}


def test_local_rows_and_a_world_of_one():
    assert pdist.local_rows(24, 0, 2) == slice(0, 12)
    assert pdist.local_rows(24, 1, 2) == slice(12, 24)
    assert pdist.DistInfo(rank=3, world=4).rows(5) == slice(15, 20)
    with pytest.raises(ValueError, match="does not split"):
        pdist.local_rows(5, 0, 2)
    t = torch.ones(3)
    pdist.all_reduce_mean_([t], pdist.SINGLE)
    pdist.all_reduce_sum_([t], pdist.SINGLE)
    assert torch.equal(t, torch.ones(3))
    assert pdist.broadcast_object("x", pdist.SINGLE) == "x"
    assert pdist.init_from_env("cpu") is pdist.SINGLE  # no torchrun environment


def test_draws_are_the_global_batch_sliced():
    """A rank's coins and label noise are rows of the global batch's: rank
    1 of 2 (no group: the rows only) against one process."""
    config = default_config(**tiny(augment=True))
    one = build_bundle(config, "cpu")
    rank1 = build_bundle(config, "cpu", dist=pdist.DistInfo(rank=1, world=2))
    hr = _batch(8, 1)
    assert torch.equal(rank1._augment(hr[4:], 3), one._augment(hr, 3)[4:])
    for a, b in zip(rank1._label_noise(None, (4, 1, 2, 2), 5),
                    one._label_noise(None, (8, 1, 2, 2), 5)):
        assert torch.equal(a, b[4:])
    given = [torch.rand(8, 1, 2, 2) for _ in range(3)]
    for a, b in zip(rank1._label_noise(given, (4, 1, 2, 2), 5), given):
        assert torch.equal(a, b[4:])


@pytest.mark.parametrize("arm", ["pretrain", "gan", "accum", "jax_gan"])
def test_two_ranks_match_one_process(runs, arm):
    want = runs["single"][arm]
    got = [r[arm] for r in runs["ranks"]]
    assert got[0]["metrics"] == got[1]["metrics"]  # the all-reduced means
    for step_got, step_want in zip(got[0]["metrics"], want["metrics"]):
        assert step_got.keys() == step_want.keys()
        for k, v in step_want.items():
            np.testing.assert_allclose(step_got[k], v, rtol=LOSS_RTOL, err_msg=k)
    trees = ("g", "d", "g_ema") if want["g_ema"] is not None else ("g", "d")
    for tree in trees:
        for name, value in want[tree].items():
            np.testing.assert_allclose(got[0][tree][name].numpy(), value.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{tree} {name}")
    assert got[0]["digest"] == got[1]["digest"], "ranks' parameters differ"


@pytest.mark.parametrize("arm", ["pretrain", "gan"])
def test_validation_matches_one_process(runs, arm):
    want = runs["single"][arm]["eval"]
    for rank in runs["ranks"]:
        got = rank[arm]["eval"]
        assert got["images"] == want["images"] == N_VAL
        for k in ("psnr", "ssim"):
            np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, err_msg=k)


def test_scale_lr_multiplies_both_rates_by_the_world(runs):
    cfg = default_config(**tiny()).training
    base = [cfg.generator_lr, cfg.discriminator_lr]
    assert runs["single"]["scale_lr"]["lrs"] == base
    for rank in runs["ranks"]:
        assert rank["scale_lr"]["lrs"] == [WORLD * v for v in base]
    assert runs["ranks"][0]["pretrain"]["lrs"] == base  # scale_lr off


def _model(cls, state):
    model = cls(**({"n_filters": 8, "n_layers": 2} if cls is Generator else {"n_filters": 8}))
    model.load_state_dict(state)
    for name, p in model.named_parameters():
        p.grad = None
    return model


def test_pretrain_step_against_jax(runs):
    got, ref = runs["ranks"][0]["jax_pretrain"], runs["jax_pretrain"]
    np.testing.assert_allclose(got["metrics"][0]["loss"], ref["loss"], rtol=1e-5)
    g = _model(Generator, got["g"])
    for name, p in g.named_parameters():
        p.grad = got["g_grad"][name]
    _assert_grads(g, ref["grads"])
    p0 = {n: v for n, v in runs["case"]["arms"]["jax_pretrain"]["g_init"].items()}
    _assert_update(g, p0, ref["g1"], ref["grads"])


def test_gan_step_against_jax(runs):
    got, ref = runs["ranks"][0]["jax_gan"], runs["jax_gan"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][0][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    jb, u, lr_img, hr_img = ref["jb"], ref["u"], ref["lr_img"], ref["hr_img"]
    sr = jb.generator.apply(ref["g0"], lr_img)

    def d_loss(p):
        real = jax_losses.bce_with_logits_loss(
            jb.discriminator.apply(p, hr_img), 0.3 * u[0] + 0.8)
        fake = jax_losses.bce_with_logits_loss(jb.discriminator.apply(p, sr), 0.3 * u[1])
        return 0.5 * real + 0.5 * fake

    d = _model(Discriminator, got["d"])
    d1 = _jax_d_params(d)  # G's gradient is taken against the ranks' updated D

    def g_loss(p):
        out = jb.generator.apply(p, lr_img)
        adv = 0.1 * jax_losses.bce_with_logits_loss(
            jb.discriminator.apply(d1, out), 0.3 * u[2] + 0.7)
        return 0.5 * adv + 0.5 * jax_losses.smooth_l1_loss(out, hr_img)

    d_grads = discriminator_state_dict_from_jax_params(_host(jax.jit(jax.grad(d_loss))(ref["d0"])))
    g_grads = state_dict_from_jax_params(_host(jax.jit(jax.grad(g_loss))(ref["g0"])))
    g = _model(Generator, got["g"])
    for model, grads in ((g, got["g_grad"]), (d, got["d_grad"])):
        for name, p in model.named_parameters():
            p.grad = grads[name]
    _assert_grads(d, d_grads)
    _assert_grads(g, g_grads)
    init = runs["case"]["arms"]["jax_gan"]
    _assert_update(d, init["d_init"], ref["d1"], d_grads)
    _assert_update(g, init["g_init"], ref["g1"], g_grads)
