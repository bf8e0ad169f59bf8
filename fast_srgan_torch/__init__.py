"""fast_srgan_torch: Fast-SRGAN's inference engine and training steps on PyTorch/CUDA.

The PyTorch port of ``fast_srgan_tpu`` for one NVIDIA H100. It mirrors the
JAX package's module layout (``models/generator.py``, ``ops/lr_tail.py``,
``inference.py`` ...) so each counterpart is found by path, and it never
imports JAX or ``fast_srgan_tpu``: the JAX package is the numerical
reference that ``tests/test_torch_*.py`` hold this one to.

Activations are NCHW tensors in ``torch.channels_last`` memory (physically
NHWC, the JAX package's layout). The hand-written kernels (``kernels/``,
CUDA C++ in ``csrc/``) are the instance-norm family (+ PReLU, + residual
add, each also masked for the bucketed forward), the fused upsample stage,
the phase-major pixel shuffle, and the int8 tier's activation quantize and
s8 conv (``quant.py``); float convolutions run through cuDNN. The serving
entry points are ``python -m fast_srgan_torch.infer`` (images, video) and
``python -m fast_srgan_torch.serve`` (HTTP); training is ``python -m
fast_srgan_torch.train`` (``train/trainer.py`` over ``train/steps.py``, the
data pipeline in ``data/``, PSNR/SSIM in ``metrics/``). Each kernel is a
``torch.library`` op (``torch.ops.fast_srgan.*``), so ``export.py`` can
save the serving forward as ``torch.export`` programs; the tools
(``export_model``, ``evaluate``, ``interp_checkpoints``,
``convert_checkpoint``, ``plot_metrics``) are ``python -m
fast_srgan_torch.scripts.<name>``.
"""

__version__ = "0.1.0"

__all__ = [
    "Generator",
    "SRInferenceEngine",
    "arch_from_params",
    "load_npz_params",
]


def __getattr__(name):  # lazy top-level API (keeps bare import light)
    if name == "Generator":
        from fast_srgan_torch.models.generator import Generator

        return Generator
    if name in ("SRInferenceEngine", "arch_from_params"):
        import fast_srgan_torch.inference as inference

        return getattr(inference, name)
    if name == "load_npz_params":
        from fast_srgan_torch.checkpoints.npz_io import load_npz_params

        return load_npz_params
    raise AttributeError(name)
