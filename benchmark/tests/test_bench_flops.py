"""The canonical operation counts against torch's FlopCounterMode on the
port at one shape (``fast_srgan_torch.scripts.profile_model``'s counter),
the conv ops only: the count is the yardstick's, the counter the check."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops


def _conv_flops(counter) -> int:
    counts = counter.get_flop_counts()["Global"]
    return sum(n for op, n in counts.items() if "convolution" in str(op))


def test_generator_forward_count():
    from fast_srgan_torch.scripts import profile_model

    args = type("A", (), {"int8": False, "fused": False, "lr_tail": False})()
    fn = profile_model.forward_fn(args, 1, 12, 20, torch.device("cpu"), torch.float32)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn()
    assert _conv_flops(counter) == flops.generator_flops(12, 20)
    assert flops.generator_flops(180, 320) == 160_513_228_800
