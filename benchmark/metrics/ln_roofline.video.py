"""ln_roofline.video: SwinIR's and HAT's LayerNorms against their byte bound,
in percent. Each device event whose name holds ``layer_norm`` (any case:
PyTorch's ``vectorized_layer_norm_kernel`` or the program's own kernel, the
same work whatever implements it) normalizes the cell's tokens once, a bf16
[batch, ph, pw, embed_dim] at the size the model runs the frame at
(``flops_swinir.padded``), read once and written once: its least time is
those bytes twice over HBM's peak (gamma and beta not counted, so the share
cannot pass 100). Summed over the traced slice's matched events, over their
device time. None where nothing matches or the run names no transformer
(the Fast-SRGAN cells)."""

import re

from benchmark import flops, flops_swinir

LAYER_NORM = re.compile(r"layer_norm", re.IGNORECASE)
#: bytes a bf16 value
ITEMSIZE = 2


def call_least_seconds(batch: int, h: int, w: int, arch) -> float:
    """One LayerNorm over the padded frame's tokens, read and written once,
    over HBM's peak."""
    ph, pw = flops_swinir.padded(h, w, arch["window_size"])
    return 2 * batch * ph * pw * arch["embed_dim"] * ITEMSIZE / flops.PEAK_HBM_BYTES_PER_S


def read(run):
    arch = run.counters.get("arch")
    if run.trace is None or not arch:
        return None
    h, w = run.counters["frame_hw"]
    least_one = call_least_seconds(run.counters["batch"], h, w, arch)
    least = busy = 0.0
    for name, seconds in run.trace["events"]:
        if LAYER_NORM.search(name):
            least += least_one
            busy += seconds
    return 100.0 * least / busy if busy > 0 else None
