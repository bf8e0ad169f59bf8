"""tail_roofline.video: the LR tail's bias + PReLU + window passes against
their byte bound, in percent: each launch of the program's ``tail_epilogue``
kernel (matched by that name, which no other kernel carries) reads one
upsampling output's window, a bf16 [batch, 4 n_filters, H, W] at the frame's
LR size, and writes it once, so its least time is those bytes twice over
HBM's peak (the interior only: stage 1's zero border is left out, so the
share cannot pass 100). Summed over the traced slice's launches, over their
device time. None where no launch matched (a program without the kernel)."""

import re

from benchmark import flops

TAIL = re.compile(r"tail_epilogue")
#: bytes a bf16 value
ITEMSIZE = 2


def launch_least_seconds(batch: int, n_filters: int, h: int, w: int) -> float:
    """One upsampling output's window read and written once, over HBM's peak."""
    return 2 * batch * 4 * n_filters * h * w * ITEMSIZE / flops.PEAK_HBM_BYTES_PER_S


def read(run):
    if run.trace is None:
        return None
    c = run.counters
    h, w = c["frame_hw"]
    least_one = launch_least_seconds(c["batch"], run.cell.config["n_filters"], h, w)
    least = busy = 0.0
    for name, seconds in run.trace["events"]:
        if TAIL.search(name):
            least += least_one
            busy += seconds
    return 100.0 * least / busy if busy > 0 else None
