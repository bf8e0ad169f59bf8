"""attn_roofline.video.hat: HAT's window attentions (the HABs', window 16)
against their bound, in percent: the least time of the HAB attentions of the
forwards the traced slice ran (each HAB's
``flops_hat.hab_attention_least_seconds``: q k^T and attn v at head 30 over
the bf16 peak, or q, k, v, the output and the layer's mask classes moved once
over HBM's, whichever is larger; the mean over shifted and unshifted HABs),
over the device time of the kernels matched by the name ``window_attn``.
The forwards are the matched launches over the driver's
``hab_launches_a_forward`` (the program's ``window_attention.calls`` in one
eager forward, a launch a call). None when nothing matches or the program
counts no calls."""

import re

from benchmark import flops_hat

#: the port's window-attention kernel
WINDOW_ATTN = re.compile(r"window_attn")


def read(run):
    c = run.counters
    calls = c.get("hab_launches_a_forward")
    if run.trace is None or not calls:
        return None
    h, w = c["frame_hw"]
    arch = c["arch"]
    per_forward = sum(arch["depths"]) * flops_hat.mean_hab_attention_least_seconds(
        arch, c["batch"], h, w)
    launches, busy = 0, 0.0
    for name, seconds in run.trace["events"]:
        if WINDOW_ATTN.search(name):
            launches += 1
            busy += seconds
    return 100.0 * launches / calls * per_forward / busy if busy > 0 else None
