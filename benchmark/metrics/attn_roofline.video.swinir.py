"""attn_roofline.video.swinir: SwinIR's window attentions against their
bound, in percent: the least time of the attentions of the forwards the
traced slice ran (each layer's ``flops_swinir.attention_least_seconds``:
q k^T and attn v at head 30 over the bf16 peak, or q, k, v, the output and
the layer's bias and masks moved once over HBM's, whichever is larger),
over the device time of the kernels that ran attentions, matched by name
(ATTENTION: the SDPA backends' kernels and the port's own ``window_attn``).
The forwards are the matched launches over the launches a forward: the
driver's ``attention_calls_a_forward``, the program's
``window_attention.calls`` in one eager forward (a shifted layer runs one
call for each region of its windows), a launch a call. None when nothing
matches or the program counts no calls."""

import re

from benchmark import flops_swinir

#: the memory-efficient (cutlass ``fmha``), flash and cuDNN SDPA kernels,
#: and the port's own window-attention kernel
ATTENTION = re.compile(r"fmha|flash_fwd|attention|sdpa|window_attn", re.IGNORECASE)


def read(run):
    c = run.counters
    calls = c.get("attention_calls_a_forward")
    if run.trace is None or not calls:
        return None
    h, w = c["frame_hw"]
    arch = c["arch"]
    per_forward = sum(arch["depths"]) * flops_swinir.mean_attention_least_seconds(
        arch, c["batch"], h, w)
    launches, busy = 0, 0.0
    for name, seconds in run.trace["events"]:
        if ATTENTION.search(name):
            launches += 1
            busy += seconds
    return 100.0 * launches / calls * per_forward / busy if busy > 0 else None
