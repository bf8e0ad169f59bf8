"""oca_roofline.video.hat: HAT's overlapping cross-attentions (the OCABs',
16 x 16 queries against 24 x 24 keys) against their bound, in percent: the
least time of the OCAs of the forwards the traced slice ran (each OCAB's
``flops_hat.oca_least_seconds``: q k^T and attn v over the 576 keys at head
30 over the bf16 peak, or q, k, v, the output and the [6, 256, 576] bias
moved once over HBM's, whichever is larger), over the device time of the
kernels that ran them, matched by name (OCA: the SDPA backends' kernels and
the name ``overlap_attn`` kept for the port's own kernel; ``window_attn``,
the HABs' kernel, never). The stock path's gather copies around the SDPA
call are not matched, so the metric reads the attention kernels' own
share. The forwards are the matched launches over the driver's
``oca_launches_a_forward`` (the program's ``overlap_attention.calls`` in one
eager forward, a launch a call). None when nothing matches or the program
counts no calls."""

import re

from benchmark import flops_hat

#: the memory-efficient (cutlass ``fmha``), flash and cuDNN SDPA kernels,
#: and the port's own OCA kernel by the name it is to take
OCA = re.compile(r"fmha|flash_fwd|sdpa|attention|overlap_attn", re.IGNORECASE)
NEVER = re.compile(r"window_attn")


def read(run):
    c = run.counters
    calls = c.get("oca_launches_a_forward")
    if run.trace is None or not calls:
        return None
    h, w = c["frame_hw"]
    per_forward = len(c["arch"]["depths"]) * flops_hat.oca_least_seconds(
        c["arch"], c["batch"], h, w)
    launches, busy = 0, 0.0
    for name, seconds in run.trace["events"]:
        if OCA.search(name) and not NEVER.search(name):
            launches += 1
            busy += seconds
    return 100.0 * launches / calls * per_forward / busy if busy > 0 else None
