"""scan_roofline.video.mambair: MambaIR's selective scans against their bound,
in percent: the least time of the SS2D scans of the forwards the traced
slice ran (each SS2D's ``flops_mambair.scan_least_seconds``: one exponential
a state update over the special-function units' rate, or u, the x
projection's output and y moved once over HBM's, whichever is larger), over
the device time of the kernels matched by the name ``selective_scan``. The
forwards are the matched launches over the driver's
``scan_launches_a_forward`` (the program's ``ss2d.calls`` in one eager
forward, one launch a call). None when nothing matches or the program counts
no calls."""

import re

from benchmark import flops_mambair

#: the port's scan kernel
SCAN = re.compile(r"selective_scan")


def read(run):
    c = run.counters
    calls = c.get("scan_launches_a_forward")
    if run.trace is None or not calls:
        return None
    h, w = c["frame_hw"]
    arch = c["arch"]
    per_forward = sum(arch["depths"]) * flops_mambair.scan_least_seconds(arch, c["batch"], h, w)
    launches, busy = 0, 0.0
    for name, seconds in run.trace["events"]:
        if SCAN.search(name):
            launches += 1
            busy += seconds
    return 100.0 * launches / calls * per_forward / busy if busy > 0 else None
