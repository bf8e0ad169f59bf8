"""The reductions the per-layer metrics of the video cells share: each
``metrics/<name>.py`` binds one of these as its ``read``. A reader returns
None where it finds nothing to read."""

import re

from benchmark import flops

#: the resident form and the two-launch form's apply carry the epilogue
#: (0: PReLU, 1: add) as their second template argument
NORM = re.compile(r"in_(?:resident|apply)_kernel<[^,>]+,\s*(?:\(int\))?(\d+)")
STATS = re.compile(r"in_stats_kernel<")


def idle_share(run):
    """The share of the traced slice in which no kernel, copy or set ran on
    the device, in percent: 1 - busy / window from the profiler's trace."""
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_frames(run):
    """The least time the chip could take for the frames handed over in the
    window (each conv of the canonical generator over the peak of the type
    it runs in, ``flops.generator_least_seconds``), over the window, in
    percent."""
    c = run.counters
    if not c.get("frames"):
        return None
    return 100.0 * c["frames"] * c["frame_least_s"] / c["window_s"]


def in_roofline(run):
    """The generator's 17 instance norms against their byte bound, in
    percent: each norm's bytes (a bf16 [B, 64, H, W] read once and written
    once; the residual-add form reads its skip once more) over HBM's peak,
    summed over the norms in the traced slice, over the device time of the
    kernels that ran them (the statistics launch counts in the time only).
    Kernels are matched by name (NORM, STATS)."""
    if run.trace is None:
        return None
    c = run.counters
    h, w = c["frame_hw"]
    channels = run.cell.config["n_filters"]
    least = busy = 0.0
    for name, seconds in run.trace["events"]:
        m = NORM.search(name)
        if m:
            nbytes = flops.instance_norm_bytes(c["batch"], channels, h, w, residual=m.group(1) == "1")
            least += nbytes / flops.PEAK_HBM_BYTES_PER_S
            busy += seconds
        elif STATS.search(name):
            busy += seconds
    return 100.0 * least / busy if busy > 0 and least > 0 else None
