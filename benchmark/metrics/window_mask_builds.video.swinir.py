"""window_mask_builds.video.swinir: the SwinIR model's ``mask_builds``
counter's rise over the measured window (sets of attention bias and shift
masks built; 0 when the cache serves every forward), as the driver
counted it. None where the program has no such counter."""


def read(run):
    value = run.counters.get("mask_builds")
    return None if value is None else float(value)
