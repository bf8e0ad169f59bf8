"""mask_builds.video.hat: the HAT model's ``mask_builds`` counter's rise over
the measured window and one eager ``upscale_batch`` after it (sets of HAB
masks and OCA biases built; 0 when the cache serves every forward), as the
driver counted it. None where the program has no such counter."""


def read(run):
    value = run.counters.get("mask_builds")
    return None if value is None else float(value)
