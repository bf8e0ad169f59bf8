"""s8_roofline.video: the int8 ``ups`` convs against their bound, in
percent: each launch of the s8 conv kernel does one stage of the canonical
upsampling for the batch (one phase, P = 1: stage 1 with an int8 output;
four phases, P = 4: stage 2 in bf16), whose operations over the int8 peak,
or bytes over HBM's, whichever is larger (``flops.
int8_ups_stage_least_seconds``), summed over the traced slice, over the
device time of those launches. None when nothing matches."""

import re

from benchmark import flops

S8 = re.compile(r"int8_conv_kernel<[^,>]+,\s*([^,>]+?),\s*(?:\(int\))?(\d+),")


def read(run):
    if run.trace is None:
        return None
    c = run.counters
    h, w = c["frame_hw"]
    least = busy = 0.0
    for name, seconds in run.trace["events"]:
        m = S8.search(name)
        if not m:
            continue
        stage = 0 if m.group(2) == "1" else 1
        out_itemsize = 1 if "char" in m.group(1) or "int8" in m.group(1) else 2
        least += flops.int8_ups_stage_least_seconds(stage, c["batch"], h, w,
                                                    run.cell.config["n_filters"], out_itemsize)
        busy += seconds
    return 100.0 * least / busy if busy > 0 else None
