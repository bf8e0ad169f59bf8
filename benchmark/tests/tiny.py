"""Each cell at a size a CPU test run holds: the same drivers, references
and checks, on small frames."""

TINY = {
    "x4-video-bf16": {"traffic": {"frame_h": 36, "frame_w": 40, "distinct_frames": 4, "batch": 2},
                      "workload": {"warm_batches": 1}},
    "x4-video-int8ups": {"traffic": {"frame_h": 36, "frame_w": 40, "distinct_frames": 4, "batch": 2},
                         "workload": {"warm_batches": 1}},
}
SECONDS = 0.5
