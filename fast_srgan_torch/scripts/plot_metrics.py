"""Render a run's metrics.jsonl to a PNG of training curves.

The counterpart of ``scripts/plot_metrics.py``, for the same schema (one
``{"step", "tag", "value", "time"}`` object a line, as the port's
``utils/logging.py`` writes it): loss curves per tag on a log axis, PSNR
and SSIM on a linear one, no TensorBoard server needed. Host only;
matplotlib is imported when the figure is drawn.

    python -m fast_srgan_torch.scripts.plot_metrics runs/SRGAN [--out curves.png]

Dashed vertical lines mark resume boundaries: wall-clock gaps of more than
60 s between consecutive rows, drawn at the first step logged after each.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

#: a wall-clock gap between two rows longer than this marks a resume
RESUME_GAP_S = 60.0


def read_metrics(path: str) -> Tuple[Dict[str, List[tuple]], List[int]]:
    """({tag: [(step, value)]}, the steps that start a resumed run)."""
    by_tag: Dict[str, List[tuple]] = {}
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    for m in rows:
        by_tag.setdefault(m["tag"], []).append((m["step"], m["value"]))
    times = [m.get("time", 0.0) for m in rows]
    boundaries = [rows[i + 1]["step"] for i, (a, b) in enumerate(zip(times, times[1:]))
                  if b - a > RESUME_GAP_S]
    return by_tag, sorted(set(boundaries))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    path = os.path.join(args.run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        raise SystemExit(f"no metrics.jsonl under {args.run_dir}")
    by_tag, boundary_steps = read_metrics(path)
    if not by_tag:
        raise SystemExit(f"{path} is empty")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    loss_tags = sorted(t for t in by_tag if "Loss" in t)
    metric_tags = sorted(t for t in by_tag if "Loss" not in t)
    n_rows = (1 if loss_tags else 0) + (1 if metric_tags else 0)
    fig, axes = plt.subplots(n_rows, 1, figsize=(10, 4 * n_rows), squeeze=False)
    row = 0
    if loss_tags:
        ax = axes[row][0]
        for tag in loss_tags:
            pts = sorted(by_tag[tag])
            ax.plot([s for s, _ in pts], [v for _, v in pts], label=tag, linewidth=1)
        ax.set_yscale("log")
        ax.set_ylabel("loss")
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
        row += 1
    if metric_tags:
        ax = axes[row][0]
        for tag in metric_tags:
            pts = sorted(by_tag[tag])
            ax.plot([s for s, _ in pts], [v for _, v in pts], label=tag, linewidth=1,
                    marker="o", markersize=2)
        ax.set_ylabel("PSNR (dB) / SSIM")
        ax.set_xlabel("step")
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
    for axrow in axes:
        for s in boundary_steps:
            axrow[0].axvline(s, linestyle="--", color="gray", alpha=0.6)

    out = args.out or os.path.join(args.run_dir, "curves.png")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"wrote {out} ({len(by_tag)} tags, {sum(len(v) for v in by_tag.values())} points,"
          f" {len(boundary_steps)} resume boundaries)")
    return out


if __name__ == "__main__":
    main()
