"""Network interpolation / weight averaging over generator checkpoints.

The counterpart of ``scripts/interp_checkpoints.py``: the SRGAN family's
fidelity-vs-perception dial (ESRGAN section 3.4, "network interpolation"),
a linear blend of a PSNR-oriented generator (the pretrain phase's) and a
GAN-trained one of the same architecture,

    theta = (1 - alpha) * theta_psnr + alpha * theta_gan,

or, in general, N checkpoints with any weights (equal weights over the
last k checkpoints are plain checkpoint averaging). Inputs are native
``.npz`` or ``.pt`` generator state_dicts in any mix; the output is
``.npz`` (every CLI of the port reads it; ``convert_checkpoint`` makes a
``.pt`` of it).

    python -m fast_srgan_torch.scripts.interp_checkpoints --alpha 0.8 \\
        pretrain_gen.npz generator_epoch_N.pt -o blend08.npz
    python -m fast_srgan_torch.scripts.interp_checkpoints g1.npz g2.npz g3.npz -o avg.npz
    python -m fast_srgan_torch.scripts.interp_checkpoints --weights 1,2,1 \\
        a.npz b.npz c.npz -o w.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from fast_srgan_torch.checkpoints.npz_io import flatten_tree, save_npz_params, unflatten_tree


def blend_param_trees(trees, weights):
    """Weighted sum (weights normalized) of N param trees of one structure,
    in fp32. Raises ValueError when the key sets or a leaf's shapes differ
    (different architectures must not blend silently)."""
    if len(trees) != len(weights):
        raise ValueError(f"{len(trees)} trees but {len(weights)} weights")
    total = float(sum(weights))
    if total <= 0:
        raise ValueError(f"weights must sum to > 0, got {list(weights)}")
    norm = [float(w) / total for w in weights]
    flats = [flatten_tree(t) for t in trees]
    keys = set(flats[0])
    for i, f in enumerate(flats[1:], start=1):
        if set(f) != keys:
            missing = sorted(keys ^ set(f))[:6]
            raise ValueError(
                f"checkpoint {i} has a different param tree (first differing keys: {missing})"
            )
    out = {}
    for k in keys:
        shapes = {f[k].shape for f in flats}
        if len(shapes) > 1:
            raise ValueError(
                f"shape mismatch at {k!r}: {sorted(shapes)}: the checkpoints are different"
                " architectures"
            )
        acc = np.zeros(flats[0][k].shape, np.float32)
        for w, f in zip(norm, flats):
            acc += w * f[k].astype(np.float32)
        out[k] = acc
    return unflatten_tree(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoints", nargs="+", help=".npz or .pt generator files")
    ap.add_argument("-o", "--output", required=True, help="output .npz path")
    ap.add_argument("--alpha", type=float, default=None,
                    help="two checkpoints: the weight of the SECOND (ESRGAN's alpha);"
                    " exclusive with --weights")
    ap.add_argument("--weights", default=None,
                    help="comma-separated weights, one a checkpoint (normalized);"
                    " default equal (a plain average)")
    args = ap.parse_args(argv)

    if args.alpha is not None and args.weights is not None:
        raise SystemExit("--alpha and --weights are mutually exclusive")
    n = len(args.checkpoints)
    if args.alpha is not None:
        if n != 2:
            raise SystemExit("--alpha needs exactly 2 checkpoints")
        if not 0.0 <= args.alpha <= 1.0:
            raise SystemExit(f"--alpha must be in [0, 1], got {args.alpha}")
        weights = [1.0 - args.alpha, args.alpha]
    elif args.weights is not None:
        weights = [float(w) for w in args.weights.split(",")]
        if len(weights) != n:
            raise SystemExit(f"{len(weights)} weights for {n} checkpoints")
    else:
        weights = [1.0] * n

    from fast_srgan_torch.checkpoints.convert import load_generator_params
    from fast_srgan_torch.inference import arch_from_params

    trees, arch = [], None
    for path in args.checkpoints:
        try:
            params = load_generator_params(path)
        except FileNotFoundError as e:
            raise SystemExit(str(e)) from None
        a = arch_from_params(params)
        if arch is None:
            arch = a
        elif a != arch:
            raise SystemExit(
                f"architecture mismatch: {args.checkpoints[0]} is {arch}, {path} is {a}"
            )
        trees.append(params)
        print(f"  {path}: {a}")

    try:
        blended = blend_param_trees(trees, weights)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    save_npz_params(args.output, blended)
    total = sum(weights)
    print(f"wrote {args.output}: " + " + ".join(
        f"{w / total:.3f}*{os.path.basename(p)}" for w, p in zip(weights, args.checkpoints)
    ))


if __name__ == "__main__":
    main()
