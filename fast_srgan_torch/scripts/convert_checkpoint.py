"""Convert generator checkpoints between ``.pt`` and the native ``.npz``.

The counterpart of ``scripts/convert_checkpoint.py``:

    python -m fast_srgan_torch.scripts.convert_checkpoint IN.pt OUT.npz   # -> native
    python -m fast_srgan_torch.scripts.convert_checkpoint IN.npz OUT.pt   # -> state_dict

A ``.pt`` input is the reference's generator state_dict (``_orig_mod.``
prefixes stripped) or the port trainer's ``generator_epoch_N.pt``. The
``.pt`` written is a state_dict in the reference's key schema (OIHW fp32),
which the port's ``Generator.load_state_dict`` and the reference's loader
take as it is. Both directions only transpose, so npz -> pt -> npz is
bitwise.
"""

from __future__ import annotations

import argparse

import torch

from fast_srgan_torch.checkpoints.convert import (
    load_generator_params,
    state_dict_from_jax_params,
)
from fast_srgan_torch.checkpoints.npz_io import load_npz_params, save_npz_params


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("src")
    parser.add_argument("dst")
    args = parser.parse_args(argv)
    try:
        if args.src.endswith(".pt") and args.dst.endswith(".npz"):
            save_npz_params(args.dst, load_generator_params(args.src))
            print(f"Wrote native checkpoint: {args.dst}")
        elif args.src.endswith(".npz") and args.dst.endswith(".pt"):
            torch.save(state_dict_from_jax_params(load_npz_params(args.src)), args.dst)
            print(f"Wrote reference-format checkpoint: {args.dst}")
        else:
            raise SystemExit("expected IN.pt OUT.npz or IN.npz OUT.pt")
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None


if __name__ == "__main__":
    main()
