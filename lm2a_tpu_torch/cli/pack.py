"""CLI: pack an npz split into memory-mapped flat arrays for training.

The flags of ``python -m lm2a_tpu.cli pack``; the pack directory it writes
is the same, so either package trains from it.
"""

import argparse


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--npz_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--align_mode", default="interp", choices=["interp", "repeat"])
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    from lm2a_tpu_torch.data.dataset import pack_dataset

    out = pack_dataset(args.npz_dir, args.out_dir, align_mode=args.align_mode)
    print("packed to", out)


if __name__ == "__main__":
    main()
