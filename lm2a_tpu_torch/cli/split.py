"""CLI: split npz shards into train/val/test.

The flags of ``python -m lm2a_tpu.cli split`` (contract parity with
``reference/datasetcode/newsplit_npz.py:25-40``: ratios 0.7/0.2/0.1 or
exact counts, seed 42, copy-or-move, manifests); the same three lists.
"""

import argparse


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--npz_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--train_ratio", type=float, default=0.7)
    p.add_argument("--val_ratio", type=float, default=0.2)
    p.add_argument("--test_ratio", type=float, default=0.1)
    p.add_argument("--train_count", type=int, default=None)
    p.add_argument("--val_count", type=int, default=None)
    p.add_argument("--test_count", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--move", action="store_true")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    from lm2a_tpu_torch.data.split import split_dataset

    counts = None
    if all(c is not None for c in (args.train_count, args.val_count, args.test_count)):
        counts = (args.train_count, args.val_count, args.test_count)
    res = split_dataset(
        args.npz_dir, args.out_dir,
        args.train_ratio, args.val_ratio, args.test_ratio,
        counts=counts, seed=args.seed, move=args.move,
    )
    total = len(res.train) + len(res.val) + len(res.test)
    print("=" * 50)
    print(f"Total files: {total}")
    for name, part in (("Train", res.train), ("Val", res.val), ("Test", res.test)):
        print(f"{name} set: {len(part)} ({len(part) / total:.1%})")
    print(f"All files saved to: {args.out_dir}")


if __name__ == "__main__":
    main()
