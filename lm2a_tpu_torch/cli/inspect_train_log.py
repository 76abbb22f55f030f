"""CLI: summarize and plot train_log.csv (port of
``lm2a_tpu/cli/inspect_train_log.py``, the same flags).

The reference's ``sometest/inspect_train_log.py`` (head/tail/stats + loss
curves PNG) over the same CSV schema
(``epoch, step, train_loss, val_loss, time_seconds``). The plot needs
matplotlib; the summary needs numpy alone.
"""

import argparse
import csv

import numpy as np


def read_log(path):
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append(row)
    return rows


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("csv", help="train_log.csv path")
    p.add_argument("--plot", default=None, help="write a loss-curve PNG here")
    p.add_argument("--head", type=int, default=5)
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    rows = read_log(args.csv)
    print(f"{len(rows)} rows")
    for r in rows[: args.head]:
        print(" ", r)
    if len(rows) > 2 * args.head:
        print("  ...")
        for r in rows[-args.head:]:
            print(" ", r)

    train = [(int(r["step"]), float(r["train_loss"]))
             for r in rows if r.get("train_loss") not in (None, "", "None")]
    val = [(int(r["step"]), float(r["val_loss"]))
           for r in rows if r.get("val_loss") not in (None, "", "None")]
    if train:
        losses = np.array([x[1] for x in train])
        print(f"train loss: first={losses[0]:.6f} last={losses[-1]:.6f} "
              f"min={losses.min():.6f} mean={losses.mean():.6f}")
    if val:
        vlosses = np.array([x[1] for x in val])
        print(f"val loss: last={vlosses[-1]:.6f} min={vlosses.min():.6f}")

    if args.plot and train:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 5))
        plt.plot(*zip(*train), label="train")
        if val:
            plt.plot(*zip(*val), label="val", marker="o")
        plt.xlabel("step")
        plt.ylabel("loss")
        plt.legend()
        plt.grid(alpha=0.3)
        plt.savefig(args.plot, bbox_inches="tight")
        print("wrote", args.plot)


if __name__ == "__main__":
    main()
