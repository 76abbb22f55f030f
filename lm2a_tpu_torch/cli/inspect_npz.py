"""CLI: inspect an npz shard (keys, shapes, stats, optional mel plot).

The flags and lines of ``python -m lm2a_tpu.cli inspect_npz``; ``--plot``
needs matplotlib and writes nothing without it. The reference's
``sometest/testnpz.py`` shape oracle as a proper tool: canonical geometry
is mel (80, 516), motion (180, 234), lyrics (180, 768), sr 22050, hop 256
(~86.13 mel fps).
"""

import argparse

import numpy as np


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("npz", help="npz shard path")
    p.add_argument("--plot", default=None, help="write a mel PNG here")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    d = np.load(args.npz, allow_pickle=True)
    print(f"file: {args.npz}")
    for k in d.files:
        v = d[k]
        if getattr(v, "ndim", 0) >= 1 and v.size > 1:
            print(f"  {k}: shape={v.shape} dtype={v.dtype} "
                  f"min={v.min():.4f} max={v.max():.4f} "
                  f"mean={v.mean():.4f} std={v.std():.4f}")
        else:
            print(f"  {k}: {v}")
    if "mel" in d.files and "hop_length" in d.files and "sr" in d.files:
        fps = float(d["sr"]) / float(d["hop_length"])
        print(f"  mel fps: {fps:.2f}")
    if args.plot and "mel" in d.files:
        from lm2a_tpu_torch.data.schema import normalize_mel_layout
        from lm2a_tpu_torch.inference.sample import _save_mel_png

        _save_mel_png(normalize_mel_layout(d["mel"]), args.plot, "mel")
        print("wrote", args.plot)


if __name__ == "__main__":
    main()
