"""CLI: mel-domain model assessment over a test split (port of
``lm2a_tpu/cli/val.py``, the same flags and defaults, plus ``--device``).

The reference's ``val.py:322-347`` contract (``--ckpt --npz_dir --out_dir
--max_samples --no-random --seed``; 10 random clips, guidance 2.1, 1000
steps by default), with --steps/--guidance exposed. Guidance resolves
distilled-aware: a distilled student is assessed at its folded 1.0
single-forward, an undistilled checkpoint at the protocol's 2.1. Each clip
is generated on the card (``--device cuda``, the default) through the
cached sampler chain and the resblock (and attention) kernels.
"""

import argparse


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--npz_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_samples", type=int, default=10)
    p.add_argument("--no-random", action="store_false", dest="random_sample",
                   default=True)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--guidance", type=float, default=None,
                   help="CFG weight. Default: distilled-aware — 2.1 for an "
                        "undistilled checkpoint (the reference protocol), "
                        "the folded 1.0 for a distilled student (an "
                        "explicit 2.1 would double-guide it)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    from lm2a_tpu_torch.eval.assess import assess_batch

    assess_batch(
        args.npz_dir, args.ckpt, args.out_dir,
        max_samples=args.max_samples, random_sample=args.random_sample,
        random_seed=args.seed, steps=args.steps, guidance=args.guidance,
        device=args.device,
    )


if __name__ == "__main__":
    main()
