"""CLI: generate mel spectrograms from motion+lyrics conditions.

The flags of ``python -m lm2a_tpu.cli sample`` plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain PyTorch versions).
"""

import argparse
import os


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--npz", default=None, help="single input npz (overrides --index)")
    p.add_argument("--index", type=int, default=0, help="index into --npz_dir")
    p.add_argument("--npz_dir", default=None)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir OR reference torch .pt file")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--guidance", type=float, default=None,
                   help="CFG weight; 1.0 disables guidance "
                        "(default: checkpoint's guidance_weight, else 1.0)")
    p.add_argument("--steps", type=int, default=None,
                   help="diffusion schedule length "
                        "(default: the checkpoint's timesteps)")
    p.add_argument("--method", default=None, choices=["ddpm", "ddim"],
                   help="default: ddpm, or the checkpoint's own DDIM grid "
                        "when sampling a distilled student")
    p.add_argument("--ddim_steps", type=int, default=None,
                   help="DDIM sampler steps over the schedule (default 50)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_png", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="print per-decile coefficient and x/eps statistics")
    p.add_argument("--all", action="store_true",
                   help="batched generation over every npz in --npz_dir")
    p.add_argument("--batch_size", type=int, default=8,
                   help="clips per sampler chain in --all mode")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    from lm2a_tpu_torch.inference.sample import sample_batch_from_npz, sample_from_npz

    if args.all:
        if not args.npz_dir:
            raise SystemExit("--all needs --npz_dir")
        files = sorted(
            os.path.join(args.npz_dir, f)
            for f in os.listdir(args.npz_dir)
            if f.endswith(".npz") and f != "motion_stats.npz"
        )
        print(f"batched sampling of {len(files)} clips -> {args.out_dir}")
        written = sample_batch_from_npz(
            files, args.ckpt, args.out_dir,
            steps=args.steps, guidance_weight=args.guidance,
            method=args.method, seed=args.seed, batch_size=args.batch_size,
            ddim_steps=args.ddim_steps, device=args.device,
        )
        print(f"wrote {len(written)} files")
        return

    if args.npz:
        npz_path = args.npz
    else:
        if not args.npz_dir:
            raise SystemExit("need --npz or --npz_dir")
        files = sorted(f for f in os.listdir(args.npz_dir) if f.endswith(".npz")
                       and f != "motion_stats.npz")
        if not files:
            raise SystemExit(f"no npz in {args.npz_dir}")
        npz_path = os.path.join(args.npz_dir, files[args.index % len(files)])

    print(f"sampling {npz_path} -> {args.out_dir}")
    out = sample_from_npz(
        npz_path, args.ckpt, args.out_dir,
        steps=args.steps, guidance_weight=args.guidance,
        method=args.method, seed=args.seed, save_png=not args.no_png,
        debug=args.debug, ddim_steps=args.ddim_steps, device=args.device,
    )
    print("wrote", out)


if __name__ == "__main__":
    main()
