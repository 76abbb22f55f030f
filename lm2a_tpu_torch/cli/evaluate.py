"""CLI: wav-domain evaluation over gt/gen pairs (port of
``lm2a_tpu/cli/evaluate.py``, the same flags).

The reference's ``evaluate_all.py:136-141`` contract (``--eval-dir
--output-dir``); ``--no-clap`` skips the optional LAION-CLAP semantic metric
instead of aborting when the package is missing. numpy and scipy work on
the host; no kernel runs here.
"""

import argparse


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--eval-dir", default="evaluation",
                   help="root containing sample_*/{gt.wav,gen.wav}")
    p.add_argument("--output-dir", default="results")
    p.add_argument("--no-clap", action="store_false", dest="use_clap", default=True)
    p.add_argument("--clap_ckpt", default=None,
                   help="local LAION-CLAP checkpoint file (skips the download)")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    from lm2a_tpu_torch.eval.evaluate_all import evaluate_all

    final = evaluate_all(args.eval_dir, args.output_dir, use_clap=args.use_clap,
                         clap_ckpt=args.clap_ckpt)
    md = final["metadata"]
    print("=" * 40)
    print(f"samples: {md['total_samples']}")
    for k in ("fad_overall", "ndb_overall", "beat_F1",
              "acoustic_similarity_mean", "clap_mean"):
        if md.get(k) is not None:
            print(f"{k}: {md[k]:.4f}" if isinstance(md[k], float) else f"{k}: {md[k]}")


if __name__ == "__main__":
    main()
