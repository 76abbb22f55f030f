"""CLI: build npz shards from the raw dataset tree.

The flags of ``python -m lm2a_tpu.cli preprocess`` (contract parity with
``reference/preprocess.py:389-415``: ``--root --out --sequence_seconds
--fps --sr``; ``--lyrics_backend`` picks the lyric embedder) plus
``--device``: the mels (and a RoBERTa embedder) run there, the card by
default.
"""

import argparse


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True, help="raw dataset root (year/song tree)")
    p.add_argument("--out", required=True, help="output npz directory")
    p.add_argument("--sequence_seconds", type=float, default=6)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--lyrics_backend", default="auto",
                   choices=["auto", "roberta", "hashed"])
    p.add_argument("--roberta_path", default=None,
                   help="local HF model dir for the roberta lyric embedder "
                        "(default: the 'roberta-base' hub name)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    from lm2a_tpu_torch.core.config import MelConfig
    from lm2a_tpu_torch.core.device import resolve_device
    from lm2a_tpu_torch.data.preprocess import make_dataset

    print(f"preprocess: {args.root} -> {args.out}")
    n = make_dataset(
        args.root, args.out,
        sequence_seconds=args.sequence_seconds, fps=args.fps, sr=args.sr,
        mel_cfg=MelConfig(sample_rate=args.sr),
        lyrics_backend=args.lyrics_backend,
        lyrics_model_path=args.roberta_path,
        device=resolve_device(args.device),
    )
    print("wrote samples:", n)


if __name__ == "__main__":
    main()
