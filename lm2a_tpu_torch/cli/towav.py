"""CLI: vocode mel npz files to wav.

The flags of ``python -m lm2a_tpu.cli towav`` plus ``--device`` and
``--seed``. ``--weights`` is an NVIDIA BigVGAN generator checkpoint of the
``--preset`` geometry; without it the generator is a seeded random init
(smoke mode: shapes and the pipeline only).
"""

import argparse
import os


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--npz", default=None, help="single mel npz")
    p.add_argument("--npz_dir", default=None, help="batch: vocode every npz here")
    p.add_argument("--out", default=None, help="output wav (single mode)")
    p.add_argument("--weights", default=None,
                   help="NVIDIA BigVGAN torch checkpoint (.pt)")
    p.add_argument("--preset", default="bigvgan_22khz_80band",
                   choices=["bigvgan_22khz_80band", "bigvgan_base_22khz_80band",
                            "bigvgan_v2_24khz_100band", "bigvgan_v2_44khz_128band",
                            "smoke_tiny"],
                   help="generator geometry; smoke_tiny is a CI-scale config "
                        "(32-channel, hop 256) for pipeline smoke tests only")
    p.add_argument("--seed", type=int, default=0, help="random-init seed")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    from lm2a_tpu_torch.vocoder.bigvgan import (
        BIGVGAN_22KHZ_80BAND,
        BIGVGAN_BASE_22KHZ_80BAND,
        BIGVGAN_V2_24KHZ_100BAND,
        BIGVGAN_V2_44KHZ_128BAND,
        VocoderConfig,
    )
    from lm2a_tpu_torch.vocoder.vocode import Vocoder, batch_npz_to_wav, npz_to_wav

    cfg = {
        "bigvgan_22khz_80band": BIGVGAN_22KHZ_80BAND,
        "bigvgan_base_22khz_80band": BIGVGAN_BASE_22KHZ_80BAND,
        "bigvgan_v2_24khz_100band": BIGVGAN_V2_24KHZ_100BAND,
        "bigvgan_v2_44khz_128band": BIGVGAN_V2_44KHZ_128BAND,
        # hop 4*4*4*4 = 256 like the real 22 kHz geometry, 48x narrower
        "smoke_tiny": VocoderConfig(
            upsample_rates=(4, 4, 4, 4), upsample_kernel_sizes=(8, 8, 8, 8),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),),
        ),
    }[args.preset]
    voc = Vocoder(weights_path=args.weights, cfg=cfg, device=args.device, seed=args.seed)

    if args.npz:
        out = args.out or os.path.splitext(args.npz)[0] + ".wav"
        path, sr = npz_to_wav(args.npz, out, voc)
        print(f"wrote {path} ({sr} Hz)")
    elif args.npz_dir:
        ok, failed = batch_npz_to_wav(args.npz_dir, voc)
        if failed:
            raise SystemExit(f"{failed} of {ok + failed} files failed to vocode")
    else:
        raise SystemExit("need --npz or --npz_dir")


if __name__ == "__main__":
    main()
