"""CLI: train the diffusion model.

The flags and defaults of ``python -m lm2a_tpu.cli train`` (bs 16, lr 2e-4,
wd 1e-4, 500 epochs, T 1000, base 256, mults 1,2,4, EMA 0.999, grad clip
1.0, CFG drop 0.2, bf16 compute on fp32 weights) plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain PyTorch versions). Checkpoints
are the JAX package's full-state layout, so either package resumes the
other's. ``--fused_resblock_grad`` routes the blocks that pass the JAX
kernel's gate through the fused chain and its CUDA backward (no effect on
``--arch v1``, whose convolutions the JAX package leaves to XLA);
``--fused_attention`` (the port's own flag: the JAX CLI leaves the switch to
the config) puts every attention core on the attention kernel, in the
steps and in the checkpoints' config, so their serving takes it too;
``--opt_backend pallas`` runs the CUDA Adan+EMA kernel (the value keeps the
JAX name so the config round-trips). On the card every step is a replay of
one captured CUDA graph of the step. ``--steps_per_call K`` runs K steps a
call over groups of K batches; with ``--device_data`` (and a packed split)
the pack is uploaded to the device once and each call stages only (K, B)
row indices, as the JAX package does.

``--quality_every_epochs N`` runs the sample-quality monitor of the EMA
model every N epochs over the validation split (``training/quality.py``;
``quality_log.csv``). ``--fused_opt 0`` is the chained clip-then-Adan form
(the JAX package's state layout for it), which ``--opt_backend pallas``
refuses, as the JAX package does.

``--coordinator host:port --num_processes N --process_id i`` (or the
``LM2A_COORDINATOR`` / ``LM2A_NUM_PROCESSES`` / ``LM2A_PROCESS_ID``
variables) run process i of N data-parallel ranks over ``torch.distributed``
(``core/distributed.py``): NCCL where each rank of a host has its own card,
gloo on the CPU and where ranks share one card. ``--model_parallel M``
makes a ``(data, model)`` mesh whose model ranks take the same rows, the
state replicated, as the JAX CLI's mesh does. ``--batch_size`` is the
global batch.

Refused, not ported: ``--rng rbg`` (a TPU generator).
"""

import argparse


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--npz_dir", required=True, help="train split npz dir (or pack dir)")
    p.add_argument("--val_npz_dir", default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--save_dir", default="checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in save_dir")
    p.add_argument("--save_interval", type=int, default=1000)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--cond_dim", type=int, default=128)
    p.add_argument("--base_dim", type=int, default=256)
    p.add_argument("--dim_mults", default="1,2,4")
    p.add_argument("--time_emb_dim", type=int, default=256)
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--mid_blocks", type=int, default=3)
    p.add_argument("--attn_heads", type=int, default=8)
    p.add_argument("--arch", default="ultimate", choices=["ultimate", "v1"])
    p.add_argument("--dataset_mean", type=float, default=None)
    p.add_argument("--dataset_std", type=float, default=None)
    p.add_argument("--val_cap_batches", type=int, default=20)
    p.add_argument("--validate_every_epochs", type=float, default=0.5,
                   help="validate when (epoch+1) %% N == 0; the reference "
                        "default 0.5 means every epoch")
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--cond_drop_prob", type=float, default=0.2)
    p.add_argument("--lr_decay_steps", type=str, default="")
    p.add_argument("--lr_decay_factors", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--opt_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="storage dtype of the Adan moments (math stays fp32)")
    p.add_argument("--rng", dest="rng_impl", default="threefry", choices=["threefry", "rbg"],
                   help="threefry only: rbg is the TPU's hardware generator")
    p.add_argument("--fused_opt", type=int, default=1, choices=[0, 1],
                   help="clip folded into Adan (1) or chained before it (0, the plain "
                        "update only)")
    p.add_argument("--opt_backend", default="xla", choices=["xla", "pallas"],
                   help="xla: the plain per-leaf update; pallas: the CUDA Adan+EMA "
                        "kernel, one launch per step")
    p.add_argument("--opt_big_backend", default="pallas", choices=["pallas", "xla"],
                   help="kept for the config round trip; the port ignores it (one "
                        "kernel launch updates every leaf)")
    p.add_argument("--amp", action="store_true",
                   help="accepted for reference-script compatibility (bf16 is the default)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="K optimizer steps per call over groups of K batches (1 = "
                        "one step a call); tail batches run single steps")
    p.add_argument("--keep_checkpoints", type=int, default=0,
                   help="prune to newest N checkpoints (0 = keep all)")
    p.add_argument("--ckpt_fetch_workers", type=int, default=0,
                   help="kept for the config round trip; the port fetches in one pass")
    p.add_argument("--device_data", action="store_true",
                   help="with --steps_per_call > 1 and a packed split: keep the dataset "
                        "on the device, stage only row indices per call")
    p.add_argument("--fused_attention", action="store_true",
                   help="the port's own: every attention core on the attention kernel "
                        "(ModelConfig.fused_attention), in training and in the checkpoints' "
                        "serving form")
    p.add_argument("--fused_resblock_grad", action="store_true",
                   help="route fitting residual blocks through the fused chain and "
                        "its CUDA backward kernels")
    p.add_argument("--max_steps", type=int, default=None, help="debug cap")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--quality_every_epochs", type=int, default=0,
                   help="every N epochs, log EMA sample-quality metrics on fixed val "
                        "clips (0 = off)")
    p.add_argument("--quality_clips", type=int, default=4)
    p.add_argument("--quality_steps", type=int, default=50)
    p.add_argument("--quality_guidance", type=float, default=2.1)
    p.add_argument("--coordinator", default=None,
                   help="multi-process: coordinator address host:port (or "
                        "LM2A_COORDINATOR env); joins a torch.distributed group")
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-process: total process count")
    p.add_argument("--process_id", type=int, default=None,
                   help="multi-process: this process's id")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model-axis size of the mesh; must divide the ranks of a host "
                        "on multi-process runs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def config_from_args(args):
    from lm2a_tpu_torch.core.config import (
        DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig,
    )

    decay_steps = (tuple(map(int, args.lr_decay_steps.split(",")))
                   if args.lr_decay_steps.strip() else ())
    decay_factors = (tuple(map(float, args.lr_decay_factors.split(",")))
                     if args.lr_decay_factors.strip() else ())
    return LM2AConfig(
        model=ModelConfig(
            arch=args.arch, base_dim=args.base_dim,
            dim_mults=tuple(map(int, args.dim_mults.split(","))),
            cond_dim=args.cond_dim, time_emb_dim=args.time_emb_dim,
            num_res_blocks=args.num_res_blocks, mid_blocks=args.mid_blocks,
            attn_heads=args.attn_heads, fused_resblock_grad=args.fused_resblock_grad,
            fused_attention=args.fused_attention,
        ),
        diffusion=DiffusionConfig(timesteps=args.timesteps),
        train=TrainConfig(
            batch_size=args.batch_size, lr=args.lr, weight_decay=args.weight_decay,
            epochs=args.epochs, ema_decay=args.ema_decay, grad_clip=args.grad_clip,
            cond_drop_prob=args.cond_drop_prob, save_interval=args.save_interval,
            log_interval=args.log_interval, val_cap_batches=args.val_cap_batches,
            validate_every_epochs=args.validate_every_epochs, seed=args.seed,
            lr_decay_steps=decay_steps, lr_decay_factors=decay_factors,
            compute_dtype=args.compute_dtype, opt_dtype=args.opt_dtype,
            rng_impl=args.rng_impl, fused_opt=bool(args.fused_opt),
            opt_backend=args.opt_backend, opt_big_backend=args.opt_big_backend,
            steps_per_call=args.steps_per_call, keep_checkpoints=args.keep_checkpoints,
            ckpt_fetch_workers=args.ckpt_fetch_workers, device_data=args.device_data,
            quality_every_epochs=args.quality_every_epochs,
            quality_clips=args.quality_clips, quality_steps=args.quality_steps,
            quality_guidance=args.quality_guidance,
        ),
    )


def main(args=None):
    args = build_parser().parse_args(args)
    cfg = config_from_args(args)
    from lm2a_tpu_torch.core import distributed
    from lm2a_tpu_torch.training.loop import check_supported, train

    try:
        check_supported(cfg)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from e
    # join the process group before any device use
    try:
        multi = distributed.init_distributed(args.coordinator, args.num_processes,
                                             args.process_id, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    if multi:
        print(distributed.describe())
    try:
        try:
            mesh = (distributed.make_hybrid_mesh(model=args.model_parallel)
                    if multi or args.model_parallel > 1 else None)
        except ValueError as e:
            raise SystemExit(str(e)) from e
        print("train config:", cfg)
        res = train(cfg, args.npz_dir, args.save_dir, val_npz_dir=args.val_npz_dir,
                    dataset_mean=args.dataset_mean, dataset_std=args.dataset_std,
                    resume=args.resume, mesh=mesh, max_steps=args.max_steps,
                    use_tensorboard=not args.no_tensorboard, device=args.device)
    finally:
        if multi:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"training done: step={res.final_step} loss={res.final_loss:.6f} "
          f"checkpoints in {res.ckpt_dir}")


if __name__ == "__main__":
    main()
