"""CLI: distill a trained teacher into a few-step DDIM student.

The flags and defaults of ``python -m lm2a_tpu.cli distill`` plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain PyTorch
versions). The default is one direct stage at the final grid
(``start_steps == student_steps``) with eps loss; ``--start_steps 2*N`` or
more gives the halving ladder, each later stage's teacher the previous
stage's student at guidance 1.0.

Routes (``training/distill.py``): the teacher, built from copies of the EMA
weights, runs the serving forward (on the card ``gn_stats`` and
``conv3_fused`` in every block); the student the training form (the gated
blocks through the fused chain and the backward kernels); the update the
``adan_ema`` kernel, one launch a step (its plain version on the CPU). The
optimizer is the JAX CLI's: weight decay 0, clip 1.0, the EMA decay of
``--ema_decay`` or the teacher's config, a constant or cosine rate.

Checkpoints are the JAX package's full-state layout with the same config
(the teacher's model and diffusion, a ``TrainConfig`` rebuilt from defaults
and the distill flags, with ``opt_backend="pallas"`` naming the update's
route) and metadata (``distilled_steps``,
``folded_guidance``, ``teacher``, ``distill_progress``), so either package
resumes the other's run and serves its student::

    python -m lm2a_tpu_torch.cli sample --ckpt <out>/ckpt_step_N ...

``--steps_per_call > 1`` on a packed dataset uploads it to the device once
and runs K steps a call over batches gathered there, their rows drawn from
the JAX CLI's own index stream; otherwise each pass restarts a shuffled
``BatchIterator``. Each step draws from a generator seeded with the run
seed and its global step, so ``--resume`` continues a run exactly.
"""

import argparse


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--teacher", required=True, help="teacher checkpoint dir")
    p.add_argument("--npz_dir", required=True, help="train split (npz or pack dir)")
    p.add_argument("--save_dir", default="distilled")
    p.add_argument("--student_steps", type=int, default=50,
                   help="final student DDIM step count")
    p.add_argument("--start_steps", type=int, default=None,
                   help="first stage's step count. Default: student_steps (one "
                        "direct stage at the final grid); 2*student_steps gives "
                        "the halving ladder")
    p.add_argument("--steps_per_stage", type=int, default=600,
                   help="optimizer steps per stage")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--steps_per_call", type=int, default=25,
                   help="steps per call (packed datasets go device-resident and "
                        "ship only row indices)")
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--guidance", type=float, default=2.1,
                   help="teacher CFG weight folded into the student")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="EMA decay for the student (default: the teacher config's)")
    p.add_argument("--loss_schedule", default="eps",
                   help="per-stage distillation loss, comma list or one value for "
                        "every stage: eps (eps-MSE) | x0_snr (truncated-SNR x0 "
                        "regression) | x0_snr_mm (x0_snr + a per-sample "
                        "mean-matching term)")
    p.add_argument("--lr_decay", default="none", choices=["none", "cosine"],
                   help="cosine: decay lr over the whole run (all stages) to lr/100")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_interval", type=int, default=0,
                   help="also checkpoint every N optimizer steps within a stage "
                        "(0 = stage-end only)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in --save_dir; all other "
                        "flags must match the original run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def stage_ladder(start_steps: int, student_steps: int):
    """Student step counts of the stages, halving from ``start_steps`` down
    to ``student_steps``."""
    stages, n = [], start_steps
    while n >= student_steps:
        stages.append(n)
        if n == student_steps:
            break
        n = max(n // 2, student_steps)
    return stages


def _find_stage_end(save_dir: str, stage_idx: int, steps_per_stage: int):
    """Newest checkpoint that completed ``stage_idx`` (its student is the
    next stage's teacher)."""
    from lm2a_tpu_torch.training.checkpoint import (
        checkpoint_path, list_checkpoints, load_metadata,
    )

    best = None
    for s in list_checkpoints(save_dir):
        p = checkpoint_path(save_dir, s)
        prog = load_metadata(p).get("distill_progress") or {}
        if (prog.get("stage_idx") == stage_idx
                and prog.get("done_in_stage", 0) >= steps_per_stage):
            best = p
    return best


def main(args=None):
    args = build_parser().parse_args(args)
    if args.start_steps is not None and args.start_steps < args.student_steps:
        raise SystemExit(
            f"--start_steps {args.start_steps} must be >= --student_steps "
            f"{args.student_steps} (stages halve from start_steps down to "
            "student_steps)")

    import numpy as np
    import torch

    from lm2a_tpu_torch.core.config import LM2AConfig, TrainConfig, config_from_dict
    from lm2a_tpu_torch.core.device import resolve_device
    from lm2a_tpu_torch.data.dataset import (
        BatchIterator, device_prefetch, open_dataset, upload_dataset,
    )
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training import distill
    from lm2a_tpu_torch.training.adan import cosine_decay_schedule
    from lm2a_tpu_torch.training.checkpoint import (
        latest_checkpoint, load_ema, load_metadata, restore_checkpoint, save_checkpoint,
    )
    from lm2a_tpu_torch.training.train_step import (
        init_train_state, make_optimizer, step_generator,
    )

    dev = resolve_device(args.device)
    meta = load_metadata(args.teacher)
    tcfg = config_from_dict(meta["config"])
    cfg = LM2AConfig(model=tcfg.model, diffusion=tcfg.diffusion,
                     train=TrainConfig(
                         batch_size=args.batch_size, lr=args.lr, weight_decay=0.0,
                         seed=args.seed,
                         ema_decay=(args.ema_decay if args.ema_decay is not None
                                    else tcfg.train.ema_decay),
                         compute_dtype=tcfg.train.compute_dtype, opt_backend="pallas"),
                     data=tcfg.data)
    mean = float(meta.get("dataset_mean", 0.0))
    std = float(meta.get("dataset_std", 1.0))
    schedule = make_schedule(cfg.diffusion, device=dev)
    stages = stage_ladder(args.start_steps or args.student_steps, args.student_steps)

    tc = cfg.train
    optimizer = make_optimizer(
        cfg, cosine_decay_schedule(args.lr, args.steps_per_stage * len(stages), alpha=0.01)
        if args.lr_decay == "cosine" else None)
    state = init_train_state(cfg, args.seed, dev, optimizer)
    # teacher = the EMA weights (what serving uses); the student starts as a copy
    ema = load_ema(args.teacher, state)
    distill.start_student(state, ema)
    teacher = distill.build_teacher(cfg, ema)
    del ema

    ds = open_dataset(args.npz_dir, cfg.data.align_mode)
    if len(ds) < tc.batch_size:
        raise SystemExit(f"{args.npz_dir}: {len(ds)} clips, fewer than --batch_size "
                         f"{tc.batch_size}")

    gstep = 0
    resume_stage, resume_done = 0, 0
    if args.resume:
        latest = latest_checkpoint(args.save_dir)
        if latest is None:
            print(f"--resume: no checkpoint under {args.save_dir}; starting fresh", flush=True)
        else:
            prog = load_metadata(latest).get("distill_progress")
            if not prog:
                raise SystemExit(
                    f"--resume: {latest} carries no distill_progress metadata "
                    "(pre-resume checkpoint); start a fresh --save_dir instead")
            if prog.get("stages") != stages:
                raise SystemExit(
                    f"--resume: checkpoint stages {prog.get('stages')} != "
                    f"requested {stages}; flags must match the original run")
            restore_checkpoint(latest, state)
            resume_stage = int(prog["stage_idx"])
            resume_done = int(prog["done_in_stage"])
            gstep = int(prog["gstep"])
            if resume_done >= args.steps_per_stage:  # stage finished: next
                resume_stage += 1
                resume_done = 0
                # the restored student IS the completed stage: the next teacher
                teacher = distill.build_teacher(cfg, state.ema)
            elif resume_stage > 0:
                prev = _find_stage_end(args.save_dir, resume_stage - 1, args.steps_per_stage)
                if prev is None:
                    raise SystemExit(
                        f"--resume: stage {resume_stage - 1} end checkpoint not found "
                        f"under {args.save_dir} (needed as the resumed stage's teacher)")
                teacher = distill.build_teacher(cfg, load_ema(prev, state))
            print(f"resumed {latest}: stage {resume_stage} "
                  f"step {resume_done}/{args.steps_per_stage} (gstep {gstep})", flush=True)
            if resume_stage >= len(stages):
                print("distillation already complete:", latest)
                return

    k_fuse = max(1, args.steps_per_call)
    data = None
    if k_fuse > 1 and hasattr(ds, "mel"):
        nbytes = sum(np.asarray(getattr(ds, k)).nbytes for k in ("mel", "motion", "lyrics"))
        print(f"uploading dataset to device ({nbytes / 1e9:.2f} GB) ...", flush=True)
        data = upload_dataset(ds, dev)

    # a distilled teacher's eps is already CFG-folded: every stage runs at
    # w = 1.0 and the metadata keeps the original fold
    teacher_folded = float(meta.get("folded_guidance", 0.0) or 0.0)
    if teacher_folded > 0.0:
        if args.guidance != 1.0:
            print(f"teacher already carries folded guidance {teacher_folded}; "
                  f"ignoring --guidance {args.guidance}", flush=True)
        effective_fold = teacher_folded
        stage_gw = [1.0] * len(stages)
    else:
        effective_fold = args.guidance
        stage_gw = distill.stage_guidance_schedule(len(stages), args.guidance)
    losses_by_stage = [s.strip() for s in args.loss_schedule.split(",")]
    for s in losses_by_stage:
        if s not in distill.LOSS_SPACES:
            raise SystemExit(f"unknown --loss_schedule entry {s!r}")
    if len(losses_by_stage) == 1:
        losses_by_stage = losses_by_stage * len(stages)
    if len(losses_by_stage) != len(stages):
        raise SystemExit(f"--loss_schedule has {len(losses_by_stage)} entries for "
                         f"{len(stages)} stages {stages}")

    path = None
    for stage_idx, (stage_n, stage_guidance, stage_loss) in enumerate(
            zip(stages, stage_gw, losses_by_stage)):
        if stage_idx < resume_stage:
            continue
        done = resume_done if stage_idx == resume_stage else 0
        resume_done = 0

        def _save(progress_done, stage_n=stage_n, stage_idx=stage_idx):
            return save_checkpoint(
                args.save_dir, state, cfg, epoch=0, dataset_mean=mean, dataset_std=std,
                extra={"distilled_steps": stage_n,
                       "folded_guidance": effective_fold,
                       "teacher": args.teacher,
                       "distill_progress": {
                           "stage_idx": stage_idx,
                           "done_in_stage": int(progress_done),
                           "gstep": int(gstep),
                           "stages": stages,
                       }})

        print(f"stage: student_steps={stage_n}, {args.steps_per_stage} steps,"
              f" teacher guidance {stage_guidance}, loss {stage_loss}", flush=True)
        last_save = done
        kw = dict(num_student_steps=stage_n, dataset_mean=mean, dataset_std=std,
                  guidance_weight=stage_guidance, loss_space=stage_loss)
        if data is not None:
            multi_fn = distill.make_device_data_multistep_distill(schedule, cfg, optimizer, **kw)
            for idx in distill.index_stream(len(ds), tc.batch_size, args.seed + stage_n,
                                            args.steps_per_stage, k_fuse, done):
                k = idx.shape[0]
                losses = multi_fn(state, teacher, data, torch.from_numpy(idx).to(dev),
                                  args.seed, range(gstep, gstep + k))
                gstep += k
                done += k
                print(f"  [{stage_n}] step {done}/{args.steps_per_stage} "
                      f"loss {float(losses[-1]):.6f}", flush=True)
                if (args.save_interval and done < args.steps_per_stage
                        and done - last_save >= args.save_interval):
                    last_save = done
                    print(f"  [{stage_n}] mid-stage checkpoint: {_save(done)}", flush=True)
        else:
            step_fn = distill.make_distill_step(schedule, cfg, optimizer, **kw)
            while done < args.steps_per_stage:
                it = BatchIterator(ds, tc.batch_size, shuffle=True, seed=args.seed + gstep)
                for batch in device_prefetch(it, dev):
                    loss = step_fn(state, teacher, batch,
                                   generator=step_generator(args.seed, gstep, dev))
                    gstep += 1
                    done += 1
                    if done % 100 == 0 or done == args.steps_per_stage:
                        print(f"  [{stage_n}] step {done}/{args.steps_per_stage} "
                              f"loss {float(loss):.6f}", flush=True)
                    if (args.save_interval and done < args.steps_per_stage
                            and done - last_save >= args.save_interval):
                        last_save = done
                        print(f"  [{stage_n}] mid-stage checkpoint: {_save(done)}", flush=True)
                    if done >= args.steps_per_stage:
                        break
        # the next stage's teacher is this stage's student (its EMA, copied)
        teacher = distill.build_teacher(cfg, state.ema)
        path = _save(args.steps_per_stage)
        print(f"stage {stage_n} checkpoint: {path}")
    print("distillation done:", path)


if __name__ == "__main__":
    main()
