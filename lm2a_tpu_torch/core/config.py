"""Configuration dataclasses — the single source of truth for hyperparameters.

A jax-free copy of ``lm2a_tpu/core/config.py``: the same fields, defaults and
JSON form, so ``meta.json["config"]`` written by the JAX trainer round-trips
through ``config_from_dict``/``config_to_dict`` here unchanged.
``fused_attention`` is honoured: it routes the denoiser's attention cores
through the attention kernel, unfolded, as in the JAX package; so are
``fused_resblock_grad`` and ``dropout`` (the training form) and the train
switch ``opt_backend`` ('pallas' selects the CUDA Adan+EMA kernel). The
other switches of JAX code paths (``folded_attention``, ``fused_resblock``,
``opt_big_backend``, ...) are kept so the dict survives the round trip; the
port ignores them (it always folds off the fused route, always serves
through the resblock kernels and updates every leaf in the one Adan launch).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MelConfig:
    """Mel-spectrogram convention (matches BigVGAN's ``get_mel_spectrogram``).

    Defaults mirror the reference's ``default_bigvgan_hparams``
    (``reference/preprocess.py:26-38``): n_fft=1024, 80 mels, 22.05 kHz,
    hop 256, win 1024, fmin 0, fmax None (-> sr/2).
    """

    n_fft: int = 1024
    num_mels: int = 80
    sample_rate: int = 22050
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: Optional[float] = None  # None -> sr / 2


@dataclass(frozen=True)
class ModelConfig:
    """Denoiser architecture.

    Defaults match the reference's production configuration
    (``reference/train.py:77-86``): UNet1D_ultimate, base 256,
    mults (1,2,4), cond 128, time-emb 256, 2 res blocks/stage, 3 mid blocks,
    8 attention heads. ``arch='v1'`` selects the simpler baseline UNet
    (``reference/models/unet1d.py``) as a config flag rather than a
    second code path at the call sites.
    """

    arch: str = "ultimate"  # "ultimate" | "v1"
    in_dim: int = 80
    base_dim: int = 256
    dim_mults: Tuple[int, ...] = (1, 2, 4)
    cond_dim: int = 128
    time_emb_dim: int = 256
    num_res_blocks: int = 2
    mid_blocks: int = 3
    attn_heads: int = 8
    dropout: float = 0.1
    motion_dim: int = 78 * 3  # pose(72)+Th(3)+Rh(3), x3 for [pos, vel, acc]
    text_dim: int = 768  # RoBERTa-base hidden size
    # the attention kernel's route (honoured by the port)
    fused_attention: bool = False
    # training: the fused resblock chain with its CUDA backward (honoured)
    fused_resblock_grad: bool = False
    # JAX-only switches, kept for the checkpoint round trip:
    folded_attention: bool = False
    fused_resblock: bool = False
    remat: bool = False


@dataclass(frozen=True)
class DiffusionConfig:
    """DDPM schedule (``reference/models/diffusion.py:14``)."""

    timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (``reference/train.py:273-306``)."""

    batch_size: int = 16
    lr: float = 2e-4
    weight_decay: float = 1e-4
    epochs: int = 500
    ema_decay: float = 0.999
    grad_clip: float = 1.0
    cond_drop_prob: float = 0.2  # classifier-free guidance drop
    save_interval: int = 1000
    log_interval: int = 10
    val_cap_batches: int = 20
    # reference default 0.5: any integer (epoch+1) % 0.5 == 0 -> every epoch;
    # values >= 1 validate every N epochs (reference train.py:222,293)
    validate_every_epochs: float = 0.5
    seed: int = 0
    # "" disables LR decay (reference semantics)
    lr_decay_steps: Tuple[int, ...] = ()
    lr_decay_factors: Tuple[float, ...] = ()
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    rng_impl: str = "threefry"
    fused_opt: bool = True
    opt_backend: str = "xla"
    opt_big_backend: str = "pallas"  # JAX-only, kept for the checkpoint round trip
    steps_per_call: int = 1
    keep_checkpoints: int = 0
    ckpt_fetch_workers: int = 0
    device_data: bool = False
    quality_every_epochs: int = 0
    quality_clips: int = 4
    quality_steps: int = 50
    quality_guidance: float = 2.1


@dataclass(frozen=True)
class DataConfig:
    """Clip geometry (``reference/sometest/testnpz.py:58-75``)."""

    sequence_seconds: float = 6.0
    fps: int = 30
    align_mode: str = "interp"  # 'interp' | 'repeat'


@dataclass(frozen=True)
class LM2AConfig:
    """Top-level bundle stored in checkpoints and passed between CLIs."""

    mel: MelConfig = field(default_factory=MelConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, tuple):
        return list(obj)
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def config_to_dict(cfg: LM2AConfig) -> dict:
    return _to_jsonable(cfg)


_SUBCONFIGS = {
    "mel": MelConfig,
    "model": ModelConfig,
    "diffusion": DiffusionConfig,
    "train": TrainConfig,
    "data": DataConfig,
}

_TUPLE_FIELDS = {"dim_mults", "lr_decay_steps", "lr_decay_factors"}


def _from_dict(cls, d: dict):
    kwargs = {}
    names = {f.name for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in names:
            continue  # forward compatibility: ignore unknown keys
        kwargs[k] = tuple(v) if k in _TUPLE_FIELDS and v is not None else v
    return cls(**kwargs)


def config_from_dict(d: dict) -> LM2AConfig:
    parts = {}
    for name, cls in _SUBCONFIGS.items():
        sub = d.get(name, {})
        parts[name] = _from_dict(cls, sub) if isinstance(sub, dict) else cls()
    return LM2AConfig(**parts)
