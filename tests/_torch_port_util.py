"""Shared helpers for the ``tests/test_torch_*.py`` parity tests: carry a
JAX parameter tree into a port module, and a tiny checkpoint config."""

import jax
import numpy as np
import torch

from lm2a_tpu.core.config import DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig
from lm2a_tpu_torch.convert import flatten_params, jax_params_to_torch

TINY_CFG = LM2AConfig(
    model=ModelConfig(
        base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
        num_res_blocks=1, mid_blocks=1, attn_heads=2,
        motion_dim=234, text_dim=768,
    ),
    diffusion=DiffusionConfig(timesteps=8),
    train=TrainConfig(batch_size=2),
)


def load_jax_params(module: torch.nn.Module, params, conv_transpose=None):
    """Load a flax ``params`` tree into ``module`` (strict) and return it."""
    flat = flatten_params(jax.device_get(params))
    module.load_state_dict(jax_params_to_torch(flat, conv_transpose))
    return module.eval().requires_grad_(False)


def rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))
