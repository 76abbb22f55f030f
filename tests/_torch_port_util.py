"""Shared helpers for the ``tests/test_torch_*.py`` parity tests: carry a
JAX parameter tree into a port module, and a tiny checkpoint config."""

import jax
import numpy as np
import pytest
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors, six test workers on one machine: one intra-op thread
    each keeps the workers from oversubscribing the cores. Import into a
    test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_state_arrays(state):
    """A JAX TrainState as host arrays keyed by ``jax.tree_util.keystr``,
    the checkpoint layout both packages write."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(state))
    return {jax.tree_util.keystr(kp): np.array(leaf) for kp, leaf in flat}


def port_train_state(port_cfg, jax_state, device="cpu"):
    """A port TrainState holding the JAX state's parameters, EMA and Adan
    state (built from ``port_cfg``, then overwritten leaf by leaf)."""
    from lm2a_tpu_torch.training.checkpoint import load_state_arrays
    from lm2a_tpu_torch.training.train_step import init_train_state

    state = init_train_state(port_cfg, 0, device)
    load_state_arrays(state, jax_state_arrays(jax_state))
    return state


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb > 0 else float(np.linalg.norm(a))


def jax_train_state(arrays):
    """A JAX ``TrainState`` (fp32 Adan state) from host arrays in the
    checkpoint layout, e.g. a port state's ``state_arrays``: no flax init."""
    import re

    import jax.numpy as jnp

    from lm2a_tpu.training.adan import AdanState
    from lm2a_tpu.training.train_step import TrainState

    def tree(prefix):
        out = {}
        for k, a in arrays.items():
            if k.startswith(prefix + "["):
                *path, leaf = re.findall(r"\['([^']*)'\]", k[len(prefix):])
                d = out
                for p in path:
                    d = d.setdefault(p, {})
                d[leaf] = jnp.asarray(a)
        return out

    return TrainState(
        step=jnp.asarray(arrays[".step"], jnp.int32),
        params=tree(".params"), ema_params=tree(".ema_params"),
        opt_state=AdanState(jnp.asarray(arrays[".opt_state.step"], jnp.int32),
                            *(tree(f".opt_state.{n}") for n in ("m", "v", "n", "prev_grad"))))
