"""``lm2a_tpu_torch.ops.motion`` against ``lm2a_tpu.ops.motion`` on the CPU.

On numpy input the port runs the JAX module's numpy path: the same bits. On
a CPU tensor it computes with torch, against the JAX module's ``jnp`` path
within 1e-6 relative (fp32 sums of the same terms; XLA may fuse the
smoothing's multiply-adds, torch does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.ops import motion as jmotion
from lm2a_tpu_torch.ops import motion

from _torch_port_util import one_torch_thread  # noqa: F401

FNS = ("gaussian_smooth", "velocity", "acceleration", "motion_features")


def _track(seed, t, d=78):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)


def _call(mod, name, x, fps=30.0):
    fn = getattr(mod, name)
    return fn(x) if name == "gaussian_smooth" else fn(x, fps)


@pytest.mark.parametrize("name", FNS)
@pytest.mark.parametrize("t", [1, 2, 3, 7, 180])
def test_numpy_path_is_bit_for_bit(name, t):
    x = _track(t, t)
    got, want = _call(motion, name, x), _call(jmotion, name, x)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FNS)
@pytest.mark.parametrize("t", [1, 2, 3, 180])
def test_tensor_path_matches_jnp(name, t):
    x = _track(100 + t, t)
    got = _call(motion, name, torch.from_numpy(x))
    want = np.asarray(_call(jmotion, name, jnp.asarray(x)))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 2.0])
def test_gaussian_kernel_and_sigma(sigma):
    x = _track(3, 40)
    np.testing.assert_array_equal(motion.gaussian_smooth(x, sigma), jmotion.gaussian_smooth(x, sigma))
    if sigma > 0:
        np.testing.assert_array_equal(motion.gaussian_kernel(sigma), jmotion.gaussian_kernel(sigma))
