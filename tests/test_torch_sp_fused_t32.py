"""The port's sequence-parallel fused train step at T = 32 on the (data 1,
model 2), (data 2, model 2) and (data 1, model 4) meshes, against the JAX
package's ``make_sp_train_step`` with ``fused_resblock_grad`` and against
the port's unsharded step (``test_torch_sp_fused.py`` holds the checks and
the T = 66 cases; the two files spread the JAX compiles over two test
workers)."""

import pytest

from _torch_port_util import one_torch_thread  # noqa: F401
from test_torch_sp_fused import MESHES, check_sp_fused_step, setup  # noqa: F401


@pytest.mark.parametrize("data,model", MESHES, ids=[f"d{d}m{m}" for d, m in MESHES])
def test_sp_fused_step_matches_jax_and_unsharded_t32(setup, tmp_path, data, model):  # noqa: F811
    check_sp_fused_step(setup, tmp_path, data, model, 32)
