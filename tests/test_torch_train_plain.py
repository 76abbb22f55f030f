"""The plain route's training steps (no ``fused_resblock_grad``,
``opt_backend='xla'``) and the eval step against the JAX package; the
helpers, the protocol and the tolerances are ``test_torch_train.py``'s."""

import pytest

from test_torch_train import check_eval_step, check_train_steps, make_setup

from _torch_port_util import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    return make_setup(False)


def test_train_steps_match_jax(setup):
    check_train_steps(setup)


def test_eval_step_matches_jax(setup):
    check_eval_step(setup)
