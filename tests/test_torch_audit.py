"""The collective audit of the port (``parallel/audit.py``): the counts of
the collective layer (``core/distributed.py``) over one call, under the JAX
package's opcode names.

- A process without a group: every helper is the no-op, and a call's
  census is empty.
- Four gloo ranks on the CPU as a (data=2, model=2) mesh: one data-parallel
  train step's census is exactly one all-reduce (the flat gradient buffer
  and the loss, bucket and all: (parameters + 1) fp32 values) and no
  gather, as the JAX package's ``test_collective_audit_counts_dp_allreduce``
  asserts of its HLO; one sequence-parallel DDIM chain's shows the halo
  exchanges (collective-permute), one all-reduce of sums for every
  GroupNorm of every forward, and the two all-gathers (the conditions, the
  sample).
"""

from collections import Counter

import numpy as np
import torch

from lm2a_tpu_torch.core import distributed
from lm2a_tpu_torch.core.config import config_to_dict
from lm2a_tpu_torch.core.config import DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig
from lm2a_tpu_torch.parallel.audit import COLLECTIVE_OPS, audit, collective_counts
from lm2a_tpu_torch.training.checkpoint import state_arrays
from lm2a_tpu_torch.training.train_step import init_train_state

from _torch_port_util import one_torch_thread  # noqa: F401
from _torch_ranks import spawn

CFG = LM2AConfig(
    model=ModelConfig(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2, motion_dim=12,
                      text_dim=24),
    diffusion=DiffusionConfig(timesteps=20),
    train=TrainConfig(batch_size=4, compute_dtype="float32"),
)


def test_the_jax_opcode_names():
    assert COLLECTIVE_OPS[:5] == ("all-reduce", "all-gather", "reduce-scatter",
                                  "collective-permute", "all-to-all")
    rec = Counter({"all-reduce": 2, "all-reduce:bytes": 8, "all-gather": 0})
    assert collective_counts(rec) == {"all-reduce": 2}


def test_single_process_census_is_empty():
    t = torch.ones(4)
    rep = audit(lambda: distributed.all_reduce(t, None) + 1)
    assert rep["collectives"] == {} and rep["total"] == 0 and rep["bytes"] == 0
    assert torch.equal(rep["result"], torch.full((4,), 2.0))


def test_dp_and_sp_census(tmp_path):
    rng = np.random.default_rng(0)
    b, t = 4, 32
    state = init_train_state(CFG, 0, "cpu")
    payload = {"mel": rng.standard_normal((b, t, 80)).astype(np.float32),
               "motion": rng.standard_normal((b, t, 12)).astype(np.float32),
               "lyrics": rng.standard_normal((b, t, 24)).astype(np.float32),
               "x_init": rng.standard_normal((1, t, 80)).astype(np.float32),
               "cond": rng.standard_normal((1, t, 8)).astype(np.float32)}
    payload.update({"state|" + k: v for k, v in state_arrays(state).items()})
    payload["meta"] = dict(cfg=config_to_dict(CFG), batch=b, model_axis=2)
    outs = spawn("audit_census", 4, tmp_path, payload)
    n = outs[0]["n_params"]
    for o in outs:
        assert o["dp"] == {"collectives": {"all-reduce": 1}, "total": 1, "bytes": (n + 1) * 4}
        c = o["sp"]["collectives"]
        assert c["collective-permute"] >= 1 and c["all-gather"] == 2, c
        # each GroupNorm of each forward: 2 a block over 5 blocks, and out_gn; 2 steps
        assert c["all-reduce"] == 2 * (2 * 5 + 1), c
        assert "reduce-scatter" not in c and "all-to-all" not in c
