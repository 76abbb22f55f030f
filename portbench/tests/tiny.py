"""Tiny cells for the benchmark's CPU tests: a cell's own traffic and
configuration layout at widths and lengths a test run can hold. Each
traffic key below is cut to its tiny value where the traffic file has it,
so a new traffic file of a known driver needs nothing here. A sampling cell
checks its first request, the one a window of any length holds."""

from __future__ import annotations

import copy

from portbench import spec

TINY_MODEL = dict(base_dim=16, dim_mults=[1, 2], cond_dim=8, time_emb_dim=16, attn_heads=2,
                  mid_blocks=1)
TINY_VOCODER = dict(upsample_initial_channel=32, upsample_rates=[2, 2],
                    upsample_kernel_sizes=[4, 4], resblock_kernel_sizes=[3],
                    resblock_dilation_sizes=[[1, 3]])
TINY_TRAFFIC = dict(batch=2, pack_clips=8, mel_t=16, motion_frames=12, steps=3, clips=4,
                    warmup_requests=1, check_requests=1, check_within=1, trace_units=1)


def tiny_cell(workload: str, limits=None, **traffic) -> spec.Cell:
    """``workload``'s cell at tiny widths and lengths (``traffic`` overrides
    keys of its traffic file)."""
    cell = copy.deepcopy(spec.load_cell(workload))
    cell.config["model"].update(TINY_MODEL)
    cell.config["vocoder"].update(TINY_VOCODER)
    t = cell.traffic
    t.update({k: min(v, t[k]) if k == "batch" else v
              for k, v in TINY_TRAFFIC.items() if k in t})
    t.update(traffic)
    if limits is not None:
        cell.limits = dict(limits)
    return cell
