"""Training traffic: ``cli train --steps_per_call K --device_data`` on a packed
split already on the card.

Set-up builds one training state (the program's ``init_train_state``, its
parameters and EMA then overwritten with the benchmark's weights) and one
``make_device_data_multistep`` step, and drives them through their first
two calls, steps 1-4, on rows that all differ: the first call captures the
CUDA graph. The window goes on calling that same step, K steps a call, each
call's (K, B) rows drawn from permutations of the pack, the loss read back
where ``cli train`` logs it (every ``log_interval`` steps).

What is checked (``check``): the losses of steps 1-3; the first gradient as
the optimizer got it (clipped), read from the state after step 2 as
``prev_grad - v / b2``; the parameters' change after step 3, read from the
state after step 4 by undoing step 4's update (``p3 = p4 (1 + wd lr) + lr
(m c_m + (1 - b2) v c_v) / (sqrt(n c_n) + eps)``, all of which the state
keeps); the EMA's change after step 3, undone the same way from the EMA
after step 4 (``e3 = (e4 - (1 - d) p4) / d``). Each against the
reference's three steps on the same rows and draws.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import adan as ref_adan
from portbench.reference import diffusion as ref_diff
from portbench.reference import unet as ref
from portbench.reference.precision import EXACT, Precision, exact_math
from portbench.weights import sync, make_pack, make_weights

MEL_MEAN, MEL_STD = -4.63706636428833, 1.8648223876953125  # the reference's mel statistics
CHECKED_STEPS = 3


def leaf_gaps(prog: Dict[str, float], want: Dict[str, float], names) -> tuple:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf; and that leaf."""
    med = float(np.median([want[k] for k in names]))
    worst, at = 0.0, None
    for k in names:
        gap = abs(prog[k] - want[k]) / max(want[k], med, 1e-30)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


class Driver:
    def __init__(self, cell, seeds, device, spans):
        self.cell, self.seeds, self.dev, self.spans = cell, seeds, torch.device(device), spans
        t = cell.traffic
        self.b, self.k, self.n = int(t["batch"]), int(t["steps_per_call"]), int(t["pack_clips"])
        self.t = int(t["mel_t"])
        self.log_every = int(cell.config["train"].get("log_interval", 10))
        self.prog_seed = seeds.small("program")
        self.rows_rng = seeds.rng("order")
        self._rows: List[int] = []
        self.window_losses: List[torch.Tensor] = []
        self.readings: Dict[str, object] = {}

    # ------------------------------------------------------------ inputs
    def _weights(self):
        m = self.cell.model
        return {**{f"unet/{k}": v for k, v in
                   make_weights(ref.spec(m), self.seeds["unet"], self.dev).items()},
                **{f"cond_proj/{k}": v for k, v in
                   make_weights(ref.cond_spec(m), self.seeds["cond"], self.dev).items()}}

    def _pack(self):
        return make_pack(self.n, self.t, self.cell.model, self.seeds["data"], self.dev,
                         MEL_MEAN, MEL_STD)

    def _next_rows(self) -> np.ndarray:
        need = self.k * self.b
        while len(self._rows) < need:
            self._rows += self.rows_rng.permutation(self.n).tolist()
        rows, self._rows = self._rows[:need], self._rows[need:]
        return np.asarray(rows, np.int64).reshape(self.k, self.b)

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from lm2a_tpu_torch.core.config import config_from_dict
        from lm2a_tpu_torch.diffusion.schedule import make_schedule
        from lm2a_tpu_torch.training.train_step import (
            init_train_state, make_device_data_multistep, make_optimizer)

        cfg = config_from_dict(self.cell.config)
        optimizer = make_optimizer(cfg)
        state = init_train_state(cfg, self.prog_seed, self.dev, optimizer)
        w = self._weights()
        with torch.no_grad():
            for k, p in state.params().items():
                p.copy_(w[k])
                state.ema[k].copy_(w[k])
        self.pack = self._pack()
        mel = self.pack["mel"]
        self.mean, self.std = float(mel.mean()), float(mel.std(unbiased=False))
        schedule = make_schedule(cfg.diffusion, device=self.dev)
        self.multi = make_device_data_multistep(schedule, cfg, optimizer, self.mean, self.std)
        self.state = state
        self.first_rows = [self._next_rows() for _ in range(2)]
        losses = [self._call(self.first_rows[0], 0)]
        self.readings["grad1"] = self._first_gradient()
        losses.append(self._call(self.first_rows[1], self.k))
        self.readings["change"] = self._change(w)
        self.readings["ema"] = self._ema_change(w)
        self.readings["loss"] = torch.cat(losses).tolist()[:CHECKED_STEPS]
        self.step = 2 * self.k
        del w
        sync(self.dev)

    def _call(self, rows, start: int) -> torch.Tensor:
        return self.multi(self.state, self.pack, rows, self.prog_seed,
                          list(range(start, start + self.k)))

    @torch.no_grad()
    def _first_gradient(self) -> Dict[str, float]:
        """Step 1's clipped gradient from the state after step 2:
        ``prev_grad`` is step 2's, ``v = b2 (g2 - g1)``."""
        b2 = ref_adan.BETAS[1]
        o = self.state.opt
        names = list(o.v)
        norms = torch.stack([(o.prev_grad[k] - o.v[k] / b2).norm() for k in names])
        return dict(zip(names, norms.tolist()))

    @torch.no_grad()
    def _change(self, w) -> Dict[str, float]:
        """The parameters after step 3 less the initial ones: step 4's update
        undone from what the state keeps after it."""
        tc = self.cell.config["train"]
        lr, wd = float(tc["lr"]), float(tc["weight_decay"])
        b2 = ref_adan.BETAS[1]
        c_m, c_v, c_n = ref_adan.corrections(2 * self.k)
        o, params, norms = self.state.opt, self.state.params(), []
        for k, p in params.items():
            raw = lr / (torch.sqrt(o.n[k].double() * c_n) + ref_adan.EPS) * (
                o.m[k].double() * c_m + (1 - b2) * o.v[k].double() * c_v)
            norms.append((p.double() * (1.0 + wd * lr) + raw - w[k].double()).norm())
        return dict(zip(params, torch.stack(norms).tolist()))

    @torch.no_grad()
    def _ema_change(self, w) -> Dict[str, float]:
        """The EMA after step 3 less the initial weights: step 4's blend
        ``e4 = d e3 + (1 - d) p4`` undone, with ``d`` and ``1 - d`` in float32
        as the optimizer's scalars hold them."""
        d = np.float32(self.cell.config["train"]["ema_decay"])
        keep, take = float(d), float(np.float32(1.0) - d)
        params, norms = self.state.params(), []
        for k, e in self.state.ema.items():
            e3 = (e.double() - take * params[k].double()) / keep
            norms.append((e3 - w[k].double()).norm())
        return dict(zip(self.state.ema, torch.stack(norms).tolist()))

    # ------------------------------------------------------------ the window
    def unit(self, i: int) -> None:
        rows = self._next_rows()
        with self.spans("train_call"):
            losses = self._call(rows, self.step)
        self.window_losses.append(losses)
        if self.step // self.log_every != (self.step + self.k) // self.log_every:
            with self.spans("log_read"):
                float(losses[-1])
        self.step += self.k

    def drain(self) -> None:
        sync(self.dev)

    def end_to_end(self, window_s: float, units: int) -> Dict[str, float]:
        return {"train_clips_per_s": units * self.k * self.b / window_s}

    def flops_per_unit(self) -> float:
        from torch.utils.flop_counter import FlopCounterMode

        m, meta = self.cell.model, torch.device("meta")
        pu = {k: torch.empty(s, device=meta, requires_grad=True) for k, (s, _) in ref.spec(m).items()}
        pc = {k: torch.empty(s, device=meta, requires_grad=True)
              for k, (s, _) in ref.cond_spec(m).items()}
        batch = {key: torch.empty((self.b, self.t, m[dim]), device=meta)
                 for key, dim in (("mel", "in_dim"), ("motion", "motion_dim"),
                                  ("lyrics", "text_dim"))}
        sched = ref_diff.schedule(self.cell.config["diffusion"])
        with FlopCounterMode(display=False) as fc:
            ref_diff.training_loss(pu, pc, m, sched, batch, mean=0.0, std=1.0, cond_drop=0.0,
                                   generator=None).backward()
        return float(fc.get_total_flops()) * self.k

    def release(self) -> None:
        self.window_nonfinite = int((~torch.isfinite(torch.cat(self.window_losses))).sum()) \
            if self.window_losses else 0
        del self.multi, self.state
        self.window_losses.clear()
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    def reference(self, q: Precision = EXACT) -> Dict[str, object]:
        """The reference's losses, first gradient, and the parameters' and the
        EMA's change after three steps on the rows and draws of the program's
        first three."""
        m, tc = self.cell.model, self.cell.config["train"]
        w = self._weights()
        params = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
        ema = {k: v.detach().clone() for k, v in w.items()}
        pu = {k[5:]: v for k, v in params.items() if k.startswith("unet/")}
        pc = {k[10:]: v for k, v in params.items() if k.startswith("cond_proj/")}
        hyper = ref_adan.Hyper(lr=float(tc["lr"]), weight_decay=float(tc["weight_decay"]),
                               grad_clip=float(tc["grad_clip"]), ema_decay=float(tc["ema_decay"]))
        st, sched = ref_adan.State(), ref_diff.schedule(self.cell.config["diffusion"])
        rows = np.concatenate(self.first_rows).reshape(-1, self.b)
        losses, grad1 = [], None
        with exact_math():
            for s in range(CHECKED_STEPS):
                gen = torch.Generator(device=self.dev).manual_seed(
                    ref_diff.step_seed(self.prog_seed, s))
                idx = torch.as_tensor(rows[s], device=self.dev)
                batch = {key: v.index_select(0, idx) for key, v in self.pack.items()}
                loss = ref_diff.training_loss(pu, pc, m, sched, batch, mean=self.mean,
                                              std=self.std, cond_drop=float(tc["cond_drop_prob"]),
                                              generator=gen, q=q)
                loss.backward()
                grads = {k: p.grad for k, p in params.items()}
                used = ref_adan.step(params, grads, ema, st, hyper)
                if s == 0:
                    grad1 = dict(zip(used, torch.stack([g.norm() for g in used.values()]).tolist()))
                for p in params.values():
                    p.grad = None
                losses.append(float(loss.detach()))
        change = dict(zip(params, torch.stack([(params[k].detach() - w[k]).norm()
                                               for k in params]).tolist()))
        ema_change = dict(zip(ema, torch.stack([(ema[k] - w[k]).norm() for k in ema]).tolist()))
        return {"loss": losses, "grad1": grad1, "change": change, "ema": ema_change}

    def check(self, control: Precision = None) -> Dict[str, float]:
        """The program's readings (or, with ``control``, the reference's in
        that precision) against the reference's."""
        prog = self.readings if control is None else self.reference(control)
        return compare(prog, self.reference(), self.window_nonfinite)


def compare(prog: Dict[str, object], want: Dict[str, object], nonfinite: int = 0) -> Dict[str, float]:
    """The numbers compared: the worst relative loss gap of the checked steps;
    the worst leaf's norm gap of the first gradient; the median leaf's norm
    gap of the parameters' change, and of the EMA's change, after three
    steps. Leaves whose reference gradient is under a thousandth of the
    median leaf's (zero but for rounding, as a key bias under softmax) move
    by round-off alone and are left out of both changes. The worst leaf's
    change gaps are reported, not compared: Adan's first steps divide by
    sqrt(n), which is near zero wherever g + (1 - b2) (g - g_prev) is, so a
    few elements of a leaf move by far more than lr and by amounts that
    rounding in the gradient's last bits changes; and the EMA's change, a
    thousandth of the parameters', is near float32 rounding in the norm
    scales (about 1.0)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], want["loss"]))
    names = sorted(want["grad1"])
    grad_gap, grad_at = leaf_gaps(prog["grad1"], want["grad1"], names)
    med = float(np.median([want["grad1"][k] for k in names]))
    moved = [k for k in names if want["grad1"][k] >= 1e-3 * med]
    change_worst, change_at = leaf_gaps(prog["change"], want["change"], moved)
    ema_worst, ema_at = leaf_gaps(prog["ema"], want["ema"], moved)
    return {"loss_gap": loss_gap, "grad1_gap": grad_gap,
            "change_median_gap": median_gap(prog["change"], want["change"], moved),
            "ema_median_gap": median_gap(prog["ema"], want["ema"], moved),
            "nonfinite_losses": float(nonfinite),
            "_where": f"grad1 worst at {grad_at}; change worst leaf {change_worst!r} at "
                      f"{change_at}, EMA worst leaf {ema_worst!r} at {ema_at} (not compared); "
                      f"{len(names) - len(moved)} leaves left out of the changes"}


def median_gap(prog: Dict[str, float], want: Dict[str, float], names) -> float:
    """The median leaf's gap between two norms, each over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([want[k] for k in names]))
    return float(np.median([abs(prog[k] - want[k]) / max(want[k], med, 1e-30) for k in names]))
