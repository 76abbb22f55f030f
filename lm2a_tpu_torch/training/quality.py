"""Sample-quality telemetry during training (port of
``lm2a_tpu/training/quality.py``).

Every N epochs the monitor generates a fixed set of validation clips from
the EMA weights (DDIM, few steps, ``uncond_fast`` CFG at the configured
weight, de-normalised with the dataset statistics) and returns the mean of
``eval.mel_metrics.compute_metrics`` over them, the metrics ``val`` reports,
so quality regressions show during the run.

The JAX version jits the whole generation into one program. Here the chain
is one ``SamplerChain`` entry: on the card its step is captured into a CUDA
graph at the first run and replayed by every later one, on the CPU it runs
eagerly. The entry samples a prepared serving model (``prepare``: the
kernel-layout chain weights, the compute dtype), the one serving forward
``cli sample`` runs, with every block on the resblock kernels. Its source
is a view of the EMA: a denoiser and a condition projection whose
parameters are the training state's EMA tensors themselves (``ema_view``),
where the Adan+EMA update writes them in place. Each run first refreshes
the serving model from that view (``Denoiser.refresh``: one
``copy_`` per leaf, into the storage the captured graph reads), so it
samples the EMA as it stands and nothing is captured again. Noise comes from a ``torch.Generator`` seeded with ``seed + 777``
at every run (the JAX version's key), or from ``x_init`` (the tests inject
the JAX side's).

In a run of several processes every rank generates the same clips, from
conditions made rank 0's (``put_replicated``, as the JAX monitor puts them
on the global mesh); only the primary logs them (``training/loop.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from lm2a_tpu_torch.core.config import LM2AConfig
from lm2a_tpu_torch.core.device import dtype_from_str
from lm2a_tpu_torch.core.distributed import put_replicated
from lm2a_tpu_torch.core.graphs import new_pool
from lm2a_tpu_torch.data.dataset import BatchIterator
from lm2a_tpu_torch.diffusion.gaussian import SamplerChain, ddim_sample
from lm2a_tpu_torch.diffusion.schedule import Schedule
from lm2a_tpu_torch.eval.mel_metrics import compute_metrics
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser

SEED_OFFSET = 777


def ema_view(module: torch.nn.Module, ema: Dict[str, torch.Tensor], tree: str) -> torch.nn.Module:
    """``module`` with every parameter set to the tensor of ``ema`` under
    ``"<tree>/<name>"`` (the same storage, no copy), in eval mode."""
    for name, p in module.named_parameters():
        src = ema[f"{tree}/{name}"]
        if src.shape != p.shape:
            raise ValueError(f"EMA leaf {tree}/{name}: {tuple(src.shape)} for {tuple(p.shape)}")
        p.data = src
    return module.eval().requires_grad_(False)


class QualityMonitor:
    """Periodic EMA-sample quality probe over the first ``n_clips`` rows of
    the validation split (unshuffled)."""

    def __init__(self, cfg: LM2AConfig, ema: Dict[str, torch.Tensor], schedule: Schedule,
                 val_ds, n_clips: int, num_steps: int, guidance: float,
                 dataset_mean: float, dataset_std: float, seed: int = 0, mesh=None):
        n_clips = min(n_clips, len(val_ds))
        batch = next(iter(BatchIterator(val_ds, n_clips, shuffle=False)))
        self._gt_mel = np.asarray(batch["mel"])  # (K, T, 80), log-mel units
        self._mean, self._std = float(dataset_mean), float(dataset_std)
        dev = schedule.betas.device
        self.seed = seed + SEED_OFFSET
        self.num_steps, self.guidance = int(num_steps), float(guidance)
        self.dtype = dtype_from_str(cfg.train.compute_dtype)
        self.unet = ema_view(build_denoiser(cfg.model), ema, "unet")
        self.cond_proj = ema_view(build_cond_projection(cfg.model), ema, "cond_proj")
        self.serving = copy.deepcopy(self.unet).prepare(self.dtype)
        self._motion = torch.as_tensor(np.asarray(batch["motion"]), device=dev)
        self._lyrics = torch.as_tensor(np.asarray(batch["lyrics"]), device=dev)
        if mesh is not None:
            put_replicated(mesh, [self._motion, self._lyrics])
        self.chain = SamplerChain(schedule, self._gt_mel.shape, "ddim", num_steps=self.num_steps,
                                  generator=torch.Generator(device=dev), pool=new_pool(dev))

    @torch.no_grad()
    def generate(self, x_init: Optional[torch.Tensor] = None) -> np.ndarray:
        """The clips' de-normalised mels (K, T, 80) from the EMA as it stands."""
        self.serving.refresh(self.unet)
        motion_f, text_f = self.cond_proj.forward_train(self._motion, self._lyrics, self.dtype)
        self.chain.generator.manual_seed(self.seed)
        x = ddim_sample(self.serving, self.chain.schedule, self.chain.shape, motion_f, text_f,
                        num_steps=self.num_steps, guidance_weight=self.guidance,
                        x_init=x_init, uncond_fast=True, chain=self.chain)
        return (x * self._std + self._mean).cpu().numpy()

    def run(self, x_init: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """Generate the fixed clips and return the mean mel metrics."""
        gen = self.generate(x_init)
        rows = [compute_metrics(self._gt_mel[i].T, gen[i].T) for i in range(gen.shape[0])]
        return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
