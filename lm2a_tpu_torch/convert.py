"""Carry parameters between flax trees and PyTorch state dicts.

Module attribute names in the port follow the flax names, so the carry-over
is one rule per leaf kind (the inverse of ``lm2a_tpu/utils/torch_convert.py``
and ``lm2a_tpu/vocoder/convert.py``):

- Dense kernel ``(in, out)``            <-> Linear weight ``(out, in)``
- Conv kernel ``(K, Cin, Cout)``        <-> Conv1d weight ``(Cout, Cin, K)``
- ConvTranspose kernel ``(K, Cin, Cout)`` <-> ConvTranspose1d weight
  ``(Cin, Cout, K)``, spatially flipped
- GroupNorm ``scale``/``bias``          <-> ``weight``/``bias``
- everything else (biases, snake alpha/beta) as is.

Flax trees travel as flat dicts keyed ``"a/b/kernel"`` of numpy arrays.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

# the vocoder's transposed convs are its top-level ``up_<i>`` modules
BIGVGAN_CONV_TRANSPOSE = re.compile(r"up_\d+").fullmatch
# the v1 UNet's are its ``up_<i>_upconv`` modules (under any tree prefix);
# the production UNet has none, so the rule holds for either denoiser
UNET_CONV_TRANSPOSE = re.compile(r"(?:.*[/.])?up_\d+_upconv").fullmatch

PathPred = Optional[Callable[[str], object]]


def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> flat ``{"a/b/kernel": np.ndarray}``."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def jax_params_to_torch(flat: Dict[str, np.ndarray],
                        conv_transpose: PathPred = None) -> Dict[str, torch.Tensor]:
    """Flat flax params -> a state dict for the port's module of the same tree."""
    out = {}
    for key, a in flat.items():
        a = np.asarray(a, dtype=np.float32)
        module, leaf = key.rsplit("/", 1) if "/" in key else ("", key)
        if leaf == "kernel":
            if a.ndim == 2:
                a = a.T
            elif conv_transpose is not None and conv_transpose(module):
                a = a[::-1].transpose(1, 2, 0)
            else:
                a = a.transpose(2, 1, 0)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        name = f"{module}.{leaf}".replace("/", ".") if module else leaf
        out[name] = torch.tensor(np.ascontiguousarray(a))
    return out


def torch_params_to_jax(state_dict: Dict[str, torch.Tensor],
                        conv_transpose: PathPred = None) -> Dict[str, np.ndarray]:
    """State dict of a port module -> flat flax params (the inverse rule; a
    1-D ``weight`` is a GroupNorm scale)."""
    out = {}
    for name, t in state_dict.items():
        a = t.detach().float().cpu().numpy()
        module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        module = module.replace(".", "/")
        if leaf == "weight":
            if a.ndim == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                if a.ndim == 2:
                    a = a.T
                elif conv_transpose is not None and conv_transpose(module):
                    a = a.transpose(2, 0, 1)[::-1]
                else:
                    a = a.transpose(2, 1, 0)
        key = f"{module}/{leaf}" if module else leaf
        out[key] = np.ascontiguousarray(a)
    return out
