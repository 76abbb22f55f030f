"""Collective-communication audit (port of ``lm2a_tpu/parallel/audit.py``).

The JAX package counts the collectives XLA inserted into a compiled step
from its HLO. PyTorch has no HLO: every collective of the port goes through
``core/distributed.py`` (``all_reduce``, ``all_gather``, ``halo_exchange``,
``broadcast``), which counts each call and the bytes it delivers to this
rank under the JAX package's opcode names (tensor parallelism's f and g,
forward or backward, as the all-reduces they run). ``audit(fn, *args)``
runs one call and reads what that layer recorded during it.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict

from lm2a_tpu_torch.core import distributed

# the JAX package's HLO opcodes that move data between devices
# (collective-permute: the halo exchange); broadcast is the port's own
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
    "broadcast",
)


def collective_counts(record: Counter) -> Dict[str, int]:
    """Calls per op of a record of the collective layer (``distributed.COUNTS``
    or a difference of two snapshots of it), ops with none left out."""
    return {op: int(record[op]) for op in COLLECTIVE_OPS if record[op]}


def audit(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and summarize its communication:
    ``{"collectives": {op: count}, "total": N, "bytes": B, "result": fn's
    return}``, ``bytes`` those the collectives delivered to this rank."""
    before = Counter(distributed.COUNTS)
    result = fn(*args, **kwargs)
    rec = Counter(distributed.COUNTS)
    rec.subtract(before)
    counts = collective_counts(rec)
    return {"collectives": counts, "total": sum(counts.values()),
            "bytes": sum(int(rec[op + ":bytes"]) for op in counts), "result": result}
