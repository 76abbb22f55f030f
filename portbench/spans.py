"""The benchmark's own spans around its calls into the program: host-clock
durations by name, and, while a trace runs, ``record_function`` ranges
(``portbench/<name>``) that the trace reads."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List


class Spans:
    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.tracing = False

    @contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self.tracing:
            from torch.profiler import record_function

            with record_function(f"portbench/{name}"):
                yield
        else:
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def mean(self, name: str):
        v = self.seconds.get(name)
        return sum(v) / len(v) if v else None
