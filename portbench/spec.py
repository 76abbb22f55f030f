"""What a cell is made of, found by name: the entry of ``BENCHMARK.json``,
its configuration file, its traffic file (``traffic/<traffic>.json``) and
its limits (``limits/<workload>.json``)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _read(os.path.join(ROOT, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict       # the configuration file: model, diffusion, train, vocoder
    traffic_name: str
    traffic: dict      # the traffic file: its "driver" names the module of drivers/
    limits: Dict[str, float] = field(default_factory=dict)
    per_layer: list = field(default_factory=list)   # BENCHMARK.json entries for this cell
    end_to_end: list = field(default_factory=list)

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    @property
    def model(self) -> dict:
        return self.config["model"]


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(workload: str, bench: dict = None) -> Cell:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    limits_path = os.path.join(HERE, "limits", f"{workload}.json")
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config_name=conf["name"], config=_read(os.path.join(ROOT, conf["file"])),
        traffic_name=entry["traffic"],
        traffic=_read(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")),
        limits=_read(limits_path) if os.path.exists(limits_path) else {},
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
    )
