"""Spawn the ranks of a ``torch.distributed`` run on the CPU (gloo) for the
port's parallelism tests.

``spawn(job, world, tmp_path, payload)`` starts ``world`` processes of
``python tests/_torch_rank_jobs.py <job> <rank> <world> <url> <dir>``, each
joining one gloo group through ``file://`` under ``tmp_path`` (no port, so
parallel test workers never collide), waits for all of them, and returns
each rank's output dict (``out_<rank>.npz`` plus ``out_<rank>.json``).
``payload`` (numpy arrays and a JSON-able dict under ``"meta"``) is what
every rank reads. A rank that fails or outlives ``timeout`` fails the test
with every rank's output; no rank is left running.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def spawn(job: str, world: int, tmp_path, payload: dict, timeout: float = 120.0):
    d = str(tmp_path / f"{job}_w{world}")
    os.makedirs(d, exist_ok=True)
    meta = payload.get("meta", {})
    np.savez(os.path.join(d, "in.npz"), **{k: v for k, v in payload.items() if k != "meta"})
    with open(os.path.join(d, "in.json"), "w") as f:
        json.dump(meta, f)
    url = "file://" + os.path.join(d, "rendezvous")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + TESTS, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.join(TESTS, "_torch_rank_jobs.py"), job,
                               str(r), str(world), url, d], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode}) ---\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    outs = []
    for r in range(world):
        with np.load(os.path.join(d, f"out_{r}.npz")) as z:
            out = {k: z[k] for k in z.files}
        with open(os.path.join(d, f"out_{r}.json")) as f:
            out.update(json.load(f))
        outs.append(out)
    return outs
