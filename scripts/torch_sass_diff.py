#!/usr/bin/env python3
"""Compare the device code (SASS) of the kernels of two builds of the port.

    python3 scripts/torch_sass_diff.py --parent build/parent/build/lm2a_tpu_torch \
        --change build/lm2a_tpu_torch [--sources attention,resblock]

Each build directory holds the ``lib<source>-<hash>.so`` libraries that
``lm2a_tpu_torch/ops/_build.py`` writes. For each source the script dumps
both libraries with ``cuobjdump -sass``, names each kernel function with the
per-file hash of its anonymous namespace taken out, drops the instruction
addresses and the NOP padding after a function's last instruction (its
alignment in the library, which another function's size can move), and
prints how many functions the two builds share and how many
of those have the same instructions: a change that adds a kernel form
without touching the others leaves every shared function the same. Needs
the CUDA toolkit's ``cuobjdump``.
"""

import argparse
import glob
import os
import re
import subprocess

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def functions(lib: str):
    """``{kernel name: its instructions}`` of one library."""
    out = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    res = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "ANON", name)
        lines = body.splitlines()
        # the last instruction that is not padding, and its encoding's second line
        last = max((i for i, line in enumerate(lines)
                    if re.match(r"\s*/\*[0-9a-f]+\*/", line) and not re.search(r"\*/\s*NOP\b", line)),
                   default=len(lines) - 2)
        body = "\n".join(lines[:last + 2])
        body = "\n".join(line.split("/*")[1] if line.strip().startswith("/*") and "*/" in line
                         else line for line in body.splitlines())
        res[name] = re.sub(r"\s+", " ", body)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the older build directory")
    ap.add_argument("--change", required=True, help="the newer build directory")
    ap.add_argument("--sources", default="attention,resblock")
    args = ap.parse_args()
    for src in args.sources.split(","):
        a = glob.glob(os.path.join(args.parent, f"lib{src}-*.so"))[0]
        b = glob.glob(os.path.join(args.change, f"lib{src}-*.so"))[0]
        fa, fb = functions(a), functions(b)
        common = sorted(set(fa) & set(fb))
        same = [n for n in common if fa[n] == fb[n]]
        print(f"[sass] {src}.cu: parent {len(fa)} functions, change {len(fb)}; {len(common)} in "
              f"both, {len(same)} with the same instructions; only in the change: "
              f"{sorted(set(fb) - set(fa))}; differing: {[n for n in common if fa[n] != fb[n]]}")


if __name__ == "__main__":
    main()
