"""CLI dispatcher: ``python -m lm2a_tpu_torch.cli <command> [args]``.

  distill            teacher checkpoint -> few-step DDIM student (CFG folded in)
  evaluate           wav-domain metrics over sample_*/{gt,gen}.wav pairs
  graph              histograms from evaluation_results.json (matplotlib)
  inspect_train_log  summarize (and plot) train_log.csv
  pack               npz split -> memory-mapped training arrays
  sample             checkpoint + npz conditions -> generated mel npz
  serve              persistent JSON-line sampling server (stdin -> stdout)
  towav              mel npz -> wav (BigVGAN)
  train              train the denoiser (checkpoints in the JAX package's layout)
  val                mel-domain assessment of a checkpoint over a test split

``distill``, ``sample``, ``serve``, ``towav``, ``train`` and ``val`` take
``--device`` (default ``cuda``).
"""

import sys

COMMANDS = {
    "distill": "lm2a_tpu_torch.cli.distill",
    "evaluate": "lm2a_tpu_torch.cli.evaluate",
    "graph": "lm2a_tpu_torch.cli.graph",
    "inspect_train_log": "lm2a_tpu_torch.cli.inspect_train_log",
    "pack": "lm2a_tpu_torch.cli.pack",
    "sample": "lm2a_tpu_torch.cli.sample",
    "serve": "lm2a_tpu_torch.cli.serve",
    "towav": "lm2a_tpu_torch.cli.towav",
    "train": "lm2a_tpu_torch.cli.train",
    "val": "lm2a_tpu_torch.cli.val",
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        print("usage: python -m lm2a_tpu_torch.cli <command> [args]")
        print("commands:", ", ".join(COMMANDS))
        raise SystemExit(0 if len(sys.argv) >= 2 else 1)
    cmd = sys.argv[1]
    if cmd not in COMMANDS:
        raise SystemExit(f"unknown command {cmd!r}; choose from {list(COMMANDS)}")
    import importlib

    importlib.import_module(COMMANDS[cmd]).main(sys.argv[2:])


if __name__ == "__main__":
    main()
