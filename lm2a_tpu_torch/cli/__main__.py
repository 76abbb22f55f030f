"""CLI dispatcher: ``python -m lm2a_tpu_torch.cli <command> [args]``.

  sample   checkpoint + npz conditions -> generated mel npz
  serve    persistent JSON-line sampling server (stdin -> stdout)
  towav    mel npz -> wav (BigVGAN)

All take ``--device`` (default ``cuda``).
"""

import sys

COMMANDS = {
    "sample": "lm2a_tpu_torch.cli.sample",
    "serve": "lm2a_tpu_torch.cli.serve",
    "towav": "lm2a_tpu_torch.cli.towav",
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
