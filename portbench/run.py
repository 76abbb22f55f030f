"""The benchmark's command: one run of one cell on the card it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON result line, last on standard output; see ``harness.py``.
"""

import os
import sys
import time

T_START = time.perf_counter()  # set-up is timed from here, imports included

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
