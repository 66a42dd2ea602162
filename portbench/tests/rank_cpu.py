"""A tiny run of a cell on the CPU (its other ranks over gloo), for the
benchmark's tests:

    python rank_cpu.py <fault or ""> <run.py arguments...>
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import run  # noqa: E402
import tiny  # noqa: E402


def main(argv) -> int:
    fault, rest = argv[0] or None, argv[1:]
    cell = rest[rest.index("--workload") + 1]
    return run.main(rest, **tiny.run_kwargs(cell),
                    hooks={"fault": fault, "rank_command": [sys.executable, __file__,
                                                            fault or ""]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
