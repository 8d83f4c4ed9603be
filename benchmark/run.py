"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

(or ``python -m benchmark.run ...`` from the repository root). It needs
the CUDA cards the cell asks for and prints, as its last line, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and the compared numbers with their limits under ``checks``.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = str(Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    from benchmark import harness
    return harness.main(argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
