"""Readings of the correctness check, for setting its limits.

    python3 benchmark/control.py --workload <name> --seeds a,b,... \\
        [--control-seeds x,y,z] [--seconds 4]

In one process, for each seed: a short run of the cell as the benchmark
makes it (the lower readings: what sound runs of the program give), and
for each control seed the same run with the program's own
lower-precision path switched on, ``run_slam --precision high`` (TF32 in
the filter's non-kernel matmuls, where the configuration states f32 with
TF32 off): the upper readings. Prints each seed's compared numbers and,
per number, the largest sound reading and the smallest control reading.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
_ROOT = str(Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

CONTROL_FLAGS = ("--precision", "high")


def main(argv=None) -> int:
    from benchmark import check, harness, manifest
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    cell = manifest.resolve(args.workload)
    harness.check_devices(cell.chips)
    rows = []
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + [
        (int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        out = harness.run_cell(cell, seed, args.seconds, False,
                               time.perf_counter(),
                               extra=CONTROL_FLAGS if control else ())
        nums = {k: v["value"] for k, v in out["result"]["checks"].items()}
        row = {"seed": seed, "control": control,
               "requests": out["result"]["attempted"], **nums}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for name in check.NAMES:
        sound = [r[name] for r in rows if not r["control"]]
        ctrl = [r[name] for r in rows if r["control"]]
        print(f"{name}: sound max {max(sound) if sound else None!r}, "
              f"control min {min(ctrl) if ctrl else None!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
