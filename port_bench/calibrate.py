"""The readings that the check's limits are set from, on the card.

    python -m port_bench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 4,5,6] [--seconds 2]

For each seed, one run of the cell's window loop in this process (a short
window; the numbers compared do not depend on its length): the program's
readings. For each control seed, the control's readings (control.py); for
each fault seed, the readings of the program with each fault of the cell's
loop planted (faults.py). One JSON line each on standard output, then the
largest program reading and the smallest control and fault reading of every
number.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from port_bench import control, faults, harness
from port_bench.loops import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    loop = importlib.import_module(
        f"port_bench.loops.{cell['traffic']['loop']}")
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    program, low, broken = {}, {}, {}
    for seed in seeds:
        t = time.perf_counter()
        res = loop.run(common.Run(cell, seed, args.seconds, False, dev, t))
        vals = {k: v["value"] for k, v in res["checks"].items()}
        for k, v in vals.items():
            program[k] = max(program.get(k, v), v)
        print(json.dumps({"side": "program", "seed": seed, "values": vals,
                          "correct": res["correct"],
                          "setup_s": res["setup_s"],
                          "seconds": time.perf_counter() - t}), flush=True)
    for seed in control_seeds:
        t = time.perf_counter()
        vals = control.values(common.Run(cell, seed, args.seconds, False,
                                         dev, t))
        for k, v in vals.items():
            low[k] = min(low.get(k, v), v)
        print(json.dumps({"side": "control", "seed": seed, "values": vals,
                          "seconds": time.perf_counter() - t}), flush=True)
    plant, names = faults.FAULTS[cell["traffic"]["loop"]]
    for seed in fault_seeds:
        for fault in names:
            t = time.perf_counter()
            with plant(fault):
                res = loop.run(common.Run(cell, seed, args.seconds, False,
                                            dev, t))
            vals = {k: v["value"] for k, v in res["checks"].items()}
            got = broken.setdefault(fault, {})
            for k, v in vals.items():
                got[k] = min(got.get(k, v), v)
            print(json.dumps({"side": f"fault {fault}", "seed": seed,
                              "values": vals, "correct": res["correct"],
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    print(json.dumps({"workload": args.workload, "program_max": program,
                      "control_min": low, "fault_min": broken}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
