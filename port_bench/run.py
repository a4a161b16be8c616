"""Run one cell of the benchmark once and print its result line.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's files (harness.py), makes its inputs from the seed, warms
up, measures for --seconds with its window loop, judges what the window
produced against the plain reference, and prints one JSON line last on
standard output: the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics, the device, and the numbers compared beside their
limits, which also end standard error. Exits non-zero, printing no result,
where no CUDA device or fewer cards than the cell asks for are visible,
where JAX or the JAX package was loaded, or where a metric that
BENCHMARK.json lists for the cell finds nothing to read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from port_bench import harness
    from port_bench.loops import common
    cell = harness.cell(args.workload)
    bench = harness.benchmark_file()
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); {visible} visible", file=sys.stderr)
        return 2
    loop = importlib.import_module(
        f"port_bench.loops.{cell['traffic']['loop']}")
    res = loop.run(common.Run(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                T_START))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"port_bench: modules loaded that the port may not use: "
              f"{loaded}", file=sys.stderr)
        return 3
    names = harness.metrics_for(bench, args.workload, bool(args.trace))
    metrics = harness.read_metrics(names, res)
    unread = harness.unread(names, metrics)
    if unread:
        print(f"port_bench: found nothing to read for {unread}, which "
              f"BENCHMARK.json lists for {args.workload}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    breakdown = None
    if args.trace:
        t = res["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        breakdown = {"device_ops": t["device_ops"],
                     "idle_gaps": t["idle_gaps"]}
    print(f"port_bench: setup {res['setup_s']:.3f} s, window "
          f"{res['window_s']:.3f} s, {res['attempted']} attempted, reference "
          f"{res['reference_s']:.3f} s, run "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    for line in harness.checks_text(res["checks"]):
        print(line, file=sys.stderr)
    print(harness.result_line(res["correct"], res["attempted"],
                              res["failed"], metrics, device, res["checks"],
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
