"""Run one cell of the port's benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port. The cell, its
configuration, traffic mix, limits and metrics are found by name from
BENCHMARK.json. `--trace 0` prints the cell's end-to-end metrics,
`--trace 1` its per-layer ones, read from a profiled sub-window after the
measured window. Every run judges what the timed path produced against the
plain reference (perfbench/checks/). Without a CUDA card, or with fewer
than the cell asks for, it exits non-zero and prints no result."""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import env  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    env.set_caches()
    from perfbench.core import spec

    cell = spec.cell(args.workload)
    env.require_cards(cell["chips"])
    print(f"card and power limit: {env.power_limit()}", file=sys.stderr)
    from perfbench.core import harness

    result, checks, _ = harness.run(cell, args.seed, args.seconds,
                                 bool(args.trace), START,
                                 tempfile.mkdtemp(prefix="perfbench-"))
    found = env.forbidden_modules()
    if found:
        sys.exit(f"modules that no run may load were loaded: {found}")
    env.emit(result, checks)


if __name__ == "__main__":
    main()
