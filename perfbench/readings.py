"""The readings that the limits of `correct` are set from, on the card:
the program's numbers over many seeds, the control's (the reference in
float8 in the program's place) and the planted faults', all in one
process. Each mode is judged by the cell's own check module, and a fault
is one of the cell's loop's own `FAULTS` (`loops.fault`). A cell
judged by checks.train also gives the worst leaves' gaps, which no limit
judges, and takes `--mode look`: the program and, beside it, two witnesses
in its place, the reference in bfloat16 (the configurations' precision)
and in float64, with the cancellation in each GroupNorm's gain and bias
gradient: where the worst leaves' gaps come from.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        --mode program|control|look|<fault> [--seconds 2]

One JSON line a seed on standard output, also appended to
<out>/<cell>.<mode>.jsonl with `--out <out>`."""

import argparse
import contextlib
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import env  # noqa: E402


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's | |p| - |ref| | over max(|ref|, the median leaf's); a
    missing or non-finite reading is infinite."""
    floor = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        g = abs(prog.get(k, float("nan")) - ref[k]) / max(ref[k], floor)
        out[k] = g if g == g else float("inf")
    return out


def worst_leaves(gaps: dict, n: int = 4) -> list:
    return sorted(([g, k] for k, g in gaps.items()), reverse=True)[:n]


def by_leaf(prog, ref, names) -> dict:
    """{"grad": gaps, "change": gaps}: the first gradient's over every
    leaf, the change's over the leaves that move."""
    from perfbench.checks import train

    return {"grad": leaf_gaps(prog[1], ref[1], names),
            "change": leaf_gaps(prog[3], ref[3], train.moving(ref[2],
                                                              names))}


def rank_corr(a: dict, b: dict) -> float:
    """Spearman's correlation of two readings over their common leaves."""
    import numpy as np

    keys = [k for k in a if k in b]
    ra = np.argsort(np.argsort([a[k] for k in keys]))
    rb = np.argsort(np.argsort([b[k] for k in keys]))
    return float(np.corrcoef(ra, rb)[0, 1])


@contextlib.contextmanager
def gn_terms():
    """While open, the f32 reference's GroupNorms record, on their first
    backward, each channel's sum of |dL/dy * xhat| and of dL/dy * xhat
    (the gain's gradient and its terms) and the same of dL/dy (the
    bias's). Yields {leaf name: |sum of |terms|| / |sum of terms|}, filled
    once the block closes."""
    import torch
    import torch.nn.functional as F

    from perfbench.checks import reference_model
    from perfbench.reference import transunet

    sums, built, ratios = {}, [], {}
    gn, build = transunet.group_norm, reference_model.build

    def group_norm(x, groups, norm, eps):
        y = gn(x, groups, norm, eps)
        if not y.requires_grad or id(norm) in sums:
            return y
        with torch.no_grad():
            xhat = F.group_norm(x.detach(), groups, None, None, eps)
        sums[id(norm)] = None

        def hook(g):
            if sums[id(norm)] is None:
                t = g * xhat
                dims = (0, 2, 3)
                sums[id(norm)] = [v.double() for v in (
                    t.abs().sum(dims), t.sum(dims), g.abs().sum(dims),
                    g.sum(dims))]
        y.register_hook(hook)
        return y

    def capture(*a, **k):
        m = build(*a, **k)
        built.append(m)
        return m

    transunet.group_norm, reference_model.build = group_norm, capture
    try:
        yield ratios
    finally:
        transunet.group_norm, reference_model.build = gn, build
    for name, mod in (built[0].named_modules() if built else ()):
        s = sums.get(id(mod))
        if s is None:
            continue
        norm = torch.linalg.vector_norm
        ratios[name + ".weight"] = float(norm(s[0]) / norm(s[1]))
        ratios[name + ".bias"] = float(norm(s[2]) / norm(s[3]))


def look(cell, seeds, batches, device, names, prog, ref) -> dict:
    """The witnesses against the f32 reference, leaf by leaf, beside the
    program's gaps."""
    from perfbench.checks import train

    mine = by_leaf(prog, ref, names)
    out = {"cancellation": {}}
    with gn_terms() as ratios:
        train.follow(cell, seeds, batches, device)
    for prec in ("bf16", "f64"):
        wit = train.follow(cell, seeds, batches, device, prec)
        theirs = by_leaf(wit, ref, names)
        out[prec] = {"numbers": train.compare(wit, ref, names)}
        for part in ("grad", "change"):
            out[prec][part] = {
                "worst": worst_leaves(theirs[part]),
                "at_program_worst": [[theirs[part][k], k] for _, k in
                                     worst_leaves(mine[part])],
                "rank_corr": rank_corr(mine[part], theirs[part])}
    for part in ("grad", "change"):
        out["cancellation"][part] = [
            [ratios.get(k), k] for _, k in worst_leaves(mine[part])]
    if ratios:
        gaps = mine["grad"]
        out["cancellation"]["median_gn"] = statistics.median(
            ratios.values())
        out["cancellation"]["median_gn_gap_over_0.1"] = statistics.median(
            [r for k, r in ratios.items() if gaps.get(k, 0) > 0.1] or [0])
        out["cancellation"]["rank_corr_grad"] = rank_corr(
            {k: gaps[k] for k in ratios}, ratios)
    return out


def train_check(with_look: bool):
    """The train cells' check, with every leaf's worst gaps and, with
    `with_look`, the witnesses."""
    from perfbench.checks import train

    def check(cell, seeds, outputs, device, workdir, control=None):
        row_err, label_px, batches, prog, ref = train.readings(
            cell, seeds, outputs, device, workdir, control)
        numbers = {"row_err": row_err, "label_px": label_px}
        if prog is None:
            return numbers
        names = outputs["names"]
        numbers.update(train.compare(prog, ref, names))
        gaps = by_leaf(prog, ref, names)
        for part in ("grad", "change"):
            numbers[f"{part}_gap"] = max(gaps[part].values())
            numbers[f"{part}_worst"] = worst_leaves(gaps[part])
        if with_look:
            numbers["look"] = look(cell, seeds, batches, device, names,
                                   prog, ref)
        return numbers
    return check


def plan(cell, mode: str):
    """(fault, control, check) of `mode` for the cell: the fault that the
    cell's loop plants, the control's precision, and the check that stands
    for the cell's own (None: the check of the cell's loop, as a run judges
    it)."""
    from perfbench import loops

    own_train = loops.driver(cell["traffic_spec"]) == "train"
    fault = loops.fault(cell["traffic_spec"], mode)
    if mode not in ("program", "control", "look") and fault is None:
        raise SystemExit(f"no mode {mode!r} for this cell")
    if mode == "look" and not own_train:
        raise SystemExit("--mode look reads checks.train's leaves; this "
                         "cell is judged by another check")
    control = "fp8" if mode == "control" else None
    return fault, control, train_check(mode == "look") if own_train else None


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", help="a directory inside the checkout")
    args = p.parse_args()
    env.set_caches()
    from perfbench.core import harness, spec

    cell = spec.cell(args.workload)
    env.require_cards(cell["chips"])
    cell["limits"]["numbers"] = {}  # every number, none judged
    fault, control, check = plan(cell, args.mode)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        result, _, numbers = harness.run(
            cell, seed, args.seconds, False, t,
            tempfile.mkdtemp(prefix="perfbench-"), fault=fault,
            control=control, check=check)
        line = json.dumps({"workload": args.workload, "mode": args.mode,
                           "seed": seed, "numbers": numbers,
                           "metrics": result["metrics"],
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(Path(args.out) / f"{args.workload}.{args.mode}.jsonl",
                      "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
