"""The train cells' comparison: the reference works out the first steps'
batches from the files and the seed, judges the program's batches against
them, then follows the first steps in float32 from the same weights and
compares each step's loss, the first gradient as the optimizer took it
and the parameters' change after the steps, by leaf.

Numbers (each judged where the cell's limits' file names it):
- `row_err`: the largest |x| gap of an image row of the program's batches
  against the reference's row under the child seed the assignment gives
  it (module docstring of reference/data.py);
- `label_px`: label pixels that differ under that assignment;
- `loss_gap`: the largest |L - L_ref| / |L_ref| over the steps;
- `grad_gap_median`: the median leaf's | |g| - |g_ref| | / |g_ref|, g the
  first gradient as the optimizer took it (decay added);
- `grad_gap_total`: the same of the whole model's first gradient, the
  norm over every leaf;
- `change_gap_median`: the median leaf's gap of the parameters' change
  after the steps, over the leaves whose reference loss gradient is at
  least a thousandth of the median leaf's (a key's bias under softmax has
  none, and moves by the decay and round-off alone).
The worst leaf's gaps, which no limit judges, are read by readings.py."""

from __future__ import annotations

import statistics

import numpy as np
import torch

from perfbench.checks import reference_model
from perfbench.reference import data as rdata
from perfbench.reference.losses import LOSSES
from perfbench.reference.ops import Ops
from perfbench.reference.optim import Optimizer, poly_lr


def reference_batches(cell, seeds, train_dir, program_batches):
    """(the reference's batches, row_err, label_px). Row j of a batch is
    sample j of the step's shuffled indices (the loader keeps the order);
    which child seed of the batch it drew is free, so each row is given the
    seed that reproduces it best, each seed to one row."""
    from scipy.optimize import linear_sum_assignment

    cfg = cell["config_spec"]["yaml"]
    batch = int(np.ravel([cfg["train_config"]["batch_size"]])[0])
    aug = bool(cfg["dataset_config"]["augmentation"])
    paths = rdata.image_list(train_dir)
    order = rdata.epoch_orders(len(paths), seeds["program"], 1)[0]
    child = rdata.child_seeds(seeds["program"], len(program_batches) * batch)
    out, row_err, label_px = [], 0.0, 0
    for step, (xs, ys) in enumerate(program_batches):
        idx, mine = rdata.batch_rows(order, step, batch, child)
        if not aug:
            mine = [None] * len(idx)
        lab = np.zeros((len(idx), len(mine)))
        img = np.full((len(idx), len(mine)), np.inf)
        images, labels = {}, {}
        for j, i in enumerate(idx):
            image, label = rdata.decode(paths[i])
            for c, seed in enumerate(mine):
                labels[j, c] = (rdata.label_under(label, seed) if aug else
                                np.asarray(label, np.int32))
                lab[j, c] = np.count_nonzero(labels[j, c] != ys[j])
            # images only under the seeds whose labels fit best
            for c in np.nonzero(lab[j] == lab[j].min())[0]:
                images[j, c] = (rdata.image_under(image, mine[c]) if aug
                                else rdata.z_normalize(image))
                img[j, c] = float(np.max(np.abs(images[j, c] - xs[j])))
        cost = np.where(np.isfinite(img), lab * 1e3 + img, 1e12)
        rows, cols = linear_sum_assignment(cost)
        row_err = max(row_err, float(img[rows, cols].max()))
        label_px += int(lab[rows, cols].sum())
        if not np.isfinite(img[rows, cols]).all():
            return None, float("inf"), label_px
        out.append((np.stack([images[j, c] for j, c in zip(rows, cols)]),
                    np.stack([labels[j, c] for j, c in zip(rows, cols)])))
    return out, row_err, label_px


def learning_rates(cell, steps: int) -> list:
    """The first steps' learning rates: the configuration's, with the poly
    decay over its epochs of the mix's steps when `adaptive_lr`."""
    t = cell["config_spec"]["yaml"]["train_config"]
    base = float(np.ravel([t["lr_rate"]])[0])
    if not t.get("adaptive_lr", False):
        return [base] * steps
    batch = int(np.ravel([t["batch_size"]])[0])
    per_epoch = -(-cell["traffic_spec"]["tiles"] // batch)
    return [poly_lr(base, i, t["epochs"] * per_epoch) for i in range(steps)]


def follow(cell, seeds, batches, device, precision="f32"):
    """The reference's first steps on `batches`: (losses, the first
    gradient's norms as the optimizer took it, the raw loss gradient's
    norms, the change's norms), by leaf in the model's parameter order."""
    reference_model.no_tf32()
    spec = cell["config_spec"]
    t = spec["yaml"]["train_config"]
    lrs = learning_rates(cell, len(batches))
    ops = Ops(precision)
    model = reference_model.build(cell, seeds["weights"], device).to(
        ops.dtype)
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = Optimizer(t["optimizer"],
                    float(np.ravel([t["weight_decay"]])[0]))
    gen = torch.Generator(device=device).manual_seed(seeds["program"])
    loss_fn = LOSSES[t["loss"]]
    losses = []
    for i, ((xs, ys), lr) in enumerate(zip(batches, lrs)):
        x = torch.from_numpy(xs).to(device, ops.dtype)
        y = torch.from_numpy(ys).to(device)
        loss = loss_fn(model(x, ops, train=True, generator=gen), y,
                       spec["model"]["num_classes"])
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        losses.append(float(loss.detach()))
        taken = opt.step({k: p.data for k, p in params.items()}, grads, lr)
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g))
                          for k, g in taken.items()}
            raw_norms = {k: float(torch.linalg.vector_norm(g))
                         for k, g in grads.items()}
        del grads, taken, loss
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - v))
              for k, v in start.items()}
    return losses, grad_norms, raw_norms, change


def median_gap(prog: dict, ref: dict, keys) -> float:
    """The median leaf's | |p| - |ref| | / |ref|."""
    gaps = [abs(prog[k] - ref[k]) / ref[k] if ref[k] > 0 else float("inf")
            for k in keys]
    return statistics.median(g if g == g else float("inf") for g in gaps)


def total_gap(prog: dict, ref: dict, keys) -> float:
    """| |p| - |ref| | / |ref| of the norm over every leaf in `keys`."""
    def norm(d):
        return sum(d[k] ** 2 for k in keys) ** 0.5
    gap = abs(norm(prog) - norm(ref)) / norm(ref)
    return gap if gap == gap else float("inf")


def worst(values) -> float:
    """The largest value; infinite if any is not a number."""
    return max(v if v == v else float("inf") for v in values)


def compare(prog, ref, names) -> dict:
    """The numbers of two readings (program or control against the
    reference), each a (losses, grad norms, raw norms, change norms)."""
    p_loss, p_grad, _, p_change = prog
    r_loss, r_grad, r_raw, r_change = ref
    nan = float("nan")
    p_grad = {k: p_grad.get(k, nan) for k in names}
    p_change = {k: p_change.get(k, nan) for k in names}
    return {
        "grad_gap_median": median_gap(p_grad, r_grad, names),
        "grad_gap_total": total_gap(p_grad, r_grad, names),
        "change_gap_median": median_gap(p_change, r_change,
                                        moving(r_raw, names)),
        "loss_gap": worst(abs(a - b) / abs(b) for a, b in zip(p_loss,
                                                               r_loss)),
    }


def moving(raw: dict, names) -> list:
    """The leaves whose reference loss gradient is at least a thousandth
    of the median leaf's."""
    floor = statistics.median(raw[k] for k in names)
    return [k for k in names if raw[k] >= 1e-3 * floor]


def readings(cell, seeds, outputs, device, workdir, control=None):
    """(row_err, label_px, the reference's batches, the program's reading
    or the control's, the reference's reading), the batches and readings
    None where a row matches no draw of its batch."""
    import os

    batches, row_err, label_px = reference_batches(
        cell, seeds, os.path.join(workdir, "train"), outputs["batches"])
    if batches is None:
        return row_err, label_px, None, None, None
    ref = follow(cell, seeds, batches, device)
    if control is None:
        names = outputs["names"]
        prog = (outputs["losses"], dict(zip(names, outputs["grad_norms"])),
                None, dict(zip(names, outputs["change_norms"])))
    else:
        prog = follow(cell, seeds, batches, device, control)
        row_err, label_px = 0.0, 0
    return row_err, label_px, batches, prog, ref


def check(cell, seeds, outputs, device, workdir, control=None):
    """{number: value}. `control` ("fp8") puts the reference computed in
    that precision in the program's place."""
    row_err, label_px, _, prog, ref = readings(cell, seeds, outputs, device,
                                               workdir, control)
    numbers = {"row_err": row_err, "label_px": label_px}
    if prog is not None:
        numbers.update(compare(prog, ref, outputs["names"]))
    return numbers
