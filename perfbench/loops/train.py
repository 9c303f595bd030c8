"""The train loop: the Trainer's batch path, as `Trainer.single_train` runs
it, without the epoch's checkpoint and validation. `_loop` is a copy of
that method's batch loop (the Trainer offers no call that runs one epoch's
steps alone); set-up and the measured window both run through it.

Each step takes one batch from the train NumpyLoader (shuffled, the
config's loader threads and augmentation), moves it with
`Trainer._to_device`, and runs `make_single_steps`'s train step at
`Trainer._current_lr()` with the Trainer's generator; the loader restarts
each epoch and the epoch's mean loss is read once, the Trainer's one sync
an epoch. Set-up writes the mix's tiles, builds the model with the seed's
weights, and runs one whole epoch, which fills the loader's decode cache
(a real run's later epochs hit it); its first three steps, read by a hook
on the loop, are the ones the check follows.

The mix's file gives `tiles` (the train set's size), `cells_per_tile`,
`profile_steps` (the traced sub-window) and `check_steps`."""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

from perfbench import faults
from perfbench.core import tiles
from perfbench.core.trace import no_span
from perfbench.loops import program

FAULTS = {"unchanged": faults.unchanged,
          "half_batch": faults.half_batch}


class State:
    pass


def setup(cell, seeds, device, workdir, fault=None):
    from unet_torch_tpu_torch.data.loader import NumpyLoader
    from unet_torch_tpu_torch.train.optim import make_optimizer
    from unet_torch_tpu_torch.train.steps import make_single_steps
    from unet_torch_tpu_torch.train.trainer import Trainer

    mix = cell["traffic_spec"]
    s = State()
    s.cell, s.seeds, s.device = cell, seeds, device
    s.train_dir = os.path.join(workdir, "train")
    empty = os.path.join(workdir, "empty")
    os.makedirs(empty, exist_ok=True)
    s.cfg = cfg = program.config(cell, s.train_dir, empty)
    size = cfg.model.input_size[0]
    t0 = time.perf_counter()
    tiles.write_tiles(s.train_dir, seeds["data"], mix["tiles"], size,
                      mix["cells_per_tile"], cfg.model.num_class)
    t1 = time.perf_counter()
    train_ds, model, dtype = program.build(cfg, seeds["program"],
                                           seeds["weights"], device)
    t2 = time.perf_counter()
    t = cfg.train
    loader = NumpyLoader(train_ds, t.batch_size, shuffle=True,
                         seed=seeds["program"], num_workers=t.num_workers)
    s.trainer = Trainer(
        model, cfg.model.model_type, os.path.join(workdir, "run"),
        {"train": loader, "val": []}, t.batch_size, t.optimizer, t.lr_rate,
        t.weight_decay, patience=t.early_stop, num_epochs=t.epochs,
        loss_function=t.loss, accuracy_metric=t.accuracy,
        num_classes=cfg.model.num_class, lr_scheduler=t.adaptive_lr,
        seed=seeds["program"], fused_head=cfg.model.fused_head,
        device=device, dtype=dtype)
    tr = s.trainer
    s.net = tr.net(tr.model)
    s.opt = make_optimizer(tr.optimizer_name, tr.model.parameters(),
                           tr.base_lr, tr.weight_decay)
    s.train_step, _ = make_single_steps(
        tr.loss_function, tr.accuracy_metric, tr.num_classes,
        relu_output=tr.relu_output, fused_head=tr.fused_head,
        group=tr.group)
    if fault is not None:
        s.train_step = fault(s.train_step)
    s.batch = t.batch_size
    if len(loader) < mix["check_steps"]:
        raise ValueError("the set-up epoch is shorter than the steps the "
                         "check follows")
    s.names = [n for n, _ in tr.model.named_parameters()]
    s.epoch_losses, s.epoch_marks = [], []
    hook = CheckSteps(s, mix["check_steps"])
    _loop(s, float("inf"), no_span, max_steps=len(loader), hook=hook)
    hook.finish()
    print(f"set-up (s): tiles {t1 - t0:.2f}, model and weights "
          f"{t2 - t1:.2f}, first epoch {time.perf_counter() - t2:.2f}",
          file=sys.stderr)
    return s


def _opt_grad(opt, p):
    """The first gradient as the optimizer took it, from its state after
    one step: Adam's first moment over (1 - beta1), SGD's momentum
    buffer; None where the optimizer holds no state for p."""
    st = opt.state.get(p, {})
    if "exp_avg" in st:
        return st["exp_avg"] / (1.0 - opt.param_groups[0]["betas"][0])
    return st.get("momentum_buffer")


def _norms(tensors, device):
    """Each tensor's norm (NaN for None), stacked on `device`."""
    nan = torch.full((), float("nan"), device=device)
    return torch.stack([nan if t is None else torch.linalg.vector_norm(
        t.float()) for t in tensors])


class CheckSteps:
    """The loop's hook in set-up: keeps the first `n` steps' host batches
    and losses, the first gradient's norms by leaf after step 1 and the
    change's after step n."""

    def __init__(self, s, n: int):
        self.s, self.n = s, n
        self.params = list(s.trainer.model.parameters())
        self.start = [p.detach().clone() for p in self.params]
        s.check_batches, s.check_losses = [], []

    def __call__(self, i, batch, loss):
        s = self.s
        if i < self.n:
            s.check_batches.append((batch[0], batch[1]))
            s.check_losses.append(loss)
        if i == 0:
            s.grad_norms = _norms([_opt_grad(s.opt, p) for p in self.params],
                                  s.device)
        if i == self.n - 1:
            s.change_norms = _norms([p.detach() - p0 for p, p0 in
                                     zip(self.params, self.start)], s.device)
            self.start = None

    def finish(self):
        s = self.s
        s.check_losses = [float(v) for v in s.check_losses]
        s.grad_norms = s.grad_norms.cpu().tolist()
        s.change_norms = s.change_norms.cpu().tolist()


def _timed(counter, key):
    @contextlib.contextmanager
    def cm():
        t = time.perf_counter()
        yield
        counter[key] += time.perf_counter() - t
    return cm


def _loop(s, until, span, host=None, max_steps=None, events=None,
          hook=None):
    """Steps until the host clock passes `until` (or `max_steps`); each
    epoch's loader restarted and its mean loss read; `hook(step, batch,
    loss)` after each step. Returns the steps."""
    from unet_torch_tpu_torch.train.trainer import _mean

    tr = s.trainer
    none = contextlib.nullcontext
    wait = _timed(host, "data_wait_s") if host is not None else none
    disp = _timed(host, "dispatch_s") if host is not None else none
    steps = 0
    while True:
        losses = []
        it = iter(tr.dataloader["train"])
        done = False
        while not done:
            if time.perf_counter() >= until or steps == max_steps:
                done = True
                break
            with wait(), span("loader.next"):
                batch = next(it, None)
            if batch is None:
                break
            with disp():
                with span("trainer.to_device"):
                    x, y = tr._to_device(*batch[:2])
                with span("step"):
                    losses.append(s.train_step(
                        s.net, s.opt, x, y, tr._current_lr(), tr.generator))
            tr.iter_num += 1
            if hook is not None:
                hook(steps, batch, losses[-1])
            steps += 1
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        it.close()
        if losses:
            s.epoch_losses.append(_mean(losses))
            s.epoch_marks.append((time.perf_counter(), len(losses)))
        if done:
            return steps


def window(s, seconds: float, timed: bool):
    """The measured window: counts, and with `timed` the host's time
    waiting on the loader and dispatching."""
    cuda = s.device.type == "cuda"
    host = {"data_wait_s": 0.0, "dispatch_s": 0.0} if timed else None
    events = [] if cuda else None
    if cuda:
        torch.cuda.synchronize(s.device)
        first = torch.cuda.Event(enable_timing=True)
        first.record()
        events.append(first)
    t0 = time.perf_counter()
    s.epoch_marks = [(t0, 0)]
    steps = _loop(s, t0 + seconds, no_span, host, events=events)
    if cuda:
        torch.cuda.synchronize(s.device)
    t1 = time.perf_counter()
    intervals = ([a.elapsed_time(b) for a, b in zip(events, events[1:])]
                 if cuda else [])
    marks = s.epoch_marks
    print("window epochs (s, img/s): " + " ".join(
        f"{b[0] - a[0]:.2f},{b[1] * s.batch / (b[0] - a[0]):.1f}"
        for a, b in zip(marks, marks[1:])), file=sys.stderr)
    out = {"seconds": t1 - t0, "steps": steps, "images": steps * s.batch,
           "step_ms": intervals, "epochs": len(s.epoch_losses) - 1}
    if host is not None:
        out.update(host)
    return out


def profile(s, span):
    """The traced sub-window: the mix's `profile_steps` steps, each call
    into a layer inside a named span. Returns the units profiled."""
    n = s.cell["traffic_spec"]["profile_steps"]
    steps = _loop(s, float("inf"), span, max_steps=n)
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    return steps


def program_outputs(s):
    """What the check judges: the first steps' host batches and losses,
    the first gradient's and the change's norms by leaf, and every
    epoch's mean loss."""
    return {"batches": s.check_batches, "losses": s.check_losses,
            "grad_norms": s.grad_norms, "change_norms": s.change_norms,
            "names": s.names, "epoch_losses": s.epoch_losses}


def release(s):
    for k in ("trainer", "net", "opt", "train_step"):
        setattr(s, k, None)
