"""The single-head and the two-head train and eval steps (counterpart of
unet_torch_tpu/train/steps.py::make_single_steps and ::make_multitask_steps).

The JAX package threads a TrainState (params, batch_stats, opt_state, step)
through jit-compiled pure functions (train/state.py). The port has no such
object: the state is the model (parameters and BN buffers, updated in
place), the optimizer (its moments) and the trainer's step count.

`train_step(model, opt, x, y, lr, generator)` sets the LR on every param
group, binds `generator` to the model's dropouts, runs forward, loss,
backward and the optimizer step, and returns the loss as a 0-d device tensor
without syncing to the host. `eval_step(model, x, y)` returns (loss, score,
logits) under `no_grad`. x is NHWC in the compute dtype; the loss is f32.

The two-head steps take (y1, y2) and a `use_ratio` flag, a 0-d bool tensor on
the device, and return the combined loss and both head losses, all on the
device.

The topo warm-up loop's steps (`make_topo_steps`) take the batch's dot map
too; their topo phase pairs on the host (losses/topo.py), so it syncs once a
step, or, through `TopoPipeline`, pairs batch k in a worker thread while the
device updates batch k - 2.

Data-parallel training: the factories take `group`, the data group of a
rank that holds a share of the batch (core/mesh.py), and the train steps
take the model wrapped in DistributedDataParallel over it. The train loss
is then formed over the whole batch where it is not a mean of per-image
terms (losses/functional.py; the two-head `ratio` combine, a product of
two batch means), and the returned losses are the means over
the group: the one-process step's. The eval steps run on every rank on
the whole validation batch, with no group. A tensor-parallel model's
replicated gradients are averaged over its model group after each backward
(parallel/tensor.py::average_replicated_grads). Under a spatial mesh a rank
holds a strip of its batch rows: the group is then the world group
(`mesh.world_group`), which DistributedDataParallel and the loss's sums
span (parallel/spatial.py).
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from unet_torch_tpu_torch.core.dist import all_reduce_sum, group_mean
from unet_torch_tpu_torch.losses import get_loss_fn
from unet_torch_tpu_torch.losses.topo import (
    compute_pairing,
    compute_pairing_windows,
    downsample_max,
    effective_window,
    topo_loss_from_pairing,
    topocount_loss_from_pairing,
    window_dot_counts,
)
from unet_torch_tpu_torch.nn.dropout import set_dropout_generator
from unet_torch_tpu_torch.parallel import average_replicated_grads
from unet_torch_tpu_torch.train.optim import clip_gradients


def _warn_fused_head(fused_head: bool) -> None:
    if fused_head:
        warnings.warn("fused_head=True is a TPU option of the JAX package; "
                      "the port ignores it", stacklevel=3)


def unwrap(model):
    """The module inside a DistributedDataParallel, or the model itself."""
    return getattr(model, "module", model)


def make_single_steps(loss_type: str, accuracy_metric: str, num_classes: int,
                      relu_output: bool = False, fused_head: bool = False,
                      group=None):
    """Steps for the single-head loop. `relu_output` (the `regression` model
    types) applies ReLU to the logits before the loss. `fused_head` is the
    JAX package's TPU layout of the loss and is ignored. `group`: the data
    group (module docstring)."""
    _warn_fused_head(fused_head)
    train_loss_fn = get_loss_fn(loss_type, num_classes, group=group)
    loss_fn = get_loss_fn(loss_type, num_classes)
    score_fn = get_loss_fn(accuracy_metric, num_classes)

    def head(out):
        return F.relu(out) if relu_output else out

    def train_step(model, opt, x, y, lr, generator):
        model.train()
        set_dropout_generator(model, generator)
        for param_group in opt.param_groups:
            param_group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss = train_loss_fn(head(model(x)), y)
        loss.backward()
        average_replicated_grads(model)
        clip_gradients(opt)
        opt.step()
        return group_mean(loss.detach(), group)

    def eval_step(model, x, y):
        model.eval()
        with torch.no_grad():
            out = model(x)
            return loss_fn(head(out), y), score_fn(head(out), y), out

    return train_step, eval_step


def make_multitask_steps(loss_type: str, num_classes: int,
                         combine: str = "sum", fused_head: bool = False,
                         group=None):
    """Steps for the two-head loops. Both heads pass through ReLU before the
    loss. The per-head loss is `loss_type` for `combine="sum"` and fixed
    `mse` for `"uncertainty"` and `"ratio"`.

    `"uncertainty"` reads the model's `log_vars`, a (2,) parameter that
    rides the same optimizer (UNetMultitask.add_log_vars):
    sum_i l_i / (2 sigma_i^2) + log sigma_i. `"ratio"` multiplies l1 + l2 by
    1 + 10 * mean |ratio_gt - ratio_pred| of the per-image count sums once
    `use_ratio` is true; a batch image whose two counts are both zero gives
    0/0 = NaN there, as in the JAX package. `group`: the data group
    (module docstring)."""
    if combine not in ("sum", "uncertainty", "ratio"):
        raise ValueError(f"Invalid combine {combine!r}")
    _warn_fused_head(fused_head)
    name = loss_type if combine == "sum" else "mse"
    eval_head_loss = get_loss_fn(name, num_classes)
    train_head_loss = get_loss_fn(name, num_classes, group=group)

    def combined(model, o1, o2, y1, y2, use_ratio, head_loss=eval_head_loss,
                 group=None):
        l1, l2 = head_loss(o1, y1), head_loss(o2, y2)
        if combine == "uncertainty":
            stds = torch.exp(unwrap(model).log_vars) ** 0.5
            coeff = 1.0 / (2.0 * stds ** 2)
            loss = (coeff[0] * l1 + torch.log(stds[0])
                    + coeff[1] * l2 + torch.log(stds[1]))
        elif combine == "ratio":
            c1_gt, c2_gt = (torch.sum(y.float(), dim=(1, 2)) for y in (y1, y2))
            c1_pr, c2_pr = (torch.sum(o[..., 0].float(), dim=(1, 2))
                            for o in (o1, o2))
            ratio_acc = torch.mean(torch.abs(c1_gt / (c1_gt + c2_gt)
                                             - c1_pr / (c1_pr + c2_pr)))
            if group is not None:
                # a product of two means over the batch: both the whole
                # batch's (the ranks' shares are equal)
                l1, l2, ratio_acc = all_reduce_sum(torch.stack(
                    [l1, l2, ratio_acc]), group) / dist.get_world_size(group)
            loss = torch.where(use_ratio,
                               (l1 + l2) * (1.0 + 10.0 * ratio_acc), l1 + l2)
        else:
            loss = l1 + l2
        return loss, l1, l2

    def train_step(model, opt, x, y1, y2, lr, generator, use_ratio):
        model.train()
        set_dropout_generator(model, generator)
        for param_group in opt.param_groups:
            param_group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        o1, o2 = model(x)
        loss, l1, l2 = combined(model, F.relu(o1), F.relu(o2), y1, y2,
                                use_ratio, train_head_loss, group)
        loss.backward()
        average_replicated_grads(model)
        clip_gradients(opt)
        opt.step()
        return tuple(group_mean(torch.stack([loss.detach(), l1.detach(),
                                             l2.detach()]), group))

    def eval_step(model, x, y1, y2, use_ratio):
        model.eval()
        with torch.no_grad():
            o1, o2 = model(x)
            o1, o2 = F.relu(o1), F.relu(o2)
            return (*combined(model, o1, o2, y1, y2, use_ratio), o1, o2)

    return train_step, eval_step


@contextlib.contextmanager
def buffers_kept(model):
    """Within it the model may run train-mode forwards: on exit every buffer
    (BN running means and variances, batch counts) holds, bit for bit, what
    it held on entry. The JAX package's forwards return the batch-stat
    updates, which its pairing forwards discard."""
    saved = [(b, b.clone()) for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


def _lap(split, name, since, device):
    """With a `split` dict: wait for the device, add the seconds since
    `since` to split[name] and return the time now; without one: nothing."""
    if split is None:
        return since
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    split[name] = split.get(name, 0.0) + now - since
    return now


def make_topo_steps(loss_type: str, num_classes: int,
                    relu_output: bool = False, max_bars: int = 64,
                    fused_head: bool = False, pair_downsample: int = 1,
                    window: int = 64, bars_per_window: int = 8, group=None):
    """Steps of the topo warm-up loop (counterpart of the JAX package's
    make_topo_steps): `(warm_step, warm_eval), (topo_step, topo_eval),
    TopoPipeline`.

    The warm-up steps train and score `dice_bce`. The topo steps pair the
    likelihood of a train-mode forward on the host, then differentiate the
    loss gathered at the paired pixels through a second forward with the
    same dropout masks (the step generator's state replayed). The pairing
    forward leaves the BN buffers as they were (`buffers_kept`), as JAX
    discards its batch-stat updates. `loss_type="TopoCount"` pairs each
    `window`² window against its own dot count (the window clamped by
    `effective_window`), every other name the whole map against the dot
    map's sum. `pair_downsample=ds` pairs the ds x ds max-pooled map, and
    the loss gathers from the same pooled map on the device.

    The serial `topo_step` copies the pooled logits to the host and forms
    the likelihood there in numpy (in f32), as the JAX package's serial step
    does; `TopoPipeline` forms it on the device, as JAX's pipeline does:
    keeping each where JAX has it keeps the tie order of the two
    frameworks' sigmoids apart only where JAX's are apart too. `topo_eval`
    runs the pairing forward with a generator seeded with 0 (JAX's fixed
    key 0) and returns that train-mode output. `fused_head` is the JAX
    package's TPU layout of the warm-up loss and is ignored. `group`: the
    data group (module docstring); every loss of this loop is a mean over
    the images, so it only averages the reported losses."""
    _warn_fused_head(fused_head)
    ds = int(pair_downsample)
    localized = loss_type == "TopoCount"
    warm_loss = get_loss_fn("dice_bce", num_classes)

    def head(out):
        return F.relu(out) if relu_output else out

    def _train_mode(model, opt, lr, generator):
        model.train()
        set_dropout_generator(model, generator)
        for param_group in opt.param_groups:
            param_group["lr"] = lr
        opt.zero_grad(set_to_none=True)

    def _finish(model, opt, loss):
        loss.backward()
        average_replicated_grads(model)
        clip_gradients(opt)
        opt.step()
        return group_mean(loss.detach(), group)

    # ---- warm-up phase: the dice_bce step
    def warm_step(model, opt, x, y, gt_dot, lr, generator):
        _train_mode(model, opt, lr, generator)
        return _finish(model, opt, warm_loss(head(model(x)), y))

    def warm_eval(model, x, y, gt_dot):
        model.eval()
        with torch.no_grad():
            out = head(model(x))
            return warm_loss(out, y), out

    # ---- topo phase
    def _forward_kept(model, x, generator):
        """The train-mode forward without autograd, the buffers kept."""
        model.train()
        set_dropout_generator(model, generator)
        with torch.no_grad(), buffers_kept(model):
            return head(model(x))

    def _pooled_logits(out):
        logits = out[..., 0] if out.dim() == 4 else out
        return downsample_max(logits.float(), ds)

    def _eff_window(h_pooled, w_pooled):
        return effective_window(h_pooled, w_pooled, window)

    def _kgt_of(gt_dot):
        if localized:
            eff = _eff_window(gt_dot.shape[1] // ds, gt_dot.shape[2] // ds)
            return window_dot_counts(gt_dot, eff * ds).to(torch.int32)
        return gt_dot.sum(dim=(1, 2)).to(torch.int32)

    def _loss_from_pairing(out, births, deaths, nbars, kgt):
        plog = _pooled_logits(out)
        if localized:
            return topocount_loss_from_pairing(plog, births, deaths, nbars,
                                               kgt, bars_per_window)
        return topo_loss_from_pairing(plog, births, deaths, nbars, kgt,
                                      max_bars)

    def _pair_np(lik, kgt):
        """Host pairing on a concrete (already pooled) likelihood + counts."""
        if localized:
            eff = _eff_window(lik.shape[1], lik.shape[2])
            return compute_pairing_windows(lik, kgt, eff, bars_per_window)
        return compute_pairing(lik, None, max_bars, kgt_override=kgt)

    def _pack(births, deaths, nbars, kgt):
        """[births | deaths | nbars | kgt] as one int32 (B, n) array: one
        copy to the device."""
        def _2d(a):
            a = np.asarray(a, np.int32)
            return a[:, None] if a.ndim == 1 else a

        return np.concatenate(
            [_2d(births), _2d(deaths), _2d(nbars), _2d(kgt)], axis=1)

    def _unpack(packed, x):
        if localized:
            eff = _eff_window(x.shape[1] // ds, x.shape[2] // ds)
            nwin = (x.shape[1] // ds // eff) * (x.shape[2] // ds // eff)
            nwb = nwin * bars_per_window
            return (packed[:, :nwb], packed[:, nwb:2 * nwb],
                    packed[:, 2 * nwb:2 * nwb + nwin],
                    packed[:, 2 * nwb + nwin:])
        return (packed[:, :max_bars], packed[:, max_bars:2 * max_bars],
                packed[:, 2 * max_bars], packed[:, 2 * max_bars + 1])

    def _to_device(packed, device):
        t = torch.from_numpy(packed)
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def _update(model, opt, x, packed, lr, generator):
        """The differentiated half: forward, the loss at the paired pixels,
        backward, the optimizer step."""
        pairing = _unpack(packed, x)
        _train_mode(model, opt, lr, generator)
        return _finish(model, opt,
                       _loss_from_pairing(head(model(x)), *pairing))

    def _pairing(out, gt_dot, split=None, since=None):
        """Serial: the pooled logits and counts to the host, the likelihood
        formed there, then the pairing."""
        plog = _pooled_logits(out).cpu().numpy()
        kgt = _kgt_of(gt_dot).cpu().numpy()
        since = _lap(split, "d2h", since, out.device)
        lik = 1.0 / (1.0 + np.exp(-plog))
        pairing = _pair_np(lik, kgt)
        _lap(split, "pairing", since, out.device)
        return pairing

    def topo_step(model, opt, x, y, gt_dot, lr, generator, split=None):
        """One serial topo step; returns the loss (0-d, on the device).
        With `split`, a dict, the step waits for the device between its
        phases and adds each phase's seconds to it: "forward" (the pairing
        forward), "d2h", "pairing" (host likelihood and pairing) and
        "update" (indices to the device, forward, loss, backward, step)."""
        since = time.perf_counter()
        state = generator.get_state()
        out = _forward_kept(model, x, generator)
        since = _lap(split, "forward", since, x.device)
        packed = _pack(*_pairing(out, gt_dot, split, since))
        since = time.perf_counter()
        generator.set_state(state)
        loss = _update(model, opt, x, _to_device(packed, x.device), lr,
                       generator)
        _lap(split, "update", since, x.device)
        return loss

    def _lik_kgt(model, x, gt_dot, generator):
        # the pipeline's likelihood: the sigmoid on the device, in f32
        out = _forward_kept(model, x, generator)
        return torch.sigmoid(_pooled_logits(out)), _kgt_of(gt_dot)

    def _to_host_async(*tensors):
        """Copies into pinned host memory, not waited for, and the event
        that marks their end (None on the CPU)."""
        if tensors[0].device.type != "cuda":
            return tensors, None
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _pair_host(host, ready):
        # in the worker: wait for this batch's copies alone, then pair
        if ready is not None:
            ready.synchronize()
        lik, kgt = (t.numpy() for t in host)
        return _pack(*_pair_np(lik, kgt.astype(np.int64)))

    class TopoPipeline:
        """Software pipeline over the topo step: batch k's likelihood
        crosses to the host by a copy into pinned memory, and one worker
        thread pairs it (waiting on that copy's event alone; the native
        pairing releases the GIL) while the main thread updates batch
        k - depth and dispatches batch k + 1. Batch k's update replays its
        own generator state, so its dropout masks are its pairing
        forward's; its pairing indices come from parameters `depth`
        updates older, the JAX package's trade. Depth 2 and one worker
        (the pairing is CPU-bound), the JAX package's defaults and the
        only values it runs. Call `flush` at the end of an epoch."""

        depth = 2

        def __init__(self):
            self._pending = collections.deque()
            self._pool = ThreadPoolExecutor(max_workers=1)

        def step(self, model, opt, x, y, gt_dot, lr, generator):
            """Dispatch batch k; returns batch k - depth's loss, or None
            while the pipe fills."""
            state = generator.get_state()
            host, ready = _to_host_async(*_lik_kgt(model, x, gt_dot,
                                                   generator))
            self._pending.append(
                (x, lr, state, self._pool.submit(_pair_host, host, ready)))
            if len(self._pending) <= self.depth:
                return None
            return self._complete(model, opt, generator,
                                  self._pending.popleft())

        def flush(self, model, opt, generator):
            """Drain the pending batches; returns each one's loss, in
            order, so that every batch weighs alike in the epoch's mean."""
            losses = []
            while self._pending:
                losses.append(self._complete(model, opt, generator,
                                             self._pending.popleft()))
            self._pool.shutdown(wait=False)
            return losses

        def _complete(self, model, opt, generator, pending):
            x, lr, state, future = pending
            packed = future.result()
            now = generator.get_state()
            generator.set_state(state)
            loss = _update(model, opt, x, _to_device(packed, x.device), lr,
                           generator)
            generator.set_state(now)
            return loss

    def topo_eval(model, x, y, gt_dot):
        generator = torch.Generator(device=x.device).manual_seed(0)
        out = _forward_kept(model, x, generator)
        pairing = _pairing(out, gt_dot)
        with torch.no_grad():
            loss = _loss_from_pairing(
                out, *(torch.from_numpy(a).to(x.device) for a in pairing))
        return loss, out

    return (warm_step, warm_eval), (topo_step, topo_eval), TopoPipeline
