"""The CLTR train, inference and eval-loss steps (counterpart of
unet_torch_tpu/train/cltr_steps.py).

One train step: forward, the cost matrices of every decoder level under
`no_grad`, the assignment, the matched losses of the same forward, backward,
Adam. The JAX package has two forms of it, a fused one with the auction on
the device and a two-phase one that runs the forward twice around scipy on
the host, because its TPU runtime had no host callbacks. Here it is one
function with a `matcher`:

  "auction"  the auction kernel (kernels/auction.py), one launch for all
             levels and images; the step reads nothing back to the host
  "scipy"    the costs go to the host, scipy's linear_sum_assignment solves
             each (level, image), the matches come back

The state is the model (parameters and frozen-BN buffers), the optimizer and
the caller's step count, as in train/steps.py. Dropout masks come from
`generator` (on the activations' device); the attention kernels' mask seeds
from `seed_generator`, a host generator, so that drawing them waits for
nothing on the device.
"""

from __future__ import annotations

import torch

from unet_torch_tpu_torch.core.dist import group_mean
from unet_torch_tpu_torch.kernels.auction import auction_lsap_batched
from unet_torch_tpu_torch.models.cltr.transformer import (
    set_attention_seed_generator,
)
from unet_torch_tpu_torch.nn.dropout import set_dropout_generator
from unet_torch_tpu_torch.parallel import average_replicated_grads
from unet_torch_tpu_torch.train.optim import clip_gradients

MATCHERS = ("auction", "scipy")


@torch.no_grad()
def match_targets(criterion, outputs, tgt_labels, tgt_points, tgt_valid,
                  matcher: str = "auction"):
    """match_src (L, B, T) int64 on the outputs' device: the query of each
    target slot at each decoder level."""
    if matcher not in MATCHERS:
        raise ValueError(f"matcher must be one of {MATCHERS}, got "
                         f"{matcher!r}")
    costs = criterion.all_cost_matrices(outputs, tgt_labels, tgt_points,
                                        tgt_valid)  # (L, B, Q, T)
    if matcher == "auction":
        valid_lbt = tgt_valid[None].expand(costs.shape[0], -1, -1)
        return auction_lsap_batched(costs.float(), valid_lbt).long()
    match = criterion.hungarian(costs.cpu().numpy(),
                                tgt_valid.sum(dim=1).cpu().numpy())
    return torch.from_numpy(match).to(costs.device).long()


def train_step(model, criterion, opt, x, tgt_labels, tgt_points, tgt_valid,
               lr, generator, seed_generator, matcher: str = "auction",
               group=None):
    """One optimizer step; returns (loss, loss_dict) as 0-d device tensors,
    detached, without syncing to the host (with the auction matcher).

    With `group`, the data group of a rank holding a share of the batch (and
    `model` its DistributedDataParallel), the auction matches the rank's
    images, the point count is the whole batch's and the returned losses
    are the means over the group: the one-process step's."""
    model.train()
    set_dropout_generator(model, generator)
    set_attention_seed_generator(model, seed_generator)
    for param_group in opt.param_groups:
        param_group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    out = model(x)
    match_src = match_targets(criterion, out, tgt_labels, tgt_points,
                              tgt_valid, matcher)
    loss, loss_dict = criterion.losses(out, tgt_labels, tgt_points,
                                       tgt_valid, match_src, group)
    loss.backward()
    average_replicated_grads(model)
    clip_gradients(opt)
    opt.step()
    # one collective for the total and the dict
    means = group_mean(torch.stack([loss.detach(), *(
        v.detach().float() for v in loss_dict.values())]), group)
    return means[0], dict(zip(loss_dict, means[1:]))


@torch.no_grad()
def infer_step(model, x):
    """(pred_logits, pred_points) of the eval-mode forward."""
    model.eval()
    out = model(x)
    return out["pred_logits"], out["pred_points"]


@torch.no_grad()
def eval_loss(model, criterion, x, tgt_labels, tgt_points, tgt_valid,
              matcher: str = "auction"):
    """(loss, pred_logits): the dropout-free forward, the matching and the
    same weighted criterion as training."""
    model.eval()
    out = model(x)
    match_src = match_targets(criterion, out, tgt_labels, tgt_points,
                              tgt_valid, matcher)
    total, _ = criterion.losses(out, tgt_labels, tgt_points, tgt_valid,
                                match_src)
    return total, out["pred_logits"]
