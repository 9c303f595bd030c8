"""The CLTR training loop (counterpart of unet_torch_tpu/train/cltr_loop.py).

Train: the weighted sum over the criterion's loss dict, one `train_step` a
batch. Val: MAE and MRE of the count, by top-k sigmoid counting at threshold
0.35 over an image's tiled patches. Targets are padded to a bucketed largest
point count, so that a few shapes occur. The best checkpoint is the one with
the lowest val MAE; `last_epoch.pt` follows every train phase.

The trainer's optional attributes, set by the train CLI: `criterion` (else
built from the model), `cltr_fused_matcher` (True: the auction kernel;
False: scipy on the host) and `cltr_clip_max_norm` (0: off). The loop trains
the model as it is handed over: pretrained backbone weights and a resume
checkpoint are loaded by the caller, in that order (cli/train_cli.py).
Several ranks: the trainer's mesh places the model (train/trainer.py), the
loop steps it through DistributedDataParallel over the data group, each
rank matching its own images on the auction kernel with the point count
of the whole batch (models/cltr/criterion.py); validation runs on every
rank and rank 0's MAE and MRE decide.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from unet_torch_tpu_torch.models.cltr.criterion import (
    SetCriterion,
    build_weight_dict,
    pad_targets,
)
from unet_torch_tpu_torch.train.cltr_steps import infer_step, train_step
from unet_torch_tpu_torch.train.optim import make_optimizer


def _bucket(n: int, size: int = 32) -> int:
    return max(size, ((n + size - 1) // size) * size)


def cltr_collate(batch):
    """Flatten the per-image patch lists: (images (B, H, W, C), targets)."""
    imgs, targets = [], []
    for item in batch:
        imgs.extend(item[0])
        targets.extend(item[1])
    return np.stack(imgs, 0), targets


def cltr_topk_count(pred_logits: np.ndarray, threshold: float = 0.35) -> int:
    """Flatten the sigmoid scores over (patches, queries, classes), keep the
    patches * queries highest, count those above `threshold`."""
    prob = 1.0 / (1.0 + np.exp(-pred_logits.reshape(-1)))
    k = pred_logits.shape[0] * pred_logits.shape[1]
    top = np.sort(prob)[::-1][:k]
    return int(np.sum(top > threshold))


def cltr_train_loop(trainer):
    """Runs on a Trainer whose model is a ConditionalDETR."""
    model = trainer.model
    criterion = getattr(trainer, "criterion", None)
    if criterion is None:
        criterion = SetCriterion(
            num_classes=2,
            weight_dict=build_weight_dict(dec_layers=model.dec_layers,
                                          aux_loss=model.aux_loss))
        trainer.criterion = criterion
    net = trainer.net(model)
    clip = float(getattr(trainer, "cltr_clip_max_norm", 0.0) or 0.0)
    opt = make_optimizer(trainer.optimizer_name, model.parameters(),
                         trainer.base_lr, trainer.weight_decay,
                         clip_max_norm=clip)
    matcher = ("auction" if getattr(trainer, "cltr_fused_matcher", True)
               else "scipy")
    # the attention kernels' mask seeds: drawn on the host
    seed_generator = torch.Generator().manual_seed(
        trainer.generator.initial_seed())

    for epoch in range(trainer.start_epoch, trainer.num_epochs + 1):
        trainer._log(f"Epoch {epoch}/{trainer.num_epochs}", "-" * 10)
        since = time.time()
        trainer._log(f"LR {trainer._current_lr()}")

        losses = []
        for imgs, targets in trainer.dataloader["train"]:
            max_pts = _bucket(max((len(t["labels"]) for t in targets),
                                  default=1))
            labels, points, _, valid = pad_targets(targets, max_pts,
                                                   model.channel_point)
            x, labels, points, valid = trainer._to_device(
                np.asarray(imgs, np.float32), labels, points, valid)
            loss, _ = train_step(net, criterion, opt, x, labels, points,
                                 valid, trainer._current_lr(),
                                 trainer.generator, seed_generator, matcher,
                                 trainer.group)
            trainer.iter_num += 1
            losses.append(loss)
        # the epoch's first read from the device
        epoch_loss = torch.stack(losses).mean().item() if losses else 0.0
        trainer.train_loss_list.append(epoch_loss)
        trainer._log(f"Train loss on epoch {epoch}: {epoch_loss}")
        trainer.save_checkpoint("last_epoch.pt")

        mae = mre = 0.0
        batch_step = 0
        for patches, gt_dots in trainer.dataloader["val"]:
            batch_step += 1
            p = np.asarray(patches, np.float32)
            if p.ndim == 5:  # a loader's batch dimension over the patches
                p = p[0]
            (x,) = trainer._to_device(p)
            logits, _ = infer_step(model, x)
            count = cltr_topk_count(logits.float().cpu().numpy())
            gt_count = float(np.sum(gt_dots))
            mae += abs(count - gt_count)
            mre += abs(count - gt_count) / max(gt_count, 1e-6)
        if batch_step:
            mae /= batch_step
            mre /= batch_step
        mae, mre = trainer.agree(mae, mre)
        trainer.val_loss_list.append(mae)
        trainer.val_score_list.append(mre)
        trainer._log(f"Val loss on epoch {epoch}: {mae}",
                     f"Val score on epoch {epoch}: {mre}")

        if mae < trainer.best_loss:
            trainer.early_stop_counter = 0
            trainer.best_loss = mae
            trainer.best_val_score = mre
            trainer._log("saving best model")
            trainer._save_best(epoch)
        else:
            trainer.early_stop_counter += 1
        if trainer.early_stop_counter > trainer.patience:
            trainer._log("Early stopping")
            break
        elapsed = time.time() - since
        trainer._log("{:.0f}m {:.0f}s".format(elapsed // 60, elapsed % 60))

    trainer.plot_loss_functions("total")
    trainer._restore_best()
    return trainer
