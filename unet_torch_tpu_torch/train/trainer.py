"""The epoch loops (counterpart of unet_torch_tpu/train/trainer.py).

`Trainer.train` dispatches as the JAX trainer does: `single`, `TransUnet`,
`regression` and `regression_t` (ReLU on the logits) and `attention` run
`single_train`; `multi_task`, `multi_task_reg` and `multi_task_regTU` run
the two-head loop as `multi_task_train` (sum), `multi_task_uc_train` (loss
`multi_task_loss`: learned uncertainty weights, a fresh Adam at 5e-4
without weight decay) or `multi_task_train_ratio` (loss
`multi_task_loss_ratio`: plateau LR unless the poly LR is on, the ratio
term and validation from epoch 6). The run artifacts are the reference's:

  * append-only `logs.txt`
  * checkpoints `models/epoch{N}.pt` and `models/best.pt` when the val score
    improves, `models/last_epoch.pt` after every train phase (torch
    state_dicts, ckpt.save_weights; an uncertainty run's hold `log_vars`)
  * per-iteration poly LR decay when `adaptive_lr`
  * early stopping after `patience` epochs without improvement; `dice_score`
    and `dice_score_mc` are higher-better (the reference's comparison, which
    never saves for them, is not copied)
  * the best weights restored at the end
  * the loss and accuracy curves as `total.png`, and the two heads' as
    `bce.png` and `mse.png`, with `plot=True` (matplotlib, imported there)

The batches reach the device by non_blocking copies from pinned memory, and
the step's losses stay on the device: the loop reads them once per epoch.
Dropout draws from a generator on the device, seeded from `seed`.

The single-head model types under a topological loss name
(`TOPO_LOSS_NAMES`) run `single_train_wup`, the warm-up loop: `dice_bce`
through epoch 5, then the topo loss against (labels, dot map) through
`TopoPipeline`, validation scored by the mean relative count error
(`mr_accuracy`) and a best model only after epoch 10.

`CLTR` runs train/cltr_loop.py::cltr_train_loop on this trainer. Any other
model type, `multitask_em` among them, has no loop, as in the JAX package.

Several ranks (`mesh`, core/mesh.py): the model takes its place in the
layout (parallel/tensor.py::parallelize: its transformer projections
sharded over the model ranks, its BatchNorms synchronised over the data
ranks) and each loop trains it through DistributedDataParallel over the
data group (`broadcast_buffers=False`: SyncBatchNorm2d keeps the buffers
equal); each rank's loader yields its share of the batch. Validation runs
on every rank on the whole validation set, and rank 0's val loss and
score decide for all, so that every rank saves, stops and restores alike.
Only rank 0 writes `logs.txt`, the checkpoints (the full, unsharded state
dict, `gather_state_tp`, which every rank joins) and the plots.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from unet_torch_tpu_torch import ckpt
from unet_torch_tpu_torch.core import not_ported
from unet_torch_tpu_torch.core.dist import broadcast_value, is_main
from unet_torch_tpu_torch.core.mesh import shard_batch
from unet_torch_tpu_torch.losses import TOPO_LOSSES
from unet_torch_tpu_torch.parallel import gather_state_tp, parallelize
from unet_torch_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    make_optimizer,
    poly_lr,
)
from unet_torch_tpu_torch.train.steps import (
    make_multitask_steps,
    make_single_steps,
    make_topo_steps,
)

# the reference trainer's warm-up dispatch names (a superset of the calc_loss
# keys)
TOPO_LOSS_NAMES = TOPO_LOSSES | {"TopoCount2", "TopoLoss2"}

_SINGLE_TYPES = ("single", "TransUnet", "regression", "regression_t",
                 "attention")
_MULTITASK_TYPES = ("multi_task", "multi_task_reg", "multi_task_regTU")
_LOOPS_NOT_PORTED = {**not_ported.MODEL_TYPES, **not_ported.LOSSES}


def _mean(values) -> float:
    """The mean of a list of 0-d device tensors, read on the host."""
    return torch.stack(values).mean().item()


class Trainer:
    def __init__(self, model, model_type, output_save_dir, dataloaders,
                 batch_size, optimizer_name, lr_rate, weight_decay, patience,
                 num_epochs, loss_function, accuracy_metric, num_classes,
                 lr_scheduler=None, start_epoch=1, seed=0, relu_output=None,
                 fused_head=False, topo_pair_downsample=1, device="cuda",
                 dtype=torch.float32, plot=False, mesh=None):
        self.mesh = mesh
        # the data group: the ranks that share this rank's model shard
        self.group = None if mesh is None else mesh.data_group
        self.model = parallelize(model.to(device), mesh)
        self.model_type = model_type
        self.output_save_dir = output_save_dir
        self.dataloader = dataloaders
        self.batch_size = batch_size
        self.patience = patience
        self.num_epochs = num_epochs
        self.loss_function = loss_function
        self.accuracy_metric = accuracy_metric
        self.num_classes = num_classes
        self.adaptive_lr = bool(lr_scheduler)
        self.start_epoch = start_epoch
        self.base_lr = lr_rate
        self._lr = lr_rate  # the plateau scheduler's, when poly LR is off
        self.optimizer_name = optimizer_name
        self.weight_decay = weight_decay
        self.device = torch.device(device)
        self.dtype = dtype
        self.plot = plot
        if relu_output is None:
            relu_output = model_type in ("regression", "regression_t")
        self.relu_output = relu_output
        self.fused_head = fused_head
        self.topo_pair_downsample = topo_pair_downsample
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.iter_num = 0
        self.max_iterations = num_epochs * max(1, len(dataloaders["train"]))
        self.best_loss = 1e15
        self.higher_better = accuracy_metric in ("dice_score", "dice_score_mc")
        self.best_val_score = -1e15 if self.higher_better else 1e15
        self.early_stop_counter = 0
        self.train_loss_list, self.val_loss_list = [], []
        self.val_score_list = []
        self.train_loss_list_1, self.val_loss_list_1 = [], []
        self.train_loss_list_2, self.val_loss_list_2 = [], []
        self.save_dir_model = os.path.join(output_save_dir, "models")
        os.makedirs(self.save_dir_model, exist_ok=True)
        self.best_state = None

    def _log(self, *lines):
        if not is_main():  # one rank owns logs.txt
            return
        with open(os.path.join(self.output_save_dir, "logs.txt"), "a") as f:
            for ln in lines:
                print(ln)
                f.write(str(ln) + "\n")

    def _current_lr(self):
        if self.adaptive_lr:
            return poly_lr(self.base_lr, self.iter_num, self.max_iterations)
        return self._lr

    def _device_mem(self) -> str:
        if self.device.type != "cuda":
            return "n/a"
        used = torch.cuda.max_memory_allocated(self.device) / 1e9
        total = torch.cuda.get_device_properties(self.device).total_memory
        return f"{used:.3g}G peak/{total / 1e9:.3g}G"

    def _to_device(self, *arrays):
        """numpy (x, y, ...) -> device tensors: x in the compute dtype, the
        others as given. From pinned memory without blocking the host on a
        card."""
        return shard_batch(arrays, self.device, self.dtype)

    def net(self, model):
        """The model the train steps drive: wrapped in
        DistributedDataParallel over the data group when there is one."""
        if self.group is None:
            return model
        from torch.nn.parallel import DistributedDataParallel

        ids = [self.device.index] if self.device.type == "cuda" else None
        return DistributedDataParallel(model, device_ids=ids,
                                       process_group=self.group,
                                       broadcast_buffers=False)

    def full_state(self) -> dict:
        """The model's full, unsharded state dict on the host; every rank
        must call it (it gathers the tensor-parallel shards)."""
        return {k: v.detach().cpu()
                for k, v in gather_state_tp(self.model, self.mesh).items()}

    def save_checkpoint(self, *names):
        """The full state dict as models/<name> for each name, written by
        rank 0; every rank must call it."""
        state = self.full_state()
        if is_main():
            for name in names:
                ckpt.save_state_dict(os.path.join(self.save_dir_model, name),
                                     state)

    def agree(self, *values):
        """Rank 0's val numbers, on every rank: the saving and stopping
        decisions are then the same on all."""
        return broadcast_value(values) if self.mesh is not None else values

    def _save_best(self, epoch):
        self.best_state = {k: v.detach().clone()
                           for k, v in self.model.state_dict().items()}
        self.save_checkpoint(f"epoch{epoch}.pt", "best.pt")

    def _restore_best(self):
        if self.best_state is not None:
            self.model.load_state_dict(self.best_state, strict=True)

    def plot_loss_functions(self, name):
        if (not self.plot or not is_main() or not self.train_loss_list
                or not self.val_loss_list):
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax1 = plt.subplots(figsize=(10, 5))
        ax1.set_xlabel("Epoch")
        ax1.set_ylabel("Loss", color="tab:blue")
        ax1.plot(np.arange(len(self.train_loss_list)), self.train_loss_list,
                 label="Train Loss", color="tab:blue", linestyle="-")
        ax1.plot(np.arange(len(self.val_loss_list)), self.val_loss_list,
                 label="Val Loss", color="tab:orange", linestyle="--")
        ax1.tick_params(axis="y", labelcolor="tab:blue")
        ax1.set_ylim(0, max(max(self.train_loss_list),
                            max(self.val_loss_list), 1.0))
        ax2 = ax1.twinx()
        ax2.set_ylabel("Accuracy", color="tab:red")
        ax2.plot(np.arange(len(self.val_score_list)), self.val_score_list,
                 label="Val Accuracy", color="tab:red", linestyle=":")
        ax2.tick_params(axis="y", labelcolor="tab:red")
        lines, labels = ax1.get_legend_handles_labels()
        lines2, labels2 = ax2.get_legend_handles_labels()
        ax1.legend(lines + lines2, labels + labels2, loc="center right")
        plt.title("Training Progress")
        plt.grid(True)
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_save_dir, f"{name}.png"))
        plt.close(fig)

        # the two heads' curves; the val lists may be shorter than the
        # train ones (the ratio loop appends none through epoch 5)
        for series_t, series_v, fname in (
                (self.train_loss_list_1, self.val_loss_list_1, "bce"),
                (self.train_loss_list_2, self.val_loss_list_2, "mse")):
            if series_t:
                plt.figure(figsize=(8, 4))
                plt.xlabel("epoch")
                plt.ylabel("loss")
                plt.plot(np.arange(len(series_t)), series_t,
                         label="train loss")
                plt.plot(np.arange(len(series_v)), series_v, label="val loss")
                plt.grid(True)
                plt.legend()
                plt.savefig(os.path.join(self.output_save_dir, f"{fname}.png"))
                plt.close()

    def train(self):
        """The JAX trainer's dispatch."""
        not_ported.check(_LOOPS_NOT_PORTED, "training loop for",
                         self.loss_function)
        not_ported.check(_LOOPS_NOT_PORTED, "training loop for",
                         self.model_type)
        if self.model_type in _SINGLE_TYPES:
            if self.loss_function in TOPO_LOSS_NAMES:
                return self.single_train_wup()
            return self.single_train()
        if self.model_type == "CLTR":
            from unet_torch_tpu_torch.train.cltr_loop import cltr_train_loop

            return cltr_train_loop(self)
        if self.model_type in _MULTITASK_TYPES:
            if self.loss_function == "multi_task_loss":
                return self.multi_task_uc_train()
            if self.loss_function == "multi_task_loss_ratio":
                return self.multi_task_train_ratio()
            return self.multi_task_train()
        raise ValueError(f'Invalid model_type "{self.model_type}"')

    def single_train(self):
        model = self.model
        net = self.net(model)
        opt = make_optimizer(self.optimizer_name, model.parameters(),
                             self.base_lr, self.weight_decay)
        train_step, eval_step = make_single_steps(
            self.loss_function, self.accuracy_metric, self.num_classes,
            relu_output=self.relu_output, fused_head=self.fused_head,
            group=self.group)

        totaltime = 0.0
        for epoch in range(self.start_epoch, self.num_epochs + 1):
            self._log(f"Epoch {epoch}/{self.num_epochs}", "-" * 10)
            since = time.time()
            self._log(f"LR {self._current_lr()}")
            losses = []
            for batch in self.dataloader["train"]:
                x, y = self._to_device(*batch[:2])
                losses.append(train_step(net, opt, x, y,
                                         self._current_lr(), self.generator))
                self.iter_num += 1
            epoch_loss = _mean(losses)  # one sync
            time_elapsed = time.time() - since
            totaltime += time_elapsed
            mean_epoch = totaltime / max(1, epoch - self.start_epoch + 1)
            self.train_loss_list.append(epoch_loss)
            self._log(
                "Training Time for this epoch: {:.0f}m {:.0f}s".format(
                    time_elapsed // 60, time_elapsed % 60),
                f"Train loss on epoch {epoch}: {epoch_loss}",
                "Current mean training time per epoch: {:.0f}m {:.0f}s".format(
                    mean_epoch // 60, mean_epoch % 60),
                f"device memory: {self._device_mem()}")
            self.save_checkpoint("last_epoch.pt")

            vlosses, vscores = [], []
            for batch in self.dataloader["val"]:
                x, y = self._to_device(*batch[:2])
                loss, score, _ = eval_step(model, x, y)
                vlosses.append(loss)
                vscores.append(score)
            val_loss, val_score = self.agree(_mean(vlosses), _mean(vscores))
            self.val_loss_list.append(val_loss)
            self.val_score_list.append(val_score)
            self._log(f"Val loss on epoch {epoch}: {val_loss}",
                      f"Val score on epoch {epoch}: {val_score}")

            improved = (val_score > self.best_val_score if self.higher_better
                        else val_score < self.best_val_score)
            if improved:
                self.early_stop_counter = 0
                self.best_val_score = val_score
                self.best_loss = val_loss
                self._log("saving best model")
                self._save_best(epoch)
            else:
                self.early_stop_counter += 1
            if self.early_stop_counter > self.patience:
                self._log("Early stopping",
                          f"Best val loss: {self.best_loss:4f}",
                          f"Best val score: {self.best_val_score:4f}")
                break
        else:
            self._log(f"Best val loss: {self.best_loss:4f}",
                      f"Best val score: {self.best_val_score:4f}")
        self.plot_loss_functions("total")
        self._restore_best()
        return self

    def single_train_wup(self):
        """The topo warm-up loop: epochs <= 5 train `dice_bce`, later ones
        the topo loss through a fresh `TopoPipeline` each epoch, drained at
        its end; batches are (x, labels, dot map). Validation: the loss of
        the phase's eval step and `mr_accuracy` of its output. The best
        model is saved only after epoch 10, on a lower val loss."""
        from unet_torch_tpu_torch.eval.metrics import mr_accuracy

        model = self.model
        net = self.net(model)
        opt = make_optimizer(self.optimizer_name, model.parameters(),
                             self.base_lr, self.weight_decay)
        (warm_step, warm_eval), (_, topo_eval), TopoPipeline = \
            make_topo_steps(self.loss_function, self.num_classes,
                            relu_output=self.relu_output,
                            fused_head=self.fused_head,
                            pair_downsample=self.topo_pair_downsample,
                            group=self.group)

        for epoch in range(self.start_epoch, self.num_epochs + 1):
            self._log(f"Epoch {epoch}/{self.num_epochs}", "-" * 10)
            since = time.time()
            topo_phase = epoch > 5
            pipe = TopoPipeline() if topo_phase else None
            step = pipe.step if topo_phase else warm_step
            eval_step = topo_eval if topo_phase else warm_eval

            self._log(f"LR {self._current_lr()}")
            losses = []
            for batch in self.dataloader["train"]:
                x, y, gt_dot = self._to_device(*batch)
                loss = step(net, opt, x, y, gt_dot, self._current_lr(),
                            self.generator)
                self.iter_num += 1
                if loss is not None:
                    losses.append(loss)
            if pipe is not None:
                losses.extend(pipe.flush(net, opt, self.generator))
            epoch_loss = _mean(losses)
            time_elapsed = time.time() - since
            self.train_loss_list.append(epoch_loss)
            self._log(f"Train loss on epoch {epoch}: {epoch_loss}",
                      "Training Time for this epoch: {:.0f}m {:.0f}s".format(
                          time_elapsed // 60, time_elapsed % 60))
            self.save_checkpoint("last_epoch.pt")

            vlosses, vscores = [], []
            for batch in self.dataloader["val"]:
                x, y, gt_dot = self._to_device(*batch)
                loss, out = eval_step(model, x, y, gt_dot)
                vlosses.append(loss)
                vscores.append(mr_accuracy(out.float().cpu().numpy(),
                                           np.asarray(batch[2])))
            val_loss, val_score = self.agree(
                _mean(vlosses), float(np.mean(vscores)) if vscores else 0.0)
            self.val_loss_list.append(val_loss)
            self.val_score_list.append(val_score)
            self._log(f"Val loss on epoch {epoch}: {val_loss}",
                      f"Val score on epoch {epoch}: {val_score}")

            if val_loss < self.best_loss and epoch > 10:
                self.early_stop_counter = 0
                self.best_val_score = val_score
                self.best_loss = val_loss
                self._log("saving best model")
                self._save_best(epoch)
            else:
                self.early_stop_counter += 1
            if self.early_stop_counter > self.patience:
                self._log("Early stopping")
                break
        self.plot_loss_functions("total")
        self._restore_best()
        return self

    def _multi_task_loop(self, combine: str, optimizer_name=None, lr=None):
        """The two-head loop; batches are (x, (y1, y2))."""
        model = self.model
        optimizer_name = optimizer_name or self.optimizer_name
        if lr is not None:
            self.base_lr = self._lr = lr
        if combine == "uncertainty":
            model.add_log_vars()
        net = self.net(model)
        opt = make_optimizer(optimizer_name, model.parameters(), self.base_lr,
                             0.0 if combine == "uncertainty"
                             else self.weight_decay)
        train_step, eval_step = make_multitask_steps(
            self.loss_function, self.num_classes, combine=combine,
            fused_head=self.fused_head, group=self.group)
        plateau = (ReduceLROnPlateau(self.base_lr) if combine == "ratio"
                   and not self.adaptive_lr else None)
        self.best_val_score = 1e15

        for epoch in range(self.start_epoch, self.num_epochs + 1):
            self._log(f"Epoch {epoch}/{self.num_epochs}", "-" * 10)
            since = time.time()
            use_ratio = torch.tensor(epoch > 5, device=self.device)

            self._log(f"LR {self._current_lr()}")
            losses, l1s, l2s = [], [], []
            for x, (y1, y2) in self.dataloader["train"]:
                x, y1, y2 = self._to_device(x, y1, y2)
                loss, l1, l2 = train_step(net, opt, x, y1, y2,
                                          self._current_lr(), self.generator,
                                          use_ratio)
                self.iter_num += 1
                losses.append(loss)
                l1s.append(l1)
                l2s.append(l2)
            epoch_loss = _mean(losses)  # the epoch's first sync
            self.train_loss_list.append(epoch_loss)
            self.train_loss_list_1.append(_mean(l1s))
            self.train_loss_list_2.append(_mean(l2s))
            if combine == "uncertainty":
                stds = torch.exp(model.log_vars.detach()) ** 0.5
                self._log(f"sigmas: {stds.tolist()}")
            time_elapsed = time.time() - since
            self._log(f"Train loss on epoch {epoch}: {epoch_loss}",
                      "Training Time for this epoch: {:.0f}m {:.0f}s".format(
                          time_elapsed // 60, time_elapsed % 60))
            self.save_checkpoint("last_epoch.pt")

            vlosses, v1s, v2s = [], [], []
            for x, (y1, y2) in self.dataloader["val"]:
                x, y1, y2 = self._to_device(x, y1, y2)
                loss, l1, l2, _, _ = eval_step(model, x, y1, y2, use_ratio)
                vlosses.append(loss)
                v1s.append(l1)
                v2s.append(l2)
            (val_loss,) = self.agree(_mean(vlosses))
            if combine == "ratio" and epoch <= 5:
                continue  # the reference validates from epoch 6
            if plateau is not None:
                self._lr = plateau.step(val_loss)
            self.val_loss_list.append(val_loss)
            self.val_loss_list_1.append(_mean(v1s))
            self.val_loss_list_2.append(_mean(v2s))
            self.val_score_list.append(val_loss)
            self._log(f"Val loss on epoch {epoch}: {val_loss}")

            if val_loss < self.best_val_score:
                self.early_stop_counter = 0
                self.best_val_score = val_loss
                self.best_loss = val_loss
                self._log("saving best model")
                self._save_best(epoch)
            else:
                self.early_stop_counter += 1
            if self.early_stop_counter > self.patience:
                self._log("Early stopping")
                break
        self.plot_loss_functions("total")
        self._restore_best()
        return self

    def multi_task_train(self):
        return self._multi_task_loop("sum")

    def multi_task_uc_train(self):
        # a fresh Adam(5e-4) over the parameters and the log-variances
        return self._multi_task_loop("uncertainty", optimizer_name="Adam",
                                     lr=5e-4)

    def multi_task_train_ratio(self):
        return self._multi_task_loop("ratio")
