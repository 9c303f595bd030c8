"""The epoch loop (counterpart of unet_torch_tpu/train/trainer.py).

`Trainer.single_train` is the JAX package's loop for one-head models
(`single`, `TransUnet`, and `regression` with ReLU on the logits), with the
reference's run artifacts:

  * append-only `logs.txt`
  * checkpoints `models/epoch{N}.pt` and `models/best.pt` when the val score
    improves, `models/last_epoch.pt` after every train phase (torch
    state_dicts, ckpt.save_weights)
  * per-iteration poly LR decay when `adaptive_lr`
  * early stopping after `patience` epochs without improvement; `dice_score`
    and `dice_score_mc` are higher-better (the reference's comparison, which
    never saves for them, is not copied)
  * the best weights restored at the end
  * the loss and accuracy curves as `total.png`, with `plot=True`
    (matplotlib, imported there)

The batches reach the device by non_blocking copies from pinned memory, and
the step's losses stay on the device: the loop reads them once per epoch.
Dropout draws from a generator on the device, seeded from `seed`.

The other loops of the JAX trainer raise NotImplementedError naming their
ROADMAP.md item.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from unet_torch_tpu_torch import ckpt
from unet_torch_tpu_torch.core import not_ported
from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
from unet_torch_tpu_torch.train.steps import make_single_steps

_SINGLE_TYPES = ("single", "TransUnet", "regression")
_LOOPS_NOT_PORTED = {
    **not_ported.MODEL_TYPES,
    **{name: item for name, item in not_ported.LOSSES.items()
       if item == "queue 1 item 12"},
}


class Trainer:
    def __init__(self, model, model_type, output_save_dir, dataloaders,
                 batch_size, optimizer_name, lr_rate, weight_decay, patience,
                 num_epochs, loss_function, accuracy_metric, num_classes,
                 lr_scheduler=None, start_epoch=1, seed=0, relu_output=None,
                 fused_head=False, device="cuda", dtype=torch.float32,
                 plot=False):
        self.model = model.to(device)
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
        self.optimizer_name = optimizer_name
        self.weight_decay = weight_decay
        self.device = torch.device(device)
        self.dtype = dtype
        self.plot = plot
        if relu_output is None:
            relu_output = model_type == "regression"
        self.relu_output = relu_output
        self.fused_head = fused_head
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.iter_num = 0
        self.max_iterations = num_epochs * max(1, len(dataloaders["train"]))
        self.best_loss = 1e15
        self.higher_better = accuracy_metric in ("dice_score", "dice_score_mc")
        self.best_val_score = -1e15 if self.higher_better else 1e15
        self.early_stop_counter = 0
        self.train_loss_list, self.val_loss_list = [], []
        self.val_score_list = []
        self.save_dir_model = os.path.join(output_save_dir, "models")
        os.makedirs(self.save_dir_model, exist_ok=True)
        self.best_state = None

    def _log(self, *lines):
        with open(os.path.join(self.output_save_dir, "logs.txt"), "a") as f:
            for ln in lines:
                print(ln)
                f.write(str(ln) + "\n")

    def _current_lr(self):
        if self.adaptive_lr:
            return poly_lr(self.base_lr, self.iter_num, self.max_iterations)
        return self.base_lr

    def _device_mem(self) -> str:
        if self.device.type != "cuda":
            return "n/a"
        used = torch.cuda.max_memory_allocated(self.device) / 1e9
        total = torch.cuda.get_device_properties(self.device).total_memory
        return f"{used:.3g}G peak/{total / 1e9:.3g}G"

    def _to_device(self, batch):
        """(x, y) numpy -> device tensors: x in the compute dtype, y as
        given. From pinned memory without blocking the host on a card."""
        x, y = (torch.from_numpy(np.ascontiguousarray(a)) for a in batch[:2])
        if self.device.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
        x = x.to(self.device, non_blocking=True).to(self.dtype)
        return x, y.to(self.device, non_blocking=True)

    def _save_best(self, epoch):
        self.best_state = {k: v.detach().clone()
                           for k, v in self.model.state_dict().items()}
        for name in (f"epoch{epoch}.pt", "best.pt"):
            ckpt.save_weights(os.path.join(self.save_dir_model, name),
                              self.model)

    def _restore_best(self):
        if self.best_state is not None:
            self.model.load_state_dict(self.best_state, strict=True)

    def plot_loss_functions(self, name):
        if not self.plot or not self.train_loss_list or not self.val_loss_list:
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

    def train(self):
        """The JAX trainer's dispatch; only the single-head loop is
        ported."""
        not_ported.check(_LOOPS_NOT_PORTED, "training loop for",
                         self.loss_function)
        not_ported.check(_LOOPS_NOT_PORTED, "training loop for",
                         self.model_type)
        if self.model_type not in _SINGLE_TYPES:
            raise ValueError(f'Invalid model_type "{self.model_type}"')
        return self.single_train()

    def single_train(self):
        model = self.model
        opt = make_optimizer(self.optimizer_name, model.parameters(),
                             self.base_lr, self.weight_decay)
        train_step, eval_step = make_single_steps(
            self.loss_function, self.accuracy_metric, self.num_classes,
            relu_output=self.relu_output, fused_head=self.fused_head)

        totaltime = 0.0
        for epoch in range(self.start_epoch, self.num_epochs + 1):
            self._log(f"Epoch {epoch}/{self.num_epochs}", "-" * 10)
            since = time.time()
            self._log(f"LR {self._current_lr()}")
            losses = []
            for batch in self.dataloader["train"]:
                x, y = self._to_device(batch)
                losses.append(train_step(model, opt, x, y,
                                         self._current_lr(), self.generator))
                self.iter_num += 1
            epoch_loss = torch.stack(losses).mean().item()  # one sync
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
            ckpt.save_weights(os.path.join(self.save_dir_model,
                                           "last_epoch.pt"), model)

            vlosses, vscores = [], []
            for batch in self.dataloader["val"]:
                x, y = self._to_device(batch)
                loss, score, _ = eval_step(model, x, y)
                vlosses.append(loss)
                vscores.append(score)
            val_loss = torch.stack(vlosses).mean().item()
            val_score = torch.stack(vscores).mean().item()
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
