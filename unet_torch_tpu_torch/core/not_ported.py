"""What the port does not carry, and why.

One table per kind of name, shared by every entry point (model factories,
the eval and train CLIs, the trainer, `calc_loss`), so that each raises the
same NotImplementedError giving the same reason.
"""

from __future__ import annotations

# every model type of the JAX package builds
MODEL_TYPES: dict = {}

# every loss name of the JAX package runs (the topo ones since queue 1 item 12)
LOSSES: dict = {}

# training options of the JAX CLI and trainer
TRAIN_OPTIONS = {
    "random_crop": (
        "the JAX package's own random_crop path fails: DataRandomCrop "
        "yields (image, label, dot map) batches and (tiles, 256, 256, 3) "
        "val stacks, which Trainer.single_train's (x, y) loops cannot "
        "unpack, and its CLI builds the model at input_size, not at the "
        "256 crop (ROADMAP.md queue 3, faults of the reference)"),
    "distributed": (
        "the port trains in one process on one device; multi-GPU data "
        "parallel (DDP) is ROADMAP.md item 13, and per-rank DDP would not "
        "match the JAX package, whose GSPMD step computes the Dice sums "
        "over the batch axis and the train-mode BatchNorm statistics over "
        "the global batch, where DDP gives a mean of per-shard ones"),
    "mesh": (
        "the port trains in one process on one device: a mesh of data > 1 "
        "is ROADMAP.md item 13's DDP (per-rank DDP would not match the "
        "JAX package, whose GSPMD step computes the Dice sums and the "
        "train-mode BatchNorm statistics over the global batch), and "
        "model > 1, tensor parallelism of the transformer families, "
        "waits for that item too; mesh: {} and {data: 1, model: 1} train"),
}


def check(table: dict, kind: str, name: str) -> None:
    """Raise NotImplementedError if `name` is in `table`."""
    if name in table:
        raise NotImplementedError(f"{kind} {name!r} is not ported: "
                                  f"{table[name]}")
