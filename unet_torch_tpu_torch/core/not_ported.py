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
}


def check(table: dict, kind: str, name: str) -> None:
    """Raise NotImplementedError if `name` is in `table`."""
    if name in table:
        raise NotImplementedError(f"{kind} {name!r} is not ported: "
                                  f"{table[name]}")
