"""What the port does not have yet, and the ROADMAP.md item that brings it.

One table per kind of name, shared by every entry point (model factories,
the eval and train CLIs, the trainer, `calc_loss`), so that each raises the
same NotImplementedError naming the same item.
"""

from __future__ import annotations

MODEL_TYPES = {
    "regression_t": "queue 1 item 10",
    "multi_task_regTU": "queue 1 item 10",
    "multitask_em": "queue 1 item 10",
}

# every loss name of the JAX package runs (the topo ones since queue 1 item 12)
LOSSES: dict = {}

# training options of the JAX CLI and trainer
TRAIN_OPTIONS = {
    "random_crop": "queue 1 item 10",  # DataRandomCrop tiling
    "pretrained_npz": "queue 1 item 10",  # load_npz_into_params
}


def check(table: dict, kind: str, name: str) -> None:
    """Raise NotImplementedError if `name` is in `table`."""
    if name in table:
        raise NotImplementedError(f"{kind} {name!r} is not ported yet "
                                  f"(ROADMAP.md {table[name]})")
