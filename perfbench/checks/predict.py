"""The eval cells' comparison: the reference's float32 logits of the sampled
batches' tiles, and the widest gap by which the logit of a class the
program served lies below the reference's best logit of that pixel.

Numbers: `class_gap`, the widest such gap over every pixel of the sampled
batches (0 where the program served the reference's best class)."""

from __future__ import annotations

import torch

from perfbench.checks import reference_model
from perfbench.reference.ops import Ops


def gaps(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Per pixel: the best logit less the logit of the served class."""
    served = torch.gather(logits, -1, classes.long().unsqueeze(-1))[..., 0]
    return logits.amax(-1) - served


def check(cell, seeds, outputs, device, workdir, control=None):
    """{number: value}. `control` ("fp8") serves the argmax of the
    reference computed in that precision in the program's place."""
    reference_model.no_tf32()
    model = reference_model.build(cell, seeds["weights"], device)
    pool, widest = outputs["pool"], 0.0
    if not outputs["samples"]:
        return {"class_gap": float("inf")}
    with torch.no_grad():
        for _, idx, classes in outputs["samples"]:
            x = torch.from_numpy(pool[idx]).to(device)
            ref = model(x, Ops("f32"))
            if control is not None:
                served = model(x, Ops(control)).argmax(-1)
            else:
                served = torch.from_numpy(classes).to(device)
            g = gaps(ref, served)
            g = torch.where(torch.isfinite(ref).all(-1), g, torch.inf)
            widest = max(widest, float(g.max()))
    return {"class_gap": widest}
