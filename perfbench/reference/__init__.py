"""The plain reference: the models, the loss, the optimizers and the data
path in plain PyTorch and NumPy, float32 with TF32 off. It imports nothing
of the program. `ops.Ops` computes every product in float32, or with its
operands rounded to float8 (e4m3) for the control.

A configuration's file names its reference model's module here
(`"reference": "<module>"`). What core/flops.py::count and
checks/reference_model.py::build call of that module:
- `build(spec) -> torch.nn.Module`, `spec` the configuration's file as
  read; it is called on the meta device, so it allocates nothing and
  draws nothing, and core/weights.py gives it the seed's weights by name.
  Its state dict carries the port's names and shapes, so that one weight
  dict loads into both;
- `model(x, ops, train=...)`, `x` a float tensor of images in NHWC at
  `spec["model"]["img_size"]` square and `spec["model"]["in_channels"]`,
  every product through `ops` (an `ops.Ops`), and each call that a kernel
  of the port would make recorded with `ops.record`. It returns one tensor
  or a tuple, list or dict of them; `count` takes the backward through
  their sum. A module may take further keyword arguments of its own (the
  train check's dropout `generator`).
"""
