"""The plain reference: the models, the loss, the optimizers and the data
path in plain PyTorch and NumPy, float32 with TF32 off. It imports nothing
of the program. `ops.Ops` computes every product in float32, or with its
operands rounded to float8 (e4m3) for the control."""
