"""unet_torch_tpu_torch — the PyTorch and CUDA port of unet_torch_tpu, for one
NVIDIA H100.

The JAX package `unet_torch_tpu` is the reference: each module here keeps the
name and place of its counterpart there, and its public functions keep the
JAX layouts (NHWC activations, HWIO conv weights) so that the two can be
compared on the same inputs. Inside, tensors are NCHW in channels_last
memory. Every Pallas kernel of the JAX package becomes a hand-written Hopper
kernel beside a plain PyTorch version, which is both its CPU path and its
oracle.

Ported so far (the UNet eval slice):
core      device resolution, precision policy, seeding
kernels   fused conv3x3 + folded BN + ReLU (CUDA, sm_90a), and its build
nn        DoubleConv / Down / Up / OutConv with the reference's state_dict names
models    UNet and build_model
ckpt      torch state_dict loading, and the bridge from the JAX package's trees
eval      class_argmax, make_predict_fn, test_single_mc
cli       the eval CLI (python -m unet_torch_tpu_torch.cli.test_cli)

Framework-free modules of the JAX package (data io, synthetic data, matching,
the Results report classes, the config loader) are imported as they are.
"""
