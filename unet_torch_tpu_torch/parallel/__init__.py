"""Parallel training of the port: Megatron tensor parallelism of the
transformer families (tensor.py) and the model's place in a (data, model)
layout (`parallelize`)."""

from unet_torch_tpu_torch.parallel.tensor import (  # noqa: F401
    average_replicated_grads,
    gather_state_tp,
    parallelize,
    shard_model_tp,
)
