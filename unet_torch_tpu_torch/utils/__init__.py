"""Logging and debugging helpers (counterpart of unet_torch_tpu/utils)."""

from unet_torch_tpu_torch.utils.debug import (  # noqa: F401
    check_input,
    profile_trace,
)
from unet_torch_tpu_torch.utils.logger import (  # noqa: F401
    MetricLogger,
    SmoothedValue,
)
