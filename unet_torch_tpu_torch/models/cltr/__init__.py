from unet_torch_tpu_torch.models.cltr.backbone import (
    FrozenBatchNorm,
    ResNet50,
    backbone_freeze_mask,
)
from unet_torch_tpu_torch.models.cltr.criterion import (
    PostProcess,
    SetCriterion,
    build_weight_dict,
    pad_targets,
    sigmoid_focal_loss,
)
from unet_torch_tpu_torch.models.cltr.model import (
    ConditionalDETR,
    build_cltr,
    build_cltr_default,
    inverse_sigmoid,
)
from unet_torch_tpu_torch.models.cltr.position_encoding import (
    PositionEmbeddingLearned,
    gen_sineembed_for_position,
    sine_position_embedding,
)
from unet_torch_tpu_torch.models.cltr.transformer import Transformer
