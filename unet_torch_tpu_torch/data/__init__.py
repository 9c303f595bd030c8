from unet_torch_tpu_torch.data.datasets import (
    DataBinary,
    DataPointReg,
    DataRandomCrop,
    DataReg,
    DataRegBinary,
    DataRegMT,
)
from unet_torch_tpu_torch.data.io import (
    get_image_list,
    load_and_preprocess,
    natural_sort,
    z_normalize,
    zoom_resize,
)
from unet_torch_tpu_torch.data.loader import NumpyLoader
from unet_torch_tpu_torch.data.stain import MacenkoNormalizer, rgb2hed
