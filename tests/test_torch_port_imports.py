"""The port imports no JAX: every module of unet_torch_tpu_torch loads in a
process where jax, flax and optax cannot be imported."""

import subprocess
import sys
from pathlib import Path

_CHECK = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax")

def blocked(name):
    return name.split(".")[0] in BLOCKED

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())

import unet_torch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    unet_torch_tpu_torch.__path__, "unet_torch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if blocked(m))
assert not loaded, loaded
print(len(names))
"""


# the modules chip_smoke.py drives on the card: they load nothing of the JAX
# package either (only the CLIs and the report side reuse its numpy code)
_MAIN_PATH = r"""
import sys
from unet_torch_tpu_torch import ckpt, losses
from unet_torch_tpu_torch.core.rng import seed_everything
from unet_torch_tpu_torch.eval.reports import make_predict_fn
from unet_torch_tpu_torch.kernels import attention, build, fused_conv
from unet_torch_tpu_torch.models.transunet import configs, resnetv2, vit
from unet_torch_tpu_torch.models.unet import build_model
from unet_torch_tpu_torch.nn import blocks, dropout
from unet_torch_tpu_torch.train import optim, steps, trainer
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "unet_torch_tpu"))
assert not loaded, loaded
"""

# the train CLI reads its config and datasets with the JAX package's
# framework-free modules: they load no JAX
_DATA_MODULES = r"""
import sys
from unet_torch_tpu.cli.config import Config
from unet_torch_tpu.data.datasets import DataBinary
from unet_torch_tpu.data.io import get_image_list
from unet_torch_tpu.data.loader import NumpyLoader
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax"))
assert not loaded, loaded
"""


def _run(code):
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_no_jax():
    # every module of the slice was imported
    assert int(_run(_CHECK).split()[-1]) >= 32


def test_main_path_imports_no_jax_package():
    _run(_MAIN_PATH)


def test_data_modules_import_no_jax():
    _run(_DATA_MODULES)
