"""The port imports no JAX and nothing of the JAX package: every module of
unet_torch_tpu_torch loads in a process where jax, flax, optax and
unet_torch_tpu cannot be imported."""

import subprocess
import sys
from pathlib import Path

_CHECK = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "unet_torch_tpu")

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


# the modules chip_smoke.py drives on the card
_MAIN_PATH = r"""
import sys
from unet_torch_tpu_torch import ckpt, losses
from unet_torch_tpu_torch.core.rng import seed_everything
from unet_torch_tpu_torch.eval.reports import make_predict_fn
from unet_torch_tpu_torch.cli.config import Config
from unet_torch_tpu_torch.kernels import attention, auction, build, fused_conv
from unet_torch_tpu_torch.kernels import minplus
from unet_torch_tpu_torch.models.cltr import backbone, box_ops, criterion
from unet_torch_tpu_torch.models.cltr import model, position_encoding
from unet_torch_tpu_torch.models.cltr import segmentation, transformer
from unet_torch_tpu_torch.models.transunet import configs, resnetv2, vit
from unet_torch_tpu_torch.models.unet import build_model
from unet_torch_tpu_torch.core import dist, mesh
from unet_torch_tpu_torch.nn import blocks, dropout, strips
from unet_torch_tpu_torch.parallel import pipeline, spatial
from unet_torch_tpu_torch.train import cltr_loop, cltr_steps, optim, steps
from unet_torch_tpu_torch.train import trainer
from unet_torch_tpu_torch.utils import debug, logger
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "unet_torch_tpu"))
assert not loaded, loaded
"""

# the CLIs read their configs and datasets, and write their reports, with
# the port's own copies of the framework-free modules
_DATA_MODULES = r"""
import sys
from unet_torch_tpu_torch.cli import test_cli, train_cli
from unet_torch_tpu_torch.cli.config import Config
from unet_torch_tpu_torch.data import nested, synthetic
from unet_torch_tpu_torch.data.datasets import DataBinary, DataPointReg
from unet_torch_tpu_torch.data.datasets import DataRegMT
from unet_torch_tpu_torch.data.io import get_image_list
from unet_torch_tpu_torch.data.loader import NumpyLoader
from unet_torch_tpu_torch.eval import matching, peaks, results
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "unet_torch_tpu", "matplotlib"))
assert not loaded, loaded
"""

# the topo slice: the losses, the native pairing (built and called), the
# steps and the warm-up loop's names, and the counting metric
_TOPO_MODULES = r"""
import sys
import numpy as np
from unet_torch_tpu_torch.eval.metrics import mr_accuracy
from unet_torch_tpu_torch.losses import TOPO_LOSSES, topo
from unet_torch_tpu_torch.native import build, ph0
from unet_torch_tpu_torch.train.steps import make_topo_steps
from unet_torch_tpu_torch.train.trainer import TOPO_LOSS_NAMES
births, deaths, n = ph0.superlevel_ph0(
    np.random.RandomState(0).rand(16, 16), 8)
assert n == 8 and len(TOPO_LOSS_NAMES) == 9
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "unet_torch_tpu"))
assert not loaded, loaded
"""

# the parallel slice: the launch, the layout, the synchronised BatchNorm and
# the tensor-parallel sharding, with what they import; nothing starts a
# process group
_PARALLEL_MODULES = r"""
import sys
import torch.distributed as dist
from unet_torch_tpu_torch.core import dist as port_dist, mesh
from unet_torch_tpu_torch.nn.sync_batchnorm import convert_sync_batchnorm
from unet_torch_tpu_torch.parallel import gather_state_tp, parallelize
from unet_torch_tpu_torch.parallel.tensor import shard_model_tp
assert not dist.is_initialized() and port_dist.process_count() == 1
assert mesh.make_mesh().size == 1
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "unet_torch_tpu"))
assert not loaded, loaded
"""

_GREP = ("import unet_torch_tpu ", "import unet_torch_tpu.",
         "from unet_torch_tpu ", "from unet_torch_tpu.")


def _run(code):
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_no_jax():
    # every module of the slice was imported
    assert int(_run(_CHECK).split()[-1]) >= 64


def test_main_path_imports_no_jax_package():
    _run(_MAIN_PATH)


def test_data_modules_import_no_jax():
    _run(_DATA_MODULES)


def test_topo_modules_import_no_jax():
    _run(_TOPO_MODULES)


def test_parallel_modules_import_no_jax():
    _run(_PARALLEL_MODULES)


def test_no_source_line_imports_the_jax_package():
    root = Path(__file__).resolve().parents[1]
    files = [root / "chip_smoke.py",
             *sorted((root / "unet_torch_tpu_torch").rglob("*.py"))]
    hits = [f"{f.relative_to(root)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if any(g in line + " " for g in _GREP)]
    assert not hits, hits
