"""No module the benchmark imports is JAX or the JAX package, compared by
whole top-level names (`unet_torch_tpu_torch` starts with
`unet_torch_tpu`), and the plain reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "unet_torch_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module a source imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_whole_names_are_compared():
    assert "unet_torch_tpu_torch" not in FORBIDDEN
    assert imported(BENCH / "loops" / "program.py") & {
        "unet_torch_tpu_torch"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "unet_torch_tpu_torch" not in imported(path), path
        assert not imported(path) & FORBIDDEN, path


def test_a_run_loads_no_forbidden_module():
    # a whole tiny run on the CPU, then the run's own look at sys.modules
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.tests import tiny\n"
        "from perfbench.core import env\n"
        "tiny.run(tiny.cell('unet64_mc.eval'))\n"
        "print('FOUND', env.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout
