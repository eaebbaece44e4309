"""The port stands alone: neither bnn_tpu_torch nor chip_smoke.py imports
JAX, flax or the JAX package (only the tests import both)."""
import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|bnn_tpu)(\.|\s|$)", re.M)


def _port_sources():
    files = sorted((ROOT / "bnn_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 20
    offenders = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert not {f: hits for f, hits in offenders.items() if hits}


def test_pattern_catches_what_it_must():
    for line in ("import jax", "from flax import nnx", "import bnn_tpu.ops",
                 "from bnn_tpu import nn", "  import jax.numpy as jnp"):
        assert _FORBIDDEN.search(line), line
    for line in ("import bnn_tpu_torch", "from bnn_tpu_torch import ops",
                 "from . import jaxlike"):
        assert not _FORBIDDEN.search(line), line


@pytest.mark.parametrize("module", ["nn/__init__.py", "functional.py",
                                    "parallel/__init__.py",
                                    "parallel/trainstep.py",
                                    "utils/checkpoint.py",
                                    "inference/compress.py",
                                    "inference/batching.py",
                                    "examples/__init__.py",
                                    "examples/serve.py",
                                    "kernels/ops.py",
                                    "inference/export.py",
                                    "data.py", "native/__init__.py",
                                    "utils/meters.py", "utils/flops.py",
                                    "utils/timing.py", "utils/profiling.py",
                                    "utils/debug.py", "utils/cache.py",
                                    "utils/torch_import.py",
                                    "examples/cifar10.py",
                                    "parallel/mesh.py",
                                    "parallel/collectives.py",
                                    "parallel/pipeline.py",
                                    "parallel/hetero_pipeline.py",
                                    "inference/tp.py",
                                    "inference/tp_packed.py",
                                    "examples/imagenet.py",
                                    "inference/serving.py",
                                    "inference/deploy.py"])
def test_training_modules_are_checked(module):
    """The training and serving slices' modules, the kernel operators, the
    serving bundle, the input pipeline, the native engines, the training
    utilities and the CIFAR trainer are among the sources checked above."""
    path = ROOT / "bnn_tpu_torch" / module
    assert path in _port_sources()
    assert not _FORBIDDEN.findall(path.read_text())


def test_distributed_worker_imports_no_jax():
    """The ranks of the distributed tests run tests/torch_distributed_worker.py,
    which imports torch and the port only (each rank also reports the JAX
    modules it holds: none)."""
    path = ROOT / "tests" / "torch_distributed_worker.py"
    assert not _FORBIDDEN.findall(path.read_text())


_PARALLEL = ["bnn_tpu_torch.parallel.mesh", "bnn_tpu_torch.parallel.collectives",
             "bnn_tpu_torch.parallel.pipeline", "bnn_tpu_torch.parallel.hetero_pipeline",
             "bnn_tpu_torch.inference.tp", "bnn_tpu_torch.inference.tp_packed",
             "bnn_tpu_torch.inference.export", "bnn_tpu_torch.examples.serve",
             "bnn_tpu_torch.examples.imagenet"]


def test_parallel_modules_import_no_jax():
    """Importing the parallel modules in a fresh interpreter loads no jax,
    flax, optax or bnn_tpu module."""
    import subprocess
    import sys

    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            + "; ".join(f"import {m}" for m in _PARALLEL)
            + "; print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'bnn_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


_INTO_JAX_PACKAGE = re.compile(r"(?<![\w])bnn_tpu[/\\]")


def _string_constants(path):
    """The string literals of a Python source, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_builds_and_opens_nothing_inside_the_jax_package():
    """The native engines build from the port's own copies of the C++
    sources: no port source names a path inside bnn_tpu/ (or the bare
    directory name) in code, no C++ or CUDA source includes from it, and
    the build directories resolve inside bnn_tpu_torch/."""
    from bnn_tpu_torch import native
    from bnn_tpu_torch.kernels import _build

    offenders = {}
    for f in sorted((ROOT / "bnn_tpu_torch").rglob("*.py")):
        hits = [v for v in _string_constants(f)
                if _INTO_JAX_PACKAGE.search(v) or v == "bnn_tpu"]
        if hits:
            offenders[str(f.relative_to(ROOT))] = hits
    for f in sorted((ROOT / "bnn_tpu_torch" / "csrc").rglob("*")):
        if f.suffix in (".cpp", ".cu", ".cuh"):
            includes = re.findall(r'^\s*#\s*include\s*"([^"]+)"', f.read_text(), re.M)
            hits = [i for i in includes if "bnn_tpu/" in i or i.startswith("..")]
            if hits:
                offenders[str(f.relative_to(ROOT))] = hits
    assert not offenders
    port = ROOT / "bnn_tpu_torch"
    for d in (native.SRC_DIR, _build.CSRC):
        assert d.resolve().is_relative_to(port)
    assert sorted(p.name for p in native.SRC_DIR.glob("*.cpp")) == [
        "dataloader.cpp", "xnor_cpu.cpp"]


def test_jax_package_pattern_catches_what_it_must():
    for v in ("bnn_tpu/native/xnor_cpu.cpp", "../bnn_tpu/native", "x/bnn_tpu\\a"):
        assert _INTO_JAX_PACKAGE.search(v), v
    for v in ("bnn_tpu_torch/csrc/cpu", "bnn_tpu_torch/_build", "my_bnn_tpu/x"):
        assert not _INTO_JAX_PACKAGE.search(v), v
