"""The port stands alone: neither bnn_tpu_torch nor chip_smoke.py imports
JAX, flax or the JAX package (only the tests import both)."""
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
                                    "inference/export.py"])
def test_training_modules_are_checked(module):
    """The training and serving slices' modules, the kernel operators and
    the serving bundle are among the sources checked above."""
    path = ROOT / "bnn_tpu_torch" / module
    assert path in _port_sources()
    assert not _FORBIDDEN.findall(path.read_text())
