"""The port's public surface against the JAX package's: every public name
that a module of ``bnn_tpu`` defines exists in the port's counterpart
module, and every parameter of each such function or class is accepted by
the port's counterpart, apart from the ``DECIDED`` table below. Each of its
entries is a line of ROADMAP.md's "Decided" list, entry for entry.

Only imports and ``inspect``: no model is built."""
import functools
import importlib
import inspect
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# ROADMAP.md's Decided entry (its leading ``**...**`` text) -> the names
# ("name") and parameters ("object.param" or "*.param" for any object) of
# bnn_tpu that the port leaves out for that entry's reason
DECIDED = {
    "TPU tiling parameters": {
        "*.interpret", "*.taps_per_dot", "*.rows_per_step", "*.block_m",
        "*.block_n", "*.block_k", "*.block_kw", "*.block_o"},
    "`loop_time(warmup=)`": {"loop_time.warmup"},
    "`transform_stem_kernel` and `to_lax_padding`": {
        "transform_stem_kernel", "to_lax_padding"},
    "`ExportedServer(exported, leaves)`": {
        "ExportedServer.exported", "ExportedServer.leaves"},
    "`make_mesh` / `make_pipeline_mesh(devices=)`": {
        "make_mesh.devices", "make_pipeline_mesh.devices"},
    "`shard_state` / `shard_tp_state` take a module": {
        "shard_state.state", "shard_tp_state.state"},
    "`rngs`, and `key` against `generator`": {
        "*.rngs", "stochastic_sign_ste.key", "drop_path.key"},
    "`popcount_gemm_reference` takes packed words": {
        "popcount_gemm_reference.x"},
}
_ALLOWED = set().union(*DECIDED.values())


def _jax_modules():
    pkg = ROOT / "bnn_tpu"
    names = []
    for f in sorted(pkg.rglob("*.py")):
        parts = f.relative_to(ROOT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


MODULES = _jax_modules()


def _public(module):
    """``{name: object}`` of the public names ``module`` defines: its
    ``__all__`` (or, without one, its names without a leading underscore),
    less what it imports from outside ``bnn_tpu``."""
    listed = getattr(module, "__all__", None)
    out = {}
    for name in (listed if listed is not None else dir(module)):
        if name.startswith("_") and listed is None:
            continue
        obj = getattr(module, name)
        origin = (obj.__name__ if inspect.ismodule(obj)
                  else getattr(obj, "__module__", None))
        if origin is None and listed is not None:
            origin = module.__name__  # a constant the module lists
        if isinstance(origin, str) and origin.split(".")[0] == "bnn_tpu":
            out[name] = obj
    return out


def _params(obj):
    """Named parameters of a function, or of a class's ``__init__``."""
    fn = obj.__init__ if inspect.isclass(obj) else obj
    sig = inspect.signature(fn)
    return [p.name for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


@functools.lru_cache(maxsize=None)
def _differences(name: str):
    """``(missing names, missing parameters)`` of the port's counterpart of
    the JAX module ``name``, each as the DECIDED table writes them."""
    jmod = importlib.import_module(name)
    pmod = importlib.import_module("bnn_tpu_torch" + name[len("bnn_tpu"):])
    names, params = set(), set()
    for attr, obj in _public(jmod).items():
        if not hasattr(pmod, attr):
            names.add(attr)
            continue
        if inspect.ismodule(obj) or not callable(obj):
            continue
        port = getattr(pmod, attr)
        try:
            want = _params(obj)
        except (TypeError, ValueError):
            continue  # a builtin without a signature
        have = set(_params(port))
        params |= {f"{attr}.{p}" for p in want if p not in have}
    return frozenset(names), frozenset(params)


def _allowed(entry: str) -> bool:
    return entry in _ALLOWED or f"*.{entry.split('.')[-1]}" in _ALLOWED


@pytest.mark.parametrize("name", MODULES)
def test_public_names_exist_in_the_port(name):
    missing, _ = _differences(name)
    assert {n for n in missing if not _allowed(n)} == set()


@pytest.mark.parametrize("name", MODULES)
def test_parameters_accepted_by_the_port(name):
    _, missing = _differences(name)
    assert {p for p in missing if not _allowed(p)} == set()


def test_decided_table_matches_the_roadmap():
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Decided: known behaviours of the reference.**")
    decided = text[start:text.index("\n### ", start)]
    entries = re.findall(r"^- \*\*(.+?)\*\*", decided, re.M)
    assert set(DECIDED) <= {e.rstrip(".") for e in entries}
    # and every entry of the table is still needed by some module
    used = set()
    for name in MODULES:
        used |= {e for e in set().union(*_differences(name)) if _allowed(e)}
    for key, covered in DECIDED.items():
        assert any(e in covered or f"*.{e.split('.')[-1]}" in covered
                   for e in used), key
