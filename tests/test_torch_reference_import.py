"""Reference-checkpoint import in the port (bnn_tpu_torch.utils.torch_import)
against bnn_tpu.utils.torch_import on the CPU.

A JAX model's state, exported to the reference's torch.save schema by
tests/test_torch_import.py's helper, is imported into both packages: the
logits agree (1e-5) and equal the source's. The importer's guards hold as in
the JAX package: DDP prefixes, the wrapper, unexpected keys (strict raises),
a wrong shape reported once with both shapes, a size-matched kernel of
another shape never reshaped, a broadcast alpha reshaped, num_batches_tracked
dropped; and the loader refuses what tests/test_torch_import.py's hostile
corpus refuses (files written here in torch.save's own layout, which
torch.load requires)."""
import io
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bnn_tpu_torch as bt
from bnn_tpu.utils import import_torch_checkpoint as jax_import
from bnn_tpu_torch.ops import (BasicInputBinarizer, BasicScaleBinarizer,
                               XNORWeightBinarizer)
from bnn_tpu_torch.utils import (import_torch_checkpoint, load_torch_file,
                                 torch_to_state_dict)
from test_torch_import import export_torch_state_dict
from test_torch_import import small_net as _small_net
from test_torch_zoo import jax_model

BC = bt.BConfig(BasicInputBinarizer, BasicScaleBinarizer, XNORWeightBinarizer)


def small_net(seed):
    """tests/test_torch_import.py's small_net, its state drawn from numpy
    (``jax_model``: the initializers cost seconds on the CPU)."""
    return jax_model(lambda: _small_net(0), seed)


def port_small_net():
    """tests/test_torch_import.py's small_net in the port, random weights."""
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1, bias=False), bt.nn.BatchNorm2d(8),
        torch.nn.PReLU(8), torch.nn.Conv2d(8, 8, 3, padding=1),
        bt.nn.BatchNorm2d(8), torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(8, 4))
    return bt.prepare_binary_model(net, BC, ignore_layers_name=["_first_", "_last_"]).eval()


def _source():
    """The JAX small_net with BN statistics and alpha away from their
    initial values, its reference-format state_dict and an input."""
    src = small_net(seed=0)
    src.eval()
    src[1].mean[...] = jnp.linspace(-0.5, 0.5, 8)
    src[1].var[...] = jnp.linspace(0.5, 2.0, 8)
    src[3].activation_post_process.alpha[...] = jnp.linspace(0.5, 1.5, 8)
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 8, 8, 3)))
    return src, export_torch_state_dict(src), x


def _logits(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()


def test_saved_file_gives_equal_logits_in_both_packages(tmp_path):
    src, sd, x = _source()
    sd["1.num_batches_tracked"] = torch.tensor(123)  # dropped on import
    path = str(tmp_path / "ckpt.pth.tar")
    torch.save({"state_dict": sd, "epoch": 7, "best_acc1": 51.2, "arch": "testnet"}, path)

    ours, theirs = port_small_net(), small_net(seed=99)
    theirs.eval()
    assert import_torch_checkpoint(ours, path) == ([], [])
    assert jax_import(theirs, path) == ([], [])
    got, want = _logits(ours, x), np.asarray(theirs(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(src(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    assert int(ours[1].num_batches_tracked) == 0


def test_ddp_prefix_and_bare_state_dict(tmp_path):
    src, sd, x = _source()
    path = str(tmp_path / "ddp.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    ours = port_small_net()
    assert import_torch_checkpoint(ours, path) == ([], [])
    np.testing.assert_allclose(_logits(ours, x), np.asarray(src(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    # a payload in memory, not a path
    assert sorted(torch_to_state_dict({"state_dict": sd})) == sorted(sd)


def test_strict_raises_on_unexpected(tmp_path):
    _, sd, _ = _source()
    sd["nonexistent.weight"] = torch.zeros(3)
    path = str(tmp_path / "bad.pth")
    torch.save({"state_dict": sd}, path)
    net = port_small_net()
    before = net[0].weight.clone()
    with pytest.raises(ValueError, match="unexpected"):
        import_torch_checkpoint(net, path)
    assert torch.equal(net[0].weight, before)  # nothing written
    jnet = small_net(seed=1)
    assert (import_torch_checkpoint(net, path, strict=False)[1]
            == jax_import(jnet, path, strict=False)[1] == ["nonexistent.weight"])


def test_shape_mismatch_reported_once(tmp_path):
    _, sd, _ = _source()
    sd["7.weight"] = torch.zeros(3, 8)  # the fc head with a wrong shape
    path = str(tmp_path / "shape.pth")
    torch.save({"state_dict": sd}, path)
    missing, unexpected = import_torch_checkpoint(port_small_net(), path, strict=False)
    jmissing, junexpected = jax_import(small_net(seed=1), path, strict=False)
    assert unexpected == junexpected == []
    assert missing == ["7.weight [shape: torch (3, 8) vs (4, 8)]"]
    assert len(jmissing) == 1 and "shape" in jmissing[0]


def test_size_matched_kernel_is_not_reshaped():
    """A (3, 1) kernel offered for a (1, 3) conv holds as many values but
    would be scrambled: it is reported, not reshaped. A (C,) alpha for the
    port's [1, C, 1, 1] is reshaped."""
    net = bt.prepare_binary_model(torch.nn.Sequential(
        torch.nn.Conv2d(2, 4, (1, 3)), torch.nn.Conv2d(4, 4, 1)), BC)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    sd["0.weight"] = torch.randn(4, 2, 3, 1)
    sd["1.activation_post_process.alpha"] = torch.arange(4.0)
    missing, unexpected = import_torch_checkpoint(net, sd, strict=False)
    assert unexpected == []
    assert missing == ["0.weight [shape: torch (4, 2, 3, 1) vs (4, 2, 1, 3)]"]
    assert torch.equal(net[1].activation_post_process.alpha.flatten(), torch.arange(4.0))


def test_real_state_dict_with_metadata(tmp_path):
    tm = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.Linear(4, 2))
    path = str(tmp_path / "real.pth")
    torch.save({"state_dict": tm.state_dict(), "epoch": 1}, path)
    sd = load_torch_file(path)["state_dict"]
    assert sd["0.weight"].shape == (4, 3, 3, 3)
    assert torch.equal(sd["1.weight"], tm[1].weight.detach())


def test_loader_rejects_arbitrary_globals(tmp_path):
    class Evil:
        def __reduce__(self):
            import os
            return (os.system, ("true",))

    path = str(tmp_path / "evil.pth")
    torch.save({"state_dict": {"x": Evil()}}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_torch_file(path)


# The hostile corpus, written in torch.save's layout: a version record and
# storage tags that are torch's storage classes
class _Storage:
    def __init__(self, tag=torch.FloatStorage, key="0", numel=4):
        self.tag, self.key, self.numel = tag, key, numel


class _Tensor:
    def __init__(self, storage, offset, size, stride):
        self.args = (storage, offset, size, stride)

    def __reduce__(self):
        import torch._utils as tu

        return (tu._rebuild_tensor_v2, (*self.args, False, {}))


class _Pickler(pickle.Pickler):
    def persistent_id(self, o):
        if isinstance(o, _Storage):
            return ("storage", o.tag, o.key, "cpu", o.numel)
        return None


FOUR_FLOATS = np.arange(4, dtype="<f4").tobytes()


def craft(tmp_path, name, obj=None, storages=None, pkl_bytes=None):
    if pkl_bytes is None:
        b = io.BytesIO()
        _Pickler(b, protocol=2).dump(obj)
        pkl_bytes = b.getvalue()
    path = str(tmp_path / name)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("archive/data.pkl", pkl_bytes)
        z.writestr("archive/byteorder", "little")
        z.writestr("archive/version", "3\n")
        for k, v in (storages or {"0": FOUR_FLOATS}).items():
            z.writestr(f"archive/data/{k}", v)
    return path


def test_crafted_valid_checkpoint_loads(tmp_path):
    p = craft(tmp_path, "ok.pth", {"w": _Tensor(_Storage(), 0, (2, 2), (2, 1))})
    assert torch.equal(load_torch_file(p)["w"], torch.arange(4.0).reshape(2, 2))


@pytest.mark.parametrize("offset,size,stride", [
    (-1, (2,), (1,)),            # negative offset
    (99, (2,), (1,)),            # offset past storage
    (0, (2, 3), (1,)),           # rank mismatch
    (0, (-2,), (1,)),            # negative size
    (0, (4,), (-1,)),            # negative stride
    (0, (3,), (2,)),             # extent past storage end
    (0, (2**20, 2**20), (0, 0)),  # stride-0 memory bomb over 4 floats
    (0, (2**40,), (1,)),         # numel bomb
    (2, (4,), (1,)),             # offset+size past end
    ("x", (2,), (1,)),           # non-integer offset
    (0, (2,), ("y",)),           # non-integer stride
    (2.9, (2,), (1,)),           # truncating float offset
    (0, (2.5,), (1,)),           # truncating float size
    (0, (2,), (1.5,)),           # truncating float stride
    (True, (2,), (1,)),          # bool offset
    (0, (3, 2), (1, 1)),         # overlapping rows over 4 floats
])
def test_hostile_tensor_geometry(tmp_path, offset, size, stride):
    p = craft(tmp_path, "geom.pth", {"w": _Tensor(_Storage(), offset, size, stride)})
    with pytest.raises(pickle.UnpicklingError):
        load_torch_file(p)


@pytest.mark.parametrize("storage,data", [
    (_Storage(key="7"), FOUR_FLOATS),            # missing storage
    (_Storage(tag="EvilStorage"), FOUR_FLOATS),  # unknown storage tag
    (_Storage(numel=1), b"\x00" * 5),            # not a multiple of the dtype
])
def test_hostile_storage(tmp_path, storage, data):
    p = craft(tmp_path, "s.pth", {"w": _Tensor(storage, 0, (1,), (1,))}, {"0": data})
    with pytest.raises(pickle.UnpicklingError):
        load_torch_file(p)


def test_truncated_files(tmp_path):
    path = str(tmp_path / "full.pth")
    torch.save({"state_dict": port_small_net().state_dict()}, path)
    blob = open(path, "rb").read()
    for frac in (0.15, 0.6, 0.97):
        tpath = tmp_path / f"trunc{frac}.pth"
        tpath.write_bytes(blob[: int(len(blob) * frac)])
        with pytest.raises((zipfile.BadZipFile, pickle.UnpicklingError, EOFError)):
            load_torch_file(str(tpath))
    b = io.BytesIO()
    _Pickler(b, protocol=2).dump({"w": _Tensor(_Storage(), 0, (2, 2), (2, 1))})
    p = craft(tmp_path, "cut.pth", pkl_bytes=b.getvalue()[: len(b.getvalue()) // 2])
    with pytest.raises((pickle.UnpicklingError, EOFError)):
        load_torch_file(p)
