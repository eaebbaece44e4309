"""The port's checkpoints (bnn_tpu_torch.utils.checkpoint): the round trips of
tests/test_utils.py and tests/test_compress.py, Predictor.from_checkpoint,
and a resumed training run, bit for bit against the uninterrupted one on
the CPU and within 1e-4 of bnn_tpu's own save, restore and resume in
float64."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.parallel import make_train_step as jax_train_step
from bnn_tpu.utils import checkpoint as jckpt
from bnn_tpu_torch.inference import Predictor, QuantizedLinear, deploy
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.parallel import make_train_step
from bnn_tpu_torch.utils import (cast_floats, load_checkpoint, restore_into,
                                 restore_optimizer, save_checkpoint)
from bnn_tpu_torch.utils import jax_to_port
from test_torch_training import (_OPTIMIZERS, _assert_state_close, _batches,
                                 _flat, _nchw, _pair)

BC = bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                tops.XNORWeightBinarizer)


def _fill(net, seed):
    """Every parameter from numpy's generator of ``seed`` (BN scales around
    1), so that two seeds give two different nets."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            v = rng.randn(*p.shape).astype(np.float32) * 0.3
            p.copy_(torch.from_numpy(v + (1.0 if name.endswith("1.weight") else 0.0)))
    return net


def make_net(seed=0, head=4):
    return _fill(torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1), bt.nn.BatchNorm2d(16),
        torch.nn.ReLU(), torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(16, head)), seed)


def _images(seed, shape=(2, 3, 8, 8)):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(np.where(x == 0, 1e-3, x).astype(np.float32))


def _state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k]["seed"] == b[k]["seed"], k
            assert a[k]["states"].keys() == b[k]["states"].keys(), k
            for d, s in a[k]["states"].items():
                assert torch.equal(s, b[k]["states"][d]), (k, d)


class TestCheckpoint:
    def test_round_trip(self, tmp_path):
        net = bt.prepare_binary_model(make_net(), BC).eval()
        with torch.no_grad():
            net[5].activation_post_process.alpha.copy_(torch.arange(4.0)[None])
        x = _images(0)
        expected = net(x)
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, net, metadata={"epoch": 3, "best_acc1": 71.5})
        assert os.listdir(path) == ["checkpoint.pt"]  # no temporary left
        fresh = bt.prepare_binary_model(make_net(seed=9), BC).eval()
        payload = load_checkpoint(path)
        assert payload["metadata"] == {"epoch": 3, "best_acc1": 71.5}
        assert "opt_state" not in payload
        assert restore_into(fresh, payload) == []
        assert torch.equal(fresh(x), expected)

    @pytest.mark.parametrize("strict", [True, False])
    def test_restore_preserves_destination_dtype(self, tmp_path, strict):
        """Restored values take the destination's dtype: an f32 checkpoint
        restored into a bf16 model keeps it bf16."""
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, bt.prepare_binary_model(make_net(), BC))
        fresh = cast_floats(bt.prepare_binary_model(make_net(seed=9), BC),
                            torch.bfloat16)
        restore_into(fresh, load_checkpoint(path), strict=strict)
        dtypes = {v.dtype for v in fresh.state_dict().values() if v.is_floating_point()}
        assert dtypes == {torch.bfloat16}
        want = bt.prepare_binary_model(make_net(), BC).state_dict()
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, want[k].to(v.dtype)), k

    def test_best_copy(self, tmp_path):
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, make_net(), is_best=True)
        assert os.path.isfile(os.path.join(path + ".best", "checkpoint.pt"))
        save_checkpoint(path, make_net(seed=1), is_best=True,
                        best_path=str(tmp_path / "top"))
        best = load_checkpoint(str(tmp_path / "top"))["model"]
        assert torch.equal(best["0.weight"], make_net(seed=1)[0].weight)
        # the default copy is replaced, not merged, by a later save
        save_checkpoint(path, make_net(seed=2), is_best=True)
        assert torch.equal(load_checkpoint(path + ".best")["model"]["0.weight"],
                           make_net(seed=2)[0].weight)

    def test_non_strict_restore_skips_mismatches(self, tmp_path):
        net = make_net()
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, net)
        other = make_net(seed=1, head=7)  # another head size
        payload = load_checkpoint(path)
        with pytest.raises(RuntimeError, match="size mismatch"):
            restore_into(copy.deepcopy(other), payload)
        skipped = restore_into(other, payload, strict=False)
        assert skipped == ["5.weight", "5.bias"]
        assert torch.equal(other[0].weight, net[0].weight)
        assert torch.equal(other[1].running_var, net[1].running_var)
        assert not torch.equal(other[5].bias, net[5].bias[:1].expand(7))


class TestDeployedCheckpoint:
    def test_deployed_model_round_trip(self, tmp_path):
        """Packed int8 weights and folded epilogues survive save and
        restore (the serving checkpoint flow)."""
        net = bt.prepare_binary_model(make_net(), BC,
                                      ignore_layers_name=["_first_"]).eval()
        dep = deploy(net)
        x = _images(1)
        expected = dep(x)
        path = str(tmp_path / "served")
        save_checkpoint(path, dep)
        net2 = bt.prepare_binary_model(make_net(seed=7), BC,
                                       ignore_layers_name=["_first_"]).eval()
        dep2 = deploy(net2)
        restore_into(dep2, load_checkpoint(path))
        assert torch.equal(dep2(x), expected)

    def test_train_deploy_restore_flow(self, tmp_path):
        """QAT checkpoint -> fresh model -> restore -> deploy equals deploying
        the original."""
        net = bt.prepare_binary_model(make_net(), BC).eval()
        path = str(tmp_path / "qat")
        save_checkpoint(path, net)
        x = _images(2)
        expected = deploy(copy.deepcopy(net))(x)
        fresh = bt.prepare_binary_model(make_net(seed=3), BC).eval()
        restore_into(fresh, load_checkpoint(path))
        assert torch.equal(deploy(fresh)(x), expected)

    def test_quantized_model_round_trip(self, tmp_path):
        lin = torch.nn.Linear(64, 32)
        q = QuantizedLinear(lin, bits=4)
        x = _images(3, (3, 64))
        want = q(x)
        save_checkpoint(str(tmp_path / "q"), q)
        torch.manual_seed(1)
        q2 = QuantizedLinear(torch.nn.Linear(64, 32), bits=4)  # other weights
        assert not torch.equal(q2(x), want)
        restore_into(q2, load_checkpoint(str(tmp_path / "q")))
        assert torch.equal(q2(x), want)


def _bin_model(seed=0):
    """tests/test_inference.py's binary model: float first layer, PReLU."""
    net = _fill(torch.nn.Sequential(
        torch.nn.Conv2d(3, 32, 3, padding=1), bt.nn.BatchNorm2d(32),
        torch.nn.PReLU(32), torch.nn.Conv2d(32, 64, 3, stride=2, padding=1),
        bt.nn.BatchNorm2d(64), torch.nn.PReLU(64), torch.nn.AdaptiveAvgPool2d(1),
        torch.nn.Flatten(), torch.nn.Linear(64, 10)), seed)
    return bt.prepare_binary_model(net, BC, ignore_layers_name=["_first_"])


def test_predictor_from_checkpoint(tmp_path):
    model = _bin_model().eval()
    path = str(tmp_path / "qat")
    save_checkpoint(path, model)
    pred = Predictor.from_checkpoint(path, lambda: _bin_model(seed=5),
                                     batch_size=8, dtype=None, fold_bn=False,
                                     device="cpu")
    x = _images(4, (3, 3, 8, 8))
    # no cast and no folds: the deployed model of the restored weights
    expected = deploy(copy.deepcopy(model))(x)
    torch.testing.assert_close(pred(x), expected, rtol=1e-5, atol=1e-5)
    assert pred.served_model() is pred.model


def _port_model(config, seed):
    """A [1, 1, 1, 1] binary ResNet in train mode; ``seed`` sets the weights
    and, with ``config="stochastic"``, the input binarizers' streams."""
    tm = bt.models.ResNet(bt.models.BasicBlock, [1, 1, 1, 1], num_classes=10,
                          generator=torch.Generator().manual_seed(seed))
    sign = (tops.StochasticInputBinarizer.with_args(seed=seed)
            if config == "stochastic" else tops.BasicInputBinarizer)
    return bt.prepare_binary_model(
        tm, bt.BConfig(sign, tops.BasicScaleBinarizer, tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"]).train()


@pytest.mark.parametrize("config,optimizer", [
    ("binary", "adam"), ("stochastic", "adamw")])
def test_resume_equals_the_uninterrupted_run(tmp_path, config, optimizer):
    """3 steps, a checkpoint, a fresh model and optimizer restored from it,
    2 more steps: the losses and the final state (BN statistics, moments,
    stochastic streams) equal 5 uninterrupted steps bit for bit."""
    batches = [(_nchw(x), torch.from_numpy(y).long()) for x, y in _batches(5)]
    step = make_train_step()
    make_opt = _OPTIMIZERS[optimizer][1]

    whole = _port_model(config, 0)
    opt_whole = make_opt(whole.parameters())
    want = [float(step(whole, opt_whole, x, y)["loss"]) for x, y in batches]

    first = _port_model(config, 0)
    opt = make_opt(first.parameters())
    got = [float(step(first, opt, x, y)["loss"]) for x, y in batches[:3]]
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, first, opt_state=opt, metadata={"step": 3})
    resumed = _port_model(config, 1)  # other weights and streams
    opt2 = make_opt(resumed.parameters())
    payload = load_checkpoint(path)
    assert restore_into(resumed, payload) == []
    assert restore_optimizer(opt2, payload) == []
    got += [float(step(resumed, opt2, x, y)["loss"]) for x, y in batches[3:]]
    assert got == want
    _state_equal(resumed.state_dict(), whole.state_dict())
    for a, b in zip(opt2.state.values(), opt_whole.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    if config == "stochastic":
        assert any(k.endswith("_extra_state") for k in payload["model"])


def test_restore_optimizer_refusals(tmp_path):
    net = make_net()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, net)
    with pytest.raises(KeyError, match="opt_state"):
        restore_optimizer(torch.optim.Adam(net.parameters()), load_checkpoint(path))
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    net(_images(5)).sum().backward()
    opt.step()
    save_checkpoint(path, net, opt_state=opt)
    other = make_net(head=7)
    opt7 = torch.optim.Adam(other.parameters(), lr=1e-2)
    with pytest.raises(ValueError, match="mismatch"):
        restore_optimizer(opt7, load_checkpoint(path))
    skipped = restore_optimizer(opt7, load_checkpoint(path), strict=False)
    assert skipped == ["state.4", "state.5"]  # the head's weight and bias
    # the live optimizer's hyperparameters stay, as in the JAX package
    assert opt7.param_groups[0]["lr"] == 1e-2
    assert torch.equal(opt7.state[other[0].weight]["exp_avg"],
                       opt.state[net[0].weight]["exp_avg"])
    assert other[5].weight not in opt7.state


def _jax_flat_state(jm):
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(nnx.to_pure_dict(nnx.state(jm))):
        out[".".join(str(getattr(p, "key", p)) for p in path)] = np.asarray(v)
    return out


def test_resume_matches_jax_in_float64(tmp_path):
    """Both packages train 3 steps, save, restore into a fresh model and
    optimizer, and train 2 more (Adam, fp32 config, in float64): losses and
    final state within 1e-4 of each other."""
    batches = _batches(5)
    jtx, topt = _OPTIMIZERS["adam"]
    with jax.enable_x64(True):
        jm, tm = _pair("fp32")
        bnn_tpu.utils.cast_floats(jm, jnp.float64)
        tm.double()
        jstep, tstep = jax_train_step(), make_train_step()
        jopt, opt = nnx.Optimizer(jm, jtx(), wrt=nnx.Param), topt(tm.parameters())

        def run(j_model, j_opt, t_model, t_opt, part):
            jl, tl = [], []
            for x, y in part:
                jl.append(float(jstep(j_model, j_opt, jnp.asarray(x, jnp.float64),
                                      jnp.asarray(y))["loss"]))
                tl.append(float(tstep(t_model, t_opt, _nchw(x).double(),
                                      torch.from_numpy(y).long())["loss"]))
            return jl, tl

        jl, tl = run(jm, jopt, tm, opt, batches[:3])
        jckpt.save_checkpoint(str(tmp_path / "jax"), jm, opt_state=jopt)
        save_checkpoint(str(tmp_path / "port"), tm, opt_state=opt)
        jm2, tm2 = _pair("fp32", seed=1)
        bnn_tpu.utils.cast_floats(jm2, jnp.float64)
        tm2.double()
        jopt2, opt2 = nnx.Optimizer(jm2, jtx(), wrt=nnx.Param), topt(tm2.parameters())
        jpayload = jckpt.load_checkpoint(str(tmp_path / "jax"))
        jckpt.restore_into(jm2, jpayload)
        jckpt.restore_optimizer(jopt2, jpayload)
        payload = load_checkpoint(str(tmp_path / "port"))
        restore_into(tm2, payload)
        restore_optimizer(opt2, payload)
        assert all(v.dtype == torch.float64 for v in tm2.parameters())
        jl2, tl2 = run(jm2, jopt2, tm2, opt2, batches[3:])
        np.testing.assert_allclose(tl + tl2, jl + jl2, rtol=1e-4)
        _assert_state_close(jm2, tm2, 1e-4)
        # the restored JAX model carries into the port as the port's does
        assert _jax_flat_state(jm2).keys() >= {"conv1.kernel", "fc.bias"}


def test_resume_at_a_new_lr_matches_jax_in_float64(tmp_path):
    """Both packages take one Adam step at 1e-3, save, resume into an
    optimizer built at 1e-2 and step again (fp32 config, float64): the
    resumed step keeps the live LR in both, so the two updates agree within
    1e-4 (relative L2 of each tensor) and the port's ``lr`` reads 1e-2."""
    batches = _batches(2)
    with jax.enable_x64(True):
        jm, tm = _pair("fp32")
        bnn_tpu.utils.cast_floats(jm, jnp.float64)
        tm.double()
        jstep, tstep = jax_train_step(), make_train_step()

        def step(j_model, j_opt, t_model, t_opt, x, y):
            jstep(j_model, j_opt, jnp.asarray(x, jnp.float64), jnp.asarray(y))
            tstep(t_model, t_opt, _nchw(x).double(), torch.from_numpy(y).long())

        jopt = nnx.Optimizer(jm, optax.adam(1e-3), wrt=nnx.Param)
        opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
        step(jm, jopt, tm, opt, *batches[0])
        jckpt.save_checkpoint(str(tmp_path / "jax"), jm, opt_state=jopt)
        save_checkpoint(str(tmp_path / "port"), tm, opt_state=opt)
        jopt2 = nnx.Optimizer(jm, optax.adam(1e-2), wrt=nnx.Param)
        opt2 = torch.optim.Adam(tm.parameters(), lr=1e-2)
        jckpt.restore_optimizer(jopt2, jckpt.load_checkpoint(str(tmp_path / "jax")))
        restore_optimizer(opt2, load_checkpoint(str(tmp_path / "port")))
        assert opt2.param_groups[0]["lr"] == 1e-2
        before_j = jax_to_port(tm, _flat(nnx.state(jm, nnx.Param)))
        before_t = {k: v.clone() for k, v in tm.state_dict().items()}
        step(jm, jopt2, tm, opt2, *batches[1])
        after_j = jax_to_port(tm, _flat(nnx.state(jm, nnx.Param)))
        after_t = tm.state_dict()
        worst, largest = 0.0, 0.0
        for k, v in after_j.items():
            want = v.double() - before_j[k].double()
            got = after_t[k].double() - before_t[k].double()
            worst = max(worst, float((got - want).norm() / (want.norm() + 1e-12)))
            largest = max(largest, float(got.abs().max()))
        assert worst < 1e-4, worst
        # Adam's first steps move a weight by about lr: the live 1e-2
        assert 5e-3 < largest <= 1.1e-2, largest
