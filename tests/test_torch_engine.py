"""The port's recipe engine (``bnn_tpu_torch.engine``) against ``bnn_tpu``'s on
the CPU: the recipe progression of ``tests/test_engine.py``, validation, the
lr schedules (float64 on both sides, 1e-7 relative), the recipe optimizers'
updates against optax's (float64, 1e-6 relative), a resume under another
base lr, and the YAML reader used where PyYAML cannot be imported.
"""
import copy
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.engine import _build_lr_schedule
from bnn_tpu.utils import checkpoint as jckpt
from bnn_tpu_torch import engine
from bnn_tpu_torch import layers as blayers
from bnn_tpu_torch.ops import (BasicInputBinarizer, Identity,
                               XNORWeightBinarizer, register)
from bnn_tpu_torch.utils import (load_checkpoint, load_jax_state,
                                 optimizer_state_dict, restore_optimizer,
                                 save_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "tests", "assets", "test.yaml")
RECIPES = sorted(glob.glob(os.path.join(ROOT, "examples", "recipes", "*.yaml"))) + [ASSET]


def make_net():
    nn = torch.nn
    return nn.Sequential(
        nn.Conv2d(3, 16, 1), bt.nn.BatchNorm2d(16), nn.ReLU(),
        nn.Conv2d(16, 16, 1), bt.nn.BatchNorm2d(16), nn.ReLU(),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(16, 3))


# --- the recipe progression ------------------------------------------------------

def test_progression_over_the_test_recipe():
    """tests/assets/test.yaml's three steps: activations, then XNOR weights
    (centred), then ``update=True`` carrying a trained alpha while the
    first and last layers binarize too."""
    chef = bt.BinaryChef(ASSET)
    assert len(chef) == chef.get_num_steps() == 3
    model = chef.next(make_net())
    assert type(model[0]) is torch.nn.Conv2d and type(model[8]) is torch.nn.Linear
    assert isinstance(model[3], blayers.Conv2d)
    assert isinstance(model[3].weight_pre_process, Identity)
    assert isinstance(model[3].activation_pre_process, BasicInputBinarizer)
    w = model[3].weight
    model = chef.next(model)
    assert model[3].weight is w
    assert isinstance(model[3].weight_pre_process, XNORWeightBinarizer)
    assert model[3].weight_pre_process.center_weights is True
    alpha = torch.linspace(0.1, 2.0, 16).reshape(1, 16, 1, 1)
    with torch.no_grad():
        model[3].activation_post_process.alpha.copy_(alpha)
    model = chef.next(model, update=True)
    assert model[3].weight_pre_process.center_weights is False
    torch.testing.assert_close(model[3].activation_post_process.alpha.detach(), alpha,
                               rtol=0, atol=0)
    assert isinstance(model[0], blayers.Conv2d) and isinstance(model[8], blayers.Linear)
    assert chef.current_step == 3


def test_user_modules_and_case_insensitive_keys():
    class MyPortBinarizer(BasicInputBinarizer):
        pass

    recipe = {"step0": {"pre_activation": {"NAME": "MyPortBinarizer"},
                        "post_activation": {"name": "Identity"},
                        "weight": {"name": "Identity"}}}
    model = bt.BinaryChef(recipe, user_modules=[MyPortBinarizer]).next(make_net())
    assert isinstance(model[3].activation_pre_process, MyPortBinarizer)
    assert bt.ops.resolve("MyPortBinarizer") is MyPortBinarizer


def test_scalar_ignore_layer_names_and_next_after_failure():
    chef = bt.BinaryChef({"step0": {
        "pre_activation": {"name": "BasicInputBinarizer"},
        "post_activation": {"name": "Identity"},
        "weight": {"name": "XNORWeightBinarizer"},
        "ignore_layer_names": "_last_"}})
    m = chef.run_step(torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 2)), 0)
    assert isinstance(m[0], blayers.Linear) and type(m[1]) is torch.nn.Linear
    chef.run_step = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
    with pytest.raises(RuntimeError):
        chef.next(object())
    assert chef.current_step == 0


_SLOTS = {"pre_activation": {"name": "Identity"},
          "post_activation": {"name": "Identity"},
          "weight": {"name": "Identity"}}

_INVALID = {
    "missing_slot": ({"step0": {"pre_activation": {"name": "Identity"},
                                "post_activation": {"name": "Identity"}}},
                     "missing required section 'weight'"),
    "missing_name": ({"step0": dict(_SLOTS, pre_activation={"args": {}})},
                     "missing required key 'name'"),
    "unknown_binarizer": ({"step0": dict(_SLOTS, pre_activation={"name": "Nope"})},
                          "Unknown binarizer"),
    "unknown_step_key": ({"step0": dict(_SLOTS, ignore_layers=[])}, "unknown keys"),
    "empty": ({}, "non-empty"),
    "bogus_args": ({"step0": dict(_SLOTS, weight={"name": "XNORWeightBinarizer",
                                                  "args": {"bogus_arg": 1}})},
                   "bogus_arg"),
    "epochs_not_int": ({"step0": dict(_SLOTS, epochs="abc")},
                       "epochs must be an integer"),
    "epochs_negative": ({"step0": dict(_SLOTS, epochs=-1)}, "positive"),
    "ignore_mapping": ({"step0": dict(_SLOTS, ignore_layer_names={"a": 1})},
                       "ignore_layer_names"),
    "optimizer_name": ({"step0": dict(_SLOTS, optimizer={"name": "lamb"})}, "lamb"),
    "optimizer_key": ({"step0": dict(_SLOTS, optimizer={"name": "sgd", "momentom": 0.9})},
                      "momentom"),
    "multistep_milestones": ({"step0": dict(_SLOTS, lr_schedule={"name": "multistep"})},
                             "milestones"),
}


@pytest.mark.parametrize("case", sorted(_INVALID))
def test_invalid_recipes_raise_as_in_jax(case):
    """Each invalid recipe raises the same error in both packages:
    ``RecipeError``, or ``KeyError`` for an unknown binarizer name."""
    recipe, match = _INVALID[case]
    kind = KeyError if case == "unknown_binarizer" else bt.RecipeError
    with pytest.raises(KeyError if case == "unknown_binarizer" else bnn_tpu.RecipeError,
                       match=match):
        bnn_tpu.BinaryChef(copy.deepcopy(recipe))
    with pytest.raises(kind, match=match):
        bt.BinaryChef(copy.deepcopy(recipe))


def test_missing_optimizer_section_and_epochs():
    chef = bt.BinaryChef({"step0": dict(_SLOTS, epochs=4), "step1": dict(_SLOTS)})
    assert chef.epochs(0) == 4 and chef.epochs(1) == 0
    with pytest.raises(bt.RecipeError, match="optimizer"):
        chef.make_tx(0)


# --- schedules and optimizers ------------------------------------------------------

_SCHEDULES = {
    "constant": ({"name": "constant"}, 3, 4),
    "cosine_warmup_final": ({"name": "cosine", "warmup_epochs": 2,
                             "final_factor": 0.05}, 7, 3),
    "multistep_on_warmup_boundary": ({"name": "multistep", "milestones": [1, 3, 5],
                                      "gamma": 0.5, "warmup_epochs": 1}, 6, 4),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_lr_schedule_matches_jax(name):
    """The lr at every step (past the end, too) against JAX's
    ``_build_lr_schedule(...)(t)``, both in float64: 1e-7 relative."""
    sched, epochs, spe = _SCHEDULES[name]
    mine = engine.lr_schedule(0.3, dict(sched), epochs, spe)
    with jax.enable_x64(True):
        theirs = _build_lr_schedule(0.3, dict(sched), epochs, spe)
        want = [float(theirs(t)) for t in range(epochs * spe + 3)]
    got = [mine(t) for t in range(epochs * spe + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert got[0] == (0.0 if sched.get("warmup_epochs") else 0.3)


def _recipe(opt, sched=None, epochs=3):
    step = dict(_SLOTS, epochs=epochs, optimizer=opt)
    if sched:
        step["lr_schedule"] = sched
    return {"step0": step}


_OPTS = {
    "sgd_momentum_decay": {"name": "sgd", "lr": 0.1, "momentum": 0.9,
                           "weight_decay": 1e-2},
    "sgd_nesterov": {"name": "sgd", "lr": 0.1, "momentum": 0.8, "nesterov": True},
    "sgd_plain_decay": {"name": "sgd", "lr": 0.1, "weight_decay": 1e-2},
    "adam_decay": {"name": "adam", "lr": 1e-2, "weight_decay": 1e-2, "b1": 0.8},
    "adamw": {"name": "adamw", "lr": 1e-2, "weight_decay": 0.1, "eps": 1e-6},
}
_WARM = {"name": "cosine", "warmup_epochs": 1}


def _pair_linear(seed=0):
    """(JAX Linear, port Linear) on the same float64 weights."""
    jm = bnn_tpu.nn.Linear(6, 4, rngs=nnx.Rngs(seed))
    bnn_tpu.utils.cast_floats(jm, jnp.float64)
    tm = torch.nn.Linear(6, 4).double()
    rng = np.random.RandomState(seed)
    flat = {"kernel": rng.randn(6, 4), "bias": rng.randn(4)}
    jm.kernel[...] = jnp.asarray(flat["kernel"])
    jm.bias[...] = jnp.asarray(flat["bias"])
    load_jax_state(tm, flat)
    return jm, tm


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return rng.randn(6, 4), rng.randn(4)


def _step_both(jm, jopt, tm, topt, step):
    gk, gb = _grads(step)
    jgrads = nnx.grad(lambda m: (m.kernel[...] * gk).sum() + (m.bias[...] * gb).sum())(jm)
    jopt.update(jm, jgrads)
    tm.weight.grad = torch.from_numpy(gk.T.copy())
    tm.bias.grad = torch.from_numpy(gb.copy())
    topt.step()


def _assert_same(jm, tm, tol):
    """Each tensor within ``tol`` of JAX's: max |diff| over max |JAX's|."""
    for got, want in ((tm.weight.detach().numpy().T, jm.kernel[...]),
                      (tm.bias.detach().numpy(), jm.bias[...])):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("opt", sorted(_OPTS))
def test_recipe_optimizer_matches_optax(opt):
    """Five steps (a one-epoch warmup of 2 steps, then cosine) of the
    port's optimizer against optax's ``make_tx`` updates, fixed gradients,
    float64: each tensor within 1e-6 of its largest value. The first
    step's lr is 0 and changes nothing."""
    recipe = _recipe(_OPTS[opt], _WARM)
    with jax.enable_x64(True):
        jm, tm = _pair_linear()
        jopt = bnn_tpu.BinaryChef(recipe).make_optimizer(jm, 0, steps_per_epoch=2)
        chef = bt.BinaryChef(recipe)
        topt = chef.make_optimizer(tm, 0, steps_per_epoch=2)
        start = tm.weight.detach().clone()
        for step in range(5):
            assert topt.current_lr() == chef.lr_schedule(0, 2)(step)
            _step_both(jm, jopt, tm, topt, step)
            if step == 0:
                assert torch.equal(tm.weight.detach(), start)
            _assert_same(jm, tm, 1e-6)


@pytest.mark.parametrize("stop", [1, 4])
def test_resume_keeps_the_schedule_position(tmp_path, stop):
    """Stop mid-warmup (step 1 of 2) or mid-cosine (step 4), save, restore
    into an optimizer of the same recipe under another base lr: the lr
    continues at the schedule's position, and the weights follow JAX's
    restored optimizer (float64, 1e-6 relative)."""
    sched = {"name": "cosine", "warmup_epochs": 1}
    opt = {"name": "adamw", "lr": 1e-2, "weight_decay": 0.1}
    with jax.enable_x64(True):
        jm, tm = _pair_linear(1)
        jopt = bnn_tpu.BinaryChef(_recipe(opt, sched, 4)).make_optimizer(jm, 0, 2)
        topt = bt.BinaryChef(_recipe(opt, sched, 4)).make_optimizer(tm, 0, 2)
        for step in range(stop):
            _step_both(jm, jopt, tm, topt, step)
        save_checkpoint(str(tmp_path / "ck"), tm, opt_state=topt)
        jpayload = {"opt_state": jckpt.optimizer_state_dict(jopt)}

        resumed = dict(opt, lr=3e-3)
        jopt2 = bnn_tpu.BinaryChef(_recipe(resumed, sched, 4)).make_optimizer(jm, 0, 2)
        jckpt.restore_optimizer(jopt2, jpayload)
        chef2 = bt.BinaryChef(_recipe(resumed, sched, 4))
        topt2 = chef2.make_optimizer(tm, 0, 2)
        assert restore_optimizer(topt2, load_checkpoint(str(tmp_path / "ck"))) == []
        for step in range(stop, 8):
            want = float(_build_lr_schedule(3e-3, sched, 4, 2)(step))
            assert abs(topt2.current_lr() - want) <= 1e-7 * abs(want)
            assert topt2.current_lr() == chef2.lr_schedule(0, 2)(step)
            _step_both(jm, jopt2, tm, topt2, step)
            _assert_same(jm, tm, 1e-6)
    state = optimizer_state_dict(topt2)["state"]
    assert all(int(s["step"]) == 8 for s in state.values())


# --- the YAML reader ------------------------------------------------------------------

@pytest.mark.parametrize("path", RECIPES, ids=os.path.basename)
def test_block_yaml_reader_equals_safe_load(path):
    text = open(path).read()
    assert engine.read_block_yaml(text) == yaml.safe_load(text)
    assert bt.BinaryChef(path).loader == "PyYAML safe_load"


@pytest.mark.parametrize("text,line", [
    ("step0:\n  weight: {name: Identity}\n", 2),
    ("step0:\n  names: [a, b]\n", 2),
    ("step0:\n  - name: x\n", 2),
    ("step0:\n  a: 1\n    b: 2\n", 3),
    ("a: &x 1\n", 1),
    ("a: 1\nb: 0x1f\n", 2),
])
def test_block_yaml_reader_refuses_what_it_does_not_read(text, line):
    with pytest.raises(bt.RecipeError, match=f"line {line}"):
        engine.read_block_yaml(text)


def test_scalars_follow_yaml_1_1():
    text = ("a: 1.0e-3\nb: 1e-3\nc: yes\nd: 'it''s'\ne: \"q # not a comment\"\n"
            "f: 0\ng: -2\nh: ~\ni: bare words  # comment\nj: True\nk: 1_000\n")
    assert engine.read_block_yaml(text) == yaml.safe_load(text)


def test_import_and_chef_without_pyyaml():
    """``import bnn_tpu_torch`` imports no yaml; with yaml unimportable
    every recipe reads through the port's own reader, equal to PyYAML's."""
    code = (
        "import sys\n"
        "import bnn_tpu_torch\n"
        "assert 'yaml' not in sys.modules\n"
        "sys.modules['yaml'] = None\n"
        "for p in sys.argv[1:]:\n"
        "    chef = bnn_tpu_torch.BinaryChef(p)\n"
        "    print(chef.loader, len(chef), repr(chef.config))\n")
    run = subprocess.run([sys.executable, "-c", code, *RECIPES], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert run.returncode == 0, run.stderr[-2000:]
    lines = run.stdout.splitlines()
    assert len(lines) == len(RECIPES)
    for path, line in zip(RECIPES, lines):
        raw = yaml.safe_load(open(path))
        assert line == (f"bnn_tpu_torch.engine.read_block_yaml {len(raw)} "
                        f"{[dict(raw[k]) for k in raw]!r}")
