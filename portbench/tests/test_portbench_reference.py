"""The frozen plain reference against the port at a small input size on the
CPU, both in float32 (at the same precision the two agree to rounding, so a
departure from the port's semantics shows): the served logits of both
configurations, and three QAT training steps with AdamW."""
import pytest
import torch

from portbench import arch, program, weights
from portbench.reference import common
from portbench.reference import resnet as reference
from portbench.traffic import train_steps

SIZE = 48


def config(name):
    return dict(arch.load_config(name), image_size=SIZE, dtype="float32",
                train_compute_dtype="float32")


@pytest.mark.parametrize("name", ["resnet18-flagship", "resnet50-flagship"])
@pytest.mark.parametrize("batch", [2, 8])
def test_served_logits_match_the_reference(name, batch):
    cfg = config(name)
    state = weights.make_state(cfg, 5, "cpu")
    x = weights.make_images(5, batch, (3, SIZE, SIZE), "cpu", 1)
    pred = program.predictor(program.qat_model(cfg, state, "cpu"), cfg, batch, "cpu")
    got = pred(x).float()
    want = common.logits(reference.Forward, cfg, state, x)
    assert ((got - want).norm(dim=1) / want.norm(dim=1)).max() < 1e-5


def test_training_steps_match_the_reference():
    cfg = config("resnet18-flagship")
    state = weights.make_state(cfg, 6, "cpu")
    batches = [(weights.make_images(6, 8, (3, SIZE, SIZE), "cpu", 10 + i),
                weights.make_labels(6, 8, 1000, "cpu", 20 + i)) for i in range(3)]
    model = program.qat_model(cfg, state, "cpu").train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    step = program.train_step(cfg)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses, grads = [], {}
    for i, (x, y) in enumerate(batches):
        losses.append(float(step(model, opt, x, y)["loss"]))
        if i == 0:
            grads = {k: float((opt.state[p]["exp_avg"] / 0.1).norm())
                     for k, p in model.named_parameters()}
    change = {k: float((p.detach() - start[k]).norm()) for k, p in model.named_parameters()}
    ref = common.train_steps(reference.Forward, cfg, state, batches, lr=1e-3,
                             weight_decay=1e-4)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    got = train_steps.numbers({"losses": losses, "grad_norms": grads, "change_norms": change},
                              ref)
    assert got["grad_norm_gap"] < 1e-4
    # Adam's normalised steps carry f32 rounding of tiny moments into the
    # change (a few 1e-4 of a parameter after three steps)
    assert got["change_norm_gap"] < 3e-3


def test_state_spec_names_the_port_model():
    for name in ("resnet18-flagship", "resnet50-flagship"):
        cfg = config(name)
        state = weights.make_state(cfg, 1, "cpu")
        model = program.qat_model(cfg, state, "cpu")
        assert set(model.state_dict()) == set(state)


def test_weights_come_from_the_seed():
    cfg = config("resnet18-flagship")
    a, b = weights.make_state(cfg, 2**31 + 5, "cpu"), weights.make_state(cfg, 2**31 + 5, "cpu")
    c = weights.make_state(cfg, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer1.0.conv1.weight"], c["layer1.0.conv1.weight"])
    assert float(a["layer2.0.bn1.running_var"].min()) >= 0.5
