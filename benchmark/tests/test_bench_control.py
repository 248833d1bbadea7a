"""On a card: the control (the reference with TF32 on, the nearest
precision below the configurations' float32, put in the program's place)
fails the cell's check, and the port passes it, at the low cell's own
size on one seed. calibrate.py reads both on a dozen seeds and more."""

import importlib

import pytest

import calibrate
from harness import check, gen, runner, sides, spec

pytestmark = pytest.mark.card
SEED = 2200002001


@pytest.mark.parametrize("name", ["low.stage2"])
def test_the_control_and_the_half_batch_fault_fail_the_port_passes(card, name):
    cell = spec.load_cell(name)
    cfg, traffic = cell.config, cell.traffic
    inputs = gen.make_inputs(cfg, traffic, SEED, "cuda", sides.pwcnet_meta())
    prog = sides.build(sides.PORT, inputs, cfg, traffic, "cuda")
    prog_read = check.checked_steps(prog, inputs, traffic["checked_steps"])
    del prog
    ref = runner.reference_readings(inputs, cfg, traffic, "cuda")
    assert check.verdict(check.compare(prog_read, ref), cell.limits)[0]
    ctrl = runner.reference_readings(inputs, cfg, traffic, "cuda", tf32=True)
    assert not check.verdict(check.compare(ctrl, ref), cell.limits)[0]
    undo = calibrate.half_batch(
        importlib.import_module("reference.train.trainer"))
    try:
        half = runner.reference_readings(inputs, cfg, traffic, "cuda")
    finally:
        undo()
    assert not check.verdict(check.compare(half, ref), cell.limits)[0]
