"""The frozen reference against the port at a tiny size on the CPU, and
the harness's check with the timed path broken underneath: each fault a
one-card training cell can have reads ``correct`` false."""

import time

import pytest
import torch

from conftest import tiny_cell
from harness import check, gen, runner, sides

SEED = 2200000077


@pytest.fixture(scope="module")
def cell():
    return tiny_cell()


@pytest.fixture(scope="module")
def inputs(cell):
    return gen.make_inputs(cell.config, cell.traffic, SEED, "cpu",
                           sides.pwcnet_meta())


def test_the_reference_agrees_with_the_port(cell, inputs):
    """Both sides' checked steps from the same inputs: the same losses,
    first gradients and changes (the port's CPU path runs the kernels'
    plain twins, which the reference copies)."""
    n = cell.traffic["checked_steps"]
    reads = []
    for pkg in (sides.PORT, sides.REFERENCE):
        side = sides.build(pkg, inputs, cell.config, cell.traffic, "cpu")
        reads.append(check.checked_steps(side, inputs, n))
    prog, ref = reads
    assert all(x > 0 for x in ref.loss)
    assert prog.loss == pytest.approx(ref.loss, rel=1e-6, abs=0)
    for leaf in ref.grad:
        assert prog.grad[leaf] == pytest.approx(ref.grad[leaf], rel=1e-5)
        assert prog.change[leaf] == pytest.approx(ref.change[leaf], rel=1e-5)
    numbers = check.compare(prog, ref)
    correct, rows = check.verdict(numbers, cell.limits)
    assert correct, rows
    # the renders themselves: one step's outputs side by side
    outs = []
    for pkg in (sides.PORT, sides.REFERENCE):
        side = sides.build(pkg, inputs, cell.config, cell.traffic, "cpu")
        static, dyn, tracks, _, _ = gen.step_batches(
            inputs, 0, side.frame_batch, side.track_batch)
        render = side.module("models.scene").render
        with torch.no_grad():
            outs.append(render(side.scene, dyn.ts[0].float(), dyn.w2cs[0],
                               dyn.Ks[0], inputs.wh, mode="blury",
                               num_exposure=cell.config["num_exposure"],
                               cap=cell.config["tile_cap"], return_mask=True,
                               return_depth=True))
    for key in ("img", "acc", "mask", "depth"):
        torch.testing.assert_close(outs[0][key], outs[1][key], rtol=1e-6,
                                   atol=1e-6)


def _run(cell):
    return runner.run_cell(cell, SEED, 0.5, False, "cpu", (1.0, 1.0),
                           time.time())


def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out.correct, out.checks
    assert set(out.metrics) == {"step_ms", "setup_s"}
    assert out.attempted > cell.traffic["checked_steps"] and out.failed == 0


def _unchanged(monkeypatch):
    from deblur4dgs_tpu_torch.train import optimizers
    monkeypatch.setattr(optimizers.SceneAdam, "update",
                        lambda self, grads, state, scene: state)


def _half_batch(monkeypatch):
    from deblur4dgs_tpu_torch.train import trainer
    orig = trainer.rgb_l1_ssim

    def half(pred, gt, mask=None):
        h = pred.shape[1] // 2
        return orig(pred[:, :h], gt[:, :h],
                    None if mask is None else mask[:, :h])
    monkeypatch.setattr(trainer, "rgb_l1_ssim", half)


def _double_move(monkeypatch):
    from deblur4dgs_tpu_torch.train import optimizers
    orig = optimizers.adam_apply

    def twice(spec, gs, grads, params):
        if "bg.means" in grads:
            before = params["bg.means"].detach().clone()
            orig(spec, gs, grads, params)
            params["bg.means"].mul_(2).sub_(before)
        else:
            orig(spec, gs, grads, params)
    monkeypatch.setattr(optimizers, "adam_apply", twice)


def _altered_answer(monkeypatch):
    from deblur4dgs_tpu_torch.models import scene
    orig = scene.render

    def render(*a, **kw):
        out = orig(*a, **kw)
        out["img"] = out["img"] * 1.01
        return out
    monkeypatch.setattr(scene, "render", render)
    from deblur4dgs_tpu_torch.train import trainer
    monkeypatch.setattr(trainer, "render", render)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _double_move,
                                   _altered_answer])
def test_a_broken_step_reads_not_correct(cell, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(cell)
    assert not out.correct, out.checks


def test_the_same_seed_gives_the_same_inputs(cell):
    make = lambda seed: gen.make_inputs(cell.config, cell.traffic, seed,
                                        "cpu", sides.pwcnet_meta())
    a, b, c = make(SEED), make(SEED), make(SEED + 1)
    for part in ("scene", "move", "pwcnet", "frames"):
        da, db, dc = (getattr(x, part) for x in (a, b, c))
        assert da.keys() == db.keys()
        assert all(torch.equal(da[k], db[k]) for k in da)
    assert not torch.equal(a.scene["fg.means"], c.scene["fg.means"])
    assert (a.schedule == b.schedule).all()
    first = [tuple(p) for p in a.schedule[:cell.traffic["checked_steps"]]]
    assert len(set(first)) == len(first)
