"""The check of ``correct`` catches what it must: a run driven on the CPU
(the look for a card skipped) with the timed path broken underneath
comes out not correct, once for each fault the cell can have; and the
control, the reference with TF32 products put in the program's place,
comes out not correct.  One card: no exchange between chips to leave
out."""
import pytest
import torch

from benchmarks.harness import compare, manifest, runner

TRAIN = [("train-b64-g524k", {"nodes": 2048}),
         ("train-ln64-g262k", {"nodes": 2048})]
SCORE = ("score-b64-mix", {"graphs": [256, 512, 1024, 2048]})


def _run(cell, override):
    return runner.run_cell(cell, 12345, 2.0, False, "cpu",
                           traffic_override=override)


@pytest.mark.parametrize("cell,override", TRAIN)
def test_state_unchanged(monkeypatch, cell, override):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    r = _run(cell, override)
    assert not r["correct"] and r["checks"]["change_gap"]["value"] == 1.0


@pytest.mark.parametrize("cell,override", TRAIN)
def test_half_the_batch_left_out(monkeypatch, cell, override):
    from gnnome_tpu_torch.train import step

    loss = step.symmetry_loss

    def half(org, rev, labels, *a, **k):
        n = org.shape[0] // 2
        return loss(org[:n], rev[:n], labels[:n], *a, **k)

    monkeypatch.setattr(step, "symmetry_loss", half)
    r = _run(cell, override)
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > \
        r["checks"]["loss_gap"]["limit"]


def _patch_logits(monkeypatch, fault):
    from gnnome_tpu_torch.models.sym_gated_gcn import SymGatedGCN

    forward = SymGatedGCN.forward

    def broken(self, *a, **k):
        out = forward(self, *a, **k).clone()
        fault(out)
        return out

    monkeypatch.setattr(SymGatedGCN, "forward", broken)


def test_answer_altered(monkeypatch):
    def alter(out):
        out[out.shape[0] // 3] += 1.0

    _patch_logits(monkeypatch, alter)
    assert not _run(*SCORE)["correct"]


def test_half_the_answers_left_out(monkeypatch):
    def half(out):
        out[out.shape[0] // 2:] = 0.0

    _patch_logits(monkeypatch, half)
    assert not _run(*SCORE)["correct"]


@pytest.mark.parametrize("cell,override", TRAIN + [SCORE])
def test_control_is_not_correct(cell, override):
    c = manifest.cell(cell)
    mod = manifest.load_module("drivers", c.traffic["driver"] + ".py")
    drv = mod.Driver(c.config, dict(c.traffic, **override), 777, "cpu")
    drv.setup()
    if drv.kind == "score":
        drv.window(2.0)
    drv.release()
    ref = drv.reference()
    correct, checks = compare.verdict(
        drv.gaps(drv.reference(tf32=True), ref), c.limits)
    assert not correct, checks
