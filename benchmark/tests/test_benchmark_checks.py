"""The check that decides ``correct`` fails where it must: the control in
the program's place, and each fault a cell can have planted in the timed
path underneath a whole run (the look for a card skipped), at a size a
test run holds, against the cells' own limits."""

import pytest
import torch

from benchmark import calibrate, compare, harness
from benchmark.tests import tiny

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import gated_pool  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import steps  # noqa: E501

CPU = torch.device("cpu")
SERVE = ("mil26_stream_cohort", "critic_onepass_cohort")
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def _correct(name, **kw):
    result, _, _ = harness.run_cell(tiny.cell(name), seed=SEEDS[0],
                                    seconds=0.3, trace=False, device=CPU,
                                    t_start=0.0, **kw)
    return result["correct"]


CONTROLS = [(name, kind) for name in tiny.CELLS
            for kind in (("control",) if name == "mil26_train_window"
                         else ("control", "fp8"))]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,kind", CONTROLS)
def test_the_control_is_not_correct(name, kind, seed):
    """The lower precision in the program's place: the program's int8
    path or the reference a step below the configuration's precision
    (``control``), and the reference with its head in float8 (``fp8``)."""
    cell = tiny.cell(name)
    row = calibrate.one_seed(cell, seed, 0.3, kind, CPU)
    ok, checks = compare.verdict(row["numbers"], cell["limits"])
    assert not ok, checks


def _pool_altered(a_raw, b, mask, weight_mask, _pool=gated_pool.gated_attention_pool):
    """One tile's attention (the heatmap's answer) doubled where the pool
    produces it."""
    m, a1t, wrois = _pool(a_raw, b, mask, weight_mask)
    a1t = a1t.clone()
    a1t[:, 0] *= 2.0
    return m, a1t, wrois


@pytest.mark.parametrize("name", SERVE)
def test_serving_faults_are_not_correct(name, monkeypatch):
    assert _correct(name)
    with monkeypatch.context() as m:
        # half of each bag left out of the pool, the mean over the rest
        m.setattr(gated_pool, "gated_attention_pool",
                  calibrate.pool_over_half(gated_pool.gated_attention_pool))
        assert not _correct(name)
    with monkeypatch.context() as m:
        # an answer altered where it is produced
        m.setattr(gated_pool, "gated_attention_pool", _pool_altered)
        assert not _correct(name)


def _wrapped_step(change):
    make = steps.make_train_step

    def make_step(cfg, **kw):
        step = make(cfg, **kw)

        def broken(model, opt, tiles, masks, labels, lr, **noise):
            return change(step, model, opt, tiles, masks, labels, lr,
                          **noise)
        return broken
    return make_step


def _half(step, model, opt, tiles, masks, labels, lr, scores, keep):
    h = max(1, len(tiles) // 2)
    return step(model, opt, tiles[:h], masks[:h], labels[:h], lr,
                scores=scores[:h], keep=keep[:h])


def _doubled_gradient(opt, lr, _apply=steps.apply_updates):
    """The first leaf's gradient doubled where the backward left it."""
    p = opt.param_groups[0]["params"][0]
    if p.grad is not None:
        p.grad.mul_(2.0)
    _apply(opt, lr)


def test_training_faults_are_not_correct(monkeypatch):
    name = "mil26_train_window"
    assert _correct(name)
    with monkeypatch.context() as m:
        # a step that leaves the state unchanged
        m.setattr(steps, "apply_updates",
                  lambda opt, lr: opt.zero_grad(set_to_none=True))
        assert not _correct(name)
    with monkeypatch.context() as m:
        # half of each window's bags left out, the mean over the rest
        m.setattr(steps, "make_train_step", _wrapped_step(_half))
        assert not _correct(name)
    with monkeypatch.context() as m:
        # an answer (a leaf's gradient) altered where it is produced
        m.setattr(steps, "apply_updates", _doubled_gradient)
        assert not _correct(name)
