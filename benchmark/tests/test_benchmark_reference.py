"""The plain references against the port at a tiny size on the CPU, both in
float32: the references are the program's semantics, written apart."""

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.tests import tiny

SEED = 2 ** 31 + 3
CPU = torch.device("cpu")


def _run(name, **cfg):
    c = tiny.cell(name)
    c["config"].update(cfg)
    return harness.Run(c, SEED, CPU)


@pytest.mark.parametrize("name", ["mil26_stream_cohort",
                                  "critic_onepass_cohort"])
def test_serving_matches_the_reference(name):
    run = _run(name, dtype="f32")
    run.setup()
    run.window(0.2)
    assert run.done
    pairs = [(out, run.ref.slide(run.weights, run._raw(t, o), run.cfg))
             for t, o, out, _ in run.done[:6]]
    gaps = compare.serve_numbers(pairs)
    assert gaps["prob_gap"] < 1e-6
    assert gaps["aterm_gap"] < 1e-5 and gaps["mterm_gap"] < 1e-5


def test_training_matches_the_reference():
    run = _run("mil26_train_window", dtype="f32")
    run.setup()
    mix = run.mix
    ref = run.ref.train_steps(run.weights, run.checked,
                              lambda o: run._raw(mix["bag_tiles"], o),
                              run.cfg, lr=mix["lr"], pad=mix["pad"])
    gaps = compare.train_numbers(run.prelude, ref)
    # the first gradient agrees to float32's sums; Adam's step turns an
    # element's gradient near zero into a step of the learning rate whose
    # sign the order of the sums decides, so the later losses and the
    # change after three steps agree more loosely
    assert gaps["grad_gap"] < 1e-4
    assert gaps["loss_gap"] < 1e-4 and gaps["change_gap"] < 2e-2


def test_reference_precisions_order():
    """bfloat16 and float8 products move the reference's answer, float8
    the more."""
    run = _run("mil26_stream_cohort")
    raw = run._raw(24, 0)
    exact = run.ref.slide(run.weights, raw, run.cfg)
    gaps = [compare.serve_numbers([(run.ref.slide(run.weights, raw, run.cfg,
                                                  prec=p), exact)])
            ["aterm_rms"] for p in ("bf16", "fp8")]
    assert 0 < gaps[0] < gaps[1]
    assert np.isfinite(gaps).all()
