"""The twins of the JAX side's last experiment tools on the CPU:
``tools/torch_exp_megabatch.py``, ``torch_exp_serve_io.py``,
``torch_exp_serve_hetero.py``, the schedule of
``torch_gan_convergence_run.py`` and its r05 script's twin, and the seed
spread's wrapper of the JAX tool.

Held: the megabatch loop's K x B embeddings equal one forward of the
concatenated batch within 1e-6 x max|out|, with either stem; the io
twin's rows at ``--io_depth 0`` and N equal each other and ``serve.main``'s
on the same slides within 1e-6; the hetero twin's slides each a distinct
tile count, its ``--prewarm`` rows equal its plain rows within 1e-6, and
its count of chunk shapes that of ``streaming_chunk_for``; the GAN tool's
trainer arguments and schedule those the JAX tool passes for the same
flags (its ``main`` run with the JAX trainer and generator stubbed); the
seed spread's wrapper changes the JAX tool's trainer seed and nothing else;
and each tool exits 1 without a card."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    serve,
)
from tools import (
    gan_convergence_run as jtool,
    torch_exp_megabatch,
    torch_exp_serve_hetero,
    torch_exp_serve_io,
    torch_gan_convergence_r05,
    torch_gan_convergence_run as gconv,
    torch_gan_seed_spread,
)

JAX_PKG = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu"


@pytest.mark.parametrize("stem, res", [("cudnn", 64), ("kernel", 300)])
def test_megabatch_equals_one_forward_of_the_whole_batch(stem, res):
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        resnet,
    )

    cnn = resnet.init_resnet26(torch.Generator().manual_seed(0),
                               device="cpu")
    fwd = torch_exp_megabatch.make_forward(cnn, stem)
    x = torch_exp_megabatch.make_tiles(2, 2, res, 3, torch.device("cpu"))
    with torch.no_grad():
        got = torch_exp_megabatch.megabatch(fwd, x)
        want = fwd(x.reshape(4, res, res, 3))
    assert got.shape == (2, 2, resnet.EMBED_DIM)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got.reshape(4, -1) - want).abs().max()) <= 1e-6 * scale


def test_megabatch_cli_rows(capsys):
    assert torch_exp_megabatch.main(["--device", "cpu", "--configs",
                                     "1x1,2x1", "--rounds", "2", "--res",
                                     "32"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["stem"], r["K"], r["B"]) for r in rows] == [
        ("cudnn", 1, 1), ("cudnn", 2, 1)]
    for r in rows:
        assert len(r["tiles_per_s"]) == 2 and r["median_tiles_per_s"] > 0
        assert r["card"] == "cpu" and r["stem_launches"] == 0


IO_ARGS = ["--device", "cpu", "--arch", "tiny", "--res", "16", "--roi",
           "64", "--px", "256", "--n", "2", "--reps", "1"]


def _probs(rows):
    return {r[0]: np.array([float(v) for v in r[1:4]]) for r in rows}


def test_serve_io_variants_equal_each_other_and_serve_main(tmp_path,
                                                           monkeypatch):
    args = torch_exp_serve_io.build_argparser().parse_args(IO_ARGS)
    results, summary = torch_exp_serve_io.run(args, torch.device("cpu"))
    assert [r["io_depth"] for r in results] == [0, 2]
    assert summary["n_slides"] == 2 and summary["median_speedup"] > 0
    for r in results:
        assert [s["name"] for s in r["slides"]] == [
            "GHP_000_A_H&E", "GHP_001_A_H&E"]
        assert all(s["build_s"] > 0 and s["infer_s"] >= 0
                   for s in r["slides"])
    # the same cold slides through the daemon's CLI
    slides = torch_exp_serve_io.build_slides(str(tmp_path), args.n, args.px)
    monkeypatch.setenv("CACHE_DIR", str(tmp_path / "cache"))
    os.makedirs(tmp_path / "cache")
    out = str(tmp_path / "out")
    assert serve.main(torch_exp_serve_io.serve_argv(slides, out, args, 0),
                      device="cpu") == 0
    want = _probs(torch_exp_serve_io.read_rows(out))
    for r in results:
        got = _probs(r["rows"])
        assert set(got) == set(want)
        for name, p in want.items():
            np.testing.assert_allclose(got[name], p, atol=1e-6, rtol=0)


def test_serve_hetero_cohort_rows_and_shape_count(tmp_path):
    args = torch_exp_serve_hetero.build_argparser().parse_args([
        "--device", "cpu", "--arch", "tiny", "--res", "16", "--roi", "32",
        "--max_tiles", "26", "--keep", str(tmp_path)])
    sizes, (plain, warm) = torch_exp_serve_hetero.run(args)
    assert sizes == [17, 21, 26, 24]
    want_shapes = len({inference.streaming_chunk_for(n, args.chunk)
                       for n in sizes})
    for res in (plain, warm):
        assert res["rc"] == 0 and res["rc_repeat"] == 0
        assert sorted(res["slide_tiles"]) == sorted(sizes)
        assert res["distinct_sizes"] == len(sizes)
        # the prewarm chunk, min(chunk, max_tiles), is a slide's size here
        assert res["n_shapes"] == res["n_shapes_after_repeat"] == want_shapes
    assert _probs(plain["rows"]).keys() == _probs(warm["rows"]).keys()
    for name, p in _probs(plain["rows"]).items():
        np.testing.assert_allclose(_probs(warm["rows"])[name], p, atol=1e-6,
                                   rtol=0)


def _stub_jax_tool(monkeypatch, tmp_path, flags):
    """The JAX tool's ``main`` set up to run over ``flags`` with its
    trainer replaced by a recorder and its generator stubbed (no training,
    no sampling); returns the list the recorder appends each argv to."""
    import importlib

    jgan = importlib.import_module(f"{JAX_PKG}.train.gan")
    jsg = importlib.import_module(f"{JAX_PKG}.models.stylegan")
    seen = []

    def trainer(argv=None, *a, **k):
        seen.append(list(argv))
        return 1

    monkeypatch.setattr(jgan, "main", trainer)
    monkeypatch.setattr(jsg, "init_styled_generator", lambda *a, **k: None)
    monkeypatch.setattr(jtool, "generate", lambda g, n, step, *a, **k: (
        np.zeros((n, 4 * 2 ** step, 4 * 2 ** step, 3), np.float32)))
    monkeypatch.setattr(sys, "argv", ["gan_convergence_run.py",
                                      *_jax_args(tmp_path), *flags])
    return seen


def _jax_args(tmp_path):
    return ["--tiny", "--n_images", "16", "--keep", str(tmp_path)]


def _jax_trainer_argv(monkeypatch, tmp_path, flags):
    """The argv the JAX tool hands its trainer for ``flags``."""
    seen = _stub_jax_tool(monkeypatch, tmp_path, flags)
    assert jtool.main() == 1
    return seen[-1]


def _flag_map(argv):
    out, i = {}, 0
    while i < len(argv):
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            out[argv[i]] = argv[i + 1]
            i += 2
        else:
            out[argv[i]] = True
            i += 1
    return out


SCHEDULE_FLAGS = [
    [],
    ["--max_res", "32"],
    ["--max_res", "32", "--ema_warmup", "--epochs", "60", "--step_every",
     "10", "--ema_decay", "0.99", "--grad_accum", "2"],
    ["--res", "16", "--max_res", "64", "--epochs", "7"],
]


@pytest.mark.parametrize("flags", SCHEDULE_FLAGS)
def test_gan_tool_schedule_is_the_jax_tools(flags, monkeypatch, tmp_path):
    want = _flag_map(_jax_trainer_argv(monkeypatch, tmp_path, flags))
    args = gconv.build_argparser().parse_args(["--tiny", *flags])
    sched = gconv.schedule(args.res, args.max_res, args.epochs,
                           args.n_images, args.step_every)
    width = 1 / 16
    # the JAX tool at --n_images 16; the schedule at the same count
    sched16 = gconv.schedule(args.res, args.max_res, args.epochs, 16,
                             args.step_every)
    got = _flag_map(gconv.trainer_argv(args, "S", "O", width, sched16))
    for key in ("--data_dir", "--output_dir"):
        want.pop(key), got.pop(key)
    assert got.pop("--compute_dtype") == "f32"
    assert got == want
    # the record's resolution sequence and transitions, the JAX tool's
    # formulas (tools/gan_convergence_run.py:200-204)
    init_step = int(np.log2(args.res)) - 2
    max_step = int(np.log2(args.max_res or args.res)) - 2
    seq = [min(init_step + e // sched["step_every"], max_step)
           for e in range(args.epochs)]
    assert sched["res_seq"] == seq
    assert sched["res_transitions"] == sum(
        a != b for a, b in zip(seq, seq[1:]))
    assert sched["ckpt_every"] == sched["step_every"]
    assert sched["pre_transition_epoch"] == (
        sched["step_every"] - 1 if sched["res_transitions"] else None)


def test_seed_spread_changes_the_seed_and_nothing_else(monkeypatch,
                                                       tmp_path):
    base = _jax_trainer_argv(monkeypatch, tmp_path, [])
    i = base.index("--seed")
    assert base[i + 1] == "1"
    for k in (2, 5):
        seen = _stub_jax_tool(monkeypatch, tmp_path, [])
        assert torch_gan_seed_spread.jax_child(k, _jax_args(tmp_path)) == 1
        got = seen[-1]
        assert got[i + 1] == str(k)
        assert got[:i + 1] + got[i + 2:] == base[:i + 1] + base[i + 2:]


def test_seed_spread_summary():
    rows = [{"trainer": t, "seed": s, "band_dist_generator": d}
            for t, s, d in (("jax", 2, 0.2), ("jax", 1, 0.1),
                            ("port", 1, 0.12), ("port", 2, None))]
    out = torch_gan_seed_spread.spread(rows)
    assert out["jax"] == {"seeds": [1, 2], "band_dist_generator": [0.1, 0.2],
                          "min": 0.1, "median": pytest.approx(0.15),
                          "max": 0.2, "miss_bar": 1}
    assert out["port"]["miss_bar"] == 1 and out["port"]["max"] == 0.12


@pytest.mark.parametrize("tool, argv", [
    (torch_exp_megabatch, []), (torch_exp_serve_io, []),
    (torch_exp_serve_hetero, []), (torch_gan_convergence_r05, ["--out", "x"]),
    (gconv, [])])
def test_each_tool_exits_1_without_a_card(tool, argv, capsys, monkeypatch,
                                          tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
