"""The port's fit sweep, serving sweep and health probe on the CPU
(``tools/torch_exp_gan512.py``, ``torch_exp_serve.py``,
``torch_chip_health.py``).

The fit probe's full-width 8 px d+g pair fits with finite losses; an
out-of-memory error gives an ``oom: true`` row and exit 0, any other
failure an ``oom: false`` row and exit 1, in the child and in the sweep.
The serving sweep's CPU smoke (the twin's own arguments) writes, for each
of its in-process variants, ``results.csv`` rows equal to
``train.serve.main`` on the same cohort within 1e-6. The health probe
exits 0 with ``--device cpu``, 1 without a card, and 1 within its budget
plus 5 s when its probe hangs. Imports nothing of JAX."""

import json
import subprocess
import time

import pytest
import torch

import torch_tool_probes
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    serve,
)
from tools import (
    torch_chip_health,
    torch_exp_gan512,
    torch_exp_serve,
    torch_profile_gan,
    torch_profile_stages,
)


def _rows(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


PROBE = ["--probe", "--device", "cpu", "--res", "8", "--batch", "2"]


def test_fit_probe_fits_with_finite_losses(capsys):
    assert torch_exp_gan512.main(PROBE) == 0
    row, = _rows(capsys)
    assert row["fit"] is True and row["platform"] == "cpu"
    assert row["res"] == 8 and row["batch"] == 2 and row["dtype"] == "f32"
    for key in ("imgs_per_sec", "step_secs", "compile_secs", "peak_mem_gb",
                "card", "power_limit"):
        assert key in row
    assert all(abs(row[k]) < float("inf") for k in ("disc_loss", "g_loss"))


def test_out_of_memory_is_a_row_and_exit_0(capsys, monkeypatch):
    def oom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                     "2.00 GiB")

    monkeypatch.setattr(torch_exp_gan512, "probe", oom)
    assert torch_exp_gan512.main(PROBE) == 0
    row, = _rows(capsys)
    assert row["fit"] is False and row["oom"] is True
    assert row["error"].startswith("OutOfMemoryError: CUDA out of memory")


def test_any_other_failure_is_a_row_and_exit_1(capsys, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("a shape mismatch")

    monkeypatch.setattr(torch_exp_gan512, "probe", broken)
    assert torch_exp_gan512.main(PROBE) == 1
    row, = _rows(capsys)
    assert row["fit"] is False and row["oom"] is False
    assert "a shape mismatch" in row["error"]


def _child(rows_by_batch):
    """A stand-in for the sweep's ``subprocess.run``: the child's row and
    exit code by batch."""
    def run(cmd, **kw):
        batch = int(cmd[cmd.index("--batch") + 1])
        row, rc = rows_by_batch[batch]
        return subprocess.CompletedProcess(cmd, rc, json.dumps(row) + "\n",
                                           "")
    return run


def test_sweep_walks_the_ladder_and_fails_on_a_non_oom_row(capsys,
                                                           monkeypatch):
    oom = {"fit": False, "oom": True, "error": "OutOfMemoryError"}
    fit = {"fit": True, "imgs_per_sec": 1.0}
    monkeypatch.setattr(torch_exp_gan512.subprocess, "run",
                        _child({4: (oom, 0), 2: (fit, 0), 1: (fit, 0)}))
    assert torch_exp_gan512.main(["--device", "cpu", "--dtypes", "f32",
                                  "--batches", "4,2,1"]) == 0
    assert [r["fit"] for r in _rows(capsys)] == [False, True]  # stops at 2

    bad = {"fit": False, "oom": False, "error": "RuntimeError"}
    monkeypatch.setattr(torch_exp_gan512.subprocess, "run",
                        _child({4: (bad, 1), 2: (fit, 0)}))
    assert torch_exp_gan512.main(["--device", "cpu", "--dtypes", "f32",
                                  "--batches", "4,2"]) == 1


SERVE_SMOKE = ["--cpu", "--arch", "tiny", "--res", "16", "--roi", "32",
               "--tiles", "24", "--slides", "6"]


def test_serve_sweep_rows_equal_serve_main(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("CACHE_DIR", str(tmp_path / "unused"))
    root = tmp_path / "sweep"
    assert torch_exp_serve.main(SERVE_SMOKE + ["--keep", str(root)]) == 0
    rows = _rows(capsys)
    variants = {"serial_bf16": [], "batched_x8": ["--batch", "8"],
                "serial_int8": ["--int8"]}
    assert [r["variant"] for r in rows] == list(variants)
    for r in rows:
        assert r["rc"] == 0 and r["n_slides"] == 6 and r["device"] == "cpu"
        for key in ("cold_first_slide_secs", "warm_secs_per_slide",
                    "warm_slides_per_min", "drain_wall_secs"):
            assert key in r
    for tag, extra in variants.items():
        ref = tmp_path / f"ref_{tag}"
        assert serve.main(["--watch_dir", str(root / "slides"),
                           "--out_root", str(ref), "--arch", "tiny",
                           "--resolution", "16", "--roi_size", "32",
                           "--chunk", "1024", "--once", "--settle_secs",
                           "0", "--seed", "0"] + extra, device="cpu") == 0
        got = sorted(torch_exp_serve.read_results(str(root / f"out_{tag}")))
        want = sorted(torch_exp_serve.read_results(str(ref)))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            # name, pred and ntiles equal; the probabilities and Aterm_var
            # within 1e-6
            assert (g[0], g[4], g[6]) == (w[0], w[4], w[6])
            for i in (1, 2, 3, 5):
                assert abs(float(g[i]) - float(w[i])) <= 1e-6, (tag, g, w)


def test_health_on_the_cpu_exits_0(capsys):
    assert torch_chip_health.main(["--device", "cpu"]) == 0
    row, = _rows(capsys)
    assert row["healthy"] is True and row["stage"] == "cpu_host"


def test_health_without_a_card_exits_1_naming_it(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        torch_chip_health.main([])
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_health_with_a_hung_probe_exits_1_within_its_budget(capsys):
    budget = 3.0
    t0 = time.monotonic()
    rc = torch_chip_health.main(["--device", "cpu", "--budget",
                                 str(budget)], target=torch_tool_probes.hang)
    assert rc == 1
    assert time.monotonic() - t0 <= budget + 5
    row, = _rows(capsys)
    assert row["healthy"] is False and row["stage"] == "unreachable"


@pytest.mark.parametrize("tool, argv", [
    (torch_exp_gan512, ["--probe"]), (torch_exp_gan512, []),
    (torch_exp_serve, []), (torch_profile_stages, []),
    (torch_profile_stages, ["--train"]), (torch_profile_gan, [])])
def test_tools_without_a_card_exit_1_naming_it(tool, argv, capsys,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
