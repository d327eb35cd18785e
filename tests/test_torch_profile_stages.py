"""``tools/torch_profile_stages.py`` against its JAX twin and the port.

The analytic FLOP count equals the JAX tool's exactly, and equals the
count of what the port's ``ResNet26`` forward runs: a torch function mode
records every ``F.conv2d`` and product of the forward (on the meta device,
so 300 px costs nothing), each by the ``Conv2d`` / ``Linear`` module whose
weight it takes, and every such module must be reached. The six segments
composed equal the forward within 1e-6 x max|emb| (f32, 64 px, batch 2);
each matches the JAX tool's ``build_segments(params,
compute_dtype=jnp.float32)`` on weights carried by ``utils/interop.py``
within 1e-5 x max(1, max|out|)."""

import collections
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    resnet as jresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    resnet as tresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)
from tools import profile_stages as jtool
from tools import torch_profile_stages as tool


@pytest.mark.parametrize("res", [300, 256, 64])
def test_segment_flops_equal_the_jax_tool(res):
    assert tool.segment_flops(res) == jtool.segment_flops(res)


class _CountFlops(TorchFunctionMode):
    """Every convolution and product the forward runs, by the module whose
    weight it takes (the fc's enters the product as a transposed view of
    it): 2 x MACs a tile."""

    def __init__(self, owner):
        super().__init__()
        self.owner = owner       # id(weight) -> module name
        self.flops = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is F.conv2d:
            w = args[1]
            _, co, ho, wo = out.shape
            _, ci, kh, kw = w.shape
            self.flops[self.owner[id(w)]] += 2.0 * ho * wo * kh * kw * ci * co
        elif func in (torch.matmul, torch.Tensor.matmul):
            w = args[1]
            base = w if w._base is None else w._base
            self.flops[self.owner[id(base)]] += 2.0 * w.shape[0] * w.shape[1]
        return out


def _segment_of(name):
    return ("stem" if name == "conv1" else "pool_fc" if name == "fc"
            else "stage" + name[len("layer"):].split(".")[0])


@pytest.mark.parametrize("res", [300, 256, 64])
def test_segment_flops_equal_what_the_forward_runs(res):
    cnn = tresnet.ResNet26(device="meta")
    owner = {id(m.weight): name for name, m in cnn.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    counter = _CountFlops(owner)
    with counter:
        cnn(torch.empty((1, res, res, 3), device="meta"))
    assert set(counter.flops) == set(owner.values())   # every module reached
    by_segment = collections.Counter()
    for name, f in counter.flops.items():
        by_segment[_segment_of(name)] += f
    assert dict(by_segment) == tool.segment_flops(res)


@pytest.fixture(scope="module")
def carried():
    """Full-width JAX parameters and the port's ResNet26 holding them."""
    jp = jax.jit(jresnet.init_resnet26)(jax.random.PRNGKey(0))
    cnn = tresnet.ResNet26(device="cpu")
    interop.load_jax_params(cnn, jp)
    return jp, cnn


def test_segments_compose_to_the_forward(carried):
    _, cnn = carried
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 64, 64, 3), np.float32))
    with torch.no_grad():
        want = cnn(x)
        h = x
        for _, fn in tool.build_segments(cnn, compute_dtype=None):
            h = fn(h)
    assert h.shape == want.shape == (2, tresnet.EMBED_DIM)
    assert float((h - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_kernel_stem_segments_compose_to_forward_u8(carried):
    """The stem kernel's segments (its plain version on the CPU) composed
    equal ``ResNet26.forward_u8``, the whole forward ``--stem kernel``
    times."""
    _, cnn = carried
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (1, 300, 300, 3), generator=g,
                      dtype=torch.uint8)
    with torch.no_grad():
        want = tool.full_forward(cnn, "kernel", compute_dtype=None)(x)
        h = x
        for _, fn in tool.build_segments(cnn, compute_dtype=None,
                                         stem="kernel"):
            h = fn(h)
    assert float((h.float() - want).abs().max()) <= (
        1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("name", list(tool.SEGMENTS))
def test_segment_matches_the_jax_tool(name, carried):
    jp, cnn = carried
    shape = tool.segment_shapes(2, 64)[name]
    x = np.random.default_rng(1).random(shape, np.float32)
    jfn = dict(jtool.build_segments(jp, compute_dtype=jnp.float32))[name]
    want = np.asarray(jfn(jnp.asarray(x)))
    fn = dict(tool.build_segments(cnn, compute_dtype=None))[name]
    xt = torch.from_numpy(x)
    if name != "stem":
        xt = xt.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
    with torch.no_grad():
        got = fn(xt)
    if got.ndim == 4:
        got = got.permute(0, 2, 3, 1)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_json_has_the_twins_keys_and_the_calibration_share(capsys):
    assert tool.main(["--device", "cpu", "--batch", "2", "--res", "64",
                      "--iters", "1", "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("batch", "res", "segments", "full_sec", "seg_sum_sec",
                "full_tflops", "tiles_per_sec"):
        assert key in row
    assert [s["name"] for s in row["segments"]] == list(tool.SEGMENTS)
    for s in row["segments"]:
        assert set(s) == {"name", "sec", "gflops", "tflops",
                          "share_of_calibration"}
        assert s["share_of_calibration"] == pytest.approx(
            s["tflops"] / row["calibration_tflops"])
    assert row["card"] == "cpu" and row["device"] == "cpu"
    assert row["pool_launches"] == row["stem_launches"] == 0


def test_kernel_stem_json_times_the_composition_beside_the_stem(capsys):
    """``--stem kernel`` adds the seconds of the composition that the bf16
    stem's one launch replaces (the stem kernel, the cast, LeakyReLU and
    max-pool); on the CPU neither stem kernel launches."""
    assert tool.main(["--device", "cpu", "--batch", "1", "--res", "300",
                      "--iters", "1", "--stem", "kernel", "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["stem"] == "kernel" and row["stem_composition_sec"] > 0
    assert row["stem_launches"] == row["stem_pool_launches"] == 0


def test_train_decomposition_runs_on_the_cpu(capsys):
    tool.main(["--device", "cpu", "--train", "--tiles-per-bag", "10",
               "--res", "32", "--iters", "2", "--json"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["pooled_T"] == 2
    assert [r["remat"] for r in row["rows"]] == [False, True]
    for r in row["rows"]:
        assert r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 and r["step_ms"] > 0


def test_kernel_stem_refuses_other_sizes():
    with pytest.raises(SystemExit, match="300 px"):
        tool.profile_forward(2, 64, 1, torch.device("cpu"), stem="kernel")
