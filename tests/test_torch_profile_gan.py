"""``tools/torch_profile_gan.py`` against the JAX package and the port.

The microbenchmark's ops (``blur``, the fused downsample, the plain conv
followed by a 2x2 mean, the fused upsample) match JAX's ``sg.blur`` /
``sg.fused_downsample`` / the twin's ``reduce_window`` formula /
``sg.fused_upsample`` on weights carried in the JAX layout, within 1e-5 x
max|ref|. The gradients of the tool's two critic pieces, without the
penalty and the penalty alone, sum to the gradient of the port's whole
WGAN-GP critic loss (``train/gan.d_loss``) on the same real and fake
images, eps and dropout masks, within 1e-5 relative (f32)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    stylegan as jsg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    gan,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)
from tools import torch_profile_gan as tool

W = 1 / 16


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("res", [16, 64])
def test_op_microbench_ops_match_jax(res):
    cin, cout, down, plain, up = tool.op_modules(res, W, "cpu")
    fns = tool.op_fns(down, plain, up)
    x = np.random.default_rng(res).standard_normal(
        (2, res, res, cin)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w5 = interop.gan_to_jax(down.weight.detach().numpy(), interop.CONV)
    b5 = down.bias.detach().numpy()
    wp = interop.gan_to_jax(plain.conv.weight_orig.detach().numpy(),
                            interop.CONV)
    wu = interop.gan_to_jax(up.weight.detach().numpy(), interop.FUP)
    bu = up.bias.detach().numpy()
    xj = jnp.asarray(x)
    want = {
        "blur": jsg.blur(xj),
        "fused_down": jsg.fused_downsample(xj, w5, b5, padding=2),
        "plain_down": jax.lax.reduce_window(
            jsg.equal_conv2d(xj, wp, b5, padding=2), 0.0, jax.lax.add,
            (1, 2, 2, 1), (1, 2, 2, 1), "VALID") / 4.0,
        "fused_up": jsg.fused_upsample(xj, wu, bu, padding=2)}
    assert set(fns) == set(want)
    with torch.no_grad():
        for name, fn in fns.items():
            got = fn(xt).permute(0, 2, 3, 1).numpy()
            assert got.shape == want[name].shape, name
            assert _rel(got, want[name]) <= 1e-5, name


def _grads(params):
    return [torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for p in params]


@pytest.mark.parametrize("step", [1, 2])
def test_critic_pieces_sum_to_the_whole_loss_gradient(step):
    gen, disc, *_ = tool.make_nets(W, "cpu")
    batch = 4
    g = torch.Generator().manual_seed(3)
    real = torch.randn((batch, 3, 4 * 2 ** step, 4 * 2 ** step),
                       generator=g)
    zs = torch.randn((1, batch, tool.CODE), generator=g)
    draws = gan.draw_d(g, disc, batch, step, "cpu")
    sel = [0] * gen.n_blocks
    params = list(disc.parameters())

    disc.zero_grad(set_to_none=True)
    gan.d_loss(gen, disc, real, zs, sel, tool.ALPHA, draws, step=step,
               sink=lambda t: t.backward())
    whole = _grads(params)

    with torch.no_grad():
        fake = sg.apply_styled_generator(gen, zs, draws["noise"], step=step,
                                         alpha=tool.ALPHA, style_sel=sel)
    no_gp = tool.param_grad(tool.d_loss_no_gp(
        disc, real, fake, draws["keep_real"], draws["keep_fake"], step),
        params)
    gp = tool.param_grad(tool.gp_only(disc, real, fake, draws["eps"],
                                      draws["keep_gp"], step), params)
    got = torch.cat([(a + b).reshape(-1) for a, b in zip(no_gp, gp)])
    want = torch.cat([w.reshape(-1) for w in whole])
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_pieces_and_ops_on_the_cpu(capsys):
    assert tool.main(["--device", "cpu", "--res", "8", "--batch", "2",
                      "--width", str(W), "--rounds", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(row["pieces_ms"]) == ["g_fwd", "d_fwd", "d_grad_no_gp",
                                      "gp_grad_only", "d_step_full",
                                      "g_step_full"]
    assert list(row["ops_ms"]) == ["blur", "fused_down", "plain_down",
                                   "fused_up"]
    assert row["card"] == "cpu" and row["dtype"] == "f32"


def test_ab_times_both_steps_and_the_pair(capsys):
    assert tool.main(["--device", "cpu", "--res", "8", "--batch", "2",
                      "--width", str(W), "--rounds", "1",
                      "--dtype", "ab"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(row["times_ms"]) == sorted(
        f"{n}_{t}" for n in ("d_step_full", "g_step_full", "pair")
        for t in ("f32", "bf16"))
    assert set(row["pair"]) == {"f32", "bf16"}
    assert row["bf16_speedup"] == pytest.approx(
        row["times_ms"]["pair_f32"] / row["times_ms"]["pair_bf16"])
