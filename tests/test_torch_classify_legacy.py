"""The port's legacy discriminator-feature classifier
(``train/classify_legacy.py``, ``models/disc_extractor.py``) against the
JAX package's ``train/classify_legacy.main`` on one tiny tree, on the CPU.

Both drivers start from one head checkpoint and one GAN checkpoint that
the JAX package writes, read the same bags (the training bags' random
crop is the one stream the packages draw differently, so both read the
deterministic eval bag there, patched alike) and the same noise (each
bag's Gumbel scores and dropout mask from JAX's own key for that bag,
handed to the port). ``--f32``; the extractor is float32 in both
packages whatever the flag. Held: the critic features to 1e-5 x
max(1, |f|); after one epoch (one Adam step over its five bags) the
Adam moments to 1e-5 and every parameter to 2e-5 x max(1, |p|) wherever
the summed gradient is above 1e-6 (Adam's step is m / (sqrt(v) + eps): where
the gradient is zero up to rounding, such as the instance classifier's
bias, which shifts every logit alike, the step is the rounding's; those
elements, under 1 %, are counted), as the mesh trainer's test holds
them; ``--test_only``'s manifests identical and its ``.dla`` maps to
1e-5 (the min-max normalized ATTN map to 1e-4)."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
    roibuilder as jroibuilder,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    blocks as jblocks,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    disc_extractor as jdx,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    stylegan as jsg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    checkpoint as jck,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    classify_legacy as jlegacy,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    gan as jgan,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (
    train as train_pkg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    roibuilder,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    blocks,
    disc_extractor,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    steps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint,
    classify_legacy,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

WIDTH, RES, CUTOFF, SEED = 0.125, 16, 2, 3


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """Six cached slides (24 tiles of 32 px each) and a csv cluster
    sheet, a head checkpoint and a GAN checkpoint written by JAX."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CACHE_DIR", str(cache))
    (tmp_path / "slides").mkdir()
    rng = np.random.default_rng(7)
    rows = [["id", ""], ["hdr", "Actual Cluster Designation"]]
    for i, c, cl in [(1, "A", "A"), (2, "B", "B"), (3, "C", "C"),
                     (5, "E", "A"), (6, "F", "B"), (7, "G", "C")]:
        base = f"GHP_{i}_{c}_H&E"
        rows.append([f"GHP_{i}_{c}", cl])
        (tmp_path / "slides" / f"{base}.scn").write_bytes(b"fake")
        tiles = np.clip(np.array([140, 60, 170])
                        + rng.integers(-40, 40, (24, 32, 32, 3)), 0,
                        255).astype(np.uint8)
        np.save(cache / f"data_{base}_rois_size32_hsvcut_v3.npy", tiles)
        np.save(cache / f"coor_{base}_rois_size32_hsvcut_v3.npy",
                np.stack([[(k // 6) * 32, (k % 6) * 32] for k in range(24)]))
    with open(tmp_path / "clusters.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)

    L = jdx.feature_dim(2, cutoff=CUTOFF, width_mult=WIDTH)
    head = jamil.init_attention_mil(jax.random.PRNGKey(11),
                                    jamil.MILConfig(L=L, class_weights=None))
    jck.save(str(tmp_path / "head.model"), head)
    pg = jsg.init_styled_generator(jax.random.PRNGKey(12), style_dim=32,
                                   width_mult=WIDTH)
    pd = jsg.init_discriminator(jax.random.PRNGKey(13), width_mult=WIDTH)
    tx = jgan.make_optimizers()
    jgan.save_gan_checkpoint(str(tmp_path / "gan.model"), pg, pd,
                             tx.init(pg), tx.init(pd), pg)
    return tmp_path


def _argv(tree, out, *extra):
    return ["--resolution", str(RES), "--width_mult", str(WIDTH),
            "--disc_cutoff", str(CUTOFF), "--roi_size", "32", "--f32",
            "--seed", str(SEED), "--data_root", str(tree),
            "--image_dir", "slides", "--label_sheet",
            str(tree / "clusters.csv"), "--output_root", str(out),
            "--gan_ckpt", str(tree / "gan.model"), *extra]


def _jax_noise(epoch, n, tiles, L):
    """The JAX driver's noise for bag n of an epoch: fold_in(fold_in(key,
    epoch), n), split into the subsample's and the dropout's keys."""
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(SEED), epoch), n)
    r_sub, r_do = jax.random.split(key)
    k = max(1, int(tiles * 0.2))
    return {"scores": torch.from_numpy(np.array(
                jax.random.gumbel(r_sub, (tiles,)))),
            "keep": torch.from_numpy(np.array(
                jax.random.bernoulli(r_do, 0.75, (k, L))))}


def _eval_bags_for_training(monkeypatch):
    monkeypatch.setattr(jroibuilder.RoiBuilder, "get_train_data",
                        lambda self: self.get_validation_data())
    monkeypatch.setattr(roibuilder.RoiBuilder, "get_train_data",
                        lambda self, deferred=False:
                        self.get_validation_data())


def test_critic_features_match_jax(tree):
    blob = checkpoint.load_raw(str(tree / "gan.model"))
    pd = jsg.init_discriminator(jax.random.PRNGKey(0), width_mult=WIDTH)
    pd, loaded, total = jgan.restore_section(pd, blob, "discriminator")
    d = sg.init_discriminator(torch.Generator().manual_seed(0),
                              width_mult=WIDTH, device="cpu")
    assert interop.load_gan_flat(
        d, {k[len("discriminator/"):]: v for k, v in blob.items()
            if k.startswith("discriminator/")}) == (loaded, total)
    x = np.random.default_rng(0).uniform(-1, 1, (10, 16, 16, 3)).astype(
        np.float32)
    for step, cutoff in ((2, 2), (2, 6), (0, 1)):
        s = 4 * 2 ** step
        want = jdx.apply_disc_extractor(pd, jnp.asarray(x[:, :s, :s]),
                                        step=step, cutoff=cutoff,
                                        width_mult=WIDTH)
        for chunk in (3, 512):  # the per-tile blocks in chunks or whole
            got = disc_extractor.apply_disc_extractor(
                d, torch.from_numpy(x[:, :s, :s].copy()), step=step,
                cutoff=cutoff, chunk=chunk)
            assert got.shape[1] == jdx.feature_dim(step, cutoff=cutoff,
                                                   width_mult=WIDTH)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_one_epoch_and_test_only_match_jax(tree, monkeypatch):
    _eval_bags_for_training(monkeypatch)
    L = jdx.feature_dim(2, cutoff=CUTOFF, width_mult=WIDTH)
    monkeypatch.setattr(classify_legacy.LegacyDriver, "bag_noise",
                        lambda self, e, n, t: _jax_noise(e, n, t, L))
    head = ["--ckpt", str(tree / "head.model")]
    # the five training bags make one window: one Adam step, whose first
    # moment is 0.1 x the summed gradient
    train = ["--epoch_start", "0", "--epoch_end", "1", "--accum", "5"]
    assert jlegacy.main(_argv(tree, tree / "jax", *head, *train)) == 0
    assert classify_legacy.main(_argv(tree, tree / "port", *head, *train),
                                device="cpu") == 0

    def run_dir(root):
        (name,) = [p for p in os.listdir(root)
                   if p.startswith("run_attention_classifier")]
        return root / name

    want = checkpoint.load_raw(str(run_dir(tree / "jax")
                                   / "train_step-000.model"))
    got = checkpoint.load_raw(str(run_dir(tree / "port")
                                  / "train_step-000.model"))
    assert sorted(got) == sorted(want)
    assert int(got["extra/epoch"]) == 0
    assert int(got["optimizer/count"]) == int(want["optimizer/count"]) == 1
    undetermined = 0
    for k, v in want.items():
        if k.startswith("extra/") or k == "optimizer/count":
            continue
        if k.startswith("optimizer/"):  # the moments: the gradients
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5,
                                       err_msg=k)
            continue
        grad = 10 * np.abs(want["optimizer/mu/" + k[len("classifier/"):]])
        where = grad > 1e-6  # Adam's step is the rounding's below it
        undetermined += int((~where & (grad > 0)).sum())
        tol = 2e-5 * np.maximum(1.0, np.abs(v))
        assert np.all((np.abs(got[k] - v) <= tol)[where]), k
    assert undetermined <= 0.01 * sum(v.size for k, v in want.items()
                                      if k.startswith("classifier/"))

    # --test_only from the JAX epoch's checkpoint: manifests and maps
    ckpt = str(run_dir(tree / "jax") / "train_step-000.model")
    assert jlegacy.main(_argv(tree, tree / "jax", "--test_only", "--ckpt",
                              ckpt)) == 0
    assert classify_legacy.main(_argv(tree, tree / "port", "--test_only",
                                      "--ckpt", ckpt), device="cpu") == 0
    a, b = tree / "jax" / "test_data", tree / "port" / "test_data"
    def outputs(d):  # the split file's name carries its time stamp
        return sorted(n for n in os.listdir(d)
                      if not n.startswith("training_validation_testing"))

    names = outputs(a)
    assert names == outputs(b)
    maps = [n for n in names if n.endswith(".dla")]
    assert len(maps) == 6 * 4  # every slide: ATTN and ACTF1-3
    for n in names:
        if n.endswith(".csv") or n.endswith(".sh"):
            assert (a / n).read_text().replace(str(tree / "jax"), "") == \
                (b / n).read_text().replace(str(tree / "port"), ""), n
        elif n.endswith(".dla"):
            x = np.loadtxt(a / n, ndmin=2)
            y = np.loadtxt(b / n, ndmin=2)
            np.testing.assert_array_equal(x[:, :2], y[:, :2])
            # ATTN is min-max normalized, which divides an error by the
            # map's range (about 0.1 here)
            np.testing.assert_allclose(y[:, 2], x[:, 2], atol=1e-4
                                       if "-ATTN." in n else 1e-5)


def test_transfer_and_the_non_finite_halt(tree, monkeypatch):
    out = tree / "xfer"
    assert classify_legacy.main(_argv(tree, out, "--epoch_start", "0",
                                      "--epoch_end", "1", "--transfer",
                                      "--ckpt", str(tree / "head.model")),
                                device="cpu") == 0
    real = classify_legacy.LegacyDriver.grad

    def poisoned(self, *a):
        outs = real(self, *a)
        return {**outs, "loss": outs["loss"] * float("nan")}

    monkeypatch.setattr(classify_legacy.LegacyDriver, "grad", poisoned)
    out = tree / "nan"
    rc = classify_legacy.main(_argv(tree, out, "--epoch_start", "0",
                                    "--epoch_end", "2"), device="cpu")
    assert rc == train_pkg.DIVERGED_EXIT
    (run,) = [p for p in out.iterdir() if p.name.startswith("run_")]
    assert not [f for f in os.listdir(run) if f.startswith("train_step-")]


def test_legacy_optimizer_and_reset_linear():
    """Adam (0.9, 0.99) with LR_MULTS per top-level group, against optax's
    scale_by_adam on the same gradients; reset_linear re-draws every
    linear weight and zeroes its bias, leaving convs, as JAX's does."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        attention_mil as amil,
    )

    cfg = amil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1), L=16)
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    opt = steps.make_optimizer_legacy(model, classify_legacy.LR_MULTS)
    assert sorted(g["lr_mult"] for g in opt.param_groups) == \
        [1.0, 1.0, 1.0, 2.0, 20.0]
    p0 = interop.jax_params_from_module(model)
    rng = np.random.default_rng(0)
    grads = {n: torch.from_numpy(rng.standard_normal(p.shape)
                                 .astype(np.float32))
             for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    steps.apply_updates(opt, 1e-3)
    tx = jlegacy.steps.make_optimizer_legacy()
    jg = interop.jax_params_from_module(model, lambda p: grads[
        [n for n, q in model.named_parameters() if q is p][0]])
    upd, _ = tx.update(jg, tx.init(p0), p0)
    got = interop.jax_params_from_module(model)
    for top in p0:
        mult = classify_legacy.LR_MULTS.get(top, 1.0)
        for k, v in jck._flatten(p0[top]).items():
            u = jck._flatten(upd[top])[k]
            want = v - 1e-3 * mult * np.asarray(u)
            np.testing.assert_allclose(jck._flatten(got[top])[k], want,
                                       atol=1e-6, err_msg=f"{top}/{k}")

    before = interop.jax_params_from_module(model)
    blocks.reset_linear(model, torch.Generator().manual_seed(1))
    after = interop.jax_params_from_module(model)
    assert not np.array_equal(after["attention"]["lin1"]["w"],
                              before["attention"]["lin1"]["w"])
    assert not np.any(after["attention"]["lin1"]["b"])
    np.testing.assert_array_equal(after["cnn"]["conv1"]["w"],
                                  before["cnn"]["conv1"]["w"])
    # the JAX tree version resets the same leaves
    jtree = jblocks.reset_linear(before, jax.random.PRNGKey(0))
    changed_j = {k for k, v in jck._flatten(jtree).items()
                 if not np.array_equal(v, jck._flatten(before)[k])}
    changed_t = {k for k, v in jck._flatten(after).items()
                 if not np.array_equal(v, jck._flatten(before)[k])}
    assert changed_t == changed_j


def test_blocks_match_jax():
    """The toolbox blocks on one parameter tree (the JAX init's, as
    tensors): the stain round-trip, linear_norm, every ConvBlock variant,
    the TinyExtractor, ConvToChannelOnly and the MLClassifier to 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)

    def to_t(tree):
        return jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)), tree)

    def close(got, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    close(blocks.rgb_to_he_res(torch.from_numpy(x)),
          jblocks.rgb_to_he_res(jnp.asarray(x)))
    close(blocks.linear_norm(torch.from_numpy(x)),
          jblocks.linear_norm(jnp.asarray(x)))
    keep = rng.random((2, 16, 16, 3)) < 0.7
    close(blocks.zero_dropout(torch.from_numpy(x), 0.3,
                              torch.from_numpy(keep), train=True),
          x * keep)
    key = jax.random.PRNGKey(2)
    for kw in (dict(downsample=True, fused=True), dict(downsample=True,
                                                       max2d=True),
               dict(downsample=True, fast=True), dict(downsample=True),
               dict()):
        jp = jblocks.init_conv_block(key, 3, 6, 3, **kw)
        want = jblocks.apply_conv_block(jp, jnp.asarray(x), padding=1, **kw)
        close(blocks.apply_conv_block(to_t(jp), torch.from_numpy(x),
                                      padding=1, **kw), want)
        shapes = jax.tree_util.tree_map(
            lambda a: tuple(a.shape), jp)
        ours = blocks.init_conv_block(torch.Generator().manual_seed(0), 3,
                                      6, 3, **kw)
        assert jax.tree_util.tree_map(lambda a: tuple(a.shape), ours,
                                      is_leaf=torch.is_tensor) == shapes
    big = rng.uniform(-1, 1, (1, 192, 192, 3)).astype(np.float32)
    jp = jblocks.init_tiny_extractor(key, 10)
    close(blocks.apply_tiny_extractor(to_t(jp), torch.from_numpy(big), 10),
          jblocks.apply_tiny_extractor(jp, jnp.asarray(big), 10))
    jp = jblocks.init_conv_to_channel_only(key, 3, 5, 16)
    close(blocks.apply_conv_to_channel_only(to_t(jp), torch.from_numpy(x)),
          jblocks.apply_conv_to_channel_only(jp, jnp.asarray(x)))
    feats = rng.standard_normal((3, 7)).astype(np.float32)
    jp = jblocks.init_ml_classifier(key, 7)
    close(blocks.apply_ml_classifier(to_t(jp), torch.from_numpy(feats)),
          jblocks.apply_ml_classifier(jp, jnp.asarray(feats)))
