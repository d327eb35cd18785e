"""The StyleGAN half of the reference-checkpoint interchange
(``utils/torch_interop.py``: ``import-gan`` / ``export-gan``) against the
JAX package's, on checkpoints the JAX package writes in the test (no
reference ``.model`` file is in the repository).

Held, bit for bit: the port's export of a GAN npz equals the JAX
package's (every section, key and array) and loads into the port's
modules with ``strict=True``; the port's import of that pickle equals
the JAX package's import, and equals the npz it came from (the
optimizer sections stay behind); a bare ``g_running`` state dict fills
both generator sections; the CLI runs both ways."""

import copy

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import test_torch_gan_train as H
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    gan as jgan,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.utils import (
    torch_interop as jti,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint,
    gan,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    torch_interop,
)


@pytest.fixture
def gan_npz(tmp_path):
    pg, pd, _, _ = H.nets()
    tx = jgan.make_optimizers()
    path = str(tmp_path / "gan.model")
    jgan.save_gan_checkpoint(path, pg, pd, tx.init(pg), tx.init(pd), pg)
    return path


def _same_pickles(a, b):
    a, b = torch.load(a), torch.load(b)
    assert sorted(a) == sorted(b)
    for sec in a:
        assert sorted(a[sec]) == sorted(b[sec]), sec
        for k in a[sec]:
            assert torch.equal(a[sec][k], b[sec][k]), (sec, k)


def test_export_gan_equals_jax_and_loads_strictly(gan_npz, tmp_path):
    ours, theirs = str(tmp_path / "ours.pt"), str(tmp_path / "theirs.pt")
    counts = torch_interop.export_gan_checkpoint(gan_npz, ours)
    jti.export_gan_checkpoint(gan_npz, theirs)
    _same_pickles(ours, theirs)
    sd = torch.load(ours)
    assert set(counts) == {"generator", "g_running", "discriminator"}
    g = sg.StyledGenerator(H.D, width_mult=H.W)
    d = sg.Discriminator(width_mult=H.W)
    g.load_state_dict(sd["generator"], strict=True)
    d.load_state_dict(sd["discriminator"], strict=True)
    assert counts["generator"] == len(g.state_dict())


def test_import_gan_equals_jax_and_round_trips(gan_npz, tmp_path):
    ref = str(tmp_path / "ref.pt")
    jti.export_gan_checkpoint(gan_npz, ref)
    ours, theirs = str(tmp_path / "ours.model"), str(tmp_path /
                                                     "theirs.model")
    imported, skipped = torch_interop.import_gan_checkpoint(ref, ours)
    jti.import_gan_checkpoint(ref, theirs)
    a, b = checkpoint.load_raw(ours), checkpoint.load_raw(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        if k != "extra/imported_from":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    src = checkpoint.load_raw(gan_npz)
    params = {k for k in src if k.split("/")[0] in
              ("generator", "discriminator", "g_running")}
    assert params == {k for k in a if not k.startswith("extra/")}
    for k in params:
        np.testing.assert_array_equal(a[k], src[k], err_msg=k)
    assert not skipped
    # the imported file resumes in the port's trainer modules
    _, _, g, d = H.nets(seed=9)
    g_opt, d_opt = gan.make_optimizers(g, d)
    res = gan.load_gan_checkpoint(ours, g, d, g_opt, d_opt, copy.deepcopy(g))
    assert res["generator"][0] == res["generator"][1]
    assert res["discriminator"][0] == res["discriminator"][1]


def test_bare_g_running_fills_both_generator_sections(gan_npz, tmp_path):
    ref = str(tmp_path / "ref.pt")
    jti.export_gan_checkpoint(gan_npz, ref)
    bare = str(tmp_path / "bare.pt")
    torch.save(torch.load(ref)["g_running"], bare)
    out = str(tmp_path / "bare.model")
    torch_interop.import_gan_checkpoint(bare, out)
    blob = checkpoint.load_raw(out)
    gen = {k[len("generator/"):] for k in blob if k.startswith("generator/")}
    run = {k[len("g_running/"):] for k in blob if k.startswith("g_running/")}
    assert gen == run and gen


def test_gan_cli_both_ways(gan_npz, tmp_path, capsys):
    ref = str(tmp_path / "ref.pt")
    assert torch_interop.main(["export-gan", gan_npz, ref]) == 0
    assert "exported" in capsys.readouterr().out
    back = str(tmp_path / "back.model")
    assert torch_interop.main(["import-gan", ref, back]) == 0
    text = capsys.readouterr().out
    assert "imported" in text and "fresh Adam state" in text
    bad = str(tmp_path / "x.pt")
    torch.save({"classifier": {"w": torch.zeros(1)}}, bad)
    with pytest.raises(ValueError, match="StyleGAN"):
        torch_interop.main(["import-gan", bad, back])
