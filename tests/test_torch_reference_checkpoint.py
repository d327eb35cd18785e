"""The port's reference-checkpoint interchange (utils/torch_interop.py)
against the JAX package's (the classifier half).

From one reference-keyed torch pickle (``{'classifier', 'optimizer'}``,
with DataParallel's ``cnn.module.`` keys, a whole-model ``module.`` prefix
and extra ``loss.*`` buffers), the port's ``import_checkpoint`` writes a
``.model`` whose npz members are byte for byte JAX's, ``extra/`` keys
included; the non-``--unsafe-pickle`` refusal is worded as JAX's. The
export loads into ``AttentionMIL`` with ``strict=True`` and equals JAX's
export of the same file; an export then an import gives the same
``.model`` back."""

import argparse
import os
import zipfile

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.utils import (
    torch_interop as jinterop,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
    torch_interop,
)

TINY = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
CFGS = {"tiny": amil.MILConfig(**TINY), "full": amil.MILConfig()}


def _model(cfg, seed=0):
    return amil.init_attention_mil(torch.Generator().manual_seed(seed), cfg,
                                   device="cpu")


def _reference_sd(model, prefix=""):
    """The reference model's state dict: the ResNet under DataParallel's
    ``cnn.module.``, the loss's buffers beside the parameters."""
    sd = {prefix + ("cnn.module." + k[4:] if k.startswith("cnn.") else k):
          v.detach().clone() for k, v in model.state_dict().items()}
    sd[prefix + "loss.weight"] = torch.tensor([1.0, 2.0, 0.5])
    sd[prefix + "loss.smoothing"] = torch.tensor(0.25)
    return sd


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("arch", sorted(CFGS))
@pytest.mark.parametrize("prefix", ["", "module."])
def test_import_equals_jax_byte_for_byte(arch, prefix, tmp_path):
    model = _model(CFGS[arch])
    src = str(tmp_path / "train_step-007.model")
    torch.save({"classifier": _reference_sd(model, prefix),
                "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4}]}},
               src)
    ours, theirs = str(tmp_path / "port.model"), str(tmp_path / "jax.model")
    imp_t, skip_t = torch_interop.import_checkpoint(src, ours)
    imp_j, skip_j = jinterop.import_checkpoint(src, theirs)
    assert (imp_t, skip_t) == (imp_j, skip_j)
    assert skip_t == [prefix + "loss.weight", prefix + "loss.smoothing"]
    members_t, members_j = _npz_members(ours), _npz_members(theirs)
    assert list(members_t) == list(members_j)
    assert "extra/imported_from.npy" in members_t
    assert "extra/format.npy" in members_t
    for name in members_j:
        assert members_t[name] == members_j[name], name
    # and it restores into the port's model exactly
    back = _model(CFGS[arch], seed=1)
    checkpoint.restore_params(back, ours, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_export_loads_strict_and_equals_jax(arch, tmp_path):
    model = _model(CFGS[arch], seed=3)
    path = checkpoint.save(str(tmp_path / "train_step-001.model"), model)
    ours, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    keys = torch_interop.export_checkpoint(path, ours)
    assert keys == jinterop.export_checkpoint(path, theirs)
    sd_t = torch.load(ours, weights_only=True)["classifier"]
    sd_j = torch.load(theirs, weights_only=True)["classifier"]
    assert sorted(sd_t) == sorted(sd_j) == keys
    assert all(k.startswith("cnn.module.") for k in keys if "cnn" in k)
    for k in sd_j:
        assert sd_t[k].dtype == sd_j[k].dtype and sd_t[k].is_contiguous()
        torch.testing.assert_close(sd_t[k], sd_j[k], rtol=0, atol=0)
    loaded = amil.AttentionMIL(CFGS[arch], device="cpu")
    loaded.load_state_dict(interop.state_dict_from_jax(sd_t), strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    # in memory: the model's reference-keyed state dict, as JAX's of the
    # same weights
    mem = torch_interop.export_state_dict(model)
    jmem = jinterop.export_state_dict(interop.jax_params_from_module(model))
    assert sorted(mem) == sorted(jmem) == keys
    for k in keys:
        np.testing.assert_array_equal(mem[k], jmem[k])


def test_export_then_import_is_bit_identical(tmp_path):
    """A ``.model`` -> reference pickle -> ``.model`` gives the same
    parameter arrays back (the bundle phase of chip_smoke.py checks this
    on the trained checkpoint)."""
    path = checkpoint.save(str(tmp_path / "a.model"), _model(CFGS["full"]))
    torch_interop.export_checkpoint(path, str(tmp_path / "ref.pt"))
    torch_interop.import_checkpoint(str(tmp_path / "ref.pt"),
                                    str(tmp_path / "b.model"))
    a = checkpoint.load_raw(path)
    b = checkpoint.load_raw(str(tmp_path / "b.model"))
    assert sorted(a) == sorted(k for k in b if k.startswith("classifier/"))
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == np.ascontiguousarray(b[k]).tobytes(), k


def test_unsafe_pickle_refusal_worded_as_jax(tmp_path):
    """A pickle that ``weights_only`` refuses (here an argparse Namespace
    beside the weights) is refused in JAX's words; ``unsafe_pickle`` reads
    it and both packages write the same members."""
    model = _model(CFGS["tiny"])
    src = str(tmp_path / "old.model")
    torch.save({"classifier": _reference_sd(model),
                "args": argparse.Namespace(lr=1e-4)}, src)
    errs = []
    for mod in (torch_interop, jinterop):
        with pytest.raises(RuntimeError) as e:
            mod.import_checkpoint(src, str(tmp_path / "x.model"))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert "retry with --unsafe-pickle" in errs[0]
    assert not os.path.exists(tmp_path / "x.model")
    ours, theirs = str(tmp_path / "p.model"), str(tmp_path / "j.model")
    torch_interop.import_checkpoint(src, ours, unsafe_pickle=True)
    jinterop.import_checkpoint(src, theirs, unsafe_pickle=True)
    assert _npz_members(ours) == _npz_members(theirs)


def test_import_refuses_a_file_with_no_parameters(tmp_path):
    src = str(tmp_path / "junk.model")
    torch.save({"classifier": {"loss.weight": torch.ones(3)}}, src)
    with pytest.raises(ValueError, match="no recognizable reference"):
        torch_interop.import_checkpoint(src, str(tmp_path / "x.model"))


def test_cli(tmp_path, capsys):
    model = _model(CFGS["tiny"])
    src = str(tmp_path / "ref.model")
    torch.save({"classifier": _reference_sd(model)}, src)
    out = str(tmp_path / "ours.model")
    assert torch_interop.main(["import", src, out]) == 0
    text = capsys.readouterr().out
    assert f"imported {len(model.state_dict())} tensors" in text
    assert "skipped 2 non-parameter keys" in text
    back = str(tmp_path / "back.pt")
    assert torch_interop.main(["export", out, back]) == 0
    assert f"exported {len(model.state_dict())} tensors" in \
        capsys.readouterr().out
    for cmd in ("import-gan", "export-gan"):
        with pytest.raises(SystemExit, match="A.12"):
            torch_interop.main([cmd, src, str(tmp_path / "g.model")])


def test_jax_weights_round_trip_through_the_port(tmp_path):
    """JAX parameters -> JAX's reference export -> the port's import: the
    same arrays as JAX's own checkpoint of them."""
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        jamil.init_attention_mil, static_argnums=1)(
            jax.random.PRNGKey(4), jamil.MILConfig(**TINY)))
    src = str(tmp_path / "ref.pt")
    torch.save({"classifier": {k: torch.from_numpy(np.array(v))
                               for k, v in
                               jinterop.export_state_dict(jp).items()}}, src)
    out = str(tmp_path / "ours.model")
    torch_interop.import_checkpoint(src, out)
    got = checkpoint.load_raw(out)
    want = checkpoint._flatten(jp)
    assert sorted(k[len("classifier/"):] for k in got
                  if k.startswith("classifier/")) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[f"classifier/{k}"], v)
