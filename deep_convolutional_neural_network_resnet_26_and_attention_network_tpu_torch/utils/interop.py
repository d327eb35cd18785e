"""Weight carry-over onto the port's modules.

``state_dict_from_jax`` maps parameters onto the port's module names, which
are the reference's state-dict names (reference: gbm/model.py:114-157,
14-48; nnBlocks.py:157-185). It takes any of:

* the JAX package's attention-MIL parameter tree (``cnn``, ``context``,
  ``attention``, ``buffer``, ``weight_mask``), leaves as numpy arrays;
* its ResNet-26 subtree alone (``conv1``, ``stages``, ``fc``);
* a reference-keyed state dict, such as the JAX package's
  ``utils.torch_interop.export_state_dict`` output, where DataParallel's
  ``module.`` segment is stripped here.

Layouts: JAX conv kernels are HWIO and become OIHW; JAX linear weights are
``[in, out]`` and become ``[out, in]``. ``jax_params_from_module`` goes
the other way (the checkpoint writer, ``train/checkpoint.py``, needs it);
given ``value`` it maps any per-parameter tensor instead (gradients, Adam
moments). ``adam_state_to_jax`` / ``load_adam_state`` carry a
``torch.optim.Adam``'s moments and step count to and from the layout of
optax's ``ScaleByAdamState(count, mu, nu)``, so a resumed run keeps its
moments across the two packages. ``qparams_from_jax`` / ``scales_from_jax``
carry the int8 serving path's quantized weights and activation scales
(``ops/quant.py``). The name rules are the port's own copy; nothing is
imported from the JAX package.
"""

import numpy as np
import torch


def _t(x, layout=None):
    a = np.asarray(x, np.float32)
    if layout == "conv":
        a = np.transpose(a, (3, 2, 0, 1))
    elif layout == "lin":
        a = a.T
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _resnet(cnn) -> dict:
    sd = {"conv1.weight": _t(cnn["conv1"]["w"], "conv"),
          "conv1.bias": _t(cnn["conv1"]["b"]),
          "fc.weight": _t(cnn["fc"]["w"], "lin")}
    for s, stage in enumerate(cnn["stages"]):
        for b, block in enumerate(stage):
            pre = f"layer{s + 1}.{b}."
            for c in ("conv1", "conv2"):
                sd[pre + c + ".weight"] = _t(block[c]["w"], "conv")
                sd[pre + c + ".bias"] = _t(block[c]["b"])
            if "downsample" in block:
                sd[pre + "downsample.0.weight"] = _t(
                    block["downsample"]["w"], "conv")
    return sd


def _reference_key(key: str) -> str:
    """Strip DataParallel's segments: ``module.`` in front of the whole
    model, ``cnn.module.`` in front of the ResNet."""
    if key.startswith("module."):
        key = key[len("module."):]
    return key.replace("cnn.module.", "cnn.", 1)


def state_dict_from_jax(params) -> dict:
    """JAX parameters (or a reference-keyed state dict) -> the port's
    state dict of CPU float32 tensors."""
    if "stages" in params:
        return _resnet(params)
    if "cnn" not in params or not isinstance(params["cnn"], dict):
        return {_reference_key(k): torch.from_numpy(np.array(v))
                for k, v in params.items()}
    sd = {"cnn." + k: v for k, v in _resnet(params["cnn"]).items()}
    sd["context.bn.weight"] = _t(params["context"]["gamma"])
    sd["context.bn.bias"] = _t(params["context"]["beta"])
    for head, layers in (("attention", ("lin1", "lin2")),
                         ("buffer", ("lin1", "classifier"))):
        for name in layers:
            p = params[head][name]
            sd[f"{head}.{name}.weight"] = _t(p["w"], "lin")
            sd[f"{head}.{name}.bias"] = _t(p["b"])
    sd["weight_mask"] = _t(params["weight_mask"])
    return sd


def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load JAX parameters into ``model`` with ``strict=True``."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _np(t, layout=None):
    a = t.detach().to("cpu", torch.float32).numpy()
    if layout == "conv":
        a = np.transpose(a, (2, 3, 1, 0))
    elif layout == "lin":
        a = a.T
    return np.array(a, np.float32, order="C")


def _resnet_tree(cnn, v) -> dict:
    stages = []
    for stage in cnn.stages():
        blocks = []
        for block in stage:
            p = {c: {"w": v(getattr(block, c).weight, "conv"),
                     "b": v(getattr(block, c).bias)}
                 for c in ("conv1", "conv2")}
            if block.downsample is not None:
                p["downsample"] = {"w": v(block.downsample[0].weight,
                                          "conv")}
            blocks.append(p)
        stages.append(blocks)
    return {"conv1": {"w": v(cnn.conv1.weight, "conv"),
                      "b": v(cnn.conv1.bias)},
            "stages": stages,
            "fc": {"w": v(cnn.fc.weight, "lin")}}


def jax_params_from_module(model: torch.nn.Module, value=None) -> dict:
    """The inverse of :func:`state_dict_from_jax`: an ``AttentionMIL`` (or a
    ``ResNet26``) -> the JAX package's nested parameter tree of float32
    numpy arrays, with JAX layouts (HWIO convs, ``[in, out]`` linears) and
    JAX key names; ``stages`` is a list of lists of blocks.

    ``value(param)`` picks another tensor of each parameter's shape instead
    of the parameter itself (``lambda p: p.grad``, an optimizer moment); it
    is laid out the same way."""
    def v(param, layout=None):
        return _np(param if value is None else value(param), layout)

    if not hasattr(model, "cnn"):
        return _resnet_tree(model, v)
    a, b = model.attention, model.buffer
    return {
        "cnn": _resnet_tree(model.cnn, v),
        "context": {"gamma": v(model.context.bn.weight),
                    "beta": v(model.context.bn.bias)},
        "attention": {n: {"w": v(a[n].weight, "lin"), "b": v(a[n].bias)}
                      for n in ("lin1", "lin2")},
        "buffer": {n: {"w": v(b[n].weight, "lin"), "b": v(b[n].bias)}
                   for n in ("lin1", "classifier")},
        "weight_mask": v(model.weight_mask),
    }


def adam_state_to_jax(model: torch.nn.Module, optimizer):
    """A ``torch.optim.Adam`` over ``model``'s parameters -> ``(count, mu,
    nu)`` in the layout of optax's ``ScaleByAdamState``: the step count as
    an int32 scalar and the two moments as JAX parameter trees. A parameter
    with no state yet has zero moments."""
    def moment(key):
        def get(p):
            st = optimizer.state.get(p, {})
            return st[key] if key in st else torch.zeros_like(p)
        return get

    steps = [int(st["step"]) for st in optimizer.state.values()
             if "step" in st]
    count = np.int32(max(steps) if steps else 0)
    return (count, jax_params_from_module(model, moment("exp_avg")),
            jax_params_from_module(model, moment("exp_avg_sq")))


def qparams_from_jax(qparams) -> dict:
    """The JAX package's int8 qparams (``ops/quant.quantize_resnet26``) ->
    the port's (``ops/quant.py``): the same nested dict with CPU tensors,
    conv ``wq`` HWIO -> OIHW, the fc's ``[in, out]`` kept."""
    def site(p):
        wq = np.asarray(p["wq"], np.int8)
        if wq.ndim == 4:
            wq = np.transpose(wq, (3, 2, 0, 1))
        out = {"wq": torch.from_numpy(np.array(wq, np.int8, order="C")),
               "sw": _t(p["sw"])}
        if "b" in p:
            out["b"] = _t(p["b"])
        return out

    return {"conv1": site(qparams["conv1"]),
            "stages": [[{k: site(v) for k, v in block.items()}
                        for block in stage] for stage in qparams["stages"]],
            "fc": site(qparams["fc"])}


def scales_from_jax(scales) -> dict:
    """The JAX package's activation scales (``calibrate_resnet26``) -> the
    port's: the same nested dict of float32 scalar tensors."""
    return {"conv1": _t(scales["conv1"]),
            "stages": [[{k: _t(v) for k, v in block.items()}
                        for block in stage] for stage in scales["stages"]],
            "fc": _t(scales["fc"])}


def load_adam_state(model: torch.nn.Module, optimizer, count, mu, nu):
    """The inverse of :func:`adam_state_to_jax`: set every parameter's Adam
    state from optax's layout (``count``, and the ``mu`` / ``nu`` trees in
    JAX layouts). Returns the optimizer."""
    mu_sd, nu_sd = state_dict_from_jax(mu), state_dict_from_jax(nu)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32),
            "exp_avg": mu_sd[name].to(p.device, p.dtype).contiguous(),
            "exp_avg_sq": nu_sd[name].to(p.device, p.dtype).contiguous()}
    return optimizer
