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

The StyleGAN half (``models/stylegan.py``): :func:`gan_key` maps a
reference state-dict name of the styled generator or the critic onto the
JAX package's flat parameter path and layout kind (the rules of the JAX
package's ``utils/torch_interop.py``), :func:`gan_flat_from_module` /
:func:`load_gan_flat` carry a module's parameters (or, with ``value``,
its gradients or Adam moments) to and from those flat JAX-layout arrays,
and :func:`gan_adam_to_flat` / :func:`load_gan_adam` do the same for a
``torch.optim.Adam`` in optax's ``ScaleByAdamState`` layout. The GAN
checkpoints (``train/gan.py``) and the reference interchange
(``utils/torch_interop.py``) both go through them.

The auxiliary models (``models/alt_resnet.py``, ``wae.py``, ``unet.py``):
:func:`aux_module_from_jax` builds the port's module from the JAX
package's tree of ``init_resnet``, ``init_encoder``, ``init_decoder``,
``init_wae_discriminator``, ``init_latent_unet`` or
``init_cluster_layer`` (the module's configuration read off the leaves'
shapes) and :func:`aux_params_from_module` is its inverse. A JAX path
names the module's parameter (``down/0/conv1/w`` ->
``down.0.conv1.weight``; ``bn/gamma`` -> ``bn.weight``), but for the
ResNet's torchvision names (``layers/1/0/downsample/w`` ->
``layer2.0.downsample.0.weight``) and the critic's list
(``3/w`` -> ``layers.3.weight``); a transposed conv's HWIO kernel becomes
``ConvTranspose2d``'s ``[in, out, kh, kw]``.
"""

import math
import re

import numpy as np
import torch

from .._device import resolve_device
from ..models import alt_resnet, unet, wae


def _t(x, layout=None):
    a = np.asarray(x, np.float32)
    if layout == "conv":
        a = np.transpose(a, (3, 2, 0, 1))
    elif layout == "upconv":
        a = np.transpose(a, (2, 3, 0, 1))
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
    elif layout == "upconv":
        a = np.transpose(a, (2, 3, 0, 1))
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


# ---------------------------------------------------------------- StyleGAN
CONV, LIN, VEC = "conv", "lin", "vec"
FUP = "fup"      # FusedUpsample [I, O, k, k] <-> [k, k, I, O]
NOISE = "noise"  # NoiseInjection [1, C, 1, 1] <-> [C]
CONST = "const"  # ConstantInput [1, C, 4, 4] <-> [1, 4, 4, C]
SKIP = "skip"    # a blur buffer: regenerated, never carried
UNKNOWN = "unknown"


def gan_to_jax(arr, kind):
    """A reference-layout array -> the JAX package's layout."""
    arr = np.asarray(arr)
    if kind == CONV:
        return np.transpose(arr, (2, 3, 1, 0))
    if kind == LIN:
        return arr.T
    if kind == FUP:
        return np.transpose(arr, (2, 3, 0, 1))
    if kind == NOISE:
        return arr.reshape(-1)
    if kind == CONST:
        return np.transpose(arr, (0, 2, 3, 1))
    return arr


def gan_to_torch(arr, kind):
    """The inverse of :func:`gan_to_jax`."""
    arr = np.asarray(arr)
    if kind == CONV:
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == LIN:
        return arr.T
    if kind == FUP:
        return np.transpose(arr, (2, 3, 0, 1))
    if kind == NOISE:
        return arr.reshape(1, -1, 1, 1)
    if kind == CONST:
        return np.transpose(arr, (0, 3, 1, 2))
    return arr


def _wb(name):
    return "w" if name == "weight_orig" else "b"


def _gen_key(key):
    """StyledGenerator state-dict name -> (JAX flat key, kind)."""
    m = re.match(r"^style\.(\d+)\.linear\.(weight_orig|bias)$", key)
    if m:  # Sequential: PixelNorm at 0, EqualLinear at 1, 3, 5, ...
        s = _wb(m.group(2))
        return f"style/{(int(m.group(1)) - 1) // 2}/{s}", (
            LIN if s == "w" else VEC)
    m = re.match(r"^generator\.to_rgb\.(\d+)\.conv\.(weight_orig|bias)$",
                 key)
    if m:
        s = _wb(m.group(2))
        return (f"generator/to_rgb/{m.group(1)}/{s}",
                CONV if s == "w" else VEC)
    m = re.match(r"^generator\.progression\.(\d+)\.(.+)$", key)
    if not m:
        return None, UNKNOWN
    base, rest = f"generator/progression/{m.group(1)}", m.group(2)
    if rest == "conv1.input":
        return f"{base}/constant", CONST
    if rest in ("conv1.conv.weight_orig", "conv1.1.conv.weight_orig"):
        return f"{base}/conv1/w", CONV
    if rest in ("conv1.conv.bias", "conv1.1.conv.bias", "conv1.0.bias"):
        return f"{base}/conv1/b", VEC
    if rest == "conv1.0.weight":
        return f"{base}/conv1/w", FUP
    if re.match(r"^conv1\.[12]\.(weight|weight_flip)$", rest):
        return None, SKIP
    m2 = re.match(r"^noise([12])\.weight_orig$", rest)
    if m2:
        return f"{base}/noise{m2.group(1)}", NOISE
    m2 = re.match(r"^adain([12])\.style\.linear\.(weight_orig|bias)$", rest)
    if m2:
        s = _wb(m2.group(2))
        return f"{base}/adain{m2.group(1)}/{s}", LIN if s == "w" else VEC
    m2 = re.match(r"^conv2\.conv\.(weight_orig|bias)$", rest)
    if m2:
        s = _wb(m2.group(1))
        return f"{base}/conv2/{s}", CONV if s == "w" else VEC
    return None, UNKNOWN


def _disc_key(key):
    """Discriminator state-dict name -> (JAX flat key, kind)."""
    m = re.match(r"^linear\.linear\.(weight_orig|bias)$", key)
    if m:
        s = _wb(m.group(1))
        return f"linear/{s}", LIN if s == "w" else VEC
    m = re.match(r"^from_rgb\.(\d+)\.(?:0\.)?conv\.(weight_orig|bias)$",
                 key)
    if m:  # with or without the from_rgb_activate Sequential
        s = _wb(m.group(2))
        return f"from_rgb/{m.group(1)}/{s}", CONV if s == "w" else VEC
    m = re.match(r"^progression\.(\d+)\.(.+)$", key)
    if not m:
        return None, UNKNOWN
    base, rest = f"progression/{m.group(1)}", m.group(2)
    if rest == "conv1.0.conv.weight_orig":
        return f"{base}/conv1/w", CONV
    if rest == "conv1.0.conv.bias":
        return f"{base}/conv1/b", VEC
    # conv2: EqualConv2d at 0 (the final block) or 1 (after the blur),
    # or the FusedDownsample's own weight at 1
    if rest in ("conv2.0.conv.weight_orig", "conv2.1.conv.weight_orig",
                "conv2.1.weight"):
        return f"{base}/conv2/w", CONV
    if rest in ("conv2.0.conv.bias", "conv2.1.conv.bias", "conv2.1.bias"):
        return f"{base}/conv2/b", VEC
    if re.match(r"^conv2\.0\.(weight|weight_flip)$", rest):
        return None, SKIP
    return None, UNKNOWN


def gan_key(key: str, part: str):
    """(JAX flat key, kind) of a reference state-dict name of ``part``
    (``"generator"`` for a StyledGenerator, ``"discriminator"``); the
    DataParallel ``module.`` prefix is dropped."""
    if key.startswith("module."):
        key = key[len("module."):]
    return (_gen_key if part == "generator" else _disc_key)(key)


def _gan_part(module) -> str:
    return "generator" if hasattr(module, "style") else "discriminator"


def _gan_params(module):
    part = _gan_part(module)
    out = []
    for name, p in module.named_parameters():
        key, kind = gan_key(name, part)
        if key is None:
            raise KeyError(f"no JAX path for the StyleGAN parameter {name}")
        out.append((key, kind, p))
    return out


def gan_flat_from_module(module, value=None) -> dict:
    """A StyledGenerator or Discriminator -> ``{JAX flat key: float32
    array in the JAX layout}``. ``value(param)`` picks another tensor of
    each parameter's shape (a gradient, an Adam moment)."""
    return {key: np.array(gan_to_jax(
        (p if value is None else value(p)).detach().to("cpu", torch.float32)
        .numpy(), kind), np.float32, order="C")
        for key, kind, p in _gan_params(module)}


def load_gan_flat(module, flat: dict, setter=None):
    """Overlay JAX-layout arrays onto ``module``'s parameters (or, with
    ``setter(param, tensor)``, onto another per-parameter state); a key
    that is missing or whose shape differs is left alone. Returns
    ``(loaded, total)``."""
    loaded = 0
    params = _gan_params(module)
    with torch.no_grad():
        for key, kind, p in params:
            v = flat.get(key)
            if v is None:
                continue
            t = torch.from_numpy(np.array(gan_to_torch(v, kind), np.float32))
            if tuple(t.shape) != tuple(p.shape):
                continue
            t = t.to(p.device, p.dtype)
            if setter is None:
                p.copy_(t)
            else:
                setter(p, t)
            loaded += 1
    return loaded, len(params)


def gan_adam_to_flat(module, optimizer):
    """``(count, mu, nu)`` of a ``torch.optim.Adam`` over ``module``'s
    parameters in optax's layout: the step count as int32 and each moment
    as :func:`gan_flat_from_module` gives it (zero where no state)."""
    def moment(key):
        def get(p):
            st = optimizer.state.get(p, {})
            return st[key] if key in st else torch.zeros_like(p)
        return get

    steps = [int(st["step"]) for st in optimizer.state.values()
             if "step" in st]
    return (np.int32(max(steps) if steps else 0),
            gan_flat_from_module(module, moment("exp_avg")),
            gan_flat_from_module(module, moment("exp_avg_sq")))


def load_gan_adam(module, optimizer, count, mu: dict, nu: dict):
    """Set the Adam state of ``module``'s parameters from optax's layout.
    ``count`` None keeps the step counts; a moment missing from ``mu`` /
    ``nu`` keeps its current value. Returns the number of leaves set
    (the count included)."""
    for p in module.parameters():
        st = optimizer.state.setdefault(p, {})
        st.setdefault("step", torch.tensor(0.0))
        st.setdefault("exp_avg", torch.zeros_like(p))
        st.setdefault("exp_avg_sq", torch.zeros_like(p))
    n = 0
    if count is not None:
        for p in module.parameters():
            optimizer.state[p]["step"] = torch.tensor(
                float(np.asarray(count)), dtype=torch.float32)
        n += 1
    for name, flat in (("exp_avg", mu), ("exp_avg_sq", nu)):
        def put(p, t, name=name):
            optimizer.state[p][name] = t.contiguous()
        n += load_gan_flat(module, flat, setter=put)[0]
    return n


# ----------------------------------------------------------- aux models
_LEAF = {"w": "weight", "b": "bias", "gamma": "weight", "beta": "bias",
         "centers": "centers"}


AUX_KINDS = {"alt_resnet": alt_resnet.ResNet, "encoder": wae.Encoder,
             "decoder": wae.Decoder,
             "wae_discriminator": wae.WAEDiscriminator,
             "latent_unet": unet.LatentUNet, "cluster": unet.ClusterLayer}


def _leaves(tree, path=()):
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _aux_layout(path, ndim):
    if path[-1] not in ("w", "weight"):
        return None
    if ndim == 4:
        return "upconv" if "upconv" in path else "conv"
    return "lin" if ndim == 2 else None


def _aux_name(kind, path):
    """A JAX path of ``kind``'s tree -> the port's parameter name."""
    p = list(path)
    if kind == "alt_resnet" and p[0] == "layers":
        p = [f"layer{p[1] + 1}", p[2]] + p[3:]
        if p[2] == "downsample":
            p.insert(3, 0)
    elif kind == "wae_discriminator":
        p = ["layers"] + p
    p[-1] = _LEAF[p[-1]]
    return ".".join(map(str, p))


def _aux_path(kind, name):
    """The inverse of :func:`_aux_name`."""
    p = [int(x) if x.isdigit() else x for x in name.split(".")]
    if kind == "alt_resnet" and str(p[0]).startswith("layer"):
        p = ["layers", int(p[0][5:]) - 1] + p[1:]
        if p[3] == "downsample":
            del p[4]
    elif kind == "wae_discriminator":
        p = p[1:]
    bn = len(p) > 1 and str(p[-2]).startswith("bn")
    p[-1] = {"weight": "gamma" if bn else "w",
             "bias": "beta" if bn else "b"}.get(p[-1], p[-1])
    return tuple(p)


def _side(flat, channels):
    return int(round(math.sqrt(flat / channels)))


def _aux_config(kind, tree):
    """The constructor keywords of ``kind``'s module, read off the JAX
    tree's shapes."""
    if kind == "alt_resnet":
        return {"layers": [len(s) for s in tree["layers"]],
                "num_classes": np.shape(tree["fc"]["w"])[1],
                "widths": [np.shape(s[0]["conv1"]["w"])[3]
                           for s in tree["layers"]]}
    if kind == "encoder":
        ch = tuple(tuple(np.shape(d["conv1"]["w"])[2:])
                   for d in tree["down"])
        return {"channels": ch,
                "latent_size": _side(np.shape(tree["fc"]["w"])[0],
                                     ch[-1][1])}
    if kind == "decoder":
        ch = tuple(tuple(np.shape(u["upconv"]["w"])[3:1:-1])
                   for u in reversed(tree["up"]))
        return {"channels": ch,
                "latent_size": _side(np.shape(tree["fc"]["w"])[1],
                                     ch[-1][1])}
    if kind == "wae_discriminator":
        return {"dims": (np.shape(tree[0]["w"])[0],)
                + tuple(np.shape(p["w"])[1] for p in tree)}
    if kind == "latent_unet":
        down, up = tree["down"], tree["up"]
        w0 = np.shape(down[0]["conv1"]["w"])
        wl = np.shape(down[-1]["conv1"]["w"])
        flat, latent_dim = np.shape(tree["fcl"]["w"])
        concat = [i for i, u in enumerate(up)
                  if np.shape(u["conv1"]["w"])[2]
                  == 2 * np.shape(u["conv1"]["w"])[3]]
        return {"in_channels": w0[2], "start_filts": w0[3],
                "out_channels": np.shape(tree["final"]["w"])[3],
                "depth": len(down),
                "latent_channels": np.shape(down[0]["bottle_in"]["w"])[3],
                "input_size": _side(flat, wl[3]) * 2 ** (len(down) - 1),
                "latent_dim": latent_dim,
                "concat_layer": concat[0] if concat else -1}
    if kind == "cluster":
        n, dim = np.shape(tree["centers"])
        return {"n_clusters": n, "dim": dim}
    raise ValueError(f"unknown auxiliary model {kind!r}; one of "
                     f"{sorted(AUX_KINDS)}")


def aux_module_from_jax(kind: str, tree, device=None) -> torch.nn.Module:
    """The port's module of ``kind`` (``"alt_resnet"``, ``"encoder"``,
    ``"decoder"``, ``"wae_discriminator"``, ``"latent_unet"``,
    ``"cluster"``) holding the JAX package's parameters ``tree`` (numpy
    leaves), on ``device`` (the card by default), loaded strictly."""
    cfg = _aux_config(kind, tree)
    model = AUX_KINDS[kind](device="meta", **cfg).to_empty(
        device=resolve_device(device))
    sd = {_aux_name(kind, path): _t(v, _aux_layout(path, np.ndim(v)))
          for path, v in _leaves(tree)}
    model.load_state_dict(sd, strict=True)
    return model


def aux_params_from_module(model: torch.nn.Module, value=None):
    """The inverse of :func:`aux_module_from_jax`: the JAX package's tree
    of float32 numpy arrays (lists where JAX has lists). ``value(param)``
    picks another tensor of each parameter's shape (a gradient)."""
    (kind,) = [k for k, cls in AUX_KINDS.items()
               if type(model) is cls]
    flat = {}
    for name, p in model.named_parameters():
        path = _aux_path(kind, name)
        flat[path] = _np(p if value is None else value(p),
                         _aux_layout(path, p.ndim))
    return _nest(flat)


def _nest(flat: dict):
    """``{path tuple: leaf}`` -> nested dicts, a dict of 0..n-1 keys
    becoming a list."""
    root = {}
    for path, v in flat.items():
        d = root
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v

    def fix(d):
        if not isinstance(d, dict):
            return d
        d = {k: fix(v) for k, v in d.items()}
        if all(isinstance(k, int) for k in d):
            return [d[i] for i in range(len(d))]
        return d

    return fix(root)
