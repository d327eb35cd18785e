"""How the benchmark drives the port for ``resnet26_mil``: the live
classifier (``models/attention_mil.AttentionMIL``, a ResNet-26 under the
gated head) through the entries its users call.

* ``stream``: one slide through ``parallel/inference.classify_slide_streaming``
  with a tile-cache stand-in, as the daemon's serial path serves it;
* ``train_window``: one accumulation window through
  ``parallel/steps.make_train_step``, each bag staged and augmented by
  ``data/transforms.apply_chunked(train_transform)``, as the trainer's
  ``RoiBuilder.get_train_data`` stages it.

``int8=True`` builds the W8A8 serving path (``ops/quant.py``) instead, the
program's own path below the configuration's bfloat16.
"""

import numpy as np
import torch

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import transforms  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import attention_mil as amil  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import inference, steps  # noqa: E501

DTYPES = {"bf16": torch.bfloat16, "f32": None}


def mil_config(cfg):
    return amil.MILConfig(
        L=cfg["L"], D=cfg["D"], K=cfg["K"], O=cfg["O"],
        n_classes=cfg["n_classes"], smoothing=cfg["smoothing"],
        dropout=cfg["dropout"],
        train_tile_fraction=cfg["train_tile_fraction"],
        widths=tuple(cfg["widths"]), blocks=tuple(cfg["blocks"]))


class TileCache:
    """A stand-in for ``RoiBuilder``: the slide's tile cache is ``raw``, a
    uint8 [T, H, W, 3] view of the benchmark's host pool, handed to the
    streaming loop as the builder's memory map would be."""

    def __init__(self, raw, coords, device, resolution):
        self.raw, self.coords, self.device = raw, coords, device
        self.params = {"resolution": resolution, "status": "VALID-READY"}

    def update_resolution_and_buffer(self, resolution):
        self.params["resolution"] = int(resolution)

    def _load_cache(self, with_coords=False, mmap=False):
        return (self.raw, self.coords) if with_coords else self.raw


class Program:
    def __init__(self, cfg, weights, device, *, int8=False, calib=None):
        self.cfg, self.device = cfg, device
        self.mcfg = mil_config(cfg)
        self.dtype = DTYPES[cfg["dtype"]]
        self.px = cfg["tile_px"]
        model = amil.AttentionMIL(self.mcfg, device="meta")
        model = model.to_empty(device=device)
        model.load_state_dict(weights, strict=True)
        self.model = model.eval()
        self.transform_extract = None
        if int8:
            from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import quant  # noqa: E501
            tiles = transforms.eval_transform(
                torch.from_numpy(np.array(calib)).to(device),
                resolution=self.px)
            qp_sc = quant.quantize_and_calibrate(self.model.cnn, tiles)
            self.transform_extract = quant.make_int8_transform_extract(
                self.model.cnn, None, self.px, qp_sc=qp_sc)
        self._step = None

    # ----------------------------------------------------------- serving
    def stream(self, raw, coords, chunk):
        probs, outs, _ = inference.classify_slide_streaming(
            self.model, self.mcfg, TileCache(raw, coords, self.device,
                                             self.px),
            resolution=self.px, chunk=chunk, compute_dtype=self.dtype,
            transform_extract=self.transform_extract)
        return {"probs": probs, "Mterm": outs["Mterm"],
                "Aterm": outs["Aterm"]}

    def warm_stream_chunk(self, n):
        """The per-chunk program at a chunk of ``n`` tiles (one of the
        shapes a slide's tail chunk takes)."""
        run = self.transform_extract or inference.make_transform_extract(
            self.mcfg, resolution=self.px, compute_dtype=self.dtype)
        x = torch.zeros((n, self.px, self.px, 3), dtype=torch.uint8,
                        device=self.device)
        run(self.model.cnn, x)

    # ---------------------------------------------------------- training
    def train_window(self, raws, noises, labels, lr, pad):
        """One Adam step over the bags ``raws``: host metrics (``loss``
        the window's mean)."""
        if self._step is None:
            self.model.train()
            self._step = steps.make_train_step(self.mcfg,
                                               compute_dtype=self.dtype)
            self.optimizer = steps.make_optimizer(self.model)
        bags = [transforms.apply_chunked(
            transforms.train_transform, raw, device=self.device,
            per_tile=(n["offsets"], n["flip_h"], n["flip_v"]),
            roi_size=self.px, resolution=self.px, pad=pad)
            for raw, n in zip(raws, noises)]
        masks = [torch.ones(b.shape[0], dtype=torch.float32,
                            device=self.device) for b in bags]
        return self._step(self.model, self.optimizer, bags, masks, labels, lr,
                          scores=[n["scores"] for n in noises],
                          keep=[n["keep"] for n in noises])

    def params(self):
        """The live parameters by name."""
        return dict(self.model.named_parameters())

    def first_moments(self):
        """Adam's first moment of every parameter, by name (zero where
        Adam holds no state for it)."""
        state = self.optimizer.state
        return {name: state[p]["exp_avg"] if "exp_avg" in state.get(p, {})
                else torch.zeros_like(p)
                for name, p in self.model.named_parameters()}
