"""How the benchmark drives the port for ``vit_mil``: UNI's ViT-L/16
(``models/vit.py``) as the embedder of ``models/attention_mil.AttentionMIL``
under the gated head, through the entry its users call.

* ``stream``: one slide through ``parallel/inference.classify_slide_streaming``
  with a tile-cache stand-in, as for ``resnet26_mil``: the default
  per-chunk program resizes the chunk's tiles to the ViT's resolution and
  encodes them in the configuration's dtype.

The program has no int8 path.
"""

import torch

from benchmark.programs.resnet26_mil import TileCache
from benchmark.reference import vit_mil as ref
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import attention_mil as amil  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import vit  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import inference  # noqa: E501

DTYPES = {"bf16": torch.bfloat16, "f32": None}


def mil_config(cfg):
    s = ref.sizes(cfg)
    return amil.MILConfig(
        L=s["dim"], D=cfg["D"], K=cfg["K"], O=cfg["O"],
        n_classes=cfg["n_classes"], class_weights=None, extractor="vit",
        vit=vit.ViTConfig(depth=s["depth"], heads=s["heads"], mlp=s["mlp"],
                          patch=s["patch"], image=s["image"],
                          init_values=cfg["init_values"]))


class Program:
    def __init__(self, cfg, weights, device):
        self.cfg, self.device = cfg, device
        self.mcfg = mil_config(cfg)
        self.dtype = DTYPES[cfg["dtype"]]
        self.px = cfg["tile_px"]
        model = amil.AttentionMIL(self.mcfg, device="meta")
        model = model.to_empty(device=device)
        model.load_state_dict(weights, strict=True)
        self.model = model.eval()

    def stream(self, raw, coords, chunk):
        probs, outs, _ = inference.classify_slide_streaming(
            self.model, self.mcfg, TileCache(raw, coords, self.device,
                                             self.px),
            resolution=self.px, chunk=chunk, compute_dtype=self.dtype)
        return {"probs": probs, "Mterm": outs["Mterm"],
                "Aterm": outs["Aterm"]}

    def warm_stream_chunk(self, n):
        """The per-chunk program at a chunk of ``n`` tiles (one of the
        shapes a slide's tail chunk takes)."""
        run = inference.make_transform_extract(
            self.mcfg, resolution=self.px, compute_dtype=self.dtype)
        x = torch.zeros((n, self.px, self.px, 3), dtype=torch.uint8,
                        device=self.device)
        with torch.no_grad():
            run(self.model.cnn, x)
