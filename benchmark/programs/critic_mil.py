"""How the benchmark drives the port for ``critic_mil``: the legacy
classifier, a frozen StyleGAN critic (``models/stylegan.Discriminator``)
cut by ``models/disc_extractor.make_extractor`` under the gated head.

* ``onepass``: one slide as one bag, as ``train/classify_legacy.py
  --test_only`` classifies it: the loader's eval transform on the card
  (``data/transforms.apply_chunked``, as ``RoiBuilder._eval_tiles``), then
  ``models/attention_mil.apply_attention_mil(extractor=)`` with the head's
  compute dtype. The critic takes the transform's float32 tiles as they
  come, so its convolutions run in float32 under cuDNN's default TF32.
"""

import torch

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import transforms  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import attention_mil as amil  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import disc_extractor as dx  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import stylegan as sg  # noqa: E501

DTYPES = {"bf16": torch.bfloat16, "f32": None}


class Program:
    def __init__(self, cfg, weights, device):
        self.cfg, self.device = cfg, device
        self.px, self.step = cfg["tile_px"], cfg["step"]
        disc = sg.Discriminator(cfg["width_mult"], from_rgb_activate=True,
                                device="meta").to_empty(device=device)
        disc.load_state_dict({k[len("disc."):]: v for k, v in weights.items()
                              if k.startswith("disc.")}, strict=True)
        self.disc = disc.eval().requires_grad_(False)
        L = dx.feature_dim(self.step, cutoff=cfg["disc_cutoff"],
                           width_mult=cfg["width_mult"])
        self.mcfg = amil.MILConfig(L=L, D=cfg["D"], K=cfg["K"], O=cfg["O"],
                                   n_classes=cfg["n_classes"],
                                   class_weights=None)
        head = amil.AttentionMIL(self.mcfg, device="meta").to_empty(
            device=device)
        missing, unexpected = head.load_state_dict(
            {k[len("head."):]: v for k, v in weights.items()
             if k.startswith("head.")}, strict=False)
        if unexpected or any(not k.startswith("cnn.") for k in missing):
            raise ValueError(f"head weights do not fit: missing {missing}, "
                             f"unexpected {unexpected}")
        self.head = head.eval()
        self.chunk = dx.CHUNK
        self.extract = dx.make_extractor(self.disc, step=self.step,
                                         cutoff=cfg["disc_cutoff"],
                                         chunk=self.chunk)
        self.dtype = DTYPES[cfg["dtype"]]

    def onepass(self, raw):
        tiles = transforms.apply_chunked(transforms.eval_transform, raw,
                                         device=self.device,
                                         resolution=self.px)
        outs = amil.apply_attention_mil(self.head, tiles, 0, self.mcfg,
                                        compute_dtype=self.dtype,
                                        extractor=self.extract)
        return {"probs": outs["y_pred"].float().cpu().numpy().ravel(),
                "Mterm": outs["Mterm"].float().cpu().numpy(),
                "Aterm": outs["Aterm"].float().cpu().numpy()}

    def warm_bag(self, n):
        """The shapes a bag of ``n`` tiles gives the parts that see the
        whole bag: the critic's last block (its stddev plane) and the head
        with its pool."""
        lay = self.disc.layout[-1]
        x = torch.zeros((n, lay[1], 4, 4), device=self.device)
        with torch.no_grad():
            self.disc.progression[len(self.disc.layout) - 1](
                sg.minibatch_stddev(x))
            amil.attention_pool(self.head, torch.zeros(
                (n, self.mcfg.L), device=self.device), self.mcfg)

    def warm_tiles(self, n):
        """The critic over ``n`` tiles: the shapes of a bag's last chunk
        of ``n`` tiles through the blocks that act on each tile alone."""
        self.extract(None, torch.zeros((n, self.px, self.px, 3),
                                       device=self.device))
