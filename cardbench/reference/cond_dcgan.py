"""Plain class-conditional DCGAN: the generator with a label embedding and
the projection discriminator (Miyato & Koyama, arXiv:1802.05637), built on
the layers of ``reference/dcgan.py``. Imports nothing of the program.

Weights are the dicts of ``reference/dcgan.py`` plus two tables:
``label_embed.embedding`` (classes, 64) in G and ``proj_embed.embedding``
(classes, feat) in D.

* G: z concatenated with the 64-wide row of ``label_embed`` for its label,
  then the unconditional G (its dense ``project`` reads z_dim + 64 inputs).
* D: the unconditional trunk to the features ``feat``, flattened in NHWC
  order; logit = out(feat) + <proj_embed[y], feat>.

Departures from the published descriptions: G conditions by concatenating
a learned embedding to z, as the repository's model does, where
arXiv:1802.05637's generators use conditional BatchNorm; D's trunk is the
DCGAN one (arXiv:1511.06434), not a ResNet, with the projection on its
flattened last feature map in place of a global sum pool.

Both operands of every matmul and convolution, the projection's inner
product among them, pass through ``q`` (``reference/dcgan.py``'s
``Precision``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cardbench.reference.dcgan import (
    F32,
    LRELU_SLOPE,
    batch_norm,
    conv_same,
    generate as generate_unconditional,
    num_stages,
)

LABEL_EMBED_DIM = 64


def generate(w: dict, z: torch.Tensor, labels: torch.Tensor, image_size: int,
             channels: int, base: int, q=F32) -> torch.Tensor:
    """G in eval mode: z (B, z_dim), labels (B,) -> images (B, H, W, C)."""
    h = torch.cat([z, w["label_embed.embedding"][labels]], dim=-1)
    return generate_unconditional(w, h, image_size, channels, base, q)


def features(w: dict, x: torch.Tensor, image_size: int, q=F32,
             train: bool = False) -> torch.Tensor:
    """D's trunk: x (B, H, W, C) -> feat (B, feat) in NHWC order."""
    n = num_stages(image_size)
    h = F.leaky_relu(conv_same(x.permute(0, 3, 1, 2), w["conv0.weight"],
                               w["conv0.bias"], q), LRELU_SLOPE)
    for i in range(1, n):
        h = conv_same(h, w[f"conv{i}.weight"], w[f"conv{i}.bias"], q)
        h = F.leaky_relu(batch_norm(h, w, f"bn{i}", train), LRELU_SLOPE)
    return h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def discriminate(w: dict, x: torch.Tensor, labels: torch.Tensor,
                 image_size: int, q=F32, train: bool = False) -> torch.Tensor:
    """D: x (B, H, W, C), labels (B,) -> logits (B,); ``train`` uses batch
    statistics and moves the running averages in ``w``."""
    feat = features(w, x, image_size, q, train)
    out = F.linear(q(feat), q(w["out.weight"]), w["out.bias"])[:, 0]
    proj = (q(w["proj_embed.embedding"][labels]) * q(feat)).sum(dim=-1)
    return out + proj
