"""The yardstick's operation counts and peaks, frozen here so that no later
change to the program moves them.

* ``pipeline_flops_per_sample``: ``bench_torch.py::_pipeline_flops_per_sample``
  copied: z -> G -> K refinement steps -> D for a DCGAN pair, every one of
  the 25 taps of every output counted, the zero border included, two FLOPs
  a multiply-add; a refine step is a D forward and its input-VJP (equal
  FLOPs), so a sample costs G + (2K + 1) D forwards (mnist: D forward
  20.71 MFLOP, G 21.95 MFLOP, 456.9 MFLOP a sample at K = 10).
* ``refine_flops_per_sample``: ``ops/conv_refine.py::refine_flops_per_sample``
  and ``_taps_in_range`` copied: kernel #4's count for its roofline, the
  28x28 / 64-filter D's taps that read inside the image only (17,364,352
  FLOP a D forward), (2K + 1) D passes, G left out.
* ``PEAK_BF16_FLOPS``: one NVIDIA H100 SXM, dense bf16 on the tensor cores,
  NVIDIA's data sheet, at its 700 W power limit.
"""

from __future__ import annotations

from cardbench.reference.dcgan import num_stages

PEAK_BF16_FLOPS = 989e12
LABEL_EMBED_DIM = 64  # G's label embedding, conditional DCGANs only


def d_forward_flops(model: dict) -> int:
    """One D forward of a DCGAN D, every tap counted (the dense head, and
    for a conditional D its projection head, included)."""
    s, c, base = (model["image_size"], model["channels"],
                  model["d_base_filters"])
    n = num_stages(s)
    d_fwd = (s // 2) ** 2 * base * 25 * c
    for i in range(1, n):
        d_fwd += ((s // 2 ** (i + 1)) ** 2 * (base * 2 ** i) * 25
                  * (base * 2 ** (i - 1)))
    feat_dim = (s // 2 ** n) ** 2 * base * 2 ** (n - 1)
    d_fwd += feat_dim
    if model.get("num_classes", 0) > 0:
        d_fwd += feat_dim
    return 2 * d_fwd


def g_forward_flops(model: dict) -> int:
    s, c = model["image_size"], model["channels"]
    gbase, z = model["g_base_filters"], model["z_dim"]
    n = num_stages(s)
    s0, ch0 = s // 2 ** n, gbase * 2 ** (n - 1)
    if model.get("num_classes", 0) > 0:
        z += LABEL_EMBED_DIM
    g_fwd = z * (s0 * s0 * ch0)
    sp, inch = s0, ch0
    for i in range(n - 1):
        outch = gbase * 2 ** (n - 2 - i)
        g_fwd += sp * sp * inch * 25 * outch
        sp, inch = sp * 2, outch
    g_fwd += sp * sp * inch * 25 * c
    return 2 * g_fwd


def pipeline_flops_per_sample(model: dict, steps: int) -> int:
    return g_forward_flops(model) + (2 * steps + 1) * d_forward_flops(model)


def taps_in_range(n_in: int, n_out: int) -> int:
    """(output, tap) pairs along one axis of a 5-tap stride-2 SAME conv
    whose input index 2*o + d - 1 lies inside the image."""
    return sum(0 <= 2 * o + d - 1 < n_in for o in range(n_out)
               for d in range(5))


KERNEL4_D_FORWARD_FLOPS = 2 * (taps_in_range(28, 14) ** 2 * 64
                               + taps_in_range(14, 7) ** 2 * 64 * 128 + 6272)


def refine_flops_per_sample(steps: int) -> int:
    """Kernel #4: K steps (forward + input-VJP) plus the final forward."""
    return (2 * steps + 1) * KERNEL4_D_FORWARD_FLOPS
