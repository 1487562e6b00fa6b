"""What the DCGAN entries (``entries/collab.py``, ``draw_refine.py``,
``serve.py``) share: the seed weights, the program's pair loaded with them,
the plain reference built from the same weights, the refusal of a config
the reference does not implement, and the gaps the checks compare.

An entry is a module ``entries/<name>.py`` whose class ``Entry`` takes the
cell and offers ``warm()``, ``run_one(i) -> dict`` (one unit's counts),
``free_program()`` and ``judge(control) -> (numbers, control's numbers)``.
An entry for another kind of model brings its own reference and its own
refusal; it need not build on this module.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cardbench import inputs
from cardbench.reference import sampler as ref
from cardbench.reference.dcgan import Precision

# What the plain reference implements; a config outside it is refused.
REFERENCE_REFINE = {"objective": "ns", "space": "x", "clip_norm": 0.0,
                    "noise": 0.0, "stop_score": 0.0, "proximal": 0.0,
                    "per_class_drs": False, "shaping_decay": 1.0,
                    "shaping_target": 0.0, "shaping_anchor": 0.0,
                    "shaping_r1_gamma": 0.0}


def refuse_unsupported(config: dict) -> None:
    bad = {k: v for k, v in REFERENCE_REFINE.items()
           if config["refine"].get(k, v) != v}
    if bad or config["model"].get("kind", "dcgan") != "dcgan" \
            or config["model"].get("num_classes", 0):
        raise ValueError("the DCGAN reference does not implement "
                         f"{bad or 'this model'}")


def port_pair(cell, gw: dict, dw: dict):
    """The program's bundle, refine config and (G, D) holding the seed
    weights."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.models.dcgan import (
        DCGANDiscriminator,
        DCGANGenerator,
    )

    preset = get_preset(cell.config["preset"])
    mcfg = dataclasses.replace(preset.model, **cell.model)
    rcfg = dataclasses.replace(preset.refine, **cell.refine)
    bundle = make_bundle(mcfg, cell.device)
    g = DCGANGenerator(mcfg.image_size, mcfg.channels, mcfg.g_base_filters,
                       mcfg.z_dim, bundle.dtype, mcfg.num_classes)
    d = DCGANDiscriminator(mcfg.image_size, mcfg.channels,
                           mcfg.d_base_filters, bundle.dtype,
                           mcfg.num_classes)
    g, d = g.to(cell.device), d.to(cell.device)
    g.load_state_dict(gw)
    d.load_state_dict(dw)
    return bundle, rcfg, g.eval(), d.eval()


class DcganEntry:
    """Set-up (weights, the program's pair) and what the units keep for the
    check (``kept``); a subclass adds the unit's loop and ``_judge``."""

    def __init__(self, cell):
        refuse_unsupported(cell.config)
        self.cell, dev = cell, cell.device
        self.gw, self.dw = inputs.seed_weights(cell.model, cell.seed, dev)
        self.bundle, self.rcfg, self.g, self.d = port_pair(cell, self.gw,
                                                           self.dw)
        self.burn = max(1, cell.refine["burn_in"] // cell.refine["batch_size"])
        self.kept: dict = {}

    def ref_model(self, precision: str = "float32") -> ref.Model:
        return ref.Model(self.cell.model, self.gw, self.dw,
                         Precision(precision))

    def free_program(self) -> None:
        self.bundle = self.g = self.d = None

    def judge(self, control: bool = False) -> tuple[dict, dict]:
        with ref.float32_exact():
            return self._judge(control)

    def _judge(self, control: bool) -> tuple[dict, dict]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# The compared numbers. Each is a gap between the judged output and the
# reference's; the largest over the judged units is held to its limit.
# ---------------------------------------------------------------------------


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else math.inf


def gain_gap(r: dict, j: int) -> float:
    """The refinement's gain D(x_K) - D(x0) row by row, judged against the
    reference's: RMS of the difference over RMS of the reference's."""
    g, g_ref = r["gains"][j].double(), r["gain_ref"].double()
    return float((g - g_ref).square().mean().sqrt()
                 / g_ref.square().mean().sqrt())


def spread_gap(a: torch.Tensor, ref_: torch.Tensor) -> float:
    """Widest gap of a to ref_, over ref_'s spread (its std)."""
    return float((a.to(ref_.device) - ref_).abs().max() / ref_.std())


def worst(rows: list[dict]) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}
