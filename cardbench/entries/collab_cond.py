"""Back-to-back class-conditional ``sample(..., method='collab')`` calls, one
caller, wired as ``Experiment.sample`` wires them: ``data_fn`` is the real
pool's ``batch``, ``cond_data_fn`` its ``batch_by_labels``. Call i draws
from a generator seeded (seed, 'call', i), from the seed weights. The pool
is the port's own device-resident uint8 store, ``load_image_dataset``'s
procedural ImageNet-64 stand-in with its labels, of the mix's
``real_images`` rows; its class table is built in set-up.

Seed weights: ``cardbench/inputs.py``'s layout and draw, with G's
``project`` reading z_dim + 64 inputs, and two tables more: G's
``label_embed`` N(0, 1), so that a label weighs in ``project`` as a
component of z does, and D's ``proj_embed`` N(0, 1 / feat), so that the
projection term has the scale of the ``out`` head.

The check replays the kept calls in the plain conditional reference
(``reference/cond_sampler.py``): samples, labels, logits, the
refinement's gain, the accept mask, the shaping losses and the shaped D.
"""

from __future__ import annotations

import math

import torch

from cardbench import dcgan_entry, inputs
from cardbench.dcgan_entry import gain_gap, port_pair, rel, spread_gap, worst
from cardbench.reference import cond_sampler as ref
from cardbench.reference.cond_dcgan import LABEL_EMBED_DIM
from cardbench.reference.dcgan import Precision
from cardbench.reference.sampler import float32_exact

NUMBERS = ("x_gap", "logit_gap", "gain_gap", "flip_pct", "loss_gap",
           "shaped_logit_gap", "label_gap")
# What the plain conditional reference implements; a config outside it is
# refused.
REFERENCE_REFINE = dict(dcgan_entry.REFERENCE_REFINE,
                        class_balanced_shaping=True,
                        shaping_freeze_embed=False,
                        shaping_class_weight=False)


def refuse_unsupported(config: dict) -> None:
    bad = {k: v for k, v in REFERENCE_REFINE.items()
           if config["refine"].get(k, v) != v}
    model = config["model"]
    if bad or model.get("kind", "dcgan") != "dcgan" \
            or model.get("num_classes", 0) <= 0:
        raise ValueError("the conditional DCGAN reference does not "
                         f"implement {bad or 'this model'}")


def seed_weights(model: dict, seed: int, device: torch.device
                 ) -> tuple[dict, dict]:
    """(G's tensors, D's tensors) as float32 on ``device``, every kernel and
    table from one N(0, 1) draw scaled by its std."""
    classes = model["num_classes"]
    g_layout = [("label_embed.embedding", (classes, LABEL_EMBED_DIM), 1.0)]
    g_layout += inputs.generator_layout(
        dict(model, z_dim=model["z_dim"] + LABEL_EMBED_DIM))
    d_layout = inputs.discriminator_layout(model)
    feat = next(s for n, s, _ in d_layout if n == "out.weight")[1]
    d_layout += [("proj_embed.embedding", (classes, feat), feat ** -0.5)]
    total = sum(torch.Size(s).numel() for _, s, i in g_layout + d_layout
                if not isinstance(i, str))
    flat = torch.randn(total, generator=inputs.generator(seed, device,
                                                         "weights"),
                       device=device)
    gw, at = inputs._fill(g_layout, flat, 0, device)
    dw, _ = inputs._fill(d_layout, flat, at, device)
    return gw, dw


def numbers(out: dict, r: dict, j: int) -> dict:
    if len(out["losses"]) != len(r["losses"]):
        return {k: math.inf for k in NUMBERS}
    dev = r["samples"].device
    return {
        "x_gap": float((out["samples"].to(dev) - r["samples"]).abs().max()),
        "logit_gap": spread_gap(out["logits"], r["logits"]),
        "gain_gap": gain_gap(r, j),
        "flip_pct": 100.0 * float((out["accepted"].to(dev)
                                   != r["accepted"]).float().mean()),
        "loss_gap": max(rel(a, b) for a, b in zip(out["losses"],
                                                  r["losses"])),
        "shaped_logit_gap": spread_gap(r["shaped_logits"][j],
                                       r["shaped_ref"]),
        "label_gap": float((out["labels"].to(dev) != r["labels"]).sum()),
    }


class Entry:
    def __init__(self, cell):
        from collaborative_gan_sampling_torch.config import DataConfig
        from collaborative_gan_sampling_torch.data.images import (
            load_image_dataset,
        )

        refuse_unsupported(cell.config)
        self.cell, dev, mix, rc = cell, cell.device, cell.mix, cell.refine
        self.gw, self.dw = seed_weights(cell.model, cell.seed, dev)
        self.bundle, self.rcfg, self.g, self.d = port_pair(cell, self.gw,
                                                           self.dw)
        self.dataset = load_image_dataset(
            DataConfig(dataset="imagenet64"),
            image_size=cell.model["image_size"],
            procedural_n=mix["real_images"], device=dev)
        if self.dataset.num_classes < cell.model["num_classes"]:
            raise ValueError(
                f"a pool of {mix['real_images']} images holds labels up to "
                f"{self.dataset.num_classes - 1}; the model draws "
                f"{cell.model['num_classes']} classes")
        self.dataset.class_table()
        self.burn = max(1, rc["burn_in"] // rc["batch_size"])
        self.keep = set(cell.rng("check").sample(range(mix["check_from"]),
                                                 mix["check"]))
        rounds = range(0, rc["num_batches"], rc["shape_every"]) \
            if rc["shape_every"] > 0 else range(0)
        self.shaping_rounds = list(rounds)
        self.kept: dict = {}

    def call(self, gen):
        from collaborative_gan_sampling_torch.sampling.collab import sample

        return sample(self.bundle, self.g, self.d, self.rcfg, gen,
                      method="collab", data_fn=self.dataset.batch,
                      cond_data_fn=self.dataset.batch_by_labels)

    def warm(self) -> None:
        int(self.call(self.cell.generator("warm")).accepted.sum())

    def run_one(self, i: int) -> dict:
        rc = self.cell.refine
        res = self.call(self.cell.generator("call", i))
        accepted = int(res.accepted.sum())
        if i in self.keep:
            self.kept[i] = self.outputs(res)
        batches = self.burn + rc["num_batches"]
        return {"batches": batches, "candidates": batches * rc["batch_size"],
                "refined": batches * rc["batch_size"], "accepted": accepted,
                "shaping_steps": len(self.shaping_rounds)
                * rc["shaping_steps"]}

    def outputs(self, res) -> dict:
        losses = res.aux["shape_losses"][self.shaping_rounds].tolist()
        return {"samples": res.samples, "labels": res.labels,
                "accepted": res.accepted, "logits": res.logits,
                "losses": losses,
                "dw": {k: t.detach().clone() for k, t in
                       res.aux["shaped_d"].state_dict().items()}}

    def free_program(self) -> None:
        self.bundle = self.g = self.d = None

    def ref_model(self, precision: str = "float32") -> ref.Model:
        return ref.Model(self.cell.model, self.gw, self.dw,
                         Precision(precision))

    def judge(self, control: bool = False) -> tuple[dict, dict]:
        with float32_exact():
            return self._judge(control)

    def _judge(self, control: bool) -> tuple[dict, dict]:
        images = self.dataset.images
        index = ref.ClassIndex(self.dataset.labels,
                               self.cell.model["num_classes"])
        rc = self.cell.refine
        prog, ctrl = [], []
        for i in sorted(self.kept):
            outs = [self.kept[i]]
            if control:
                outs.append(ref.collab_call(self.ref_model("fp8"), images,
                                            index,
                                            self.cell.generator("call", i),
                                            rc))
            r = ref.collab_call(self.ref_model(), images, index,
                                self.cell.generator("call", i), rc,
                                judged=outs)
            prog.append(numbers(outs[0], r, 0))
            if control:
                ctrl.append(numbers(outs[1], r, 1))
        return worst(prog), worst(ctrl)
