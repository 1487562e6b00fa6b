"""Back-to-back ``sample(..., method='collab')`` calls, one caller; call i
draws from a generator seeded (seed, 'call', i), from the seed weights,
with shaping batches from the procedural images. The check replays the
kept calls in the plain reference: samples, logits, the refinement's gain,
the accept mask, the shaping losses and the shaped D."""

from __future__ import annotations

import math

from cardbench import inputs
from cardbench.dcgan_entry import DcganEntry, gain_gap, rel, spread_gap, worst
from cardbench.reference import sampler as ref

NUMBERS = ("x_gap", "logit_gap", "gain_gap", "flip_pct", "loss_gap",
           "shaped_logit_gap")


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
    }


class Entry(DcganEntry):
    def __init__(self, cell):
        super().__init__(cell)
        mix, rc = cell.mix, cell.refine
        self.images = inputs.procedural_images(mix["real_images"], cell.model,
                                               cell.seed, cell.device)
        self.keep = set(cell.rng("check").sample(range(mix["check_from"]),
                                                 mix["check"]))
        rounds = range(0, rc["num_batches"], rc["shape_every"]) \
            if rc["shape_every"] > 0 else range(0)
        self.shaping_rounds = list(rounds)

    def data_fn(self, gen, n):
        return inputs.real_batch(self.images, gen, n), None

    def call(self, gen):
        from collaborative_gan_sampling_torch.sampling.collab import sample

        return sample(self.bundle, self.g, self.d, self.rcfg, gen,
                      method="collab", data_fn=self.data_fn)

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
        return {"samples": res.samples, "accepted": res.accepted,
                "logits": res.logits, "losses": losses,
                "dw": {k: t.detach().clone() for k, t in
                       res.aux["shaped_d"].state_dict().items()}}

    def _judge(self, control: bool) -> tuple[dict, dict]:
        prog, ctrl = [], []
        for i in sorted(self.kept):
            outs = [self.kept[i]]
            if control:
                outs.append(ref.collab_call(self.ref_model("fp8"), self.images,
                                            self.cell.generator("call", i),
                                            self.cell.refine))
            r = ref.collab_call(self.ref_model(), self.images,
                                self.cell.generator("call", i),
                                self.cell.refine, judged=outs)
            prog.append(numbers(outs[0], r, 0))
            if control:
                ctrl.append(numbers(outs[1], r, 1))
        return worst(prog), worst(ctrl)
