"""Calls of ``rounds`` z -> G -> K-step refinements of ``batch`` through
``make_draw_refine_fn``, each round's x and logits summed into one device
scalar that the call reads once (``bench_torch.py``'s loop). The check
replays kept rounds in the plain reference: samples, logits and the
refinement's gain."""

from __future__ import annotations

import torch

from cardbench.dcgan_entry import DcganEntry, gain_gap, spread_gap, worst
from cardbench.reference import sampler as ref


def numbers(out: dict, r: dict, j: int) -> dict:
    dev = r["samples"].device
    return {
        "x_gap": float((out["samples"].to(dev) - r["samples"]).abs().max()),
        "logit_gap": spread_gap(out["logits"], r["logits"]),
        "gain_gap": gain_gap(r, j),
    }


class Entry(DcganEntry):
    def __init__(self, cell):
        super().__init__(cell)
        from collaborative_gan_sampling_torch.sampling.refine import (
            make_draw_refine_fn,
        )

        self.fn = make_draw_refine_fn(self.bundle, self.rcfg)
        mix, rng = cell.mix, cell.rng("check")
        self.keep = {(rng.randrange(mix["check_from"]),
                      rng.randrange(mix["rounds"]))
                     for _ in range(mix["check"])}

    def run_call(self, gen, i=None) -> None:
        b = self.cell.batch
        acc = torch.zeros((), device=self.cell.device)
        for r in range(self.cell.mix["rounds"]):
            x, _, logits = self.fn(self.g, self.d, gen, b)
            acc += x.sum() + logits.sum()
            if (i, r) in self.keep:
                self.kept[(i, r)] = {"samples": x, "logits": logits}
        acc.item()

    def warm(self) -> None:
        self.run_call(self.cell.generator("warm"))

    def run_one(self, i: int) -> dict:
        self.run_call(self.cell.generator("call", i), i)
        n = self.cell.mix["rounds"] * self.cell.batch
        return {"batches": self.cell.mix["rounds"], "candidates": n,
                "refined": n}

    def _judge(self, control: bool) -> tuple[dict, dict]:
        prog, ctrl = [], []
        b = self.cell.batch
        for (i, r) in sorted(self.kept):
            outs = [self.kept[(i, r)]]
            if control:
                outs.append(ref.refine_round(self.ref_model("fp8"),
                                             self.cell.generator("call", i), b,
                                             self.cell.refine, r))
            rr = ref.refine_round(self.ref_model(),
                                  self.cell.generator("call", i), b,
                                  self.cell.refine, r, judged=outs)
            prog.append(numbers(outs[0], rr, 0))
            if control:
                ctrl.append(numbers(outs[1], rr, 1))
        return worst(prog), worst(ctrl)
