"""A closed loop of one client, no think time: request i asks
``generate(n)`` of a ``ServingSampler(..., 'collab')`` under the D that one
collab call shaped in set-up, with a generator seeded (seed, 'request', i).
The sizes are a fixed log-uniform set, the same for every seed, in an
order drawn from the seed. The check matches every returned uint8 row of
the kept requests to the reference's candidates of the same request."""

from __future__ import annotations

import math
import time

import torch

from cardbench import inputs
from cardbench.dcgan_entry import DcganEntry
from cardbench.reference import sampler as ref


def numbers(outs: list[dict], refs: list[tuple]) -> dict:
    """Each returned row is matched to its nearest reference candidate of
    the same request (L2 over the uint8 pixels), one to one. ``pix_gap``:
    the widest pixel gap of a row to its match, in uint8 levels;
    ``flip_pct``: the share of all judged rows whose match the reference
    rejected. A request that returned other than n rows, or two rows with
    one match (a row given twice), reads inf."""
    gap, misses, rows = 0.0, 0, 0
    for out, (cands, acc) in zip(outs, refs):
        n_rows = out["samples"].shape[0]
        if n_rows != out["n"]:
            return {"pix_gap": math.inf, "flip_pct": math.inf}
        c = cands.reshape(cands.shape[0], -1).float()
        c2 = c.square().sum(1)
        p_all = out["samples"].reshape(n_rows, -1).to(c.device).float()
        matched = []
        for lo in range(0, n_rows, 1024):
            p = p_all[lo:lo + 1024]
            idx = (c2[None, :] - 2.0 * p @ c.T).argmin(1)
            gap = max(gap, float((p - c[idx]).abs().max()))
            misses += int((~acc[idx]).sum())
            matched.append(idx)
        if torch.cat(matched).unique().numel() != n_rows:
            return {"pix_gap": math.inf, "flip_pct": math.inf}
        rows += n_rows
    return {"pix_gap": gap, "flip_pct": 100.0 * misses / rows}


class Entry(DcganEntry):
    def __init__(self, cell):
        super().__init__(cell)
        from collaborative_gan_sampling_torch.sampling.collab import sample
        from collaborative_gan_sampling_torch.sampling.serve import (
            ServingSampler,
        )

        mix = cell.mix
        self.images = inputs.procedural_images(mix["real_images"], cell.model,
                                               cell.seed, cell.device)
        lo, hi, k = mix["n_min"], mix["n_max"], mix["sizes"]
        self.sizes = [round(lo * (hi / lo) ** (j / (k - 1))) for j in range(k)]
        self.keep = set(cell.rng("check").sample(range(mix["check_from"]),
                                                 mix["check"]))
        self.kept_longest = False
        res = sample(self.bundle, self.g, self.d, self.rcfg,
                     cell.generator("shape"), method="collab",
                     data_fn=lambda gen, n: (inputs.real_batch(
                         self.images, gen, n), None))
        self.shaped_d = res.aux["shaped_d"]
        self.srv = ServingSampler(self.bundle, self.rcfg, "collab")

    def size(self, i: int) -> int:
        k = len(self.sizes)
        order = self.cell.rng("order", i // k).sample(range(k), k)
        return self.sizes[order[i % k]]

    def warm(self) -> None:
        self.srv.generate(self.g, self.shaped_d, self.cell.generator("warm"),
                          max(self.sizes))

    def run_one(self, i: int) -> dict:
        n, rc = self.size(i), self.cell.refine
        t0 = time.perf_counter()
        samples, _, stats = self.srv.generate(
            self.g, self.shaped_d, self.cell.generator("request", i), n)
        latency = time.perf_counter() - t0
        longest = n == max(self.sizes) and not self.kept_longest
        if i in self.keep or longest:
            self.kept_longest |= longest
            self.kept[i] = {"samples": samples, "n": n,
                            "rounds": stats["rounds"]}
        batches = self.burn + stats["rounds"] * rc["num_batches"]
        return {"batches": batches, "candidates": batches * rc["batch_size"],
                "refined": batches * rc["batch_size"], "accepted": n,
                "latency_ms": latency * 1e3}

    def free_program(self) -> None:
        super().free_program()
        self.shaped_d = self.srv = None

    def _judge(self, control: bool) -> tuple[dict, dict]:
        rc, model = self.cell.refine, self.ref_model()
        dw = ref.collab_call(model, self.images, self.cell.generator("shape"),
                             rc)["dw"]
        if control:
            fp8 = self.ref_model("fp8")
            dw8 = ref.collab_call(fp8, self.images,
                                  self.cell.generator("shape"), rc)["dw"]
        judged = {"program": ([], []), "control": ([], [])}
        per_round = rc["num_batches"] * rc["batch_size"]
        for i in sorted(self.kept):
            out = self.kept[i]
            outs = {"program": out}
            if control:
                outs["control"] = dict(ref.serve_request(
                    fp8, dw8, self.cell.generator("request", i), rc,
                    out["n"]), n=out["n"])
            rounds = max(o["rounds"] for o in outs.values())
            cands, acc = ref.serve_candidates(
                model, dw, self.cell.generator("request", i), rc, rounds)
            for side, o in outs.items():
                cut = o["rounds"] * per_round
                judged[side][0].append(o)
                judged[side][1].append((cands[:cut], acc[:cut]))
        prog = numbers(*judged["program"]) if self.kept else {}
        ctrl = numbers(*judged["control"]) if control else {}
        return prog, ctrl
