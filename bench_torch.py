"""Benchmark harness of the PyTorch / CUDA port: prints ONE JSON line with the
primary metric of ``bench.py``, measured on the card.

The metric: refined samples per second at K = 10 refinement steps on the
``mnist`` preset (DCGAN 28x28x1, 64/64 filters, z = 100, bf16) at batch
2,048: z -> G -> K steps through ``sampling/refine.py::make_draw_refine_fn``,
which launches the bf16 conv refine kernel (``cgs::conv_refine28_bf16``) once
a round. ``celeba`` and ``imagenet64`` (batch 512, autograd refinement) ride
along nested in the same line; ``mfu_pct`` is the analytic pipeline FLOPs
over the H100's dense bf16 peak. This file imports torch and the port only.

Protocol (``bench.py``'s): seed-0 weights; one untimed warm-up call of
``rounds`` rounds (the kernels' nvcc build at first use included), then
``repeats`` timed calls, the best kept. Each call queues ``rounds``
draw-refine rounds on the current stream from one ``torch.Generator`` on the
device (seeded 1 for the warm-up, 100 + r for repeat r), adds x.sum() +
logits.sum() into one device scalar and reads it with one ``.item()``; the
card is synchronised before each timed call starts.

Divergences from ``bench.py``, on purpose:

- ``vs_baseline`` is always null, and there is no ``--no-tf-baseline``:
  bench.py divides by a TF1-style loop (``benchmarks/tf1_reference.py``)
  whose cached rate was measured on the TPU host's CPU, with TensorFlow,
  which the card's machine does not have.
- A secondary preset that fails raises, and the exit code is not 0; bench.py
  prints the failure to stderr and exits 0.
- No backend probe thread: without a card and without ``--device cpu`` the
  line has ``value: null`` and an ``error``, and the exit code is 1. Nothing
  falls back to the CPU.
- No compile cache to enable: ``ops/_build.py`` builds the kernels into
  ``build/kernels/`` and reuses them.
- ``device`` names the card and its power limit, as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` gives them.
- ``mfu_pct`` is null off the card (``--device cpu``): the peak is the
  card's.

Usage: python bench_torch.py [--batch N] [--steps K] [--preset P]
                             [--secondary a,b | none] [--device cuda | cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch


def make_run(batch_size: int, steps_k: int, rounds: int = 20,
             preset: str = "mnist", device=None):
    """``(run, cfg, device)``: ``run(seed)`` queues ``rounds`` draw-refine
    rounds of ``batch_size`` at K = ``steps_k`` on seed-0 weights, from a
    ``torch.Generator`` on the device seeded ``seed``, and returns the sum
    of every x and logit as a float (one ``.item()``)."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.sampling.refine import (
        make_draw_refine_fn,
    )

    cfg = get_preset(preset)
    rcfg = dataclasses.replace(cfg.refine, steps=steps_k)
    bundle = make_bundle(cfg.model, device)
    dev = bundle.device
    g, d = bundle.init(torch.Generator(device=dev).manual_seed(0))
    draw_refine = make_draw_refine_fn(bundle, rcfg)

    def run(seed: int) -> float:
        gen = torch.Generator(device=dev).manual_seed(seed)
        acc = torch.zeros((), device=dev)
        for _ in range(rounds):
            x, _, logits = draw_refine(g, d, gen, batch_size)
            with torch.no_grad():
                acc += x.sum().float() + logits.sum().float()
        return acc.item()

    return run, cfg, dev


def measure_refine_throughput(batch_size: int, steps_k: int,
                              rounds: int = 20, repeats: int = 3,
                              preset: str = "mnist", device=None) -> dict:
    """Refined samples/s of the z -> G -> refine(K) pipeline: best of
    ``repeats`` timed calls of ``rounds`` rounds after one warm-up call."""
    run, cfg, dev = make_run(batch_size, steps_k, rounds, preset, device)
    run(1)  # warm-up: the kernels' build, cuDNN plans, the allocator
    best = float("inf")
    for r in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run(100 + r)
        best = min(best, time.perf_counter() - t0)
    sps = batch_size * rounds / best
    # The analytic FLOP count models the DCGAN conv pipeline; for other
    # model kinds (e.g. the toy2d MLP), or against the card's peak off the
    # card, an MFU from it would be fiction.
    mfu = (round(100.0 * sps * _pipeline_flops_per_sample(cfg.model, steps_k)
                 / BF16_PEAK_FLOPS, 1)
           if cfg.model.kind == "dcgan" and dev.type == "cuda" else None)
    return {
        "samples_per_sec": sps,
        "sec_per_batch": best / rounds,
        "batch_size": batch_size,
        "steps_k": steps_k,
        "rounds": rounds,
        "mfu_pct": mfu,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }


# H100 SXM: 989 TFLOP/s dense bf16 on the tensor cores (NVIDIA's data sheet,
# at the 700 W power limit).
BF16_PEAK_FLOPS = 989e12


def _pipeline_flops_per_sample(mcfg, steps_k: int) -> float:
    """Analytic FLOPs/sample of the z -> G -> refine(K) -> D pipeline for any
    DCGAN preset (5x5 stride-2 convs/deconvs throughout; MACs x 2), as
    ``bench.py`` counts them: every one of the 25 taps of every output,
    the zero border included (mnist: D forward 20.71 MFLOP, G 21.95 MFLOP,
    456.9 MFLOP a sample at K = 10). A refine step is a D forward and its
    input-VJP (equal FLOPs); total = G + (2K + 1) * D forward. Conditional
    presets add the projection head's inner product to every D pass and
    widen G's projection input by the label embedding.

    This is not the count of the conv kernel's bound
    (``ops/conv_refine.py::refine_flops_per_sample``), which takes only the
    taps that read inside the image (17,364,352 FLOP per D forward of the
    28x28 D) and leaves G out. Only defined for DCGAN presets: callers
    guard on ``mcfg.kind``."""
    from collaborative_gan_sampling_torch.models.dcgan import (
        LABEL_EMBED_DIM,
        num_stages,
    )

    s, c = mcfg.image_size, mcfg.channels
    base, gbase, z = mcfg.d_base_filters, mcfg.g_base_filters, mcfg.z_dim
    cond = mcfg.num_classes > 0
    n = num_stages(s)
    d_fwd = (s // 2) ** 2 * base * 25 * c
    for i in range(1, n):
        d_fwd += ((s // 2 ** (i + 1)) ** 2 * (base * 2 ** i) * 25
                  * (base * 2 ** (i - 1)))
    feat_dim = (s // 2 ** n) ** 2 * base * 2 ** (n - 1)
    d_fwd += feat_dim  # dense head
    if cond:
        d_fwd += feat_dim  # projection head: logit += <embed(y), feat>
    d_fwd *= 2
    s0, ch0 = s // 2 ** n, gbase * 2 ** (n - 1)
    if cond:
        z += LABEL_EMBED_DIM  # emb(y) concatenated to z
    g_fwd = z * (s0 * s0 * ch0)  # projection
    sp, inch = s0, ch0
    for i in range(n - 1):
        outch = gbase * 2 ** (n - 2 - i)
        g_fwd += sp * sp * inch * 25 * outch
        sp, inch = sp * 2, outch
    g_fwd += sp * sp * inch * 25 * c  # deconv_out
    g_fwd *= 2
    return g_fwd + (2 * steps_k + 1) * d_fwd


# Per-preset measurement batch, bench.py's: mnist at 2,048, celeba at 512,
# imagenet64 (the same 64x64x3 pipeline shape) at celeba's.
DEFAULT_BATCH = {"mnist": 2048, "celeba": 512, "imagenet64": 512}


def _measure_preset(preset: str, batch: int | None, steps_k: int,
                    device=None) -> dict:
    """One preset's entry of the JSON line."""
    if batch is None:
        batch = DEFAULT_BATCH.get(preset, 512)
    ours = measure_refine_throughput(batch, steps_k, preset=preset,
                                     device=device)
    return {
        "metric": f"refined_samples_per_sec_per_chip_k{steps_k}_{preset}",
        "value": round(ours["samples_per_sec"], 1),
        "unit": "samples/sec",
        "vs_baseline": None,
        "mfu_pct": ours["mfu_pct"],
    }


def _device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's name off the card."""
    if dev.type != "cuda":
        return str(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    lines = smi.stdout.strip().splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return lines[min(index, len(lines) - 1)]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=None,
                   help="override the per-preset batch "
                        f"(defaults: {DEFAULT_BATCH})")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--preset", default="mnist",
                   help="model preset to measure (mnist, celeba, ...); the "
                        "primary metric is the mnist default")
    p.add_argument("--secondary", default="celeba,imagenet64",
                   help="comma-separated presets folded into the same JSON "
                        "line (default 'celeba,imagenet64'; 'none' to "
                        "disable), only with the default --preset mnist")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({
            "metric": f"refined_samples_per_sec_per_chip_k{args.steps}_"
                      f"{args.preset}",
            "value": None, "unit": "samples/sec", "vs_baseline": None,
            "error": "no CUDA device is available; pass --device cpu to "
                     "measure on the CPU"}))
        return 1

    result = _measure_preset(args.preset, args.batch, args.steps, dev)
    if args.preset == "mnist":
        for sec in args.secondary.split(","):
            sec = sec.strip()
            if sec and sec != "none":
                result[sec] = _measure_preset(sec, None, args.steps, dev)
    result["device"] = _device_line(dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
