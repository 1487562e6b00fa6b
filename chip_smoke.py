#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. device  - requires CUDA; prints the card's name and power limit as
             ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. build   - compiles every kernel of ``collaborative_gan_sampling_torch/
             csrc`` with nvcc (one process per source, all at once);
3. kernels - holds each kernel against its plain PyTorch version on the card
             at the main path's shapes (and a ragged batch), TF32 off;
4. main    - ``sample(..., method="collab")`` on the ``mnist`` preset at full
             width (DCGAN 28x28x1, 64/64 filters, z = 100, K = 10, batch 256,
             bf16 compute) from a random init, with real batches from a
             seeded pool of images; launch counters are set to 0 just before
             and read just after; then the kernel and plain refine paths are
             held against each other on a small input;
5. timing  - each kernel and its plain version timed with CUDA events at the
             main path's shapes, beside the least time the card could take.

The line before the last is a JSON object with one row per kernel; the last
line is ``{"ok": true, "device": {...}}``. Needs no network.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_F32_FLOPS = 67e12  # float32 on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3

BATCH, STEPS, RATE = 256, 10, 0.02  # the mnist preset's refine shape
RAGGED = 37
REFINE_ATOL = 1e-5  # f32 sums in another order over K = 10 steps
ACCEPT_BAND = 1e-6  # masks may differ only where |u - p| < 1e-6


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    phase(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    return card


def build_phase():
    from collaborative_gan_sampling_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build()
    phase(f"build: {time.perf_counter() - t0:.1f} s for {len(reports)} "
          "kernels (sm_90a)")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"   {name}: {line.strip()}")


def accept_cases(torch, dev):
    """Max |kernel - plain| over both entries, outside the rounding band."""
    from collaborative_gan_sampling_torch.ops import accept as A

    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    for n in (BATCH, 1000, 1 << 20):
        logits = torch.randn(n, device=dev, generator=gen) * 3.0
        m, gamma = logits.max() - 0.5, torch.tensor(-0.4, device=dev)
        seed = A.draw_seed(gen, dev)
        u = A.bits_to_uniform(A.philox_bits_plain(seed, n))
        f = torch.clamp_max(logits - m, -1e-6)
        p = torch.sigmoid(f - torch.log(1.0 - torch.exp(f - 1e-6)) - gamma)
        outside = (u - p).abs() >= ACCEPT_BAND
        got = A.drs_accept_mask_philox(seed, logits, m, gamma)
        want = A.drs_accept_mask_philox_plain(seed, logits, m, gamma)
        err_p = float(((got != want) & outside).float().max())
        u2 = torch.rand(n, device=dev, generator=gen)
        outside2 = (u2 - p).abs() >= ACCEPT_BAND
        got2 = A.drs_accept_mask_from_uniform(u2, logits, m, gamma)
        want2 = A.drs_accept_mask_from_uniform_plain(u2, logits, m, gamma)
        err_u = float(((got2 != want2) & outside2).float().max())
        rate, mean_p = float(got.float().mean()), float(p.mean())
        sigma = math.sqrt(float((p * (1 - p)).sum())) / n
        print(f"   drs_accept B={n}: philox {int((got != want).sum())} "
              f"differing masks ({err_p:.0f} outside the band), "
              f"from_uniform {int((got2 != want2).sum())} ({err_u:.0f}); "
              f"accept rate {rate:.6f} vs mean p {mean_p:.6f} "
              f"(4 sigma {4 * sigma:.2e})")
        if err_p or err_u:
            raise AssertionError("DRS accept kernel disagrees with its plain "
                                 "version")
        if abs(rate - mean_p) > 4 * sigma + 1.0 / n:
            raise AssertionError("DRS accept rate is off the probability")
        worst = max(worst, err_p, err_u)
    return worst


def refine_d(torch, dev):
    """The mnist D at float32 with random weights and non-trivial BN."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle

    mcfg = dataclasses.replace(get_preset("mnist").model,
                               compute_dtype="float32")
    bundle = make_bundle(mcfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    _, d = bundle.init(gen)
    with torch.no_grad():
        d.bn1.running_mean.normal_(0.0, 0.2, generator=gen)
        d.bn1.running_var.uniform_(0.3, 1.5, generator=gen)
        d.bn1.weight.normal_(1.0, 0.3, generator=gen)
        d.bn1.bias.normal_(0.0, 0.1, generator=gen)
    return d, gen


def refine_cases(torch, dev):
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
        refine_conv28_plain,
    )

    d, gen = refine_d(torch, dev)
    params = fold_dcgan_d(d)
    worst = 0.0
    for n in (BATCH, RAGGED):
        x0 = torch.randn(n, 28, 28, 1, device=dev, generator=gen) * 0.5
        xk, lk = fused_refine_conv28(params, x0, STEPS, RATE)
        torch.cuda.synchronize()
        # cuDNN off: the plain version in plain f32 im2col + GEMM.
        with torch.backends.cudnn.flags(enabled=False):
            xp, lp = refine_conv28_plain(params, x0, STEPS, RATE)
        ex = float((xk - xp).abs().max())
        el = float((lk - lp).abs().max())
        moved = float((xp - x0).abs().max())
        print(f"   conv_refine28 B={n} K={STEPS}: max |dx| {ex:.3e}, "
              f"max |dlogit| {el:.3e} (refinement moved x by {moved:.3e})")
        if not (ex <= REFINE_ATOL and el <= REFINE_ATOL):
            raise AssertionError("conv refine kernel disagrees with its "
                                 f"plain version beyond {REFINE_ATOL}")
        worst = max(worst, ex, el)
    return worst


def pool_data_fn(torch, dev, n_pool=4096, seed=11):
    """Real batches for shaping: a seeded pool of smooth [-1, 1] images."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(n_pool, 1, 28, 28, device=dev, generator=gen)
    kernel = torch.ones(1, 1, 5, 5, device=dev) / 25.0
    pool = torch.tanh(3.0 * torch.nn.functional.conv2d(noise, kernel,
                                                       padding=2))
    pool = pool.permute(0, 2, 3, 1).contiguous()

    def data_fn(generator, n):
        idx = torch.randint(0, n_pool, (n,), generator=generator, device=dev)
        return pool[idx], None

    return data_fn


def main_path(torch, dev):
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.ops.accept import (
        drs_accept_mask_philox,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
    )
    from collaborative_gan_sampling_torch.sampling.collab import sample

    cfg = get_preset("mnist")
    rcfg = dataclasses.replace(cfg.refine, num_batches=8, burn_in=1024)
    bundle = make_bundle(cfg.model)  # on the card, the preset's bf16
    g, d = bundle.init(torch.Generator(device=dev).manual_seed(0))
    data_fn = pool_data_fn(torch, dev)

    def run(seed):
        return sample(bundle, g, d, rcfg,
                      torch.Generator(device=dev).manual_seed(seed),
                      method="collab", data_fn=data_fn)

    run(1)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    fused_refine_conv28.launches = 0
    drs_accept_mask_philox.launches = 0
    t0 = time.perf_counter()
    res = run(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"conv_refine28": fused_refine_conv28.launches,
                "drs_accept": drs_accept_mask_philox.launches}

    n = res.samples.shape[0]
    rate = res.accept_rate
    steps_done = res.aux["shaping_steps_done"]
    finite = bool(torch.isfinite(res.samples).all()
                  and torch.isfinite(res.logits).all())
    burn = max(1, rcfg.burn_in // rcfg.batch_size)
    phase(f"main: mnist collab, {rcfg.num_batches} rounds x {rcfg.batch_size}"
          f" (+{burn} burn-in rounds), K={rcfg.steps}, "
          f"shape_every={rcfg.shape_every}")
    print(f"   samples {tuple(res.samples.shape)} finite={finite}, "
          f"accept rate {rate:.4f}, shaping steps {steps_done}, "
          f"M {float(res.aux['logit_max']):.4f}")
    print(f"   launches {launches}")
    print(f"   {seconds * 1e3:.1f} ms wall, {n / seconds:.1f} refined "
          "samples/s (burn-in included)")
    if tuple(res.samples.shape) != (rcfg.num_batches * rcfg.batch_size,
                                    28, 28, 1) or not finite:
        raise AssertionError("collab samples are not finite of the expected "
                             "shape")
    if not 0.0 < rate < 1.0:
        raise AssertionError(f"accept rate {rate} is not in (0, 1)")
    if steps_done <= 0:
        raise AssertionError("no shaping step was taken")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

    # The same collab path with the kernels off (autograd refinement,
    # torch.rand accept), for its wall time only. Inside its gate the kernel
    # refines in f32 through the folded D, whatever the preset's dtype, so
    # the plain path runs twice: with the preset's bf16 model, and with an
    # f32 model whose refinement matches the kernel's precision.
    plain_cfg = dataclasses.replace(rcfg, use_pallas=False)
    bundle32 = make_bundle(dataclasses.replace(cfg.model,
                                               compute_dtype="float32"))
    g32, d32 = bundle32.init(torch.Generator(device=dev).manual_seed(0))
    for label, (b, gm, dm) in (("bf16", (bundle, g, d)),
                               ("f32", (bundle32, g32, d32))):
        sample(b, gm, dm, plain_cfg, torch.Generator(device=dev).manual_seed(1),
               method="collab", data_fn=data_fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(b, gm, dm, plain_cfg, torch.Generator(device=dev).manual_seed(2),
               method="collab", data_fn=data_fn)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        print(f"   plain path ({label} model): {plain_s * 1e3:.1f} ms wall, "
              f"{n / plain_s:.1f} refined samples/s")
    return launches, n / seconds


def small_reference(torch, dev):
    """Kernel refine path vs autograd refine path through the f32 model on a
    small input: the refinement sampler's output agrees."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.sampling.collab import sample

    cfg = get_preset("mnist")
    bundle = make_bundle(dataclasses.replace(cfg.model,
                                             compute_dtype="float32"))
    g, d = bundle.init(torch.Generator(device=dev).manual_seed(5))
    rcfg = dataclasses.replace(cfg.refine, num_batches=1, batch_size=64)
    outs = []
    for use_kernel in (True, False):
        c = dataclasses.replace(rcfg, use_pallas=use_kernel)
        with torch.backends.cudnn.flags(enabled=False):
            outs.append(sample(bundle, g, d, c,
                               torch.Generator(device=dev).manual_seed(9),
                               method="refinement"))
    ex = float((outs[0].samples - outs[1].samples).abs().max())
    el = float((outs[0].logits - outs[1].logits).abs().max())
    print(f"   refinement sampler, kernel vs autograd path (B=64, f32): "
          f"max |dx| {ex:.3e}, max |dlogit| {el:.3e}")
    if not (ex <= REFINE_ATOL and el <= REFINE_ATOL):
        raise AssertionError("kernel refine path disagrees with the autograd "
                             "path")


def timing(torch, dev):
    from collaborative_gan_sampling_torch.ops import accept as A
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
        refine_flops_per_sample,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
        refine_conv28_plain,
    )

    d, gen = refine_d(torch, dev)
    params = fold_dcgan_d(d)
    x0 = torch.randn(BATCH, 28, 28, 1, device=dev, generator=gen) * 0.5
    out = {}
    flops = refine_flops_per_sample(STEPS) * BATCH
    nbytes = 4 * (2 * x0.numel() + BATCH + sum(t.numel() for t in params))
    out["conv_refine28"] = dict(
        ms=time_ms(lambda: fused_refine_conv28(params, x0, STEPS, RATE)),
        plain_ms=time_ms(lambda: refine_conv28_plain(params, x0, STEPS,
                                                     RATE)),
        flops=flops, bytes=nbytes)

    logits = torch.randn(BATCH, device=dev, generator=gen)
    m, gamma = logits.max(), torch.tensor(0.0, device=dev)
    seed = A.draw_seed(gen, dev)
    # Per element: the float math of _accept_math (~20 operations); the
    # Philox rounds are integer work, which the f32 table does not cover.
    out["drs_accept"] = dict(
        ms=time_ms(lambda: A.drs_accept_mask_philox(seed, logits, m,
                                                           gamma), iters=200),
        plain_ms=time_ms(lambda: A.drs_accept_mask_philox_plain(
            seed, logits, m, gamma), iters=200),
        flops=20 * BATCH, bytes=4 * BATCH + BATCH + 8 + 8)
    for row in out.values():
        t_ops = row["flops"] / PEAK_F32_FLOPS * 1e3
        t_bytes = row["bytes"] / PEAK_BYTES_PER_S * 1e3
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def main() -> None:
    card = device_phase()
    sys.path.insert(0, REPO)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build_phase()

    phase("kernels against their plain versions")
    err_accept = accept_cases(torch, dev)
    err_refine = refine_cases(torch, dev)

    launches, samples_per_s = main_path(torch, dev)
    small_reference(torch, dev)

    phase("timing at the main path's shapes (CUDA events)")
    times = timing(torch, dev)
    rows = []
    meta = {
        "conv_refine28": dict(
            source="collaborative_gan_sampling_torch/csrc/conv_refine28.cu",
            replaces="collaborative_gan_sampling_tpu/ops/"
                     "conv_refine_pallas.py:275",
            max_abs_err=err_refine),
        "drs_accept": dict(
            source="collaborative_gan_sampling_torch/csrc/drs_accept.cu",
            replaces="collaborative_gan_sampling_tpu/ops/accept_pallas.py:83",
            max_abs_err=err_accept),
    }
    for name, info in meta.items():
        t = times[name]
        print(f"   {name}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.6f} ms by {t['bound_by']})")
        rows.append({"name": name, "route": "cuda", "source": info["source"],
                     "replaces": info["replaces"],
                     "launches": launches[name],
                     "max_abs_err": info["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    print(f"   collab main path: {samples_per_s:.1f} refined samples/s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
