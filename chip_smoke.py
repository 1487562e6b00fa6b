#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. device  - requires CUDA; prints the card's name and power limit as
             ``nvidia-smi --query-gpu=name,power.limit`` gives them, in the
             row of the card's own UUID;
2. build   - compiles every kernel of ``collaborative_gan_sampling_torch/
             csrc`` with nvcc (one process per source, all at once), prints
             ptxas's registers and spills, and fails if the f32 conv refine
             kernel spills;
3. kernels - holds each kernel against its plain PyTorch version on the card
             at the main paths' shapes (and a ragged batch; the f32 conv
             refine kernel also at B = 1, a block whose second sample is
             dead; the MLP kernel at B = 1, 37, 256, 1,001 and 65,536, each
             on the tile its wrapper picks: 2 up to 264 samples, else 8),
             TF32 off; the bf16 conv refine kernel also at B = 2,048
             (bench_torch.py's mnist batch, 1,024 blocks) and against the
             f32 one, from which it must differ by more than its bounds;
             the DRS accept step with and without its percentile on both
             routes (one launch up to 4,096 logits, the
             tensor-op percentile above), its gamma_total against
             torch.quantile's;
4. main    - ``sample(..., method="collab")`` on the ``mnist`` preset at full
             width (DCGAN 28x28x1, 64/64 filters, z = 100, K = 10, batch 256,
             the preset's bf16 compute) from a random init, with real batches
             from the port's image stream (``load_image_dataset``: 20,000
             procedural images on the card); launch counters are set to 0
             just before and read just after (the bf16 refine kernel 12
             times, the f32 one 0); the same path with the kernels off; a
             shorter f32 collab run after a warm-up (the f32 refine
             kernel's launches); one ``sample(..., method="mhgan")`` run
             (chains of 40); then the f32 kernel and autograd refine paths
             held against each other on a small input;
5. toy2d   - ``sample(..., method="collab")`` on the ``toy2d`` preset at full
             width (MLP D and G of 3 x 128 relu layers over 2-D points,
             z = 4, K = 10, rate 0.1, 40 rounds of 256, burn-in 2048, f32)
             from a seeded random init, with real batches from the
             ``ring8_imbalanced`` mixture; launch counters set to 0 just
             before and read just after; %HQ, KL and modes covered printed;
             then the kernel and autograd refine paths held against each
             other on a small input;
5t. train  - the port's own training, through ``Experiment``: the mnist
             preset uncut (bf16, 500 iterations), the toy2d preset uncut
             (4,000 iterations) and a short f32 mnist run with FusedProp,
             EMA-G and R1 (40 iterations), each from scratch in a workdir
             ``runs/smoke_<name>`` (gitignored): every logged loss finite,
             the checkpoint restored by ``load_state`` equal to the trained
             state bit for bit, one warm chunk timed and one profiled (host
             launches per iteration), then collab on the restored state with
             the launch counters (the bf16 conv and accept kernels on mnist,
             the MLP and accept kernels on toy2d, the f32 conv kernel on the
             f32 run); %HQ, KL and modes covered of standard and collab
             sampling on toy2d; the MLP kernel against its plain version on
             the trained D; the bf16 conv kernel on the trained and on the
             shaped D and the f32 conv kernel on the f32 run's D, held to
             float64 one step at a time (``trained_weight_gate``: median and
             90th percentile of the per-sample error at most the plain
             version's plus a tenth of the bf16 rounding's own effect
             (bf16), or 4 times the plain version's (f32));
5e. eval   - the trained mnist preset's standard and collab pools scored by
             ``Experiment.evaluate`` at the preset's eval config (10,000
             real samples, the classifier trained 1,500 steps) with
             precision/recall on 2,048 and KID over 10 subsets: FID, KID,
             precision, recall and each stage's seconds printed; every value
             finite, precision and recall in [0, 1], the card's float32
             Frechet distance within 1e-2 of the float64 host one, the
             classifier's features on the card within 1e-4 (of their scale)
             of the CPU's; ``fid_refine`` for one round must lower the batch
             FID; Inception-v3 on random variables (written and read in the
             msgpack format) over 1,024 generated samples, pool3 width
             2,048;
6. serving - ``ServingSampler(..., "collab").generate``: toy2d under the
             shaped D of phase 5 (n = 100,000 float32 samples), mnist under
             the shaped D of phase 4 (n = 4,096 uint8 samples), each with
             its launch counters;
6x. export - run last, after 5f: the mnist bf16 and toy2d collab
             serving rounds (batch 256, 40 batches, under the shaped Ds of
             phases 4 and 5) exported with
             ``sampling/export.py::export_sampler`` and reloaded in one
             child process (``export_child``) that imports nothing of the
             models, samplers, training or pipeline: seeds 0 and 1 equal
             to the live ``round_seeded`` bit for bit, the artifact's
             launches of its refine kernel and of kernel #1 by the
             counters (40 a round) and by ``torch.profiler`` kernel names;
             export seconds, artifact bytes and a warm round's wall, live
             and reloaded; the toy2d refinement field (``_grid_fields``) on
             the card against the CPU; 20 toy2d training iterations with
             ``viz_every`` 10 and the TensorBoard mirror, where matplotlib
             and tensorboard are installed (a line says which are);
7. timing  - each kernel and its plain version timed with CUDA events at the
             main paths' shapes (the MLP kernel also at B = 65,536, and by
             tile; the accept step with and without its percentile), each
             kernel also by its device time per launch from
             torch.profiler, beside the least time the card could take.

5c. imagenet64 - run last, after 7: the class-conditional preset at
             full width (DCGAN 64x64x3, z = 128, 96/96 filters, 1,000
             classes, bf16, K = 10, rate 0.01, batch 256, shape_every 4)
             on its 20,000 procedural images, through ``Experiment``: 100
             of its 100,000 iterations (cut for time) in chunks of 10,
             restored bit for bit; collab (40 rounds, burn-in 2,048,
             global M, class-balanced shaping: the accept kernel 40 times,
             labels (10,240,) in [0, 1,000), every shaping real batch of
             the refined batch's labels), timed warm, and a run of 4
             rounds timed warm and then profiled (host launches a round,
             device busy share of the profiled and of the warm wall, the
             share of D's conv0 and its VJP); collab under per-class
             DRS (burn-in 16,384: M (1,000,) finite, 40 launches, round
             0's kernel mask equal to ``drs_accept_mask_philox_plain``
             outside |u - p| < 1e-6); ``generate(4096, "collab",
             class_id=7)`` (every label 7, one launch a batch); z-space
             collab (4 rounds, 4 launches); and intra-FID of the collab
             pool over its 10 most frequent classes (at least 5 counted,
             finite).

5f. files, tuning and the benchmark matrix - run after 5c: five CIFAR-10
             pickles of 2,000 images (the port's procedural cifar10 images,
             in the dataset's own format) written and loaded through
             ``load_image_dataset`` bit for bit on the card;
             ``center_crop_resize`` on the card against the CPU over 512
             CelebA-size images (218x178, crop 108 -> 64) and the CIFAR
             override 32 -> 28 (float32 within 1e-4, uint8 at most 1 apart
             on at most 0.1%), and the folder loader where PIL is
             installed; the cifar10 preset at full width (DCGAN 32x32x3,
             64/64 filters, z = 100, batch 256, bf16) through the CLI in
             this process: ``train`` (200 of 20,000 iterations), ``tune``
             over K 5, 10 and rates 0.01, 0.02, ``collab --auto-tune``,
             ``generate`` (which persists the shaped D), ``benchmark`` (the
             five methods, FID finite, kernel #1 counted per method) and
             ``inspect``, with 8 sampling rounds and FID over 2,048 samples
             (cuts); ``profile`` in a child process (its trace must hold
             ``train_chunk``, ``refinement`` and a device kernel); then
             ``select_hparams`` over K 5, 10, rates 0.01, 0.02 and
             objectives ns, kl on phase 5t's trained mnist state (4
             rounds: each ns cell launches the bf16 conv kernel 4 times,
             each kl cell none) and ``benchmark`` on phase 5t's trained
             toy2d state (%HQ and KL per method, kernels #5 and #1).

8. compat and parallel - run after 5f, before 6x: phase 5t's trained
             mnist (bf16) and toy2d states through ``state_to_tf1`` ->
             ``tf1_to_checkpoint`` (a fresh workdir under
             ``runs/smoke_compat``) -> ``load_or_train``, which must not
             train; collab on each imported state equal to collab on the
             original bit for bit (mnist 8 rounds of 256 and one burn-in
             round: kernel #4 9 times, kernel #1 8; toy2d the preset's 40
             rounds and 8 burn-in rounds: kernel #5 48 times, kernel #1
             40); where ``tensorflow`` is installed, the map written as a
             ``tf.train.Saver`` checkpoint and read back bit for bit in a
             child process that sees no card (a line says whether it is);
             a process group of one rank over NCCL in a child process: 10
             mnist train iterations at full width and 4 collab rounds,
             each with the group equal to the same without it bit for bit
             (kernel #4 5 times, kernel #1 4); two processes over gloo on
             the one card (``torch.distributed.run``): ``cli train --mesh``
             of toy2d (3 iterations) writes one checkpoint and one log,
             from rank 0, within 1e-4 (losses) and 1e-5 (parameters) of
             the same command in one process, ``cli collab --mesh`` gives
             the one-process accept rate and %HQ, KL within 1e-4; mnist
             bf16 collab (2 rounds) on the imported state with the group
             of 2: round 0's samples and mask equal to one process bit for
             bit, kernel #4 once a round (and burn-in round) on each rank;

9. entry points - run after 8, before 6x: ``bench_torch.py``'s
             ``measure_refine_throughput`` in this process at bench.py's
             batches and protocol (mnist 2,048, celeba and imagenet64 512,
             K = 10, 20 rounds a call, a warm-up and 3 timed calls, best
             kept) with the launch counters (kernel #4 once a round on
             mnist: 80; none on the others), rates and ``mfu_pct`` printed;
             one more mnist call profiled (host launches a round, device
             busy share, kernel #4's device time at B = 2,048);
             ``python3 bench_torch.py --secondary none`` in a child (rc 0,
             a last line with bench.py's keys, the card named,
             ``vs_baseline`` null); the ``examples_torch/`` scripts that
             need neither matplotlib nor TensorFlow (custom_data,
             shaped_d_reuse, export_serving, inception_fid) in children at
             once with ``--device cuda`` and NITERS=50 under
             ``runs/smoke_entry`` (removed after), each to exit 0; a line
             for each of the others names the package it needs;

Between phases 5 and 6, one DRS step through ``sampling/rejection.py`` is
profiled: the key's draw and the kernel, at most two launches.

Phases 4, 5 and 6 also profile one more mnist or toy2d run with
torch.profiler (device busy share, kernels by device time, ops by host
time).

The line before the last is a JSON object with one row per kernel; the last
line is ``{"ok": true, "device": {...}}``. Needs no network.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_F32_FLOPS = 67e12  # float32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12  # bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3

BATCH, STEPS, RATE = 256, 10, 0.02  # the mnist preset's refine shape
BENCH_BATCH = 2048  # bench_torch.py's mnist batch (phase 9): 1,024 blocks
RAGGED = 37
REFINE_ATOL = 1e-5  # f32 sums in another order over K = 10 steps
# The bf16 kernel against its plain version: the same f32 sums of exact
# bf16 products in another order, which may also put a sum on the other
# side of a bf16 rounding midpoint (one operand one bf16 ulp apart).
BF16_ATOL_X, BF16_ATOL_LOGIT = 1e-5, 1e-4
ACCEPT_BAND = 1e-6  # masks may differ only where |u - p| < 1e-6
# Both routes of the accept step: up to STEP_CAP (4,096) in one launch,
# above it the tensor-op percentile and the elementwise kernel.
ACCEPT_BATCHES = (1, 37, BATCH, 4096, 1000, 1 << 20)
# The step's gamma_total against torch.quantile's over torch's shift: the
# same sort and lerp, but the card's expm1f / logf in the kernel and in
# torch's elementwise ops may round a shift's last bit apart (~8 float32
# ulps of the value).
GAMMA_RTOL = 1e-6
MLP_STEPS, MLP_RATE = 10, 0.1  # the toy2d preset's refine shape
# One sample, ragged, the main path (tiles of 2), tiles of 8 with a ragged
# last one, large (tiles of 8).
MLP_BATCHES = (1, 37, 256, 1001, 65536)
# relu' may differ between the MLP kernel and its plain version only where a
# pre-activation lies within float32 rounding of 0; samples whose plain run
# came within RELU_BAND of 0 at any unit and step are held to REFINE_ATOL
# only as a group: at most BAND_SHARE of the batch may exceed it. The bf16
# conv kernel's samples are held to BAND_SHARE likewise (bf16_refine_cases).
RELU_BAND = 1e-5
BAND_SHARE = 1e-3


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


def profiled(torch, fn):
    """Run fn once under torch.profiler (CPU and CUDA activities). Returns
    the wall seconds under the profiler, {kernel: [device ms, launches]}
    from the device's own records (user annotations left out), and the
    profiler's averages."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            row = kernels.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    return wall, kernels, prof.key_averages()


def device_ms_per_launch(torch, fn, kernel: str, calls: int = 10) -> float:
    """Device time per launch of the kernels whose name holds ``kernel``,
    from torch.profiler over ``calls`` calls of fn after one warm-up: the
    mean over the launches the profiler recorded (it may drop one). Now and
    then a session records none of them (seen on an H100 for kernels of a
    few microseconds); such a session is profiled again, up to 3 sessions."""
    fn()
    for _ in range(3):
        _, kernels, _ = profiled(torch, lambda: [fn() for _ in range(calls)])
        launches = sum(n for k, (_, n) in kernels.items() if kernel in k)
        if launches:
            break
    if not 0 < launches <= calls:
        raise AssertionError(f"profiler saw {launches} launches of "
                             f"{kernel} in {calls} calls")
    return sum(ms for k, (ms, _) in kernels.items() if kernel in k) / launches


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespace or arguments."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").split("(")[0]
    return name if len(name) <= 48 else name[:45] + "..."


def host_launches(averages) -> int:
    """Kernel launches from the host in a profile (the runtime API calls)."""
    return sum(a.count for a in averages
               if a.key.startswith("cudaLaunchKernel"))


def host_waits(averages) -> str:
    """The runtime calls in a profile at which the host may wait for the
    card: stream and device synchronizations and copies, each with its
    count and host time."""
    rows = [a for a in averages
            if a.key.startswith(("cudaStreamSynchronize",
                                 "cudaDeviceSynchronize", "cudaMemcpy"))]
    return "; ".join(f"{a.key} x{a.count} ({a.self_cpu_time_total / 1e3:.2f}"
                     " ms)" for a in rows) or "none"


def device_kernels(kernels) -> int:
    """Kernel records on the device in a profile (copies left out)."""
    return sum(n for k, (_, n) in kernels.items()
               if not k.startswith(("Memcpy", "Memset")))


def print_profile(label, wall, kernels, averages, top=5):
    busy = sum(ms for ms, _ in kernels.values())
    launches = host_launches(averages)
    print(f"   profile ({label}): {wall * 1e3:.1f} ms wall under the "
          f"profiler, device busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}"
          f"% of wall), {launches} kernel launches from the host")
    by_dev = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    print("     by device time: " + "; ".join(
        f"{short_name(k)} {ms:.2f} ms x{n}" for k, (ms, n) in by_dev))
    by_host = sorted(averages, key=lambda a: -a.self_cpu_time_total)[:top]
    print("     by host time: " + "; ".join(
        f"{a.key[:40]} {a.self_cpu_time_total / 1e3:.2f} ms x{a.count}"
        for a in by_host))
    print(f"     host waits: {host_waits(averages)}")


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from collaborative_gan_sampling_torch.utils.profiling import card_line

    card = card_line(torch.device("cuda", torch.cuda.current_device()))
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
    # The f32 conv kernel keeps its register tiles in registers.
    spills = [line for line in reports["conv_refine28"].splitlines()
              if "spill" in line
              and " 0 bytes spill stores, 0 bytes spill loads" not in line]
    if spills:
        raise AssertionError(f"conv_refine28 spills registers: {spills}")


def accept_cases(torch, dev):
    """Max |kernel - plain| over both entries, outside the rounding band,
    with and without the percentile term, on both routes (the one-launch
    step up to STEP_CAP, the tensor-op percentile and the elementwise
    kernel above it); the step's gamma_total against torch.quantile's."""
    from collaborative_gan_sampling_torch.ops import accept as A

    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    for n in ACCEPT_BATCHES:
        for pct in (0.0, 80.0):
            logits = torch.randn(n, device=dev, generator=gen) * 3.0
            m, gamma = logits.max() - 0.5, -0.4
            g_got = torch.empty(1, device=dev)
            g_want = A.gamma_total_plain(logits, m, gamma, pct, 1e-6)
            f = torch.clamp_max(logits - m, -1e-6)
            p = torch.sigmoid(f - torch.log(1.0 - torch.exp(f - 1e-6))
                              - g_want)
            seed = A.draw_seed(gen, dev)
            u = A.bits_to_uniform(A.philox_bits_plain(seed, n))
            outside = (u - p).abs() >= ACCEPT_BAND
            got = A.drs_accept_mask_philox(seed, logits, m, gamma, 1e-6, pct,
                                           gamma_out=g_got)
            want = A.drs_accept_mask_philox_plain(seed, logits, m, gamma,
                                                  1e-6, pct)
            err_p = float(((got != want) & outside).float().max())
            u2 = torch.rand(n, device=dev, generator=gen)
            outside2 = (u2 - p).abs() >= ACCEPT_BAND
            g_got2 = torch.empty(1, device=dev)
            got2 = A.drs_accept_mask_from_uniform(u2, logits, m, gamma, 1e-6,
                                                  pct, gamma_out=g_got2)
            want2 = A.drs_accept_mask_from_uniform_plain(u2, logits, m,
                                                         gamma, 1e-6, pct)
            err_u = float(((got2 != want2) & outside2).float().max())
            dg = max(float((g_got - g_want).abs()),
                     float((g_got2 - g_want).abs()))
            g_tol = GAMMA_RTOL * max(1.0, abs(float(g_want)))
            rate, mean_p = float(got.float().mean()), float(p.mean())
            sigma = math.sqrt(float((p * (1 - p)).sum())) / n
            route = "one launch" if n <= A.STEP_CAP else "tensor percentile"
            print(f"   drs_accept B={n} percentile {pct:g} ({route}): philox "
                  f"{int((got != want).sum())} differing masks ({err_p:.0f} "
                  f"outside the band), from_uniform "
                  f"{int((got2 != want2).sum())} ({err_u:.0f}); gamma_total "
                  f"{float(g_got):.7f}, |d| {dg:.3e} from torch.quantile's "
                  f"(bound {g_tol:.1e}); accept rate {rate:.6f} vs mean p "
                  f"{mean_p:.6f} (4 sigma {4 * sigma:.2e})")
            if err_p or err_u:
                raise AssertionError("DRS accept kernel disagrees with its "
                                     "plain version")
            if not dg <= g_tol:
                raise AssertionError("DRS step's gamma_total is off "
                                     "torch.quantile's")
            if abs(rate - mean_p) > 4 * sigma + 1.0 / n:
                raise AssertionError("DRS accept rate is off the probability")
            worst = max(worst, err_p, err_u)
    return worst


def accept_call_launches(torch, dev, calls=5):
    """Launches of one DRS step through ``sampling/rejection.py``'s kernel
    route at the main paths' B = 256, with and without the percentile, from
    a profile of ``calls`` calls: {percentile: (host launches, device kernel
    records, device ms, CUDA-events ms over 200 back-to-back calls, each per
    call; the profile's ``host_waits``)}. ``collab_walls.py`` counts the
    same on another tree's package."""
    from collaborative_gan_sampling_torch.sampling.rejection import (
        drs_accept_mask,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    logits = torch.randn(BATCH, device=dev, generator=gen)
    m = logits.max()
    out = {}
    for pct in (80.0, 0.0):
        def call(pct=pct):
            return drs_accept_mask(gen, logits, m, 0.0, 1e-6, pct,
                                   use_pallas=True)

        call()
        torch.cuda.synchronize()
        _, kernels, averages = profiled(
            torch, lambda: [call() for _ in range(calls)])
        out[pct] = (host_launches(averages) / calls,
                    device_kernels(kernels) / calls,
                    sum(ms for ms, _ in kernels.values()) / calls,
                    time_ms(call, iters=200), host_waits(averages))
    return out


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
    # B = 1: a block whose second sample is dead. No sample may go beyond.
    for n in (BATCH, RAGGED, 1):
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


def kink_margin(torch, params, x):
    """Per sample, the least |pre-activation| of any h1 or h2 unit in the
    bf16 plain version's forward at x (B, 28, 28, 1)."""
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        preactivations_bf16,
    )

    a0, a1 = preactivations_bf16(params, x.permute(0, 3, 1, 2))
    return torch.minimum(a0.abs().flatten(1).amin(1),
                         a1.abs().flatten(1).amin(1))


def name_jump(torch, params, x0):
    """For one sample x0 (1, 28, 28, 1): the step k whose error against the
    plain version grew most, the error of that one step run by both from
    the kernel's own x_{k-1}, and the plain forward's least |pre-activation|
    there. A discrete lrelu' flip shows as one step that carries the whole
    error, from an x where some unit lies near its kink."""
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28_bf16 as kernel,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        refine_conv28_plain_bf16 as plain,
    )

    errs = [0.0]
    for k in range(1, STEPS + 1):
        errs.append(float((kernel(params, x0, k, RATE)[0]
                           - plain(params, x0, k, RATE)[0]).abs().max()))
    k = max(range(1, STEPS + 1), key=lambda i: errs[i] - errs[i - 1])
    x_prev = kernel(params, x0, k - 1, RATE)[0]
    one = float((kernel(params, x_prev, 1, RATE)[0]
                 - plain(params, x_prev, 1, RATE)[0]).abs().max())
    return k, one, float(kink_margin(torch, params, x_prev)[0])


def bf16_case(torch, params, x0):
    """The bf16 kernel against its plain version and the f32 kernel on x0,
    printed, each sample beyond the bounds named with the step where its
    error jumped.
    Returns (the samples beyond the bounds, how many may be, max |dx| and
    |dlogit| over all, max |dx| and |dlogit| from the f32 kernel)."""
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
        fused_refine_conv28_bf16,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        refine_conv28_plain_bf16,
    )

    n = x0.shape[0]
    xk, lk = fused_refine_conv28_bf16(params, x0, STEPS, RATE)
    x32, l32 = fused_refine_conv28(params, x0, STEPS, RATE)
    torch.cuda.synchronize()
    with torch.backends.cudnn.flags(enabled=False):
        xp, lp = refine_conv28_plain_bf16(params, x0, STEPS, RATE)
    dx, dl = (xk - xp).abs().flatten(1).amax(1), (lk - lp).abs()
    beyond = ((dx > BF16_ATOL_X) | (dl > BF16_ATOL_LOGIT)).nonzero()
    allowed = math.ceil(BAND_SHARE * n)
    inside = torch.ones_like(dx, dtype=torch.bool)
    inside[beyond[:, 0]] = False
    ex = float(dx[inside].max()) if bool(inside.any()) else 0.0
    el = float(dl[inside].max()) if bool(inside.any()) else 0.0
    gx = float((xk - x32).abs().max())
    gl = float((lk - l32).abs().max())
    moved = float((xp - x0).abs().max())
    print(f"   conv_refine28_bf16 B={n} K={STEPS}: max |dx| {ex:.3e}, "
          f"max |dlogit| {el:.3e} over the samples within the bounds "
          f"({BF16_ATOL_X:.0e}, {BF16_ATOL_LOGIT:.0e}); {len(beyond)} "
          f"beyond them (at most {allowed} allowed; max |dx| "
          f"{float(dx.max()):.3e}, max |dlogit| {float(dl.max()):.3e} "
          f"over all); from the f32 kernel: max |dx| {gx:.3e}, max "
          f"|dlogit| {gl:.3e}; refinement moved x by {moved:.3e}")
    far = int(((dx > 10 * BF16_ATOL_X) | (dl > 10 * BF16_ATOL_LOGIT)).sum())
    if len(beyond):
        print(f"     beyond 10 times the bounds: {far}; median |dx| "
              f"{float(dx.median()):.3e} and |dlogit| "
              f"{float(dl.median()):.3e} over the batch")
    with torch.backends.cudnn.flags(enabled=False):
        for i in beyond[:, 0].tolist():
            k, one, margin = name_jump(torch, params, x0[i:i + 1])
            print(f"     sample {i}: |dx| {float(dx[i]):.3e}, |dlogit| "
                  f"{float(dl[i]):.3e}; its error jumped at step {k}: "
                  f"that one step from the kernel's x_{k - 1} differs "
                  f"by {one:.3e}, and the plain forward there has a "
                  f"pre-activation {margin:.3e} from its kink")
    return (beyond[:, 0].tolist(), allowed, float(dx.max()),
            float(dl.max()), gx, gl)


def bf16_refine_cases(torch, dev):
    """The bf16 kernel against its plain version, and its distance from the
    f32 kernel on the same input, which must exceed the bounds: the operands
    are really rounded. lrelu' may differ between the two versions where a
    pre-activation lies near 0: the two sum in another order, a sum may fall
    on the other side of a bf16 rounding midpoint, and the operand it rounds
    to moves by one bf16 ulp. Every sample has some of its 18,816 units near
    a kink at some step, so no band can be named in advance; as for the MLP
    kernel's relu band, at most BAND_SHARE of the batch may exceed the
    bounds, and each such sample is named with the step whose error jumped
    and the one-step error from the same x there."""
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
    )

    d, gen = refine_d(torch, dev)
    params = fold_dcgan_d(d)
    worst = 0.0
    for n in (BATCH, RAGGED, BENCH_BATCH):
        x0 = torch.randn(n, 28, 28, 1, device=dev, generator=gen) * 0.5
        beyond, allowed, wx, wl, gx, gl = bf16_case(torch, params, x0)
        if len(beyond) > allowed:
            raise AssertionError(f"{len(beyond)} samples of {n} differ beyond "
                                 f"the bf16 kernel's bounds; at most "
                                 f"{allowed} may")
        if not (gx > BF16_ATOL_X and gl > BF16_ATOL_LOGIT):
            raise AssertionError("bf16 conv refine kernel is within its "
                                 "bounds of the f32 kernel: its operands "
                                 "are not rounded")
        worst = max(worst, wx, wl)
    return worst


def trained_weight_gate(torch, params, x0, route, label):
    """The criterion on trained weights (``ops/conv_refine_ref.py``): from
    each x_t of the plain version's K-step trajectory from x0, one step of
    the kernel, of the plain version (float32 sums) and of the same plain
    function in float64 (the yardstick; the same bf16-rounded operands on
    the bf16 route, where the float64 f32 step also gives what bf16
    rounding does to the step). Over the batch, the kernel's median and
    90th percentile of the per-sample |error|, on x and on the logit, may
    be at most F32_FACTOR times the plain version's (f32), or the plain
    version's plus BF16_FRACTION of the bf16 effect's (bf16); the 99th
    percentile and the max are printed. Returns the largest share of its
    allowance that each gated statistic took over the steps."""
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
        fused_refine_conv28_bf16,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        BF16_FRACTION,
        F32_FACTOR,
        GATED,
        beyond_criterion,
        refine_conv28_plain,
        refine_conv28_plain_bf16,
        step_errors,
    )

    bf16 = route == "bf16"
    kernel, plain = ((fused_refine_conv28_bf16, refine_conv28_plain_bf16)
                     if bf16 else (fused_refine_conv28, refine_conv28_plain))
    rule = (f"the plain version's plus {BF16_FRACTION:g} of the bf16 effect's"
            if bf16 else f"{F32_FACTOR:g} times the plain version's")
    print(f"   {label}, {route} kernel (B = {x0.shape[0]}, one step from "
          f"each x_t, t < {STEPS}): |error| against float64 as median / "
          f"90th / 99th percentile / max over the batch, kernel | plain"
          + (" | bf16 effect" if bf16 else "") + f"; the kernel's median "
          f"and 90th percentile may be {rule}")
    worst, x = dict.fromkeys(GATED, 0.0), x0
    for t in range(STEPS):
        out = kernel(params, x, 1, RATE)
        torch.cuda.synchronize()
        with torch.backends.cudnn.flags(enabled=False):
            ref = plain(params, x, 1, RATE)
            yard = plain(params, x, 1, RATE, dtype=torch.float64)
            effect = (step_errors(refine_conv28_plain(
                params, x, 1, RATE, dtype=torch.float64), yard) if bf16
                else None)
        e_k, e_p = step_errors(out, yard), step_errors(ref, yard)
        cols = (e_k, e_p) + ((effect,) if bf16 else ())
        print(f"     step {t}: " + "; ".join(
            f"{v} " + " | ".join(
                f"{e[f'{v}_median']:.3e} / {e[f'{v}_q90']:.3e} / "
                f"{e[f'{v}_q99']:.3e} / {e[f'{v}_max']:.3e}"
                for e in cols)
            for v in ("x", "logit")))
        for k in GATED:
            allowed = (e_p[k] + BF16_FRACTION * effect[k] if bf16
                       else F32_FACTOR * e_p[k])
            worst[k] = max(worst[k], e_k[k] / max(allowed, 1e-300))
        over = beyond_criterion(e_k, e_p, effect)
        if over:
            raise AssertionError(f"{label}: the {route} kernel's {over} at "
                                 f"step {t} are beyond {rule}")
        x = ref[0]
    print("     largest share of the allowance: " + ", ".join(
        f"{k} {v:.3f}" for k, v in worst.items()))
    return worst


def mlp_d(torch, dev, seed=4):
    """The toy2d D at full width (3 x 128 relu layers over 2-D points) with
    random weights and non-zero biases."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle

    bundle = make_bundle(get_preset("toy2d").model, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _, d = bundle.init(gen)
    with torch.no_grad():
        for layer in d.children():
            layer.bias.normal_(0.0, 0.1, generator=gen)
    return d, gen


def relu_margin(torch, params, x0, steps, rate):
    """Per sample, the least |pre-activation| of any hidden unit over the
    plain version's K + 1 forwards."""
    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        refine_mlp_plain,
    )

    x = x0
    margin = torch.full((x0.shape[0],), float("inf"), device=x0.device)
    for k in range(steps + 1):
        h = x
        for w, b in params[:-1]:
            z = h @ w + b
            margin = torch.minimum(margin, z.abs().amin(1))
            h = torch.relu(z)
        if k < steps:
            x, _ = refine_mlp_plain(params, x, 1, rate)
    return margin


def mlp_refine_cases(torch, dev, d=None, batches=MLP_BATCHES):
    """Max |kernel - plain| over x and logits outside the relu band; inside
    it, at most BAND_SHARE of the batch beyond the tolerance. On ``d`` (a
    toy2d D) when given, else on random weights."""
    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        _sms,
        fused_refine_mlp,
        launch_plan,
        mlp_layers,
        mlp_params_from_d,
        refine_mlp_plain,
    )

    if d is None:
        d, gen = mlp_d(torch, dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(4)
    params = mlp_params_from_d(d)
    worst = 0.0
    for n in batches:
        plan = launch_plan(n, 2, 128, 3, _sms(torch.cuda.current_device()))
        x0 = torch.randn(n, 2, device=dev, generator=gen) * 2.0
        xp, lp = refine_mlp_plain(params, x0, MLP_STEPS, MLP_RATE)
        far = relu_margin(torch, params, x0, MLP_STEPS, MLP_RATE) >= RELU_BAND
        moved = float((xp - x0).abs().max())
        xk, lk = fused_refine_mlp(mlp_layers(d), x0, MLP_STEPS, MLP_RATE)
        torch.cuda.synchronize()
        dx, dl = (xk - xp).abs().amax(1), (lk - lp).abs()
        ex = float(dx[far].max()) if bool(far.any()) else 0.0
        el = float(dl[far].max()) if bool(far.any()) else 0.0
        beyond = int(((dx > REFINE_ATOL) | (dl > REFINE_ATOL)).sum())
        allowed = math.ceil(BAND_SHARE * n)
        print(f"   refine_mlp B={n} K={MLP_STEPS} (tile {plan.tile}, "
              f"{plan.grid} blocks, {plan.smem} B of shared memory): max "
              f"|dx| {ex:.3e}, "
              f"max |dlogit| {el:.3e} outside the relu band; "
              f"{int((~far).sum())} samples in the band, {beyond} beyond "
              f"{REFINE_ATOL} (at most {allowed} allowed; max |dx| "
              f"{float(dx.max()):.3e} over all; refinement moved x by "
              f"{moved:.3e})")
        if not (ex <= REFINE_ATOL and el <= REFINE_ATOL):
            raise AssertionError("MLP refine kernel disagrees with its "
                                 f"plain version beyond {REFINE_ATOL}")
        if beyond > allowed:
            raise AssertionError(f"{beyond} relu-band samples of {n} differ "
                                 f"beyond {REFINE_ATOL}; at most {allowed} "
                                 "may")
        worst = max(worst, ex, el)
    return worst


def image_data_fn(dev, data_cfg):
    """Real batches from the port's image stream: ``load_image_dataset``
    (procedural without dataset files, 20,000 uint8 images on the card)."""
    from collaborative_gan_sampling_torch.data.images import (
        load_image_dataset,
    )

    ds = load_image_dataset(data_cfg, device=dev)

    def data_fn(generator, n):
        return ds.batch(generator, n)[0], None

    return ds, data_fn


def conv_counters():
    """The launch counters of the kernels an mnist run can reach."""
    from collaborative_gan_sampling_torch.ops.accept import (
        drs_accept_mask_philox,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
        fused_refine_conv28_bf16,
    )

    return {"conv_refine28_bf16": fused_refine_conv28_bf16,
            "conv_refine28": fused_refine_conv28,
            "drs_accept": drs_accept_mask_philox}


def counted(torch, fn, counters):
    """fn() with every counter set to 0 just before; (its result, wall
    seconds up to a synchronize, the counts just after)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, seconds, {k: c.launches for k, c in counters.items()}


def check_collab(torch, res, rcfg, label, launches, want):
    """Finite samples of the expected shape, an accept rate in (0, 1), a
    shaping step and the expected launches."""
    rate = res.accept_rate
    steps_done = res.aux["shaping_steps_done"]
    finite = bool(torch.isfinite(res.samples).all()
                  and torch.isfinite(res.logits).all())
    print(f"   samples {tuple(res.samples.shape)} finite={finite}, "
          f"accept rate {rate:.4f}, shaping steps {steps_done}, "
          f"M {float(res.aux['logit_max']):.4f}")
    print(f"   launches {launches}")
    if tuple(res.samples.shape) != (rcfg.num_batches * rcfg.batch_size,
                                    28, 28, 1) or not finite:
        raise AssertionError(f"{label} samples are not finite of the "
                             "expected shape")
    if not 0.0 < rate < 1.0:
        raise AssertionError(f"{label} accept rate {rate} is not in (0, 1)")
    if steps_done <= 0:
        raise AssertionError(f"no shaping step was taken on {label}")
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, expected {want}")


def f32_collab(torch, dev, data_fn):
    """A shorter mnist collab run at f32, the precision of the f32 refine
    kernel: 4 rounds of 256 and 2 burn-in rounds from a random init.
    Returns its refine config and run(seed). ``collab_walls.py`` times
    the same run."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.sampling.collab import sample

    cfg = get_preset("mnist")
    rcfg = dataclasses.replace(cfg.refine, num_batches=4, burn_in=512)
    bundle = make_bundle(dataclasses.replace(cfg.model,
                                             compute_dtype="float32"))
    g, d = bundle.init(torch.Generator(device=dev).manual_seed(0))

    def run(seed):
        return sample(bundle, g, d, rcfg,
                      torch.Generator(device=dev).manual_seed(seed),
                      method="collab", data_fn=data_fn)

    return rcfg, run


def bf16_collab(torch, dev, data_fn):
    """The mnist collab run at the preset's bf16 (the main path): 8 rounds
    of 256 and 4 burn-in rounds from a random init. Returns its refine
    config, run(seed, c=that config, method="collab") and (bundle, g, d).
    ``collab_walls.py --path bf16`` times the same run."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.sampling.collab import sample

    cfg = get_preset("mnist")
    rcfg = dataclasses.replace(cfg.refine, num_batches=8, burn_in=1024)
    bundle = make_bundle(cfg.model)  # on the card, the preset's bf16
    g, d = bundle.init(torch.Generator(device=dev).manual_seed(0))

    def run(seed, c=rcfg, method="collab"):
        return sample(bundle, g, d, c,
                      torch.Generator(device=dev).manual_seed(seed),
                      method=method, data_fn=data_fn)

    return rcfg, run, (bundle, g, d)


def main_path(torch, dev):
    """mnist at the preset's bf16: collab (the main path), the same path
    with the kernels off, a shorter f32 collab run, and one MH-GAN run."""
    from collaborative_gan_sampling_torch.config import get_preset

    cfg = get_preset("mnist")
    counters = conv_counters()
    ds, data_fn = image_data_fn(dev, cfg.data)
    rcfg, run_seed, (bundle, g, _) = bf16_collab(torch, dev, data_fn)

    def run(c, seed=2, method="collab"):
        return run_seed(seed, c, method)

    run(rcfg, seed=1)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    res, seconds, launches = counted(torch, lambda: run(rcfg), counters)
    n = res.samples.shape[0]
    burn = max(1, rcfg.burn_in // rcfg.batch_size)
    phase(f"main: mnist collab, {rcfg.num_batches} rounds x {rcfg.batch_size}"
          f" (+{burn} burn-in rounds), K={rcfg.steps}, "
          f"shape_every={rcfg.shape_every}, {cfg.model.compute_dtype}")
    print(f"   shaping batches from {ds.name}: {ds.n} images "
          f"{ds.image_shape} uint8 on the card "
          f"({ds.images.numel() / 1e6:.2f} MB)")
    check_collab(torch, res, rcfg, "mnist collab", launches,
                 {"conv_refine28_bf16": burn + rcfg.num_batches,
                  "conv_refine28": 0, "drs_accept": rcfg.num_batches})
    print(f"   {seconds * 1e3:.1f} ms wall, {n / seconds:.1f} refined "
          "samples/s (burn-in included)")

    # The same collab path with the kernels off (autograd refinement through
    # the bf16 model, torch.rand accept), for its wall time only.
    plain_cfg = dataclasses.replace(rcfg, use_pallas=False)
    run(plain_cfg, seed=1)
    torch.cuda.synchronize()
    _, plain_s, _ = counted(torch, lambda: run(plain_cfg), counters)
    print(f"   plain path (bf16 model): {plain_s * 1e3:.1f} ms wall, "
          f"{n / plain_s:.1f} refined samples/s")
    print_profile("mnist collab, one more run",
                  *profiled(torch, lambda: run(rcfg, seed=4)))

    cfg32, run32 = f32_collab(torch, dev, data_fn)
    run32(1)  # warm-up: f32 cuDNN plans
    torch.cuda.synchronize()
    res32, s32, launches32 = counted(torch, lambda: run32(2), counters)
    burn32 = max(1, cfg32.burn_in // cfg32.batch_size)
    phase(f"mnist collab at f32: {cfg32.num_batches} rounds x "
          f"{cfg32.batch_size} (+{burn32} burn-in rounds), K={cfg32.steps}")
    check_collab(torch, res32, cfg32, "mnist f32 collab", launches32,
                 {"conv_refine28_bf16": 0,
                  "conv_refine28": burn32 + cfg32.num_batches,
                  "drs_accept": cfg32.num_batches})
    print(f"   {s32 * 1e3:.1f} ms wall, "
          f"{res32.samples.shape[0] / s32:.1f} refined samples/s")

    # MH-GAN, the paper's third arm: Platt calibration and chain init from
    # the image stream, the preset's chain length.
    mcfg = dataclasses.replace(cfg.refine, num_batches=2)
    resm, sm, launches_m = counted(torch, lambda: run(mcfg, seed=3,
                                                      method="mhgan"),
                                   counters)
    mh_rate = float(resm.aux["mh_accept_rate"])
    never = float(resm.aux["mh_never_accepted"])
    finite = bool(torch.isfinite(resm.samples).all()
                  and torch.isfinite(resm.logits).all())
    phase(f"mnist mhgan: {mcfg.num_batches} rounds x {mcfg.batch_size} "
          f"chains of {mcfg.mh_chain_len} proposals, bf16")
    print(f"   samples {tuple(resm.samples.shape)} finite={finite}, MH accept "
          f"rate {mh_rate:.4f}, chains that never accepted {never:.4f}, "
          f"accepted share {resm.accept_rate:.4f}, Platt a "
          f"{float(resm.aux['platt_a']):.4f} b "
          f"{float(resm.aux['platt_b']):.4f}; {sm * 1e3:.1f} ms wall; "
          f"launches {launches_m}")
    if tuple(resm.samples.shape) != (mcfg.num_batches * mcfg.batch_size,
                                     28, 28, 1) or not finite:
        raise AssertionError("mhgan samples are not finite of the expected "
                             "shape")
    if not 0.0 < mh_rate < 1.0:
        raise AssertionError(f"MH accept rate {mh_rate} is not in (0, 1)")
    launches["conv_refine28"] = launches32["conv_refine28"]
    launches["drs_accept"] += launches32["drs_accept"]
    return launches, n / seconds, (bundle, g, res.aux["shaped_d"])


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


def toy2d_collab(torch, dev):
    """The full toy2d collab preset (40 rounds x 256, burn-in 2048) from a
    seeded random init, with real batches from its 2D mixture. Returns the
    preset, the mixture, run(seed, c=the preset's refine config) and
    (bundle, g). ``collab_walls.py --path toy2d`` times the same run."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.data.synthetic2d import (
        make_mixture,
        sample_mixture,
    )
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.sampling.collab import sample

    cfg = get_preset("toy2d")
    bundle = make_bundle(cfg.model)
    g, d = bundle.init(torch.Generator(device=dev).manual_seed(0))
    spec = make_mixture(cfg.data.dataset, cfg.data.ring_radius,
                        cfg.data.mixture_std)

    def data_fn(generator, n):
        return sample_mixture(generator, spec, n), None

    def run(seed, c=cfg.refine):
        return sample(bundle, g, d, c,
                      torch.Generator(device=dev).manual_seed(seed),
                      method="collab", data_fn=data_fn)

    return cfg, spec, run, (bundle, g)


def toy2d_path(torch, dev):
    from collaborative_gan_sampling_torch.evals.metrics2d import metrics_2d
    from collaborative_gan_sampling_torch.ops.accept import (
        drs_accept_mask_philox,
    )
    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        fused_refine_mlp,
    )

    cfg, spec, run, (bundle, g) = toy2d_collab(torch, dev)
    rcfg = cfg.refine  # the full preset: 40 rounds x 256, burn-in 2048

    run(1)  # warm-up: allocator
    torch.cuda.synchronize()
    fused_refine_mlp.launches = 0
    drs_accept_mask_philox.launches = 0
    t0 = time.perf_counter()
    res = run(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"refine_mlp": fused_refine_mlp.launches,
                "drs_accept": drs_accept_mask_philox.launches}

    n = res.samples.shape[0]
    rate = res.accept_rate
    steps_done = res.aux["shaping_steps_done"]
    finite = bool(torch.isfinite(res.samples).all()
                  and torch.isfinite(res.logits).all())
    burn = max(1, rcfg.burn_in // rcfg.batch_size)
    phase(f"toy2d: collab, {rcfg.num_batches} rounds x {rcfg.batch_size} "
          f"(+{burn} burn-in rounds), K={rcfg.steps}, rate {rcfg.rate}, "
          f"shape_every={rcfg.shape_every}, {cfg.data.dataset}")
    print(f"   samples {tuple(res.samples.shape)} finite={finite}, "
          f"accept rate {rate:.4f}, shaping steps {steps_done}, "
          f"M {float(res.aux['logit_max']):.4f}")
    print(f"   launches {launches}")
    print(f"   {seconds * 1e3:.1f} ms wall, {n / seconds:.1f} refined "
          "samples/s (burn-in included)")
    metrics = {}
    for label, w in (("all", None), ("accepted", res.accepted.float())):
        m = {k: float(v) for k, v in metrics_2d(res.samples, spec,
                                                weights=w).items()}
        metrics[label] = m
        print(f"   metrics_2d ({label}, random weights): %HQ "
              f"{m['pct_hq']:.4f}, KL {m['kl']:.4f}, modes covered "
              f"{m['modes_covered']:.0f} of {spec.means.shape[0]}")
    if tuple(res.samples.shape) != (rcfg.num_batches * rcfg.batch_size,
                                    cfg.model.data_dim) or not finite:
        raise AssertionError("toy2d samples are not finite of the expected "
                             "shape")
    if not 0.0 < rate < 1.0:
        raise AssertionError(f"toy2d accept rate {rate} is not in (0, 1)")
    if steps_done <= 0:
        raise AssertionError("no shaping step was taken on toy2d")
    for m in metrics.values():
        if not (0.0 <= m["pct_hq"] <= 1.0 and math.isfinite(m["kl"])
                and m["kl"] >= -1e-6
                and 0 <= m["modes_covered"] <= spec.means.shape[0]):
            raise AssertionError(f"toy2d metrics out of range: {m}")
    want = {"refine_mlp": burn + rcfg.num_batches,
            "drs_accept": rcfg.num_batches}
    if launches != want:
        raise AssertionError(f"toy2d launches {launches}, expected {want}")

    # The same path with the kernels off (autograd refinement, torch.rand
    # accept), for its wall time only.
    plain_cfg = dataclasses.replace(rcfg, use_pallas=False)
    run(1, plain_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(2, plain_cfg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    print(f"   plain path: {plain_s * 1e3:.1f} ms wall, {n / plain_s:.1f} "
          "refined samples/s")
    print_profile("toy2d collab, one more run", *profiled(torch,
                                                         lambda: run(3)))
    return launches, n / seconds, (bundle, g, res.aux["shaped_d"])


def toy2d_small_reference(torch, dev):
    """Kernel refine path vs autograd refine path through the toy2d model
    on a small input: the refinement sampler's output agrees."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.sampling.collab import sample

    cfg = get_preset("toy2d")
    bundle = make_bundle(cfg.model)
    g, d = bundle.init(torch.Generator(device=dev).manual_seed(5))
    rcfg = dataclasses.replace(cfg.refine, num_batches=1, batch_size=64)
    outs = [sample(bundle, g, d, dataclasses.replace(rcfg, use_pallas=k),
                   torch.Generator(device=dev).manual_seed(9),
                   method="refinement") for k in (True, False)]
    ex = float((outs[0].samples - outs[1].samples).abs().max())
    el = float((outs[0].logits - outs[1].logits).abs().max())
    print(f"   refinement sampler, kernel vs autograd path (B=64, f32): "
          f"max |dx| {ex:.3e}, max |dlogit| {el:.3e}")
    if not (ex <= REFINE_ATOL and el <= REFINE_ATOL):
        raise AssertionError("MLP kernel refine path disagrees with the "
                             "autograd path")


# The workdirs of phase 5t, runs/smoke_<name> (their checkpoints and logs
# are gitignored). The checkpoint dirs (an mnist checkpoint holds about
# 13 MB) are removed at the end of the phase; the logs stay.
TRAIN_DIR = os.path.join(REPO, "runs")
LOSS_KEYS = ("d_loss", "g_loss", "d_real", "d_fake", "r1")


def train_experiment(preset, name, overrides, dev):
    """An Experiment on ``preset`` with ``overrides``, in a fresh workdir
    TRAIN_DIR/smoke_<name>."""
    from collaborative_gan_sampling_torch.config import (
        apply_overrides,
        get_preset,
    )
    from collaborative_gan_sampling_torch.pipeline import Experiment

    workdir = os.path.join(TRAIN_DIR, f"smoke_{name}")
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = apply_overrides(get_preset(preset).replace(workdir=workdir),
                          overrides)
    return Experiment(cfg, echo_metrics=False, device=dev)


def mnist_train(dev):
    """The mnist preset uncut (DCGAN 28x28x1, 64/64 filters, z = 100, batch
    256, g_steps 2, lr 2e-4, bf16 compute, f32 params) from its seeded init
    on the procedural image stream: 500 iterations in 25 chunks of 20, a log
    line per chunk, checkpoints at 200, 400 and 500."""
    return train_experiment("mnist", "mnist", [
        "train.niters=500", "train.log_every=20", "train.ckpt_every=200"],
        dev)


def toy2d_train(dev):
    """The toy2d preset uncut (MLP G and D of 3 x 128, batch 256, lr 1e-3,
    f32, ring8_imbalanced): 4,000 iterations in chunks of 50, a log line
    every 200, checkpoints at 1,000 .. 4,000."""
    return train_experiment("toy2d", "toy2d", [], dev)


def options_train(dev):
    """The mnist preset at f32 (so that collab on it reaches the f32 conv
    kernel) with FusedProp, EMA-G 0.999 and R1 1.0: 40 iterations, 2
    chunks of 20."""
    return train_experiment("mnist", "options", [
        "model.compute_dtype=float32", "train.niters=40",
        "train.log_every=20", "train.fused_prop=true",
        "train.g_ema_decay=0.999", "train.r1_gamma=1.0"], dev)


def state_differences(torch, a, b):
    """The tensors in which two TrainStates differ, bit for bit: G's and
    D's params and buffers, both Adam states and the EMA params."""
    out = [] if a.step == b.step else ["step"]
    for side in ("g", "d"):
        ma, mb = getattr(a, side), getattr(b, side)
        oa, ob = getattr(a, f"{side}_opt"), getattr(b, f"{side}_opt")
        pairs = list(zip(ma.named_parameters(), mb.parameters()))
        for (name, x), y in pairs + list(zip(ma.named_buffers(),
                                             mb.buffers())):
            if not torch.equal(x, y):
                out.append(f"{side}.{name}")
        for (name, x), y in pairs:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                if not torch.equal(oa.state[x][k].cpu(), ob.state[y][k].cpu()):
                    out.append(f"{side}_opt.{name}.{k}")
    if (a.g_ema is None) != (b.g_ema is None):
        out.append("g_ema")
    elif a.g_ema is not None:
        for (name, x), y in zip(a.g_ema.named_parameters(),
                                b.g_ema.parameters()):
            if not torch.equal(x, y):
                out.append(f"g_ema.{name}")
    return out


def train_run(torch, exp, label):
    """``exp.train()`` from scratch, timed to a synchronize; its log
    printed, every loss finite; ``load_state`` held to the trained state
    bit for bit. Returns (trained state, restored state, iterations/s over
    the whole call, the log's rows)."""
    cfg = exp.cfg.train
    t0 = time.perf_counter()
    state = exp.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(exp.workdir, "train.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    phase(f"train: {label}, {cfg.niters} iterations in chunks of "
          f"{cfg.steps_per_call} (batch {cfg.batch_size}, d_steps "
          f"{cfg.d_steps}, g_steps {cfg.g_steps}, fused_prop "
          f"{cfg.fused_prop}, r1_gamma {cfg.r1_gamma}, g_ema_decay "
          f"{cfg.g_ema_decay}), {exp.cfg.model.compute_dtype}")
    for r in rows:
        print(f"   step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.4f}" for k in LOSS_KEYS if k in r)
            + f"; {r['iters_per_s']} it/s since the line before")
    bad = [r["step"] for r in rows
           if not all(math.isfinite(r[k]) for k in LOSS_KEYS if k in r)]
    if bad or not rows:
        raise AssertionError(f"{label}: non-finite losses at steps {bad}")
    print(f"   {cfg.niters / seconds:.1f} iterations/s over the whole call "
          f"({seconds:.2f} s: first-call set-up, log reads and checkpoint "
          "writes included)")
    ckpts = sorted(os.listdir(exp.ckpt_dir))
    restored = exp.load_state()
    diffs = state_differences(torch, state, restored)
    same = "equal to the trained state bit for bit"
    print(f"   checkpoints {ckpts}; restored step {restored.step}: "
          f"{diffs or same}")
    if diffs or restored.step != cfg.niters:
        raise AssertionError(f"{label}: the restored state differs in "
                             f"{diffs}")
    return state, restored, cfg.niters / seconds, rows


def chunk_profile(torch, exp, state, label):
    """One warm chunk timed (iterations/s), then one profiled: host launches
    per iteration and the device's busy share. Trains ``state`` further."""
    from collaborative_gan_sampling_torch.training.gan import (
        make_train_chunk,
    )

    spc = exp.cfg.train.steps_per_call
    chunk = make_train_chunk(exp.bundle, exp.cfg.train, exp.data_fn,
                             exp.seed)
    chunk(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(state)
    torch.cuda.synchronize()
    warm = spc / (time.perf_counter() - t0)
    wall, kernels, averages = profiled(torch, lambda: chunk(state))
    busy = sum(ms for ms, _ in kernels.values()) / (wall * 1e3)
    per_iter = host_launches(averages) / spc
    print(f"   one warm chunk of {spc}: {warm:.1f} iterations/s; profiled: "
          f"{per_iter:.1f} host launches per iteration, device busy "
          f"{100 * busy:.1f}% of the wall")
    print_profile(f"{label}, one train chunk", wall, kernels, averages)
    return warm, per_iter, busy


def g_samples(torch, exp, state, n, seed=21):
    """n samples of the state's sampling G from a seeded z."""
    from collaborative_gan_sampling_torch.training.gan import sampling_g

    gen = torch.Generator(device=exp.device).manual_seed(seed)
    with torch.no_grad():
        return exp.bundle.generate(sampling_g(state),
                                   exp.bundle.sample_z(gen, n))


def sample_counted(torch, exp, state, method, counters, **kw):
    """``exp.sample`` with the counters set to 0 just before; the result
    checked finite of the expected shape, the accept rate in (0, 1]."""
    res, seconds, launches = counted(
        torch, lambda: exp.sample(state, method=method, **kw), counters)
    rcfg = kw.get("refine_cfg") or exp.cfg.refine
    want = (rcfg.num_batches * rcfg.batch_size, *exp.bundle.data_shape)
    finite = bool(torch.isfinite(res.samples).all()
                  and torch.isfinite(res.logits).all())
    print(f"   {method}: samples {tuple(res.samples.shape)} finite={finite}, "
          f"accept rate {res.accept_rate:.4f}, {seconds * 1e3:.1f} ms wall; "
          f"launches {launches}")
    if tuple(res.samples.shape) != want or not finite:
        raise AssertionError(f"{method} samples on trained weights are not "
                             "finite of the expected shape")
    if not 0.0 < res.accept_rate <= 1.0:
        raise AssertionError(f"{method} accept rate {res.accept_rate}")
    return res, launches


def need_launches(launches, names, label):
    for k in names:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on {label}")


# Phase 5e scores the trained mnist preset at its own eval config, uncut
# (10,000 real samples in batches of 256, feature net "auto": the classifier
# trained 1,500 steps on the procedural labels), with precision/recall and
# KID switched on, and runs fid_refine for one round of the preset's batch.
EVAL_OVERRIDES = ["eval.prd_samples=2048", "eval.kid_subsets=10",
                  "refine.num_batches=1"]
# The card's float32 Frechet distance (eigh) against the float64 host one on
# the same stats: float32 eigenvalues carry ~1e-7 of the largest, whose
# square roots at the clipped, rank-deficient end (dead relu units) reach
# ~3e-4 of the spectrum's root each; relative to the FID, 1e-2.
FRECHET_RTOL = 1e-2
# The classifier's features on the card against the same module on the
# CPU: float32 convs and dense layers summed in another order, TF32 off.
FEATURE_ATOL = 1e-4  # of the features' largest magnitude
INCEPTION_SAMPLES = 1024


def timed(torch, fn):
    """(fn(), seconds to a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def eval_phase(torch, dev, exp, state, pools):
    """Phase 5e: each pool scored by ``Experiment.evaluate`` (FID, KID,
    precision/recall) through the ported evals, each stage timed; the
    card's float32 Frechet distance held to the float64 host one, the
    classifier's features on the card to the CPU's; fid_refine for one
    round; Inception-v3 on random variables over INCEPTION_SAMPLES
    samples. Returns the readings."""
    import copy

    from collaborative_gan_sampling_torch.config import apply_overrides
    from collaborative_gan_sampling_torch.evals.features import (
        make_feature_fn,
    )
    from collaborative_gan_sampling_torch.evals.fid import (
        frechet_distance,
        frechet_distance_host,
        stats_from_features,
    )
    from collaborative_gan_sampling_torch.evals.inception import (
        init_inception,
        save_inception_params,
    )
    from collaborative_gan_sampling_torch.pipeline import Experiment

    eexp = Experiment(apply_overrides(exp.cfg, EVAL_OVERRIDES),
                      echo_metrics=False, device=dev)
    out = {"exp": eexp}  # its feature net and real stats serve phase 5f
    ecfg = eexp.cfg.eval
    phase(f"5e: evaluation on trained weights (mnist, {exp.cfg.train.niters}"
          f" iterations): feature net {ecfg.feature_net!r}, "
          f"{ecfg.fid_num_samples} real samples in batches of "
          f"{ecfg.fid_batch_size}, precision/recall on {ecfg.prd_samples}, "
          f"KID over {ecfg.kid_subsets} subsets of {ecfg.kid_subset_size}")
    fn, out["train_s"] = timed(torch, eexp._feature_fn)
    print(f"   feature net {eexp._feature_label}: "
          f"{ecfg.feature_train_steps} training steps in "
          f"{out['train_s']:.2f} s")
    real, out["real_s"] = timed(torch, eexp.real_stats)
    print(f"   real stats: {int(real.n)} samples, {real.mu.shape[0]} "
          f"features, {out['real_s']:.2f} s")

    # The classifier on the card against the same weights on the CPU.
    x, _ = eexp.dataset.batch(torch.Generator(device=dev).manual_seed(8),
                              ecfg.fid_batch_size)
    cpu = copy.deepcopy(fn.func).cpu()
    with torch.no_grad():
        f_card = fn(x).cpu()
        f_cpu = cpu(x.cpu(), return_features=True)
    err = float((f_card - f_cpu).abs().max())
    scale = float(f_cpu.abs().max())
    print(f"   classifier features, card against CPU on {x.shape[0]} real "
          f"images: max |diff| {err:.3e} (largest feature {scale:.3e}, "
          f"bound {FEATURE_ATOL:g} of it)")
    if not err <= FEATURE_ATOL * scale:
        raise AssertionError("the classifier's features on the card differ "
                             "from the CPU's")

    for name, res in pools.items():
        pool, _ = eexp._accepted_pool(res)
        bs = min(ecfg.fid_batch_size, pool.shape[0])
        (feats, m), feat_s = timed(torch, lambda: eexp._feats_of(pool, bs))
        stats = stats_from_features(feats)
        host, host_s = timed(torch, lambda: frechet_distance_host(stats,
                                                                  real))
        card, card_s = timed(torch, lambda: float(frechet_distance(stats,
                                                                   real)))
        rel = abs(card - host) / abs(host)
        m_all, eval_s = timed(torch, lambda: eexp.evaluate(res))
        print(f"   {name}: FID {m_all['fid']:.4f}, KID {m_all['kid']:.6f} "
              f"+- {m_all['kid_std']:.6f}, precision "
              f"{m_all['precision']:.4f}, recall {m_all['recall']:.4f}, "
              f"accept rate {m_all['accept_rate']:.4f} ({pool.shape[0]} "
              f"samples, {m} scored)")
        print(f"     seconds: features {feat_s:.3f}, float64 host distance "
              f"{host_s:.3f}, float32 card distance {card_s:.3f}, the whole "
              f"evaluate (features again, KID, precision/recall) "
              f"{eval_s:.3f}; card FID {card:.6f} against host "
              f"{host:.6f}: relative {rel:.3e} (bound {FRECHET_RTOL:g})")
        values = [m_all[k] for k in ("fid", "kid", "kid_std", "precision",
                                     "recall")] + [card, host]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{name}: non-finite metrics {m_all}")
        if not (0.0 <= m_all["precision"] <= 1.0
                and 0.0 <= m_all["recall"] <= 1.0):
            raise AssertionError(f"{name}: precision/recall outside [0, 1]")
        if not rel <= FRECHET_RTOL:
            raise AssertionError(f"{name}: the card's float32 FID differs "
                                 "from the float64 host one")
        out[name] = dict(m_all, features_s=feat_s, host_s=host_s,
                         card_s=card_s, evaluate_s=eval_s, card_fid=card)

    ref, out["fid_refine_s"] = timed(torch, lambda: eexp.fid_refine(state))
    start = float(ref.aux["batch_fid_start"])
    end = float(ref.aux["batch_fid_end"])
    print(f"   fid_refine: {eexp.cfg.refine.num_batches} round of "
          f"{eexp.cfg.refine.batch_size}, K = {eexp.cfg.refine.steps}, rate "
          f"{eexp.cfg.refine.rate}: batch FID {start:.4f} -> {end:.4f} in "
          f"{out['fid_refine_s']:.2f} s")
    if not (math.isfinite(end) and end < start
            and bool(torch.isfinite(ref.samples).all())):
        raise AssertionError("fid_refine did not lower the batch FID")
    out["fid_refine"] = (start, end)

    path = os.path.join(TRAIN_DIR, "smoke_inception.msgpack")
    gen = torch.Generator(device=dev).manual_seed(9)
    _, init_s = timed(torch, lambda: save_inception_params(
        path, init_inception(gen, dev)))
    inc, _ = make_feature_fn(f"inception:{path}", eexp.bundle.data_shape,
                             device=dev)
    x = pools["standard"].samples[:INCEPTION_SAMPLES]
    with torch.no_grad():
        feats, inc_s = timed(torch, lambda: torch.cat([
            inc(x[i:i + ecfg.fid_batch_size])
            for i in range(0, x.shape[0], ecfg.fid_batch_size)]))
    os.remove(path)
    print(f"   Inception-v3 (random variables, written and read back "
          f"through the msgpack format, {init_s:.2f} s): pool3 width "
          f"{feats.shape[1]} over {feats.shape[0]} generated samples in "
          f"{inc_s:.2f} s (resize to 299 included)")
    if feats.shape != (x.shape[0], 2048) or not bool(
            torch.isfinite(feats).all()):
        raise AssertionError(f"Inception features {tuple(feats.shape)}")
    out["inception"] = (feats.shape[1], inc_s)
    return out


def train_phase(torch, dev):
    """Train -> checkpoint -> restore -> collab on each preset, on weights
    the port trained. Returns the kernels' launches on those collab runs
    and the phase's readings."""
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
    )
    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        fused_refine_mlp,
    )
    from collaborative_gan_sampling_torch.training.gan import sampling_g

    counters = {"refine_mlp": fused_refine_mlp, **conv_counters()}
    total = dict.fromkeys(counters, 0)
    out = {}

    exp = mnist_train(dev)
    state, restored, ips, _ = train_run(torch, exp, "mnist")
    out["mnist"] = (ips, *chunk_profile(torch, exp, state, "mnist"))
    res, launches = sample_counted(torch, exp, restored, "collab", counters)
    need_launches(launches, ("conv_refine28_bf16", "drs_accept"),
                  "mnist collab after training")
    total = {k: total[k] + launches[k] for k in total}

    phase(f"the bf16 conv kernel on trained weights (B = {BATCH}, x0 = the "
          "trained G's samples): against float64, gated")
    x0 = g_samples(torch, exp, restored, BATCH)
    for label, d in (("trained D", restored.d),
                     ("shaped D", res.aux["shaped_d"])):
        out[f"bf16 gate {label}"] = trained_weight_gate(
            torch, fold_dcgan_d(d), x0, "bf16", label)

    std, launches = sample_counted(torch, exp, restored, "standard",
                                   counters)
    total = {k: total[k] + launches[k] for k in total}
    out["eval"] = eval_phase(torch, dev, exp, restored,
                             {"standard": std, "collab": res})
    out["mnist_trained"] = (exp, restored)

    exp = toy2d_train(dev)
    state, restored, ips, _ = train_run(torch, exp, "toy2d")
    out["toy2d"] = (ips, *chunk_profile(torch, exp, state, "toy2d"))
    std, _ = sample_counted(torch, exp, restored, "standard", counters)
    res, launches = sample_counted(torch, exp, restored, "collab", counters)
    need_launches(launches, ("refine_mlp", "drs_accept"),
                  "toy2d collab after training")
    total = {k: total[k] + launches[k] for k in total}
    for method, r in (("standard", std), ("collab", res)):
        m = exp.evaluate(r)
        print(f"   metrics_2d ({method}, accepted samples, trained "
              f"weights): %HQ {m['pct_hq']:.4f}, KL {m['kl']:.4f}, modes "
              f"covered {m['modes_covered']:.0f} of "
              f"{exp.spec.means.shape[0]}, accept rate "
              f"{m['accept_rate']:.4f}")
        out[f"toy2d {method}"] = m
    mlp_refine_cases(torch, dev, d=restored.d, batches=(BATCH,))
    out["toy2d_trained"] = (exp, restored)

    exp = options_train(dev)
    state, restored, ips, rows = train_run(torch, exp, "mnist options")
    if not all("r1" in r for r in rows):
        raise AssertionError("the R1 run logged no r1")
    same = [torch.equal(p, q) for p, q in zip(restored.g_ema.parameters(),
                                              restored.g.parameters())]
    print(f"   EMA params equal to the live ones in {sum(same)} of "
          f"{len(same)} tensors")
    if all(same) or sampling_g(restored) is not restored.g_ema:
        raise AssertionError("the EMA generator is not tracked")
    rcfg = dataclasses.replace(exp.cfg.refine, num_batches=1, burn_in=256)
    _, launches = sample_counted(torch, exp, restored, "collab", counters,
                                 refine_cfg=rcfg)
    need_launches(launches, ("conv_refine28", "drs_accept"),
                  "f32 mnist collab after training")
    total = {k: total[k] + launches[k] for k in total}
    phase(f"the f32 conv kernel on trained weights (B = {BATCH}, the f32 "
          "run's D and G): against float64, gated")
    out["f32 gate"] = trained_weight_gate(
        torch, fold_dcgan_d(restored.d),
        g_samples(torch, exp, restored, BATCH), "f32", "trained D")

    for name in ("mnist", "toy2d", "options"):
        shutil.rmtree(os.path.join(TRAIN_DIR, f"smoke_{name}", "ckpts"))
    return total, out


# Phase 5c: the imagenet64 preset (the class-conditional DCGAN: 64x64x3,
# z = 128, 96/96 filters, 1,000 classes, bf16; K = 10, rate 0.01, batch
# 256, shape_every 4) at full width on its procedural data (20,000 images),
# trained 100 of its 100,000 iterations (cut for time).
IN64_TRAIN = ["train.niters=100", "train.log_every=10"]
# Per-class DRS needs burn_in >> num_classes: 16,384 is ~16 samples a class.
IN64_PER_CLASS_BURN_IN = 16_384
# Intra-FID over the 10 most frequent classes of the collab pool (~4,000
# accepted samples over 1,000 classes, ~4 real samples a class): a class
# counts from 2 samples on each side (the preset's 32 would count none).
IN64_INTRA = ["eval.intra_fid_classes=10", "eval.intra_fid_min_count=2"]
IN64_INTRA_CLASSES = 5  # at least this many classes must count
IN64_CLASS, IN64_SERVE = 7, 4096  # targeted serving: class, samples
IN64_PROFILE_ROUNDS = 4


def imagenet64_experiment(dev):
    """An Experiment on the imagenet64 preset uncut in width: 100
    iterations in its chunks of 10, a checkpoint at the end."""
    return train_experiment("imagenet64", "imagenet64",
                            IN64_TRAIN + IN64_INTRA, dev)


def conv0_share(torch, fn, data_shape):
    """fn() under torch.profiler with shapes recorded: (wall seconds,
    device ms of all kernels, device ms under D's conv0 ops, host launches,
    the profiler's averages). conv0's ops are the convolutions (forward and
    backward) that take the padded (B, C, H + 3, W + 3) image, which no
    other convolution of the pair takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    h, w, c = data_shape
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, conv0, ops = 0.0, 0.0, 0
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            busy += e.time_range.elapsed_us() / 1e3
        elif e.name in ("aten::convolution", "aten::convolution_backward") \
                and any(list(s[1:]) == [c, h + 3, w + 3]
                        for s in e.input_shapes if len(s) == 4):
            conv0 += e.device_time_total / 1e3
            ops += 1
    averages = prof.key_averages()
    return wall, busy, (conv0, ops), host_launches(averages), averages


def imagenet64_phase(torch, dev):
    """Train -> checkpoint -> restore -> collab (global M, per-class M),
    targeted serving, z-space collab and intra-FID on the imagenet64
    preset. Returns the accept kernel's launches and the readings."""
    from collaborative_gan_sampling_torch.ops import accept as A
    from collaborative_gan_sampling_torch.sampling import rejection

    counters = {"drs_accept": A.drs_accept_mask_philox}
    t_phase = time.perf_counter()
    exp = imagenet64_experiment(dev)
    rcfg = exp.cfg.refine
    state, restored, ips, _ = train_run(torch, exp, "imagenet64")
    out = {"train_ips": ips}
    def at():
        return f" [{time.perf_counter() - t_phase:.1f} s into 5c]"

    phase(f"5c: imagenet64 collab on the restored state ({rcfg.num_batches} "
          f"rounds x {rcfg.batch_size}, burn-in {rcfg.burn_in}, K = "
          f"{rcfg.steps}, rate {rcfg.rate}, shape_every {rcfg.shape_every}, "
          f"class-balanced shaping {rcfg.class_balanced_shaping}, "
          f"{exp.cfg.model.compute_dtype})" + at())

    # Every shaping real batch against the refined batch it goes with.
    shaping = []
    real_cond = exp.dataset.batch_by_labels

    def cond_spy(gen, labels):
        x, lab = real_cond(gen, labels)
        shaping.append(bool(torch.equal(lab, labels)))
        return x, lab

    exp.dataset.batch_by_labels = cond_spy
    res, launches = sample_counted(torch, exp, restored, "collab", counters)
    exp.dataset.batch_by_labels = real_cond
    rounds = rcfg.num_batches
    total = launches["drs_accept"]
    n = rounds * rcfg.batch_size
    labels = res.labels
    ok_labels = (labels is not None and tuple(labels.shape) == (n,)
                 and int(labels.min()) >= 0
                 and int(labels.max()) < exp.bundle.num_classes)
    want_shapes = -(-rounds // rcfg.shape_every) * rcfg.shaping_steps
    print(f"   labels {None if labels is None else tuple(labels.shape)} in "
          f"[{int(labels.min())}, {int(labels.max())}]; {len(shaping)} "
          f"shaping real batches, {sum(shaping)} with the refined batch's "
          "labels")
    if not ok_labels:
        raise AssertionError("imagenet64 collab labels are not (N,) in "
                             "[0, num_classes)")
    if launches["drs_accept"] != rounds:
        raise AssertionError(f"imagenet64 collab launched the accept kernel "
                             f"{launches['drs_accept']} times, not {rounds}")
    if len(shaping) != want_shapes or not all(shaping):
        raise AssertionError("class-balanced shaping did not draw the "
                             "refined batch's labels")
    if not 0.0 < res.accept_rate < 1.0:
        raise AssertionError(f"imagenet64 accept rate {res.accept_rate}")

    # The same run warm and timed. A short one (IN64_PROFILE_ROUNDS and
    # one burn-in round; a whole run is ~64,000 launches, more than one
    # profiler session keeps) timed warm, then the same short run
    # profiled: its device ms over its own profiled wall is the busy share
    # the profile measures (the profiler slows the host), over the warm
    # wall of the same work the share without the profiler's cost.
    _, seconds, _ = counted(torch, lambda: exp.sample(restored, "collab"),
                            counters)
    out["samples_per_s"] = n / seconds
    short = dataclasses.replace(rcfg, num_batches=IN64_PROFILE_ROUNDS,
                                burn_in=rcfg.batch_size)

    def run_short():
        return exp.sample(restored, "collab", refine_cfg=short)

    _, short_s = timed(torch, run_short)
    wall, busy_ms, (conv0_ms, conv0_ops), launches_host, averages = \
        conv0_share(torch, run_short, exp.bundle.data_shape)
    per_round = busy_ms / (IN64_PROFILE_ROUNDS + 1)
    out.update(busy=busy_ms / (wall * 1e3), conv0=conv0_ms / busy_ms,
               launches_per_round=launches_host / (IN64_PROFILE_ROUNDS + 1),
               device_ms_per_round=per_round, wall_ms=seconds * 1e3,
               busy_warm=busy_ms / (short_s * 1e3))
    print(f"   warm: {seconds * 1e3:.1f} ms wall, {out['samples_per_s']:.1f} "
          f"refined samples/s; short run ({IN64_PROFILE_ROUNDS} rounds and 1 "
          f"burn-in round) {short_s * 1e3:.1f} ms warm, {wall * 1e3:.1f} ms "
          f"profiled, device busy {busy_ms:.1f} ms ({per_round:.2f} a "
          f"round; {100 * out['busy']:.1f}% of the profiled wall, "
          f"{100 * out['busy_warm']:.1f}% of the warm one), "
          f"{launches_host} host launches ({out['launches_per_round']:.1f} a "
          f"round), D's conv0 and its VJP {conv0_ms:.1f} ms in {conv0_ops} "
          f"ops ({100 * out['conv0']:.1f}% of the device time)")
    by_dev = sorted(averages, key=lambda a: -a.self_device_time_total)[:6]
    print("     by device time: " + "; ".join(
        f"{a.key[:44]} {a.self_device_time_total / 1e3:.2f} ms x{a.count}"
        for a in by_dev))

    phase(f"5c: per-class DRS collab (burn-in {IN64_PER_CLASS_BURN_IN})"
          + at())
    pcfg = dataclasses.replace(rcfg, per_class_drs=True,
                               burn_in=IN64_PER_CLASS_BURN_IN)
    calls = []
    real_philox = rejection.drs_accept_mask_philox

    def philox_spy(seed, logits, logit_max, *args):
        mask = real_philox(seed, logits, logit_max, *args)
        if not calls:  # the first round: its inputs and the kernel's mask
            calls.append((seed.clone(), logits.clone(), logit_max, args,
                          mask.clone()))
        return mask

    rejection.drs_accept_mask_philox = philox_spy
    try:
        pres, launches = sample_counted(torch, exp, restored, "collab",
                                        counters, refine_cfg=pcfg)
    finally:
        rejection.drs_accept_mask_philox = real_philox
    total += launches["drs_accept"]
    m = pres.aux["logit_max"]
    seed, folded, m0, (gamma, eps, pct), got = calls[0]
    want = A.drs_accept_mask_philox_plain(seed, folded, m0, gamma, eps, pct)
    g = A.gamma_total_plain(folded, m0, gamma, pct, eps)
    f = torch.clamp_max(folded - m0, -eps)
    p = torch.sigmoid(f - torch.log(1.0 - torch.exp(f - eps)) - g)
    u = A.bits_to_uniform(A.philox_bits_plain(seed, folded.shape[0]))
    outside = (u - p).abs() >= ACCEPT_BAND
    bad = int(((got != want) & outside).sum())
    print(f"   M {tuple(m.shape)}, finite {bool(torch.isfinite(m).all())}, "
          f"range [{float(m.min()):.4f}, {float(m.max()):.4f}]; round 0: "
          f"{int((got != want).sum())} masks differ from the plain "
          f"version's ({bad} outside |u - p| < {ACCEPT_BAND:g})")
    if tuple(m.shape) != (exp.bundle.num_classes,) or not bool(
            torch.isfinite(m).all()):
        raise AssertionError("per-class M is not finite of shape (C,)")
    if launches["drs_accept"] != rounds or bad:
        raise AssertionError(f"per-class DRS: {launches['drs_accept']} "
                             f"launches, {bad} masks off the plain version")

    phase(f"5c: targeted serving, generate({IN64_SERVE}, collab, class_id="
          f"{IN64_CLASS})" + at())
    exp.save_shaped_d(res)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    samples, slabels, stats = exp.generate(
        restored, IN64_SERVE, method="collab", class_id=IN64_CLASS,
        generator=torch.Generator(device=dev).manual_seed(5))
    out["serve_s"] = time.perf_counter() - t0
    served = counters["drs_accept"].launches
    total += served
    print(f"   {tuple(samples.shape)} {samples.dtype}, labels all "
          f"{IN64_CLASS}: {bool((slabels == IN64_CLASS).all())}, "
          f"{out['serve_s']:.2f} s, accept rate {stats['accept_rate']:.4f}, "
          f"{stats['rounds']} rounds, accept kernel launches {served}")
    if (samples.shape[0] != IN64_SERVE or slabels is None
            or not bool((slabels == IN64_CLASS).all())):
        raise AssertionError(f"targeted serving did not return {IN64_SERVE} "
                             f"samples of class {IN64_CLASS}")
    if served != stats["rounds"] * rcfg.num_batches:
        raise AssertionError(f"serving launched the accept kernel {served} "
                             "times, not once a batch")

    phase("5c: z-space collab (refine.space=z), 4 rounds" + at())
    zcfg = dataclasses.replace(rcfg, space="z", num_batches=4,
                               burn_in=rcfg.batch_size)
    zres, launches = sample_counted(torch, exp, restored, "collab",
                                    counters, refine_cfg=zcfg)
    total += launches["drs_accept"]
    if launches["drs_accept"] != 4:
        raise AssertionError("z-space collab launched the accept kernel "
                             f"{launches['drs_accept']} times, not 4")

    phase("5c: intra-FID of the collab pool (" + ", ".join(IN64_INTRA) + ")"
          + at())
    (intra, secs) = timed(torch, lambda: exp.intra_fid(res))
    out["intra_fid"] = intra
    print(f"   intra-FID {intra['intra_fid']:.4f} over "
          f"{intra['intra_fid_classes']} classes, {secs:.2f} s (the "
          "classifier's training included)")
    if (not math.isfinite(intra["intra_fid"])
            or intra["intra_fid_classes"] < IN64_INTRA_CLASSES):
        raise AssertionError(f"intra-FID {intra}")
    shutil.rmtree(exp.workdir)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"   phase 5c: {out['seconds']:.1f} s")
    return total, out


# Phase 5f: the paper's experiment workflow on the cifar10 preset (DCGAN
# 32x32x3, 64/64 filters, z = 100, batch 256, bf16; K = 10, rate 0.02,
# shape_every 4) at full width, on CIFAR-10 files that the phase writes in
# the dataset's own format (the port's procedural cifar10 images), through
# the CLI a user runs. Cut for time: 200 of its 20,000 training iterations,
# 8 rounds of 256 per sampling run (the preset's 40), FID over 2,048
# samples (the preset's 10,000).
F_WORKDIR = os.path.join(TRAIN_DIR, "smoke_cifar10")
F_FILES = os.path.join(TRAIN_DIR, "smoke_cifar10_files")
F_PER_BATCH = 2_000  # images in each of the five data_batch_i pickles
F_CUTS = ["train.niters=200", "refine.num_batches=8",
          "eval.fid_num_samples=2048"]
F_GRID = ["sweep_steps=5,10", "tune_rates=0.01,0.02"]
# The trained mnist preset's grid (kernel #4 for ns, the gate for kl).
F_MNIST_GRID = dict(ks=[5, 10], rates=[0.01, 0.02], objectives=["ns", "kl"])
# Crop and resize on the card against the CPU: CelebA's aligned size, the
# celeba preset's crop 108 -> 64.
F_CROP_N, F_CROP_HW, F_CROP = 512, (218, 178), (108, 64)
F_RESIZE_ATOL, F_RESIZE_SHARE = 1e-4, 1e-3


def write_cifar10_files(root, images, labels, per_batch):
    """``data_batch_1`` .. ``_5`` in CIFAR-10's python pickle format:
    ``b"data"`` (n, 3072) uint8 in CHW order, ``b"labels"`` a list."""
    import pickle

    os.makedirs(root, exist_ok=True)
    for i in range(5):
        x = images[i * per_batch:(i + 1) * per_batch]
        with open(os.path.join(root, f"data_batch_{i + 1}"), "wb") as fh:
            pickle.dump({
                b"batch_label": f"training batch {i + 1} of 5".encode(),
                b"labels": labels[i * per_batch:(i + 1) * per_batch].tolist(),
                b"data": x.transpose(0, 3, 1, 2).reshape(-1, 3072),
                b"filenames": [f"{j:05d}.png".encode()
                               for j in range(len(x))]}, fh)


def u8_apart(torch, a, b):
    """(largest difference, share of values that differ) of two uint8
    tensors."""
    d = (a.cpu().int() - b.cpu().int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def check_resize(torch, dev, u8, crop, size, label):
    """center_crop_resize on the card against the CPU: float32 within
    F_RESIZE_ATOL before rounding, uint8 at most 1 apart on at most
    F_RESIZE_SHARE of the values."""
    from collaborative_gan_sampling_torch.data.images import (
        center_crop_resize,
        resize_bilinear,
    )

    x = torch.as_tensor(u8)
    h, w = x.shape[1:3]
    if crop and crop < min(h, w):
        top, left = (h - crop) // 2, (w - crop) // 2
        x = x[:, top:top + crop, left:left + crop]
    err = float((resize_bilinear(x.to(dev), size).cpu()
                 - resize_bilinear(x, size)).abs().max())
    got, seconds = timed(torch, lambda: center_crop_resize(u8, crop, size,
                                                           device=dev))
    most, share = u8_apart(torch, got, center_crop_resize(u8, crop, size,
                                                          device="cpu"))
    print(f"   {label}: {tuple(got.shape)} on the card in {seconds:.3f} s; "
          f"float32 within {err:.3g} of the CPU's, uint8 at most {most} "
          f"apart on {100 * share:.4f}% of the values")
    if err > F_RESIZE_ATOL or most > 1 or share > F_RESIZE_SHARE:
        raise AssertionError(f"{label}: the card's resize is off the CPU's")


@contextlib.contextmanager
def sample_log(torch, counters):
    """Every ``Experiment.sample`` call in the block logged: its method,
    refine config, each counter's launches in it, seconds to a synchronize,
    sample count and accept rate."""
    from collaborative_gan_sampling_torch.pipeline import Experiment

    log, real = [], Experiment.sample

    def logged(self, state, method=None, refine_cfg=None, **kw):
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(self, state, method=method, refine_cfg=refine_cfg, **kw)
        torch.cuda.synchronize()
        log.append(dict(
            method=method or self.cfg.refine.method,
            rcfg=refine_cfg or self.cfg.refine,
            launches={k: c.launches - before[k]
                      for k, c in counters.items()},
            seconds=time.perf_counter() - t0, n=res.samples.shape[0],
            accept_rate=res.accept_rate))
        return res

    Experiment.sample = logged
    try:
        yield log
    finally:
        Experiment.sample = real


def run_cli(torch, args, counters):
    """``cli.main(args)`` in this process, every counter set to 0 just
    before and read just after: (the JSON its stdout ends with, seconds,
    launches)."""
    import io

    from collaborative_gan_sampling_torch import cli

    buf = io.StringIO()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {args[0]} exited {rc}: {text[-2000:]}")
    lines = text.strip().splitlines()
    # The JSON result is the last object printed (indented or on one line).
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    for line in lines[:start]:
        print(f"   | {line}")
    return (json.loads("\n".join(lines[start:])), seconds,
            {k: c.launches for k, c in counters.items()})


def files_phase(torch, dev):
    """5f a-b: CIFAR-10 pickles written and loaded bit for bit on the card;
    center_crop_resize on the card against the CPU; the folder loader
    where PIL is installed."""
    from collaborative_gan_sampling_torch.config import DataConfig
    from collaborative_gan_sampling_torch.data.images import (
        load_image_dataset,
        procedural_images,
    )

    n = 5 * F_PER_BATCH
    images, labels = procedural_images("cifar10", n, 32, 3, 10, seed=0,
                                       device=dev)
    images_np, labels_np = images.cpu().numpy(), labels.cpu().numpy()
    shutil.rmtree(F_FILES, ignore_errors=True)
    write_cifar10_files(F_FILES, images_np, labels_np, F_PER_BATCH)
    nbytes = sum(os.path.getsize(os.path.join(F_FILES, f))
                 for f in os.listdir(F_FILES))
    ds, seconds = timed(torch, lambda: load_image_dataset(
        DataConfig(dataset="cifar10", path=F_FILES), device=dev))
    same = (torch.equal(ds.images, images) and ds.labels.dtype == torch.int32
            and torch.equal(ds.labels, labels))
    print(f"   5 pickles of {F_PER_BATCH} images ({nbytes / 1e6:.1f} MB) "
          f"loaded in {seconds:.2f} s as {ds.name!r}, procedural "
          f"{ds.procedural}: images {tuple(ds.images.shape)} "
          f"{ds.images.dtype} and labels {ds.labels.dtype} equal to what "
          f"was written: {same}")
    if ds.procedural or not same:
        raise AssertionError("the CIFAR-10 files did not load bit for bit")

    celeba = torch.randint(0, 256, (F_CROP_N, *F_CROP_HW, 3),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.uint8)
    check_resize(torch, dev, celeba, *F_CROP, f"{F_CROP_N} CelebA-size "
                 f"images {F_CROP_HW}, crop {F_CROP[0]} -> {F_CROP[1]}")
    check_resize(torch, dev, images_np, 0, 28, f"the {n} CIFAR-10 images "
                 "32 -> 28 (the image_size override)")
    try:
        import PIL
        from PIL import Image
    except ImportError:
        print("   PIL is not installed here: the folder loader returns "
              "None (it is held against JAX's on the CPU by the tests)")
        return
    folder = os.path.join(F_FILES, "celeba")
    os.makedirs(folder)
    for i in range(16):
        Image.fromarray(celeba[i].numpy()).save(
            os.path.join(folder, f"{i:06d}.png"))
    cfg = DataConfig(dataset="celeba", path=folder)
    card_ds = load_image_dataset(cfg, image_size=64, device=dev)
    cpu_ds = load_image_dataset(cfg, image_size=64, device="cpu")
    most, share = u8_apart(torch, card_ds.images, cpu_ds.images)
    print(f"   PIL {PIL.__version__} is installed here: 16 PNGs through "
          f"the folder loader, "
          f"{tuple(card_ds.images.shape)} on the card, procedural "
          f"{card_ds.procedural}; uint8 at most {most} apart from the CPU's "
          f"on {100 * share:.4f}%")
    if (card_ds.procedural or card_ds.image_shape != (64, 64, 3) or most > 1
            or share > F_RESIZE_SHARE):
        raise AssertionError("the folder loader on the card")


def cifar10_workflow(torch, dev, counters):
    """5c of the phase: train, tune, collab --auto-tune, generate (which
    persists the shaped D), benchmark and inspect through the CLI in this
    process; profile in a child process. Returns the launches and the
    readings."""
    from collaborative_gan_sampling_torch.config import (
        apply_overrides,
        get_preset,
    )
    from collaborative_gan_sampling_torch.models import make_bundle

    shutil.rmtree(F_WORKDIR, ignore_errors=True)
    # A log line a chunk (20 iterations): the last one times a warm chunk.
    base = ["--config", "cifar10", "--workdir", F_WORKDIR, "--device",
            dev.type, f"data.path={F_FILES}", "train.log_every=20", *F_CUTS]
    cfg = apply_overrides(get_preset("cifar10"), F_CUTS)
    total = dict.fromkeys(counters, 0)
    out = {}

    def cli(*args):
        res, seconds, launches = run_cli(torch, [*args, *base], counters)
        for k in total:
            total[k] += launches[k]
        print(f"   cli {' '.join(args)}: {seconds:.2f} s, launches "
              f"{launches}")
        return res, seconds

    _, seconds = cli("train")
    with open(os.path.join(F_WORKDIR, "train.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    out["train_ips"] = (cfg.train.niters / seconds, rows[-1]["iters_per_s"])
    print(f"   train: {cfg.train.niters / seconds:.1f} iterations/s over "
          f"the whole call, {rows[-1]['iters_per_s']} in the last chunk; "
          f"{len(rows)} log lines, the last: "
          + ", ".join(f"{k} {rows[-1][k]:.4f}" for k in LOSS_KEYS
                      if k in rows[-1]))
    if not all(math.isfinite(r[k]) for r in rows for k in LOSS_KEYS
               if k in r):
        raise AssertionError("cifar10 training logged a non-finite loss")

    with sample_log(torch, counters) as log:
        tune, _ = cli("tune", *F_GRID)
    print(f"   tune grid (method refinement): best K {tune['best_k']}, "
          f"rate {tune['best_rate']}")
    for cell, m in tune["grid"].items():
        print(f"     {cell}: FID {m['fid']:.4f}, accept rate "
              f"{m['accept_rate']:.4f}")
    if len(tune["grid"]) != 4 or not all(
            math.isfinite(m["fid"]) for m in tune["grid"].values()):
        raise AssertionError(f"cifar10 tune grid {tune['grid']}")

    with sample_log(torch, counters) as log:
        collab, _ = cli("collab", "--auto-tune", *F_GRID)
    final = log[-1]
    out["collab_sps"] = final["n"] / final["seconds"]
    print(f"   collab --auto-tune: tuned K {collab['tuned_k']}, rate "
          f"{collab['tuned_rate']} over {len(log) - 1} collab cells; FID "
          f"{collab['fid']:.4f}, accept rate {collab['accept_rate']:.4f}; "
          f"the final run {final['n']} samples in {final['seconds']:.3f} s "
          f"({out['collab_sps']:.1f} refined samples/s), kernel #1 "
          f"{final['launches']['drs_accept']} launches")
    if not math.isfinite(collab["fid"]) or len(log) != 5:
        raise AssertionError(f"cifar10 collab --auto-tune: {collab}")

    served, _ = cli("generate", "n=256")
    print(f"   generate (collab, persists the shaped D): {served['n']} "
          f"samples, accept rate {served['accept_rate']:.4f}")

    with sample_log(torch, counters) as log:
        table, _ = cli("benchmark")
    out["benchmark"] = {}
    for rec in log:
        m = table[rec["method"]]
        out["benchmark"][rec["method"]] = rec
        print(f"     {rec['method']:>10}: FID {m['fid']:.4f}, accept rate "
              f"{m['accept_rate']:.4f}, {rec['n'] / rec['seconds']:.1f} "
              f"samples/s, kernel #1 {rec['launches']['drs_accept']} "
              "launches")
    if [r["method"] for r in log] != list(table) or not all(
            math.isfinite(m["fid"]) for m in table.values()):
        raise AssertionError(f"cifar10 benchmark {table}")
    for method in ("reject", "collab"):
        if out["benchmark"][method]["launches"]["drs_accept"] <= 0:
            raise AssertionError(f"cifar10 {method} launched no kernel #1")

    info, _ = cli("inspect")
    bundle = make_bundle(cfg.model, device="cpu")
    g, d = bundle.init(torch.Generator().manual_seed(0))
    counts = (sum(p.numel() for p in g.parameters()),
              sum(p.numel() for p in d.parameters()))
    print(f"   inspect: step {info['step']}, G {info['g_params']} and D "
          f"{info['d_params']} parameters (the bundle's {counts}), shaped D "
          f"saved {info['shaped_d_saved']}")
    if (info["step"] != cfg.train.niters
            or (info["g_params"], info["d_params"]) != counts
            or not info["shaped_d_saved"]):
        raise AssertionError(f"cli inspect {info}")

    # profile in a child process (a profiler session in this one can leave
    # later sessions without device records), short: chunks of 2
    # iterations and 2 refinement rounds.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "collaborative_gan_sampling_torch.cli",
         "profile", *base, "train.steps_per_call=2", "refine.num_batches=2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"cli profile: {proc.stderr[-3000:]}")
    trace_dir = json.loads(proc.stdout.strip().splitlines()[-1])["trace_dir"]
    (path,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    # Each annotation is a host event ("user_annotation") and, where the
    # device ran under it, a device one ("gpu_user_annotation").
    names = [e.get("name") for e in events
             if e.get("cat") == "user_annotation"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"   cli profile (child process, {time.perf_counter() - t0:.1f} "
          f"s): {os.path.getsize(path) / 1e6:.1f} MB trace, "
          f"{names.count('train_chunk')} train_chunk and "
          f"{names.count('refinement')} refinement annotations, {kernels} "
          "device kernels")
    if (names.count("train_chunk") != 3 or names.count("refinement") != 1
            or kernels == 0):
        raise AssertionError("the cifar10 profile trace")
    for name in ("train_chunk", "refinement"):
        wall, busy, n = annotated_busy(events, name)
        out[f"{name}_busy"] = (wall, busy, n)
        print(f"     {name}: {wall:.2f} ms under the profiler, device busy "
              f"{busy:.2f} ms ({100 * busy / wall:.1f}%) in {n} kernels")
    return total, out


def annotated_busy(events, name):
    """(host ms under the annotations ``name``, device ms of the kernels
    that started within them, their count) in a Chrome trace. The
    annotated regions end in a synchronization, so their kernels run
    within them."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and any(a <= e["ts"] < b for a, b in spans)]
    return (sum(b - a for a, b in spans) / 1e3,
            sum(e["dur"] for e in kernels) / 1e3, len(kernels))


def mnist_grid(torch, dev, trained, eval_exp, counters):
    """5d of the phase: select_hparams on phase 5t's trained mnist state,
    num_batches 4, with the feature net and real stats of phase 5e: each
    ns cell launches the bf16 conv kernel once a round, each kl cell never
    (the gate)."""
    from collaborative_gan_sampling_torch.config import apply_overrides
    from collaborative_gan_sampling_torch.pipeline import Experiment

    exp0, state = trained
    exp = Experiment(apply_overrides(exp0.cfg, ["refine.num_batches=4"]),
                     echo_metrics=False, device=dev)
    exp.adopt_eval_caches(eval_exp)
    for c in counters.values():
        c.launches = 0
    with sample_log(torch, counters) as log:
        best, table = exp.select_hparams(state, **F_MNIST_GRID)
    launches = {k: c.launches for k, c in counters.items()}
    rounds = exp.cfg.refine.num_batches
    print(f"   grid {F_MNIST_GRID}, {rounds} rounds of "
          f"{exp.cfg.refine.batch_size}: best {best}")
    for (cell, m), rec in zip(table.items(), log):
        n = rec["launches"]["conv_refine28_bf16"]
        print(f"     {cell}: FID {m['fid']:.4f}, {n} launches of "
              f"conv_refine28_bf16, {rec['seconds'] * 1e3:.1f} ms")
        want = rounds if cell[2] == "ns" else 0
        if n != want or not all(math.isfinite(v) for v in m.values()
                                if isinstance(v, float)):
            raise AssertionError(f"mnist grid cell {cell}: {n} launches "
                                 f"(want {want}), {m}")
    return launches


def toy2d_benchmark(torch, trained, counters):
    """5e of the phase: the five methods on phase 5t's trained toy2d
    state."""
    exp, state = trained
    for c in counters.values():
        c.launches = 0
    with sample_log(torch, counters) as log:
        table = exp.benchmark(state)
    launches = {k: c.launches for k, c in counters.items()}
    for rec in log:
        m = table[rec["method"]]
        print(f"     {rec['method']:>10}: %HQ {m['pct_hq']:.4f}, KL "
              f"{m['kl']:.4f}, accept rate {m['accept_rate']:.4f}; "
              f"launches {rec['launches']}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"toy2d benchmark {rec['method']}: {m}")
    for method, kernel in (("refinement", "refine_mlp"),
                           ("collab", "refine_mlp"), ("reject", "drs_accept"),
                           ("collab", "drs_accept")):
        rec = next(r for r in log if r["method"] == method)
        if rec["launches"][kernel] <= 0:
            raise AssertionError(f"toy2d {method} launched no {kernel}")
    return launches


def files_tuning_phase(torch, dev, trained):
    """Phase 5f: files, tuning and the benchmark matrix. Returns the
    kernels' launches and the readings."""
    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        fused_refine_mlp,
    )

    counters = {"refine_mlp": fused_refine_mlp, **conv_counters()}
    t_phase = time.perf_counter()

    def at():
        return f" [{time.perf_counter() - t_phase:.1f} s into 5f]"

    phase("5f: CIFAR-10 files, crop and resize on the card" + at())
    files_phase(torch, dev)
    phase("5f: the cifar10 preset through the CLI (train, tune, collab "
          "--auto-tune, generate, benchmark, inspect, profile); cuts: "
          + ", ".join(F_CUTS) + "; grid " + " ".join(F_GRID) + at())
    total, out = cifar10_workflow(torch, dev, counters)
    phase("5f: select_hparams on the trained mnist state (kernel #4)"
          + at())
    for k, n in mnist_grid(torch, dev, trained["mnist_trained"],
                           trained["eval"]["exp"], counters).items():
        total[k] += n
    phase("5f: the toy2d benchmark matrix on the trained state" + at())
    for k, n in toy2d_benchmark(torch, trained["toy2d_trained"],
                                counters).items():
        total[k] += n
    shutil.rmtree(F_FILES)
    shutil.rmtree(F_WORKDIR)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"   phase 5f: {out['seconds']:.1f} s; launches {total}")
    return total, out


# Phase 8: compat and parallel, after 5f and before 6x. The TF1 round trip
# of phase 5t's trained states, and data parallelism at world size 1 over
# NCCL (a child process) and 2 over gloo on the one card (torchrun), in
# workdirs under runs/smoke_compat (gitignored; removed at the end).
P8_DIR = os.path.join(TRAIN_DIR, "smoke_compat")
P8_MNIST = ["refine.num_batches=8", "refine.burn_in=256"]
P8_WS1 = ["train.niters=10", "train.steps_per_call=10",
          "refine.num_batches=4", "refine.burn_in=256"]
# JAX tests/test_parallel.py's chunk of 3 iterations: the bounds below are
# its bounds for that many steps (rounding differences grow with Adam's
# steps).
P8_TOY_TRAIN = ["train.niters=3", "train.steps_per_call=3",
                "train.log_every=3"]
P8_WS2_MNIST = ["refine.num_batches=2", "refine.burn_in=256"]
# The same pair of runs in f32 (kernel #3), with the shaping step's
# separation test on (any positive separation passes it).
P8_WS2_F32 = ["model.compute_dtype=float32", "refine.shaping_target=1e-6"]
P8_LOSS_ATOL = 1e-4  # JAX tests/test_parallel.py:64-67, losses
P8_PARAM_ATOL = 1e-5  # and parameters
# One f32 shaping step's summed gradients against one process's, over the
# largest gradient. Rounding alone reads up to ~9e-5 at full width (the
# card, and the CPU after 100 training iterations), where BatchNorm on each
# rank's own moments reads ~1e-1 and a missing 1 / world size scale 1.0
# (2 gloo ranks on the CPU).
P8_GRAD_RTOL = 1e-3


def p8_counters():
    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        fused_refine_mlp,
    )

    return {"refine_mlp": fused_refine_mlp, **conv_counters()}


def p8_rounds(rcfg) -> tuple[int, int]:
    """(refine kernel launches, accept kernel launches) of one collab run:
    the burn-in rounds refine too."""
    return (rcfg.num_batches + max(1, rcfg.burn_in // rcfg.batch_size),
            rcfg.num_batches)


def saver_child(npz: str, prefix: str) -> dict:
    """The Saver step of phase 8, in a child process that sees no card
    (TensorFlow would reserve the card's memory): write the npz's map as a
    ``tf.train.Saver`` checkpoint, read it back, compare bit for bit."""
    import importlib.metadata

    import numpy as np

    from collaborative_gan_sampling_torch.compat.tf1_export import (
        write_tf1_checkpoint,
    )
    from collaborative_gan_sampling_torch.compat.tf1_import import (
        read_tf1_checkpoint,
    )

    with np.load(npz) as f:
        tf_vars = {k.replace("|", "/"): f[k] for k in f.files}
    write_tf1_checkpoint(tf_vars, prefix)
    back = read_tf1_checkpoint(os.path.dirname(prefix))
    same = sorted(back) == sorted(tf_vars) and all(
        np.array_equal(back[k], v) for k, v in tf_vars.items())
    return {"variables": len(back), "equal": bool(same),
            "tensorflow": importlib.metadata.version("tensorflow")}


def tf1_roundtrip(torch, dev, trained, counters):
    """8a: state_to_tf1 of phase 5t's trained mnist and toy2d states ->
    tf1_to_checkpoint into a fresh workdir -> load_or_train (which must not
    train) -> collab on the imported state equal to collab on the original
    bit for bit, with the launch counters; the Saver round trip where
    TensorFlow is installed."""
    import importlib.util

    import numpy as np

    from collaborative_gan_sampling_torch.compat.tf1_export import (
        state_to_tf1,
    )
    from collaborative_gan_sampling_torch.compat.tf1_import import (
        tf1_to_checkpoint,
    )
    from collaborative_gan_sampling_torch.config import apply_overrides
    from collaborative_gan_sampling_torch.pipeline import Experiment

    total = dict.fromkeys(counters, 0)
    have_tf = importlib.util.find_spec("tensorflow") is not None
    print(f"   tensorflow: {'installed' if have_tf else 'not installed'} "
          f"on this machine{'' if have_tf else '; the Saver step is skipped'}")
    for name, key, cuts, kernel in (
            ("mnist", "mnist_trained", P8_MNIST, "conv_refine28_bf16"),
            ("toy2d", "toy2d_trained", [], "refine_mlp")):
        exp0, state0 = trained[key]
        workdir = os.path.join(P8_DIR, f"tf1_{name}")
        cfg = apply_overrides(exp0.cfg, cuts).replace(workdir=workdir)
        t0 = time.perf_counter()
        tf_vars = state_to_tf1(state0, cfg.model)
        path = tf1_to_checkpoint(tf_vars, cfg, device=dev)
        exp = Experiment(cfg, echo_metrics=False, device=dev)
        state = exp.load_or_train()
        import_s = time.perf_counter() - t0
        retrained = os.path.exists(os.path.join(workdir, "train.jsonl"))
        print(f"   {name}: {len(tf_vars)} TF1 variables -> "
              f"{os.path.relpath(path, REPO)} in {import_s:.2f} s; "
              f"load_or_train at step {state.step}, trained: {retrained}")
        if retrained or state.step != cfg.train.niters:
            raise AssertionError(f"{name}: the imported checkpoint was "
                                 "trained on")
        res0, _, _ = counted(torch, lambda: exp.sample(state0, "collab"),
                             counters)
        res1, seconds, launches = counted(
            torch, lambda: exp.sample(state, "collab"), counters)
        same = all(torch.equal(a, b) for a, b in (
            (res0.samples, res1.samples), (res0.accepted, res1.accepted),
            (res0.logits, res1.logits)))
        rcfg = cfg.refine
        want = p8_rounds(rcfg)
        print(f"   {name} collab, {rcfg.num_batches} rounds of "
              f"{rcfg.batch_size}: imported equal to the original bit for "
              f"bit: {same}; accept rate {res1.accept_rate:.4f}, "
              f"{seconds * 1e3:.1f} ms; launches {launches}")
        if not same:
            raise AssertionError(f"{name}: collab on the imported state "
                                 "differs from the original")
        if (launches[kernel], launches["drs_accept"]) != want:
            raise AssertionError(f"{name}: launches {launches}, want "
                                 f"{kernel} {want[0]}, drs_accept {want[1]}")
        total = {k: total[k] + launches[k] for k in total}
        if have_tf:
            npz = os.path.join(workdir, "tf1_map.npz")
            np.savez(npz, **{k.replace("/", "|"): v
                             for k, v in tf_vars.items()})
            child = subprocess.run(
                [sys.executable, "-c", "import json, sys; sys.path.insert("
                 f"0, {REPO!r}); import chip_smoke as cs; print(json.dumps("
                 "cs.saver_child(*sys.argv[1:])))", npz,
                 os.path.join(workdir, "tf1", "model-1")],
                capture_output=True, text=True, cwd=REPO, timeout=300,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
            if child.returncode != 0:
                raise AssertionError(f"the Saver child failed:\n"
                                     f"{child.stderr[-4000:]}")
            saver = json.loads(child.stdout.strip().splitlines()[-1])
            print(f"   {name} Saver checkpoint (tensorflow "
                  f"{saver['tensorflow']}): {saver['variables']} variables "
                  f"read back equal: {saver['equal']}")
            if not saver["equal"]:
                raise AssertionError(f"{name}: the Saver round trip differs")
    return total


def ws1_child() -> dict:
    """8b, in a child process: a process group of one rank over NCCL, passed
    explicitly; 10 train iterations of the mnist preset at full width and 4
    collab rounds, each with the group and without, bit for bit."""
    import socket

    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from collaborative_gan_sampling_torch.config import (
        apply_overrides,
        get_preset,
    )
    from collaborative_gan_sampling_torch.pipeline import Experiment
    from collaborative_gan_sampling_torch.sampling.collab import sample
    from collaborative_gan_sampling_torch.training.gan import (
        create_train_state,
        make_train_chunk,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    group = dist.group.WORLD
    counters = p8_counters()
    cfg = apply_overrides(get_preset("mnist"), P8_WS1).replace(
        workdir=os.path.join(P8_DIR, "ws1"))
    exp = Experiment(cfg, echo_metrics=False, device=dev)
    states, metrics = [], []
    for g in (None, group):
        state = create_train_state(exp.bundle, cfg.train, cfg.seed)
        state, m = make_train_chunk(exp.bundle, cfg.train, exp.data_fn,
                                    cfg.seed, group=g)(state)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"train_differs_in": state_differences(torch, *states),
           "metrics": metrics}
    runs = []
    for g in (None, group):
        res, seconds, launches = counted(torch, lambda: sample(
            exp.bundle, states[0].g, states[0].d, cfg.refine,
            torch.Generator(device=dev).manual_seed(3), method="collab",
            data_fn=exp.data_fn, group=g), counters)
        runs.append((res, seconds, launches))
    (r0, s0, _), (r1, s1, launches) = runs
    out["collab_equal"] = all(torch.equal(a, b) for a, b in (
        (r0.samples, r1.samples), (r0.accepted, r1.accepted),
        (r0.logits, r1.logits)))
    out["launches"] = launches
    out["want"] = p8_rounds(cfg.refine)
    out["seconds"] = [s0, s1]
    out["shape"] = list(r1.samples.shape)
    dist.destroy_process_group()
    return out


def bn_fed(name: str) -> bool:
    """A bias of a layer whose output goes into a BatchNorm (D's conv{i},
    i >= 1; G's project and deconv{i}): its gradient is exactly zero, so
    it holds only rounding noise, which Adam scales up to its step size."""
    layer, _, leaf = name.rpartition(".")
    return leaf == "bias" and (
        layer == "project"
        or (layer.startswith("deconv") and layer != "deconv_out")
        or (layer.startswith("conv") and layer != "conv0"))


def module_digest(module) -> str:
    """sha256 over the digests of a module's parameters and buffers."""
    import hashlib

    h = hashlib.sha256()
    for t in list(module.parameters()) + list(module.buffers()):
        h.update(digest(t).encode())
    return h.hexdigest()


def shaped_d_differences(torch, bundle, d1, d2, x) -> dict:
    """Two shaped Ds (one process, a group) on the batch ``x``: the largest
    differences of their parameters apart from the BN-fed biases, of those
    biases, of the BN statistics, of the train-mode outputs computed in
    f32 (BatchNorm makes them independent of the BN-fed biases), of the
    eval-mode logits in the Ds' own dtype (what refinement and the accept
    test read), and of those logits once d2 takes d1's BN-fed biases."""
    import copy

    out = {"params": 0.0, "bn_fed": 0.0}
    p1 = {n: p.detach() for n, p in d1.named_parameters()}
    for name, q in d2.named_parameters():
        key = "bn_fed" if bn_fed(name) else "params"
        out[key] = max(out[key], float((p1[name] - q.detach()).abs().max()))
    b1 = dict(d1.named_buffers())
    out["stats"] = max([0.0] + [float((b1[n].float() - b.float()).abs().max())
                                for n, b in d2.named_buffers()])
    swapped, f1, f2 = (copy.deepcopy(d) for d in (d2, d1, d2))
    with torch.no_grad():
        for name, p in swapped.named_parameters():
            if bn_fed(name):
                p.copy_(p1[name])
        f1.dtype = f2.dtype = torch.float32
        out["train_f32"] = float((bundle.discriminate(f1, x, train=True)
                                  - bundle.discriminate(f2, x, train=True))
                                 .abs().max())
        e1, e2, e3 = (bundle.discriminate(d, x) for d in (d1, d2, swapped))
    out["eval_logits"] = float((e1 - e2).abs().max())
    out["eval_swapped"] = float((e1 - e3).abs().max())
    return out


def shaping_gradient_difference(torch, bundle, d, lr, group, x_real,
                                x_fake) -> float:
    """One shaping step's gradients, with ``group`` (each rank's slices,
    summed over the ranks) and without it, on the same pair from the same
    D: their largest difference over the largest gradient."""
    from collaborative_gan_sampling_torch.parallel.mesh import shard_batch
    from collaborative_gan_sampling_torch.training.shaping import ShapingStep

    grads = []
    for g in (None, group):
        step = ShapingStep(bundle, lr, group=g)
        state, _ = step(step.init(d), shard_batch(g, x_real),
                        shard_batch(g, x_fake))
        grads.append([p.grad for p in state.d.parameters()])
    scale = max(float(t.abs().max()) for t in grads[0])
    return max(float((a - c).abs().max()) for a, c in zip(*grads)) / scale


def toy2d_ranks(torch, workdir: str) -> dict:
    """8c, a rank of ``chip_smoke.py --mesh-worker toy2d``: ``cli collab
    --mesh`` of the toy2d preset on the checkpoint ``train --mesh`` wrote,
    every counter set to 0 just before the CLI call and read just after;
    (the rank's launches, what the CLI printed: rank 0's result)."""
    import io

    from collaborative_gan_sampling_torch import cli
    from collaborative_gan_sampling_torch.config import (
        apply_overrides,
        get_preset,
    )

    cfg = apply_overrides(get_preset("toy2d"), P8_TOY_TRAIN)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, seconds, launches = counted(torch, lambda: cli.main(
            ["collab", "--mesh", "--config", "toy2d", "--workdir", workdir,
             *P8_TOY_TRAIN]), p8_counters())
    printed = [line for line in buf.getvalue().splitlines()
               if line.startswith("{")]
    return {"rc": rc, "launches": launches, "seconds": seconds,
            "want": p8_rounds(cfg.refine),
            "result": json.loads(printed[-1]) if printed else None}


def mnist_ranks(torch, workdir: str) -> dict:
    """8c, a rank of ``chip_smoke.py --mesh-worker mnist``: the imported
    mnist state of 8a (bf16) restored through ``Experiment(use_mesh=True)``,
    collab with the group of 2 and without it: round 0 bit for bit, and
    where the runs part after the shaping step, the shaped Ds' differences.
    Then the same pair of runs in f32 (kernel #3) with the separation test
    on, and where its round 0 parts: G and kernel #3 on half the batch."""
    from collaborative_gan_sampling_torch.config import (
        apply_overrides,
        get_preset,
    )
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
        fused_refine_conv28_bf16,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
    )
    from collaborative_gan_sampling_torch.pipeline import Experiment
    from collaborative_gan_sampling_torch.sampling.collab import sample
    from collaborative_gan_sampling_torch.training.gan import (
        create_train_state,
        sampling_g,
    )
    from collaborative_gan_sampling_torch.utils.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
    )
    from collaborative_gan_sampling_torch.utils.prng import step_generator

    cfg = apply_overrides(get_preset("mnist"), P8_WS2_MNIST).replace(
        workdir=workdir)
    counters = p8_counters()
    mexp = Experiment(cfg, use_mesh=True, echo_metrics=False)
    state = mexp.load_state()
    one = Experiment(cfg, echo_metrics=False).sample(state, "collab")
    res, seconds, launches = counted(
        torch, lambda: mexp.sample(state, "collab"), counters)
    b = cfg.refine.batch_size
    # Where round 0 could part from one process: G and the refine kernel on
    # a rank's half of the batch against the same rows of the whole batch.
    z = mexp.bundle.sample_z(torch.Generator(device=mexp.device)
                             .manual_seed(5), b)
    with torch.no_grad():
        x0 = mexp.bundle.generate(sampling_g(state), z)
        g_half = torch.equal(mexp.bundle.generate(sampling_g(state),
                                                  z[:b // 2]), x0[:b // 2])
    params, rate = fold_dcgan_d(state.d), cfg.refine.rate
    k_whole = fused_refine_conv28_bf16(params, x0, cfg.refine.steps, rate)
    k_half = fused_refine_conv28_bf16(params, x0[:b // 2], cfg.refine.steps,
                                      rate)
    out = {"g_half_equal": bool(g_half),
           "kernel_half_equal": bool(torch.equal(k_whole[0][:b // 2],
                                                 k_half[0])),
           "round0_equal": bool(torch.equal(one.samples[:b], res.samples[:b])
                                and torch.equal(one.accepted[:b],
                                                res.accepted[:b])),
           "max_dx": float((one.samples.float()
                            - res.samples.float()).abs().max()),
           "masks_equal": bool(torch.equal(one.accepted, res.accepted)),
           "launches": launches, "seconds": seconds,
           "want": p8_rounds(cfg.refine), "shape": list(res.samples.shape),
           "shaping_lr": cfg.refine.shaping_lr,
           "steps": res.aux["shaping_steps_done"],
           # Round 0's refined batch: equal in both runs.
           "shaped": shaped_d_differences(
               torch, mexp.bundle, one.aux["shaped_d"], res.aux["shaped_d"],
               one.samples[:b].float())}
    x_real = mexp.data_fn(torch.Generator(device=mexp.device)
                          .manual_seed(6), b)[0]
    out["shaped"]["grad"] = shaping_gradient_difference(
        torch, mexp.bundle, state.d, cfg.refine.shaping_lr, mexp.group,
        x_real, one.samples[:b])
    fcfg = apply_overrides(cfg, P8_WS2_F32)
    fbundle = make_bundle(fcfg.model, mexp.device)
    fstate = restore_checkpoint(
        latest_checkpoint(mexp.ckpt_dir),
        target=create_train_state(fbundle, fcfg.train, fcfg.seed))
    runs = [counted(torch, lambda g=g: sample(
        fbundle, sampling_g(fstate), fstate.d, fcfg.refine,
        step_generator(fcfg.seed, 0, "eval", mexp.device), method="collab",
        data_fn=mexp.data_fn, group=g), counters)
        for g in (None, mexp.group)]
    (f1, _, _), (f2, _, f_launches) = runs
    # Where f32 round 0 parts: G on half the batch against the whole
    # batch's rows, and the same rows refined by kernel #3.
    fparams = fold_dcgan_d(fstate.d)
    with torch.no_grad():
        x0 = fbundle.generate(sampling_g(fstate), z)
        x0_half = fbundle.generate(sampling_g(fstate), z[:b // 2])
    k_whole = fused_refine_conv28(fparams, x0, cfg.refine.steps, rate)[0]
    k_rows = fused_refine_conv28(fparams, x0[:b // 2], cfg.refine.steps,
                                 rate)[0]
    k_half = fused_refine_conv28(fparams, x0_half, cfg.refine.steps,
                                 rate)[0]
    out["f32"] = dict(
        shaped_d_differences(torch, fbundle, f1.aux["shaped_d"],
                             f2.aux["shaped_d"], f1.samples[:b]),
        samples=float((f1.samples - f2.samples).abs().max()),
        masks_equal=bool(torch.equal(f1.accepted, f2.accepted)),
        # Round 0 runs before the shaping step.
        round0=float((f1.samples[:b] - f2.samples[:b]).abs().max()),
        round0_masks_equal=bool(torch.equal(f1.accepted[:b],
                                            f2.accepted[:b])),
        loss=float((f1.aux["shape_losses"]
                    - f2.aux["shape_losses"]).abs().max()),
        steps=[f1.aux["shaping_steps_done"], f2.aux["shaping_steps_done"]],
        launches=f_launches, want=p8_rounds(fcfg.refine),
        g_half=float((x0_half - x0[:b // 2]).abs().max()),
        kernel_half_equal=bool(torch.equal(k_rows, k_whole[:b // 2])),
        refined_g_half=float((k_half - k_whole[:b // 2]).abs().max()),
        grad=shaping_gradient_difference(
            torch, fbundle, fstate.d, fcfg.refine.shaping_lr, mexp.group,
            x_real, f1.samples[:b]))
    # What the group holds must be the same on every rank; each rank's
    # one-process runs are its own.
    out["group"] = {"bf16_samples": digest(res.samples),
                    "bf16_d": module_digest(res.aux["shaped_d"]),
                    "f32_samples": digest(f2.samples),
                    "f32_d": module_digest(f2.aux["shaped_d"])}
    out["one"] = {"bf16_samples": digest(one.samples),
                  "bf16_d": module_digest(one.aux["shaped_d"]),
                  "f32_samples": digest(f1.samples),
                  "f32_d": module_digest(f1.aux["shaped_d"])}
    return out


MESH_WORKERS = {"toy2d": toy2d_ranks, "mnist": mnist_ranks}


def mesh_worker(kind: str, out_path: str, workdir: str) -> None:
    """Each rank of ``torchrun --nproc_per_node 2 chip_smoke.py
    --mesh-worker <kind> <out> <workdir>`` on the one card: the group comes
    up from torchrun's environment (gloo: two processes share the card),
    ``MESH_WORKERS[kind]`` runs, and rank 0 writes every rank's dict."""
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from collaborative_gan_sampling_torch.parallel.multihost import (
        maybe_initialize_distributed,
        shutdown_distributed,
    )

    maybe_initialize_distributed("cuda")
    out = MESH_WORKERS[kind](torch, workdir)
    out.update(rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    if dist.get_rank() == 0:
        with open(out_path, "w") as fh:
            json.dump(every, fh)
    shutdown_distributed()


def run_ranks(kind: str, workdir: str) -> tuple[list, float]:
    """``mesh_worker(kind, ...)`` under torchrun: (every rank's dict,
    seconds)."""
    out_path = os.path.join(P8_DIR, f"ranks_{kind}.json")
    _, seconds = torchrun([os.path.join(REPO, "chip_smoke.py"),
                           "--mesh-worker", kind, out_path, workdir])
    with open(out_path) as fh:
        return json.load(fh), seconds


def check_rank_launches(r: dict, launches: dict, want, names) -> None:
    got = tuple(launches[k] for k in names)
    if got != tuple(want):
        raise AssertionError(f"rank {r['rank']}: launches of {names} "
                             f"{got}, want {tuple(want)}")


def torchrun(args, timeout=600):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2``
    with ``args`` from the repo root: (its stdout, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *args], capture_output=True, text=True,
        cwd=REPO, timeout=timeout, env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {args[:4]} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def last_json(text: str) -> dict:
    return json.loads([line for line in text.strip().splitlines()
                       if line.startswith("{")][-1])


def ws2_toy2d(torch, counters):
    """8c through the CLI: ``train --mesh`` and ``collab --mesh`` of the
    toy2d preset at full width over gloo with 2 processes on the one card,
    against the same commands in one process (this one). ``collab
    --mesh`` runs in ``toy2d_ranks``, which counts each rank's launches:
    their sum is what the phase returns."""
    from collaborative_gan_sampling_torch.utils.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
    )

    wd2, wd1 = (os.path.join(P8_DIR, f"toy2d_ws{n}") for n in (2, 1))
    common = ["--config", "toy2d"]
    stdout, s2 = torchrun(["-m", "collaborative_gan_sampling_torch.cli",
                           "train", "--mesh",
                           *common, "--workdir", wd2, *P8_TOY_TRAIN])
    results = [json.loads(line) for line in stdout.splitlines()
               if line.startswith("{")]
    got1, s1, _ = run_cli(torch, ["train", *common, "--workdir", wd1,
                                  *P8_TOY_TRAIN], counters)
    with open(os.path.join(wd2, "train.jsonl")) as fh:
        rows2 = [json.loads(line) for line in fh]
    with open(os.path.join(wd1, "train.jsonl")) as fh:
        rows1 = [json.loads(line) for line in fh]
    ckpts = sorted(os.listdir(os.path.join(wd2, "ckpts")))
    raw2 = restore_checkpoint(latest_checkpoint(os.path.join(wd2, "ckpts")))
    raw1 = restore_checkpoint(latest_checkpoint(os.path.join(wd1, "ckpts")))
    dp = max(float(abs(a - b).max()) for side in ("g_vars", "d_vars")
             for a, b in zip(leaves(raw1[side]["params"]),
                             leaves(raw2[side]["params"])))
    dl = max(abs(r1[k] - r2[k]) for r1, r2 in zip(rows1, rows2)
             for k in LOSS_KEYS if k in r1)
    print(f"   train --mesh (2 processes, gloo): {s2:.1f} s; results "
          f"printed {len(results)} (rank 0), checkpoints {ckpts}, "
          f"{len(rows2)} log rows; one process {s1:.1f} s: max |dloss| "
          f"{dl:.3e}, max |dparam| {dp:.3e}")
    if (len(results) != 1 or results[0]["trained_steps"] != 3
            or len(rows2) != len(rows1) or ckpts != [
                "ckpt_00000003.msgpack", "config.json"]):
        raise AssertionError("train --mesh did not write one checkpoint and "
                             "one log from rank 0")
    if not (dl <= P8_LOSS_ATOL and dp <= P8_PARAM_ATOL):
        raise AssertionError(f"train --mesh: losses {dl}, params {dp} off "
                             "the one-process run")
    ranks, s2 = run_ranks("toy2d", wd2)
    m2 = ranks[0]["result"]
    m1, s1, _ = run_cli(torch, ["collab", *common, "--workdir", wd2,
                                *P8_TOY_TRAIN], counters)
    print(f"   collab --mesh: {s2:.1f} s, {m2}; one process ({s1:.1f} s): "
          f"{m1}")
    total = dict.fromkeys(counters, 0)
    for r in ranks:
        print(f"   rank {r['rank']} of {r['world']} ({r['backend']}): cli "
              f"exited {r['rc']}, launches {r['launches']}")
        if r["rc"] != 0 or r["backend"] != "gloo":
            raise AssertionError(f"rank {r['rank']}: cli collab --mesh "
                                 f"exited {r['rc']} over {r['backend']}")
        check_rank_launches(r, r["launches"], r["want"],
                            ("refine_mlp", "drs_accept"))
        for k in total:
            total[k] += r["launches"][k]
    if m1["accept_rate"] != m2["accept_rate"] or not all(
            abs(m1[k] - m2[k]) <= 1e-4 for k in ("pct_hq", "kl")):
        raise AssertionError("collab --mesh differs from one process")
    return total


def leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def compat_parallel_phase(torch, dev, trained):
    """Phase 8. Returns the kernels' launches and the phase's seconds."""
    counters = p8_counters()
    shutil.rmtree(P8_DIR, ignore_errors=True)
    t_phase = time.perf_counter()

    def at():
        return f" [{time.perf_counter() - t_phase:.1f} s into 8]"

    phase("8: TF1 round trip of the trained mnist and toy2d states "
          "(state_to_tf1 -> tf1_to_checkpoint -> load_or_train -> collab)"
          + at())
    total = tf1_roundtrip(torch, dev, trained, counters)

    phase("8: world size 1 over NCCL in a child process (mnist, 10 train "
          "iterations and 4 collab rounds, with the group and without)"
          + at())
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import json, sys; sys.path.insert(0, "
         f"{REPO!r}); import chip_smoke as cs; print(json.dumps("
         "cs.ws1_child()))"], capture_output=True, text=True, cwd=REPO,
        timeout=600)
    if child.returncode != 0:
        raise AssertionError(f"the NCCL child failed:\n{child.stderr[-4000:]}")
    ws1 = json.loads(child.stdout.strip().splitlines()[-1])
    print(f"   {time.perf_counter() - t0:.1f} s; train with the group "
          f"differs in {ws1['train_differs_in'] or 'nothing'}; collab "
          f"{tuple(ws1['shape'])} equal bit for bit: {ws1['collab_equal']}; "
          f"launches {ws1['launches']}")
    if ws1["train_differs_in"] or not ws1["collab_equal"]:
        raise AssertionError("world size 1 over NCCL differs from no group")
    want = tuple(ws1["want"])
    if (ws1["launches"]["conv_refine28_bf16"],
            ws1["launches"]["drs_accept"]) != want:
        raise AssertionError(f"NCCL child launches {ws1['launches']}, "
                             f"want {want}")
    for k in total:
        total[k] += ws1["launches"][k]

    phase("8: world size 2 over gloo on the one card (torchrun): toy2d "
          "train --mesh and collab --mesh through the CLI" + at())
    for k, n in ws2_toy2d(torch, counters).items():
        total[k] += n

    phase("8: world size 2 over gloo: mnist collab "
          f"({', '.join(P8_WS2_MNIST)}) on the imported state, bf16 and "
          "f32" + at())
    ranks, seconds = run_ranks("mnist", os.path.join(P8_DIR, "tf1_mnist"))
    for r in ranks:
        sh, f = r["shaped"], r["f32"]
        adam = 4 * r["shaping_lr"] * r["steps"]  # Adam's movement, both runs
        print(f"   rank {r['rank']} of {r['world']} ({r['backend']}): round "
              f"0 equal to one process bit for bit: {r['round0_equal']}; "
              f"all rounds: max |dx| {r['max_dx']:.3e}, masks equal "
              f"{r['masks_equal']}; launches {r['launches']}; G on half "
              f"the batch equal to the whole batch's rows: "
              f"{r['g_half_equal']}, the refine kernel: "
              f"{r['kernel_half_equal']}")
        print(f"     bf16 shaped D after {r['steps']} step(s), group "
              f"against one process: params {sh['params']:.3e}, BN-fed "
              f"biases {sh['bn_fed']:.3e} (Adam's bound {adam:.1e}), BN "
              f"statistics {sh['stats']:.3e}, train-mode outputs in f32 "
              f"{sh['train_f32']:.3e}; eval logits {sh['eval_logits']:.3e}, "
              f"{sh['eval_swapped']:.3e} with the one-process BN-fed "
              f"biases; one step's summed gradients {sh['grad']:.3e} of "
              "the largest")
        print(f"     f32 (kernel #3, separation test on): G on half the "
              f"batch against the whole batch's rows {f['g_half']:.3e}, "
              f"kernel #3 on the same rows equal: {f['kernel_half_equal']}, "
              f"on G's half-batch rows {f['refined_g_half']:.3e}; round 0 "
              f"{f['round0']:.3e}, masks equal {f['round0_masks_equal']}; "
              f"all rounds {f['samples']:.3e}, masks equal "
              f"{f['masks_equal']}, "
              f"shaping loss {f['loss']:.3e}, steps {f['steps']}; shaped "
              f"D: params {f['params']:.3e}, BN-fed biases "
              f"{f['bn_fed']:.3e}, BN statistics {f['stats']:.3e}, "
              f"train-mode outputs {f['train_f32']:.3e}; eval logits "
              f"{f['eval_logits']:.3e} ({f['eval_swapped']:.3e} with the "
              f"one-process BN-fed biases); one step's summed gradients "
              f"{f['grad']:.3e} of the largest; launches {f['launches']}")
        if r["backend"] != "gloo" or not r["round0_equal"]:
            raise AssertionError(f"rank {r['rank']}: round 0 differs from "
                                 f"one process ({r['backend']})")
        # A gradient that is zero but for rounding (the BN-fed biases; at
        # full width, now and then another parameter) is scaled by Adam's
        # first step to +-lr, in either dtype: the shaped Ds' parameters are
        # held to Adam's bound, the data-parallel arithmetic (the summed
        # gradients through the group's BN moments) by the gradients in
        # f32, the BN statistics and the loss by the CPU tests' bounds
        # (JAX test_parallel.py's). Round 0 parts in f32 where G does
        # (cuDNN's algorithm for half the batch); its masks are held.
        if (max(sh["bn_fed"], sh["params"]) > adam
                or sh["stats"] > P8_PARAM_ATOL):
            raise AssertionError(f"rank {r['rank']}: bf16 shaped D beyond "
                                 "Adam's movement")
        if not (f["round0_masks_equal"] and f["loss"] <= P8_LOSS_ATOL
                and f["grad"] <= P8_GRAD_RTOL
                and max(f["params"], f["bn_fed"]) <= adam
                and f["stats"] <= P8_PARAM_ATOL
                and f["steps"][0] == f["steps"][1] == r["steps"]):
            raise AssertionError(f"rank {r['rank']}: f32 collab with the "
                                 f"group off one process: {f}")
        check_rank_launches(r, r["launches"], r["want"],
                            ("conv_refine28_bf16", "drs_accept"))
        check_rank_launches(r, f["launches"], f["want"],
                            ("conv_refine28", "drs_accept"))
        for k in total:
            total[k] += r["launches"][k] + f["launches"][k]
    differ = {side: sorted(k for k in ranks[0][side]
                           if len({r[side][k] for r in ranks}) > 1)
              for side in ("group", "one")}
    print(f"   the ranks' gathered samples and shaped Ds (bf16, f32) differ "
          f"in: {differ['group'] or 'nothing'}; their one-process runs in: "
          f"{differ['one'] or 'nothing'}; torchrun: {seconds:.1f} s")
    if differ["group"]:
        raise AssertionError(f"the ranks hold different {differ['group']}")
    shutil.rmtree(P8_DIR)
    seconds = time.perf_counter() - t_phase
    print(f"   phase 8: {seconds:.1f} s; launches {total}")
    return total, seconds


# Phase 9: the repo's own entry points, after 8 and before 6x, in a workdir
# under runs/smoke_entry (gitignored; removed at the end). bench_torch's
# measurement in this process at bench.py's batches and protocol (K = 10, 20
# rounds a call, one warm-up and 3 timed calls), one more mnist call
# profiled, ``python3 bench_torch.py --secondary none`` in a child, and the
# example scripts of examples_torch/ in children, all at once.
BENCH_PRESETS = (("mnist", BENCH_BATCH), ("celeba", 512),
                 ("imagenet64", 512))
BENCH_ROUNDS, BENCH_REPEATS = 20, 3
EXAMPLES_ON_CARD = ("custom_data", "shaped_d_reuse", "export_serving",
                    "inception_fid")
# The examples that need a package the card's machine may lack.
EXAMPLES_NEED = {"quickstart_2d": "matplotlib", "migrate_tf1": "tensorflow"}
ENTRY_DIR = os.path.join(REPO, "runs", "smoke_entry")


def bench_measurements(torch, dev, counters):
    """bench_torch.measure_refine_throughput for each of BENCH_PRESETS with
    the counters set to 0 just before: kernel #4 once a round on mnist
    (rounds x (1 + repeats)), no refine or accept kernel on the others
    (autograd refinement, no accept step). Returns {preset: result} and
    the launches summed."""
    import bench_torch

    out, total = {}, {k: 0 for k in counters}
    for preset, batch in BENCH_PRESETS:
        res, seconds, launches = counted(
            torch, lambda: bench_torch.measure_refine_throughput(
                batch, STEPS, BENCH_ROUNDS, BENCH_REPEATS, preset, dev),
            counters)
        per_call = BENCH_ROUNDS if preset == "mnist" else 0
        want = {"conv_refine28_bf16": per_call * (1 + BENCH_REPEATS),
                "conv_refine28": 0, "drs_accept": 0}
        print(f"   {preset} B={batch} K={STEPS}: {res['samples_per_sec']:.1f} "
              f"refined samples/s (best of {BENCH_REPEATS}), "
              f"{1e3 * res['sec_per_batch']:.3f} ms a round, mfu_pct "
              f"{res['mfu_pct']}; the call {seconds:.1f} s; launches "
              f"{launches}")
        if launches != want:
            raise AssertionError(f"bench {preset}: launches {launches}, want "
                                 f"{want}")
        if not (res["samples_per_sec"] > 0 and res["mfu_pct"] is not None
                and 0 < res["mfu_pct"] < 100):
            raise AssertionError(f"bench {preset}: {res}")
        out[preset] = res
        for k, n in launches.items():
            total[k] += n
    return out, total


def bench_profile(torch, dev):
    """One more mnist call of bench_torch (B = 2,048, 20 rounds), untimed
    and profiled: host launches a round, device busy share of the wall,
    kernel #4's device time per launch."""
    import bench_torch

    from collaborative_gan_sampling_torch.ops.conv_refine import (
        refine_flops_per_sample,
    )

    batch = BENCH_PRESETS[0][1]
    run, _, _ = bench_torch.make_run(batch, STEPS, BENCH_ROUNDS, "mnist", dev)
    run(1)
    torch.cuda.synchronize()
    wall, kernels, averages = profiled(torch, lambda: run(7))
    busy = sum(ms for ms, _ in kernels.values())
    k4 = [(ms, n) for k, (ms, n) in kernels.items()
          if "refine_bf16_kernel" in k]
    launches = sum(n for _, n in k4)
    if not 0 < launches <= BENCH_ROUNDS:
        raise AssertionError(f"profiler saw {launches} launches of kernel #4 "
                             f"in {BENCH_ROUNDS} rounds")
    out = {"launches_per_round": host_launches(averages) / BENCH_ROUNDS,
           "busy": busy / (wall * 1e3),
           "k4_ms": sum(ms for ms, _ in k4) / launches,
           "k4_share": sum(ms for ms, _ in k4) / busy,
           # As phase 7 bounds it: in-range taps at the bf16 peak.
           "k4_bound_ms": (refine_flops_per_sample(STEPS) * batch
                           / PEAK_BF16_FLOPS * 1e3)}
    print_profile(f"bench_torch mnist, B={batch}, {BENCH_ROUNDS} rounds",
                  wall, kernels, averages)
    print(f"   {out['launches_per_round']:.1f} host launches a round, device "
          f"busy {100 * out['busy']:.1f}% of the wall; kernel #4 "
          f"{out['k4_ms']:.4f} ms on the device per launch at B={batch} "
          f"({100 * out['k4_share']:.1f}% of the device time; bound "
          f"{out['k4_bound_ms']:.4f} ms by operations, "
          f"{100 * out['k4_bound_ms'] / out['k4_ms']:.1f}% of it)")
    return out


def bench_child(card: str) -> dict:
    """``python3 bench_torch.py --secondary none`` from the repo root: rc 0
    and a last line with bench.py's keys, the card named, vs_baseline
    null."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "bench_torch.py", "--secondary",
                           "none"], capture_output=True, text=True, cwd=REPO,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"   bench_torch.py --secondary none ({time.perf_counter() - t0:.1f}"
          f" s): {json.dumps(line)}")
    keys = {"metric", "value", "unit", "vs_baseline", "mfu_pct", "device"}
    if not (keys <= set(line) and line["value"] > 0
            and line["vs_baseline"] is None and line["device"] == card
            and line["metric"] == "refined_samples_per_sec_per_chip_k10_"
                                  "mnist"):
        raise AssertionError(f"bench_torch.py's line: {line}")
    return line


def examples_children() -> dict:
    """The example scripts that this machine's packages allow, each in a
    child with ``--device cuda`` and NITERS=50, all started at once, in
    ENTRY_DIR (their relative ``runs/`` lands there); a child that exits
    non-zero fails the phase. The others are named with the package they
    lack. Returns {script: seconds}."""
    import importlib.util

    for script, lib in EXAMPLES_NEED.items():
        have = importlib.util.find_spec(lib) is not None
        print(f"   {script}.py: {lib} is "
              + ("installed here, but " if have else "not installed here: ")
              + "not run on this machine")
    os.makedirs(ENTRY_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for script in EXAMPLES_ON_CARD:  # output to files: no pipe fills up
        log = os.path.join(ENTRY_DIR, f"{script}.log")
        with open(log, "w") as fh:
            procs[script] = (log, subprocess.Popen(
                [sys.executable,
                 os.path.join(REPO, "examples_torch", f"{script}.py"),
                 "--device", "cuda"], cwd=ENTRY_DIR,
                env=dict(os.environ, PYTHONPATH=REPO, NITERS="50"),
                stdout=fh, stderr=subprocess.STDOUT))
    seconds, failed = {}, []
    for script, (log, proc) in procs.items():
        rc = proc.wait(timeout=600)
        seconds[script] = time.perf_counter() - t0
        with open(log) as fh:
            text = fh.read()
        tail = text.strip().splitlines()[-1:] or [""]
        print(f"   {script}.py: rc {rc}, done {seconds[script]:.1f} s after "
              f"the start; {tail[0][:200]}")
        if rc != 0:
            failed.append(f"{script}.py (rc {rc}):\n{text[-3000:]}")
    if failed:
        raise AssertionError("example scripts failed: " + "\n".join(failed))
    return seconds


def entry_points_phase(torch, dev, card):
    """Phase 9. Returns the kernels' launches in the in-process bench runs
    and the phase's numbers."""
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    t_phase = time.perf_counter()

    def at():
        return f" [{time.perf_counter() - t_phase:.1f} s into 9]"

    phase("9: bench_torch.measure_refine_throughput in this process "
          "(mnist 2,048, celeba and imagenet64 512, K = 10)" + at())
    out, launches = bench_measurements(torch, dev, conv_counters())
    phase("9: one more mnist bench call, profiled" + at())
    out["profile"] = bench_profile(torch, dev)
    phase("9: python3 bench_torch.py --secondary none in a child" + at())
    out["child"] = bench_child(card)
    phase("9: examples_torch/ in child processes (--device cuda, "
          "NITERS=50)" + at())
    out["examples"] = examples_children()
    shutil.rmtree(ENTRY_DIR)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"   phase 9: {out['seconds']:.1f} s; launches {launches}")
    return launches, out


def serving_phase(torch, dev, toy, mnist):
    """``ServingSampler(..., "collab").generate`` on each preset under its
    shaped D, with the launch counters of the kernels it must reach."""
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        fused_refine_mlp,
    )
    from collaborative_gan_sampling_torch.sampling.serve import (
        ServingSampler,
    )

    counters = {"refine_mlp": fused_refine_mlp, **conv_counters()}
    cases = (("toy2d", toy, 100_000, torch.float32,
              ("refine_mlp", "drs_accept")),
             ("mnist", mnist, 4_096, torch.uint8,
              ("conv_refine28_bf16", "drs_accept")))
    phase("serving: ServingSampler(collab).generate under the shaped D")
    for name, (bundle, g, d), n, dtype, kernels in cases:
        srv = ServingSampler(bundle, get_preset(name).refine, "collab")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        samples, labels, stats = srv.generate(
            g, d, torch.Generator(device=dev).manual_seed(5), n=n)
        wall = time.perf_counter() - t0
        launches = {k: counters[k].launches for k in kernels}
        print(f"   {name}: {tuple(samples.shape)} {samples.dtype}, "
              f"{wall * 1e3:.1f} ms wall, {n / wall:.1f} accepted samples/s "
              f"over the whole call (calibration and first round included),"
              f" accept rate {stats['accept_rate']:.4f}, launches "
              f"{launches}")
        print(f"   {name} stats {json.dumps(stats)}")
        if (tuple(samples.shape) != (n, *bundle.data_shape)
                or samples.dtype != dtype or labels is not None):
            raise AssertionError(f"{name} serving returned "
                                 f"{tuple(samples.shape)} {samples.dtype}")
        if dtype == torch.float32 and not bool(torch.isfinite(samples).all()):
            raise AssertionError(f"{name} serving returned non-finite "
                                 "samples")
        if not 0.0 < stats["accept_rate"] < 1.0:
            raise AssertionError(f"{name} serving accept rate "
                                 f"{stats['accept_rate']}")
        for k, count in launches.items():
            if count <= 0:
                raise AssertionError(f"kernel {k} was not launched while "
                                     f"serving {name}")
        if name == "toy2d":
            print_profile("toy2d serving, n = 20,000", *profiled(
                torch, lambda: srv.generate(
                    g, d, torch.Generator(device=dev).manual_seed(6),
                    n=20_000)))


# Phase 6x: the serving export. The mnist bf16 and toy2d collab serving
# rounds (batch 256, the presets' 40 batches, under the shaped Ds of phases 4
# and 5) exported on the card and reloaded in one child process that imports
# no model code (EXPORT_CHILD); the figures' device work and the TensorBoard
# mirror through a short toy2d run.
X_DIR = os.path.join(TRAIN_DIR, "smoke_export")
X_SEEDS = (0, 1)  # compared bit for bit, live against reloaded
X_TIMED = 3  # warm rounds timed, live and reloaded
# The refinement field on the card against the CPU: float32 forward and
# backward of the 3 x 128 MLP D, sums in another order. Logits at 1e-5;
# -grad at 1e-5 of the field's largest value: an element's own relative
# error means nothing where the field crosses 0 (4.4e-4 on random weights,
# over elements of at least 1e-6 of the largest, on one H100).
X_LOGIT_ATOL, X_FIELD_RTOL = 1e-5, 1e-5
X_VIZ_ITERS, X_VIZ_EVERY = 20, 10
X_FORBIDDEN = ("models", "sampling.serve", "sampling.refine",
               "sampling.collab", "training", "pipeline", "data")


def digest(t) -> str | None:
    """sha256 of a tensor's bytes (None for None)."""
    import hashlib

    import torch

    if t is None:
        return None
    raw = t.detach().contiguous().reshape(-1).cpu().view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def round_wall(torch, fn, reps: int = X_TIMED) -> float:
    """Mean wall seconds of ``reps`` warm calls of fn, each synchronized."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def export_child(paths: list[str]) -> dict:
    """The child's side of phase 6x: load each artifact with
    ``load_sampler`` alone, run it on ``X_SEEDS`` (digests and the launch
    counters of its cgs:: ops), time warm rounds, and count its kernels in a
    profile of one round; then check that no model code was imported."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from collaborative_gan_sampling_torch.ops import (
        accept,
        conv_refine,
        refine_mlp,
    )
    from collaborative_gan_sampling_torch.sampling.export import (
        load_sampler,
    )

    counters = {"conv_refine28_bf16": conv_refine.fused_refine_conv28_bf16,
                "conv_refine28": conv_refine.fused_refine_conv28,
                "refine_mlp": refine_mlp.fused_refine_mlp,
                "drs_accept": accept.drs_accept_mask_philox}
    out = {}
    for path in paths:
        t0 = time.perf_counter()
        fn, meta = load_sampler(path)
        load_s = time.perf_counter() - t0
        for c in counters.values():
            c.launches = 0
        digests = {s: [digest(t) for t in fn(s)] for s in X_SEEDS}
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        wall = round_wall(torch, lambda: fn(2))
        _, kernels, _ = profiled(torch, lambda: fn(3))
        out[path] = {"load_s": load_s, "digests": digests,
                     "launches": launches, "round_s": wall,
                     "kernels": {k: n for k, (_, n) in kernels.items()},
                     "meta": meta}
    pkg = "collaborative_gan_sampling_torch."
    bad = [m for m in sys.modules
           if m.startswith(tuple(pkg + f for f in X_FORBIDDEN))]
    if bad:
        raise AssertionError(f"load_sampler imported model code: {bad}")
    return out


def profiled_count(kernels: dict, name: str) -> int:
    """Launches the child's profile saw of kernel ``name`` (by its CUDA
    function's name; refine_kernel is not a part of refine_bf16_kernel)."""
    return sum(n for k, n in kernels.items()
               if f"{name}(" in k or f"{name}<" in k or k == name)


def export_phase(torch, dev, card, toy, mnist):
    """Export, reload in a child process, compare bit for bit, count the
    artifact's launches; the toy2d refinement field on the card against
    the CPU; a short toy2d run with ``viz_every`` and ``tensorboard``.
    Returns the kernels' launches in the phase (parent and child) and the
    phase's numbers."""
    import copy
    import importlib.util

    from collaborative_gan_sampling_torch.config import (
        apply_overrides,
        get_preset,
    )
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        fused_refine_mlp,
    )
    from collaborative_gan_sampling_torch.pipeline import Experiment
    from collaborative_gan_sampling_torch.sampling.export import (
        export_sampler,
    )
    from collaborative_gan_sampling_torch.sampling.serve import (
        ServingSampler,
    )
    from collaborative_gan_sampling_torch.viz.plots import _grid_fields

    t_phase = time.perf_counter()
    phase("export and figures: the serving round as a torch.export "
          "artifact, reloaded without model code")
    counters = {"refine_mlp": fused_refine_mlp, **conv_counters()}
    total = {k: 0 for k in counters}
    shutil.rmtree(X_DIR, ignore_errors=True)
    os.makedirs(X_DIR)
    cases = {"mnist": (mnist, {"conv_refine28_bf16": "refine_bf16_kernel",
                               "drs_accept": "drs_step_kernel"}),
             "toy2d": (toy, {"refine_mlp": "refine_kernel",
                             "drs_accept": "drs_step_kernel"})}
    live, paths, out = {}, {}, {}
    for name, ((bundle, g, d), kernels) in cases.items():
        rcfg = get_preset(name).refine
        if rcfg.batch_size != BATCH:
            raise AssertionError(f"{name} serves batches of "
                                 f"{rcfg.batch_size}, not {BATCH}")
        srv = ServingSampler(bundle, rcfg, "collab")
        paths[name] = os.path.join(X_DIR, f"{name}.pt2")
        meta, seconds, launches = counted(torch, lambda: export_sampler(
            srv, g, d, torch.Generator(device=dev).manual_seed(7),
            paths[name]), counters)
        need_launches(launches, tuple(kernels), f"{name} export")
        m = srv.calibrate(g, d, torch.Generator(device=dev).manual_seed(7))
        live[name] = {s: [digest(t) for t in srv.round_seeded(
            g, d, m, torch.tensor([s], device=dev))] for s in X_SEEDS}
        wall = round_wall(torch, lambda: srv.round_seeded(
            g, d, m, torch.tensor([2], device=dev)))
        total = {k: total[k] + launches[k] for k in total}
        out[name] = {"export_s": seconds, "bytes": meta["bytes"],
                     "live_round_s": wall, "meta": meta,
                     "candidates": rcfg.num_batches * rcfg.batch_size}

    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import json, sys; sys.path.insert(0, "
         f"{REPO!r}); import chip_smoke as cs; print(json.dumps("
         "cs.export_child(sys.argv[1:])))", *paths.values()],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the export child failed:\n{child.stderr}")
    reloaded = json.loads(child.stdout.strip().splitlines()[-1])
    print(f"   child process: {child_s:.1f} s (start, load, "
          f"{len(X_SEEDS)} + {X_TIMED + 2} rounds per artifact)")
    for name, ((bundle, _, _), kernels) in cases.items():
        r, o = reloaded[paths[name]], out[name]
        nb = o["meta"]["num_batches"]
        got = {int(s): v for s, v in r["digests"].items()}
        same = got == live[name]
        counts = {k: r["launches"][k] for k in kernels}
        seen = {k: profiled_count(r["kernels"], kn)
                for k, kn in kernels.items()}
        print(f"   {name} ({card}): export {o['export_s']:.2f} s, "
              f"{o['bytes']} bytes, load {r['load_s']:.2f} s; a round of "
              f"{o['candidates']} candidates {1e3 * o['live_round_s']:.2f} "
              f"ms live, {1e3 * r['round_s']:.2f} ms reloaded; seeds "
              f"{X_SEEDS} bit for bit {same}; the artifact's launches "
              f"{counts} (counters, {len(X_SEEDS)} rounds), profiled "
              f"{seen} (one round)")
        if not same:
            raise AssertionError(f"{name}: the reloaded artifact differs "
                                 f"from the live seeded round: {got} "
                                 f"against {live[name]}")
        for k in kernels:
            if counts[k] != nb * len(X_SEEDS):
                raise AssertionError(f"{name} artifact launched {k} "
                                     f"{counts[k]} times, not "
                                     f"{nb * len(X_SEEDS)}")
            # The profiler may drop a launch's record; never adds one.
            if not nb - 1 <= seen[k] <= nb:
                raise AssertionError(f"{name} artifact's profile shows "
                                     f"{seen[k]} launches of {k}, not {nb}")
        for k, n in r["launches"].items():
            total[k] += n
        o.update(reloaded_round_s=r["round_s"], load_s=r["load_s"])

    # The overview's arrays: D's logits and -grad on the grid, on the card
    # and on the CPU.
    bundle, _, d = toy
    cpu_bundle = make_bundle(bundle.cfg, "cpu")
    got = _grid_fields(bundle, d, 3.0)
    want = _grid_fields(cpu_bundle, copy.deepcopy(d).cpu(), 3.0)
    e_logit = float(abs(got[2] - want[2]).max())
    scale = float(abs(want[3]).max())
    e_field = float(abs(got[3] - want[3]).max()) / scale
    print(f"   toy2d _grid_fields (40 x 40) on the card against the CPU: "
          f"max |dlogit| {e_logit:.3e}, max |dfield| {e_field:.3e} of the "
          f"field's largest |value| {scale:.4e}")
    if e_logit > X_LOGIT_ATOL or e_field > X_FIELD_RTOL:
        raise AssertionError("the refinement field on the card disagrees "
                             "with the CPU's")

    have = {lib: importlib.util.find_spec(lib) is not None
            for lib in ("matplotlib", "tensorboard")}
    print("   " + "; ".join(
        f"{lib} is installed here" if ok else
        f"{lib} is not installed here: its "
        + ("drawing" if lib == "matplotlib" else "event writing")
        + " is not run (held against JAX's on the CPU by the tests)"
        for lib, ok in have.items()))
    workdir = os.path.join(X_DIR, "viz")
    cfg = apply_overrides(get_preset("toy2d"), [
        f"train.steps_per_call={X_VIZ_EVERY}", "train.ckpt_every=0",
        f"train.viz_every={X_VIZ_EVERY if have['matplotlib'] else 0}",
        f"train.tensorboard={str(have['tensorboard']).lower()}"]).replace(
        workdir=workdir)
    exp = Experiment(cfg, echo_metrics=False)
    t0 = time.perf_counter()
    state = exp.train(niters=X_VIZ_ITERS)
    torch.cuda.synchronize()
    viz_s = time.perf_counter() - t0
    files = sorted(os.listdir(workdir))
    pngs = [f for f in files if f.endswith(".png")]
    tb = sorted(os.listdir(os.path.join(workdir, "tb"))) \
        if have["tensorboard"] else []
    if not have["matplotlib"]:  # the figure's device work all the same
        exp.bundle.generate(state.g, exp.bundle.sample_z(
            torch.Generator(device=dev).manual_seed(0), 64))
        _grid_fields(exp.bundle, state.d, 3.0)
    print(f"   toy2d train {X_VIZ_ITERS} iterations (viz_every "
          f"{X_VIZ_EVERY}): {viz_s:.2f} s; figures {pngs}; TensorBoard "
          f"event files {len(tb)}")
    want_png = ([f"viz_{s:08d}.png" for s in range(X_VIZ_EVERY,
                                                   X_VIZ_ITERS + 1,
                                                   X_VIZ_EVERY)]
                if have["matplotlib"] else [])
    if state.step != X_VIZ_ITERS or pngs != want_png or (
            have["tensorboard"] and not tb):
        raise AssertionError(f"the toy2d viz run wrote {files}")
    shutil.rmtree(X_DIR)
    out["seconds"] = time.perf_counter() - t_phase
    out["child_s"] = child_s
    print(f"   phase 6x: {out['seconds']:.1f} s; launches {total}")
    return total, out


def timing(torch, dev):
    from collaborative_gan_sampling_torch.ops import accept as A
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
        fused_refine_conv28_bf16,
        refine_flops_per_sample,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
        refine_conv28_plain,
        refine_conv28_plain_bf16,
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
    # The bf16 kernel reads w0 and w1 as bf16 (half of their f32 bytes
    # above); its bound at the bf16 peak.
    wbytes = 2 * (params.w0.numel() + params.w1.numel())
    out["conv_refine28_bf16"] = dict(
        ms=time_ms(lambda: fused_refine_conv28_bf16(params, x0, STEPS,
                                                    RATE)),
        plain_ms=time_ms(lambda: refine_conv28_plain_bf16(params, x0, STEPS,
                                                          RATE)),
        flops=flops, bytes=nbytes - wbytes,
        peak=PEAK_BF16_FLOPS)
    # Each conv kernel's own device time per launch; the events above also
    # count the wrapper's casts and packing between back-to-back calls.
    for name, fn, kernel in (
            ("conv_refine28", fused_refine_conv28, "refine_kernel"),
            ("conv_refine28_bf16", fused_refine_conv28_bf16,
             "refine_bf16_kernel")):
        out[name]["device"] = device_ms_per_launch(
            torch, lambda: fn(params, x0, STEPS, RATE), kernel)

    logits = torch.randn(BATCH, device=dev, generator=gen)
    m = logits.max()
    seed = A.draw_seed(gen, dev)
    u = torch.rand(BATCH, device=dev, generator=gen)
    # The main paths' step (percentile 80) and the step without it. Per
    # element: the float math of _accept_math (~20 operations) and of the
    # shift (~10); the Philox rounds and the sort's compare-exchanges are
    # integer and compare work, which the f32 table does not cover. Bytes:
    # the logits (and u) read, the mask written, the scalars.
    for name, pct, entry, plain, arg, extra in (
            ("drs_accept", 80.0, A.drs_accept_mask_philox,
             A.drs_accept_mask_philox_plain, seed, 8),
            ("drs_accept no percentile", 0.0, A.drs_accept_mask_philox,
             A.drs_accept_mask_philox_plain, seed, 8),
            ("drs_accept_from_uniform", 80.0, A.drs_accept_mask_from_uniform,
             A.drs_accept_mask_from_uniform_plain, u, 4 * BATCH)):
        def call(entry=entry, arg=arg, pct=pct):
            return entry(arg, logits, m, 0.0, 1e-6, pct)

        out[name] = dict(
            ms=time_ms(call, iters=200),
            plain_ms=time_ms(lambda plain=plain, arg=arg, pct=pct: plain(
                arg, logits, m, 0.0, 1e-6, pct), iters=200),
            # Back-to-back calls of this short kernel time the host; the
            # profiler gives the kernel's own device time.
            device=device_ms_per_launch(torch, call, "drs_step_kernel"),
            flops=(30 if pct else 20) * BATCH,
            bytes=4 * BATCH + BATCH + extra + 4 + 4)

    from collaborative_gan_sampling_torch.ops.refine_mlp import (
        TILES,
        _launch,
        _sms,
        fused_refine_mlp,
        launch_plan,
        mlp_layers,
        mlp_params_from_d,
        refine_flops_per_sample as mlp_flops_per_sample,
        refine_mlp_plain,
    )

    d_mlp, gen = mlp_d(torch, dev)
    layers, params = mlp_layers(d_mlp), mlp_params_from_d(d_mlp)
    sms = _sms(torch.cuda.current_device())
    for n in (BATCH, 65536):
        x0 = torch.randn(n, 2, device=dev, generator=gen) * 2.0
        # The kernel's own device time per launch, apart from the
        # wrapper's host work (which bounds back-to-back calls at small B).
        device = device_ms_per_launch(torch, lambda: fused_refine_mlp(
            layers, x0, MLP_STEPS, MLP_RATE), "refine_kernel")
        # Both tiles, for the plan's choice.
        by_tile = {t: device_ms_per_launch(torch, lambda t=t: _launch(
            layers, x0, MLP_STEPS, MLP_RATE,
            launch_plan(n, 2, 128, 3, sms, tile=t)), "refine_kernel")
            for t in TILES}
        print(f"   refine_mlp B={n}: wrapper's tile "
              f"{launch_plan(n, 2, 128, 3, sms).tile}; device ms per "
              "launch by tile " + ", ".join(
                  f"{t}: {ms:.4f}" for t, ms in by_tile.items()))
        name = "refine_mlp" if n == BATCH else f"refine_mlp B={n}"
        out[name] = dict(
            ms=time_ms(lambda: fused_refine_mlp(layers, x0, MLP_STEPS,
                                                MLP_RATE)),
            device=device,
            plain_ms=time_ms(lambda: refine_mlp_plain(params, x0, MLP_STEPS,
                                                      MLP_RATE)),
            flops=mlp_flops_per_sample(MLP_STEPS, 2, 128, 3) * n,
            bytes=4 * (2 * x0.numel() + n
                       + sum(w.numel() + b.numel() for w, b in params)))
    for row in out.values():
        t_ops = row["flops"] / row.pop("peak", PEAK_F32_FLOPS) * 1e3
        t_bytes = row["bytes"] / PEAK_BYTES_PER_S * 1e3
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def main() -> None:
    sys.path.insert(0, REPO)
    card = device_phase()
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build_phase()

    phase("kernels against their plain versions")
    err_accept = accept_cases(torch, dev)
    err_refine = refine_cases(torch, dev)
    err_refine_bf16 = bf16_refine_cases(torch, dev)
    err_mlp = mlp_refine_cases(torch, dev)

    launches, samples_per_s, mnist_served = main_path(torch, dev)
    small_reference(torch, dev)
    toy_launches, toy_samples_per_s, toy_served = toy2d_path(torch, dev)
    toy2d_small_reference(torch, dev)
    train_launches, trained = train_phase(torch, dev)
    phase(f"launches of one DRS step (sampling/rejection.py, B = {BATCH})")
    for pct, (host, kern, ms, ev, waits) in accept_call_launches(
            torch, dev).items():
        print(f"   percentile {pct:g}: {host:g} host launches, {kern:g} "
              f"device kernels, {ms:.4f} device ms, {ev:.4f} ms by events "
              f"per call; host waits in 5 calls: {waits}")
        if not (host <= 2 and kern <= 2 and max(host, kern) > 0):
            raise AssertionError("one DRS step takes more than the key's "
                                 "draw and the kernel")
    # Each path ran with its counters set to 0 just before; the accept
    # kernel serves the mnist runs and toy2d, so its row counts all three.
    launches["refine_mlp"] = toy_launches["refine_mlp"]
    launches["drs_accept"] += toy_launches["drs_accept"]
    # The collab runs on trained weights, each counted from 0 likewise.
    for k, n in train_launches.items():
        launches[k] += n
    serving_phase(torch, dev, toy_served, mnist_served)

    phase("timing at the main paths' shapes (CUDA events)")
    times = timing(torch, dev)
    # Phase 5c last: its profile of the conditional path is the largest.
    in64_launches, in64 = imagenet64_phase(torch, dev)
    # Its collab, per-class, serving and z-space runs.
    launches["drs_accept"] += in64_launches
    # Phase 5f after the timing phase too; each of its runs counted from 0.
    files_launches, files = files_tuning_phase(torch, dev, trained)
    for k, n in files_launches.items():
        launches[k] += n
    # Phase 8 after 5f, before 6x; each of its runs counted from 0 (the
    # child processes' counts are theirs).
    p8_launches, p8_seconds = compat_parallel_phase(torch, dev, trained)
    for k, n in p8_launches.items():
        launches[k] += n
    # Phase 9 after 8, before 6x; its bench runs counted from 0 (the child
    # processes' launches are theirs).
    entry_launches, entry = entry_points_phase(torch, dev, card)
    for k, n in entry_launches.items():
        launches[k] += n
    # Phase 6x last: after the export in this process, torch.profiler's
    # later sessions here lost every device record of a kernel (three
    # sessions of 10 launches each on one H100).
    export_launches, exported = export_phase(torch, dev, card, toy_served,
                                             mnist_served)
    for k, n in export_launches.items():
        launches[k] += n
    rows = []
    meta = {
        "conv_refine28": dict(
            source="collaborative_gan_sampling_torch/csrc/conv_refine28.cu",
            replaces="collaborative_gan_sampling_tpu/ops/"
                     "conv_refine_pallas.py:275",
            max_abs_err=err_refine),
        "conv_refine28_bf16": dict(
            source="collaborative_gan_sampling_torch/csrc/"
                   "conv_refine28_bf16.cu",
            replaces="collaborative_gan_sampling_tpu/ops/"
                     "conv_refine_pallas.py:483",
            max_abs_err=err_refine_bf16),
        "drs_accept": dict(
            source="collaborative_gan_sampling_torch/csrc/drs_accept.cu",
            replaces="collaborative_gan_sampling_tpu/ops/accept_pallas.py:83",
            max_abs_err=err_accept),
        "refine_mlp": dict(
            source="collaborative_gan_sampling_torch/csrc/refine_mlp.cu",
            replaces="collaborative_gan_sampling_tpu/ops/refine_pallas.py:109",
            max_abs_err=err_mlp),
    }
    for name, t in times.items():
        device = (f"; {t['device']:.4f} ms on the device" if "device" in t
                  else "")
        print(f"   {name}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.6f} ms by {t['bound_by']}){device}")
    for name, info in meta.items():
        t = times[name]
        rows.append({"name": name, "route": "cuda", "source": info["source"],
                     "replaces": info["replaces"],
                     "launches": launches[name],
                     "max_abs_err": info["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    print(f"   collab main path (mnist): {samples_per_s:.1f} refined "
          "samples/s")
    print(f"   collab main path (toy2d): {toy_samples_per_s:.1f} refined "
          "samples/s")
    for name in ("mnist", "toy2d"):
        ips, warm, per_iter, busy = trained[name]
        print(f"   train ({name}): {ips:.1f} iterations/s over the whole "
              f"call, {warm:.1f} in a warm chunk, {per_iter:.1f} host "
              f"launches per iteration, device busy {100 * busy:.1f}%")
    ev = trained["eval"]
    for name in ("standard", "collab"):
        m = ev[name]
        print(f"   eval ({name}, trained mnist): FID {m['fid']:.4f}, KID "
              f"{m['kid']:.6f} +- {m['kid_std']:.6f}, precision "
              f"{m['precision']:.4f}, recall {m['recall']:.4f}")
    print(f"   eval stages: classifier {ev['train_s']:.2f} s, real stats "
          f"{ev['real_s']:.2f} s, fid_refine {ev['fid_refine_s']:.2f} s, "
          f"Inception over {INCEPTION_SAMPLES} {ev['inception'][1]:.2f} s")
    print(f"   imagenet64 (phase 5c, {in64['seconds']:.1f} s): train "
          f"{in64['train_ips']:.1f} iterations/s over the whole call; collab "
          f"{in64['samples_per_s']:.1f} refined samples/s warm "
          f"({in64['wall_ms']:.1f} ms), {in64['launches_per_round']:.1f} "
          f"host launches a round, device busy {100 * in64['busy']:.1f}% "
          f"of a profiled short run's wall ({100 * in64['busy_warm']:.1f}% "
          "of the same run's warm wall), "
          f"D's conv0 ops {100 * in64['conv0']:.1f}% of the device time; "
          f"intra-FID {in64['intra_fid']['intra_fid']:.4f} over "
          f"{in64['intra_fid']['intra_fid_classes']} classes")
    bench = files["benchmark"]
    print(f"   files, tuning and the benchmark matrix (phase 5f, "
          f"{files['seconds']:.1f} s): cifar10 train "
          f"{files['train_ips'][0]:.1f} iterations/s over the whole call, "
          f"{files['train_ips'][1]} in the last chunk, collab "
          f"{files['collab_sps']:.1f} refined samples/s (the tuned run), "
          "kernel #1 launches by method "
          + ", ".join(f"{m} {r['launches']['drs_accept']}"
                      for m, r in bench.items())
          + f"; launches in the phase {files_launches}")
    print(f"   compat and parallel (phase 8, {p8_seconds:.1f} s): "
          f"launches {p8_launches}")
    prof = entry["profile"]
    print(f"   entry points (phase 9, {entry['seconds']:.1f} s): bench_torch "
          + ", ".join(f"{p} B={b} {entry[p]['samples_per_sec']:.1f} refined "
                      f"samples/s (mfu_pct {entry[p]['mfu_pct']})"
                      for p, b in BENCH_PRESETS)
          + f"; mnist {prof['launches_per_round']:.1f} host launches a "
          f"round, device busy {100 * prof['busy']:.1f}%, kernel #4 "
          f"{prof['k4_ms']:.4f} ms on the device at B={BENCH_BATCH} ({card})")
    for name in ("mnist", "toy2d"):
        x = exported[name]
        print(f"   export ({name} collab serving round, "
              f"{x['candidates']} candidates): {x['export_s']:.2f} s, "
              f"{x['bytes']} bytes; a round {1e3 * x['live_round_s']:.2f} "
              f"ms live, {1e3 * x['reloaded_round_s']:.2f} ms reloaded "
              f"({card})")
    print(f"   whole script: {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:  # phase 8's torchrun ranks
        sys.path.insert(0, REPO)
        mesh_worker(*sys.argv[2:5])
    else:
        main()
