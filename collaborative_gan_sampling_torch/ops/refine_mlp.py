"""Fused K-step refinement under an MLP discriminator: the CUDA kernel's
wrapper, its plain version and its gate.

The kernel (``csrc/refine_mlp.cu``) replaces the TPU kernel
``collaborative_gan_sampling_tpu/ops/refine_pallas.py::fused_refine_mlp``
(body ``_refine_kernel``). K times, with the hand-written input-VJP:

    logit  = head(relu(... relu(x W0 + b0) ...))
    dlogit = -sigmoid(-logit)                  # d softplus(-l) / dl
    da     = dlogit Wout^T; per hidden layer, last first:
    da     = (da * [a_i > 0]) W_i^T
    x     <- x - rate * da

and returns (x_K, logit(x_K)), all in float32. ``refine_mlp_plain`` is the
same arithmetic in tensor ops, without autograd. ``fused_refine_mlp`` takes
the plain version for a tensor on the CPU and launches the kernel for a
tensor on the card; it never falls back from the card to the plain version.
``supports_mlp_refine_kernel`` is the gate that ``sampling/refine.py``
dispatches on.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.ops import _build

# (kernel (in, out), bias (out,)) per layer, the head (h, 1) last.
MLPParams = list[tuple[torch.Tensor, torch.Tensor]]

# Samples per block, as T in the .cu: the fastest tile at the main
# path's B = 256 (PERF.md).
TILE = 4
SMEM_LIMIT = 232_448  # bytes of shared memory one block may opt into (H100)


def mlp_params_from_d(d: torch.nn.Module) -> MLPParams:
    """The D's layers as float32 (kernel (in, out), bias) pairs, the hidden
    layers in numeric order (``fc10`` after ``fc9``), then the head."""
    names = sorted((n for n, _ in d.named_children() if n.startswith("fc")),
                   key=lambda s: int(s[2:]))
    layers = [getattr(d, n) for n in names] + [d.out]
    return [(m.weight.detach().float().t(), m.bias.detach().float())
            for m in layers]


def d_forward_flops(d_in: int, hidden: int, layers: int) -> int:
    """One MLP-D forward per sample, two FLOPs per multiply-add."""
    return 2 * (d_in * hidden + (layers - 1) * hidden * hidden + hidden)


def refine_flops_per_sample(steps: int, d_in: int, hidden: int,
                            layers: int) -> int:
    """K steps (forward + input-VJP, which touches the same weights) plus
    the final forward."""
    return (2 * steps + 1) * d_forward_flops(d_in, hidden, layers)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def packed_size(d_in: int, hidden: int, layers: int) -> int:
    """Floats of the packed weights: W0, b0, each further hidden kernel with
    its rows padded to hidden + 1 and its bias, the head and its bias,
    rounded up to a multiple of 4."""
    per_hidden = hidden * (hidden + 1) + hidden
    return _round4(d_in * hidden + hidden + (layers - 1) * per_hidden
                   + hidden + 1)


def smem_bytes(d_in: int, hidden: int, layers: int) -> int:
    """Dynamic shared memory of one block: the packed weights, x as
    (d, TILE), the activations as (layers, hidden, TILE), the logits."""
    return 4 * (packed_size(d_in, hidden, layers) + _round4(d_in * TILE)
                + layers * hidden * TILE + TILE)


def pack_mlp_params(params: MLPParams) -> torch.Tensor:
    """The kernel's weight layout, one flat float32 tensor (see
    ``packed_size``). A hidden kernel's rows are padded by one float so
    that the input-VJP, which reads a row per thread, hits 32 different
    shared-memory banks across a warp."""
    (w0, b0), *hidden, (wo, bo) = params
    parts = [w0.reshape(-1), b0]
    for w, b in hidden:
        parts += [F.pad(w, (0, 1)).reshape(-1), b]
    parts += [wo.reshape(-1), bo.reshape(-1)]
    n = sum(p.numel() for p in parts)
    parts.append(wo.new_zeros(-n % 4))
    return torch.cat([p.float() for p in parts])


def _forward_plain(params: MLPParams, x: torch.Tensor):
    acts = [x]
    for w, b in params[:-1]:
        acts.append(torch.relu(acts[-1] @ w + b))
    wo, bo = params[-1]
    return (acts[-1] @ wo + bo)[:, 0], acts


def refine_mlp_plain(params: MLPParams, x0: torch.Tensor, steps: int,
                     rate) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in tensor ops: K steps with the hand-written
    input-VJP (relu' = [a > 0], 0 at exactly 0), then the final logits."""
    x = x0.float()
    wo = params[-1][0]
    for _ in range(steps):
        logit, acts = _forward_plain(params, x)
        dlogit = -torch.sigmoid(-logit)
        da = dlogit[:, None] * wo[:, 0][None, :]
        for i in range(len(params) - 2, -1, -1):
            dz = torch.where(acts[i + 1] > 0, da, 0.0)
            da = dz @ params[i][0].t()
        x = x - rate * da
    logit, _ = _forward_plain(params, x)
    return x, logit


def fits_kernel(d_in: int, hidden: int, layers: int) -> bool:
    """Whether the weights and a tile fit one block's shared memory."""
    return layers >= 1 and smem_bytes(d_in, hidden, layers) <= SMEM_LIMIT


def supports_mlp_refine_kernel(bundle, cfg, labels=None,
                               return_trajectory: bool = False) -> bool:
    """Gate: unconditional MLP D whose weights fit the kernel's shared
    memory, plain ``ns`` descent (no clip, noise, stop_score or proximal
    term), x-space, no trajectory, and ``use_pallas`` on. The rate is a
    run-time argument of the kernel, so any rate passes."""
    m = bundle.cfg
    return (m.kind == "mlp" and labels is None and not return_trajectory
            and fits_kernel(m.data_dim, m.d_hidden, m.d_layers)
            and cfg.use_pallas and cfg.clip_norm == 0 and cfg.noise == 0
            and cfg.objective == "ns" and cfg.stop_score == 0
            and cfg.proximal == 0 and cfg.space == "x")


def _lib():
    lib = _build.load("refine_mlp")
    lib.refine_mlp.restype = ctypes.c_int
    lib.refine_mlp.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


def fused_refine_mlp(params: MLPParams, x0: torch.Tensor, steps: int,
                     rate) -> tuple[torch.Tensor, torch.Tensor]:
    """K refinement steps under the MLP D. x0: (B, d) float32.

    Returns (x_K, logits (B,)). ``rate`` is a float or a 0-d tensor, passed
    to the kernel at run time."""
    if x0.device.type == "cpu":
        return refine_mlp_plain(params, x0, steps, rate)
    if x0.device.type != "cuda":
        raise ValueError(f"no MLP refine kernel for device {x0.device}")
    if x0.dtype != torch.float32 or x0.ndim != 2:
        raise ValueError("MLP refine kernel takes (B, d) float32, got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    batch, d_in = x0.shape
    hidden, layers = params[0][0].shape[1], len(params) - 1
    shapes_ok = (params[0][0].shape[0] == d_in
                 and all(tuple(w.shape) == (hidden, hidden)
                         for w, _ in params[1:-1])
                 and tuple(params[-1][0].shape) == (hidden, 1))
    if not shapes_ok:
        raise ValueError("MLP refine kernel takes equal hidden widths and "
                         "a one-unit head")
    smem = smem_bytes(d_in, hidden, layers)
    if layers < 1 or smem > SMEM_LIMIT:
        raise ValueError(f"MLP D of {layers} x {hidden} needs {smem} bytes "
                         f"of shared memory; the block has {SMEM_LIMIT}")
    dev = x0.device
    x0 = x0.contiguous()
    packed = pack_mlp_params([(w.to(dev), b.to(dev)) for w, b in params])
    x_out = torch.empty_like(x0)
    logits = torch.empty(batch, device=dev, dtype=torch.float32)
    lib = _lib()
    err = lib.refine_mlp(_build.ptr(x0), _build.ptr(x_out),
                         _build.ptr(logits), _build.ptr(packed),
                         packed.numel(), batch, d_in, hidden, layers,
                         int(steps), float(rate), smem,
                         _build.stream_of(x0))
    _build.check(lib, err, "refine_mlp")
    fused_refine_mlp.launches += 1
    return x_out, logits


fused_refine_mlp.launches = 0
