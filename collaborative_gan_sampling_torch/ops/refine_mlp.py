"""Fused K-step refinement under an MLP discriminator: the CUDA kernel's
wrapper, its plain version, its launch plan and its gate.

The kernel (``csrc/refine_mlp.cu``) replaces the TPU kernel
``collaborative_gan_sampling_tpu/ops/refine_pallas.py::fused_refine_mlp``
(body ``_refine_kernel``). K times, with the hand-written input-VJP:

    logit  = head(relu(... relu(x W0 + b0) ...))
    dlogit = -sigmoid(-logit)                  # d softplus(-l) / dl
    da     = dlogit Wout^T; per hidden layer, last first:
    da     = (da * [a_i > 0]) W_i^T
    x     <- x - rate * da

and returns (x_K, logit(x_K)), all in float32.

D's parameters come in two forms. The kernel reads the module's own
tensors, ``mlp_layers(d)``: per layer the ``(out, in)`` weight and the bias,
the head last, read where they lie at each launch (so in-place updates of D
between calls need no cache). ``refine_mlp_plain`` takes the ``(in, out)``
form of the JAX package's kernels; ``plain_params`` maps the first form to
the second. The kernel is the ``torch.library`` custom op
``cgs::refine_mlp`` (``ops/registry.py``) over x0, the layers' weights and
biases as two ``Tensor[]``, the step count and the run-time rate: its CUDA
implementation launches the kernel and counts on ``fused_refine_mlp``'s
``launches`` (a launch from a reloaded ``torch.export`` artifact counts
too), its CPU implementation is the plain version, its fake implementation
gives the shapes. ``fused_refine_mlp`` calls the op, so a tensor on the CPU
takes the plain version and a tensor on the card launches the kernel or
raises; it never falls back from the card to the plain version.
``supports_mlp_refine_kernel`` is the gate that ``sampling/refine.py``
dispatches on.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.utils.profiling import span

# (weight (out, in), bias (out,)) per layer as the module holds them, the
# head (1, h) last: the kernel's form.
MLPLayers = list[tuple[torch.Tensor, torch.Tensor]]
# (kernel (in, out), bias (out,)) per layer, the head (h, 1) last: the plain
# version's form, the JAX package's.
MLPParams = list[tuple[torch.Tensor, torch.Tensor]]

TILES = (2, 8)  # samples per tile: the kernel's instances
MAX_LAYERS = 64  # relu layers the kernel takes (MAX_LAYERS in the .cu)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may opt into (H100)
SMEM_PER_SM = 233_472  # bytes an SM shares among its blocks (H100)
SMEM_RESERVED = 1_024  # bytes the runtime keeps per block


def mlp_layers(d: torch.nn.Module) -> MLPLayers:
    """D's layers as the module holds them (no copy): the hidden layers in
    numeric order (``fc10`` after ``fc9``), then the head."""
    names = sorted((n for n, _ in d.named_children() if n.startswith("fc")),
                   key=lambda s: int(s[2:]))
    layers = [getattr(d, n) for n in names] + [d.out]
    return [(m.weight.detach(), m.bias.detach()) for m in layers]


def plain_params(layers: MLPLayers) -> MLPParams:
    """The one converter between the two forms: module (out, in) weights to
    the plain version's float32 (in, out) kernels."""
    return [(w.float().t(), b.float()) for w, b in layers]


def mlp_params_from_d(d: torch.nn.Module) -> MLPParams:
    """D's layers in the plain version's (in, out) form."""
    return plain_params(mlp_layers(d))


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


def smem_bytes(d_in: int, hidden: int, layers: int, tile: int) -> int:
    """Dynamic shared memory of one block (``Plan`` in the .cu): W0 and b0,
    each further hidden layer's rows at a pitch of hidden + 4 floats and its
    bias, the head's weights, the activations (layers, hidden, tile), x
    (tile, d_in), the logits, and layers + 1 mbarriers of 8 bytes."""
    h, pitch = hidden, hidden + 4
    floats = (h * d_in + h + (layers - 1) * (h * pitch + h) + h
              + layers * h * tile + _round4(tile * d_in) + _round4(tile))
    return 4 * floats + 8 * (layers + 1)


class LaunchPlan(NamedTuple):
    tile: int  # samples per tile
    grid: int  # persistent blocks, each walking over tiles
    smem: int  # dynamic shared memory per block, bytes


def launch_plan(batch: int, d_in: int, hidden: int, layers: int, sms: int,
                tile: int | None = None) -> LaunchPlan:
    """The kernel's launch for ``batch`` samples on a card of ``sms`` SMs.

    Tiles of 2 while they fit in one wave of resident blocks (at the main
    path's B = 256, 128 blocks, nearly one per SM), else tiles of 8, where
    they fit in shared memory: a tile of 8 takes about twice the cycles of
    a tile of 2 for 4 times the samples (PERF.md). ``tile`` forces one (for
    measurement)."""
    def resident(t):
        per_sm = max(1, SMEM_PER_SM // (smem_bytes(d_in, hidden, layers, t)
                                        + SMEM_RESERVED))
        return sms * per_sm

    if tile is None:
        tile = (2 if -(-batch // 2) <= resident(2)
                or smem_bytes(d_in, hidden, layers, 8) > SMEM_LIMIT else 8)
    if tile not in TILES:
        raise ValueError(f"MLP refine kernel tiles are {TILES}, not {tile}")
    tiles = max(1, -(-batch // tile))
    return LaunchPlan(tile, min(tiles, resident(tile)),
                      smem_bytes(d_in, hidden, layers, tile))


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
    """Whether the kernel takes this D: 1 to MAX_LAYERS relu layers, a width
    that is a multiple of 4 (rows are bulk-copied and read as float4s), and
    the weights with the smallest tile within one block's shared memory."""
    return (1 <= layers <= MAX_LAYERS and hidden >= 4 and hidden % 4 == 0
            and smem_bytes(d_in, hidden, layers, min(TILES)) <= SMEM_LIMIT)


def supports_mlp_refine_kernel(bundle, cfg, labels=None,
                               return_trajectory: bool = False) -> bool:
    """Gate: unconditional MLP D that the kernel takes (``fits_kernel``),
    plain ``ns`` descent (no clip, noise, stop_score or proximal term),
    x-space, no trajectory, and ``use_pallas`` on. The rate is a run-time
    argument of the kernel, so any rate passes."""
    m = bundle.cfg
    return (m.kind == "mlp" and labels is None and not return_trajectory
            and fits_kernel(m.data_dim, m.d_hidden, m.d_layers)
            and cfg.use_pallas and cfg.clip_norm == 0 and cfg.noise == 0
            and cfg.objective == "ns" and cfg.stop_score == 0
            and cfg.proximal == 0 and cfg.space == "x")


def check_layers(layers: MLPLayers, x0: torch.Tensor) -> tuple[int, int]:
    """Raises ValueError unless the kernel takes ``layers`` for ``x0`` as
    they lie: equal hidden widths and a one-unit head, each tensor float32,
    contiguous and on x0's device, and every weight and every bias but the
    head's 16-byte aligned (they are bulk-copied). Returns (hidden, relu
    layers)."""
    relu = len(layers) - 1
    if not 1 <= relu <= MAX_LAYERS:
        raise ValueError(f"MLP refine kernel takes 1 to {MAX_LAYERS} relu "
                         f"layers, got {relu}")
    d_in = x0.shape[1]
    hidden = layers[0][0].shape[0]
    want = ([((hidden, d_in), (hidden,))]
            + [((hidden, hidden), (hidden,))] * (relu - 1)
            + [((1, hidden), (1,))])
    if [(tuple(w.shape), tuple(b.shape)) for w, b in layers] != want:
        raise ValueError("MLP refine kernel takes equal hidden widths and a "
                         "one-unit head, (out, in) weights")
    if not fits_kernel(d_in, hidden, relu):
        raise ValueError(f"MLP refine kernel does not take a D of {relu} x "
                         f"{hidden} over {d_in} inputs (width a multiple of "
                         f"4, {SMEM_LIMIT} bytes of shared memory)")
    for i, (w, b) in enumerate(layers):
        for name, t in (("weight", w), ("bias", b)):
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or t.device != x0.device):
                raise ValueError(f"MLP refine kernel: layer {i} {name} must "
                                 f"be float32, contiguous, on {x0.device}")
            if (t.data_ptr() % 16 and not (i == relu and name == "bias")):
                raise ValueError(f"MLP refine kernel: layer {i} {name} is "
                                 "not 16-byte aligned")
    return hidden, relu


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The C entry's arguments before the stream: x0, x_out, logits, the
# weights' and the biases' pointer arrays, batch, d, h, L, steps, rate,
# tile, grid, smem (csrc/refine_mlp.cu).
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_void_p)] * 2
             + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3)


def _launch(layers: MLPLayers, x0: torch.Tensor, steps: int, rate,
            plan: LaunchPlan, lib: ctypes.CDLL | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel under ``plan``, after ``check_layers``, from
    ``lib`` if given (another build of the source, ``_build.open_lib``),
    else from the package's build."""
    batch, d_in = x0.shape
    hidden, relu = len(layers[0][1]), len(layers) - 1
    x_out = torch.empty_like(x0)
    logits = torch.empty(batch, device=x0.device, dtype=torch.float32)
    ptrs = ctypes.c_void_p * (relu + 1)
    _build.launch(lib or _build.load("refine_mlp"), "refine_mlp", _ARGTYPES,
                  x0, x_out, logits, ptrs(*(w.data_ptr() for w, _ in layers)),
                  ptrs(*(b.data_ptr() for _, b in layers)), batch, d_in,
                  hidden, relu, int(steps), float(rate), plan.tile, plan.grid,
                  plan.smem)
    return x_out, logits


def _refine_mlp_cpu(x0, weights, biases, steps, rate):
    return _build.unaliased(x0, refine_mlp_plain(
        plain_params(list(zip(weights, biases))), x0, steps, rate))


def _refine_mlp_cuda(x0, weights, biases, steps, rate):
    if x0.dtype != torch.float32 or x0.ndim != 2:
        raise ValueError("MLP refine kernel takes (B, d) float32, got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    layers = list(zip(weights, biases))
    x0 = x0.contiguous()
    with span("cgs.refine.prepare"):
        hidden, relu = check_layers(layers, x0)
        plan = launch_plan(x0.shape[0], x0.shape[1], hidden, relu,
                           _sms(x0.device.index if x0.device.index is not None
                                else torch.cuda.current_device()))
    return _launch(layers, x0, steps, rate, plan)


def _refine_mlp_fake(x0, weights, biases, steps, rate):
    return torch.empty_like(x0), x0.new_empty(x0.shape[0])


def fused_refine_mlp(layers: MLPLayers, x0: torch.Tensor, steps: int,
                     rate) -> tuple[torch.Tensor, torch.Tensor]:
    """K refinement steps under the MLP D given as ``mlp_layers(d)``.
    x0: (B, d) float32.

    Returns (x_K, logits (B,)). ``rate`` is a float or a 0-d tensor, passed
    to the kernel at run time."""
    _build.check_device(x0, "MLP refine")
    return torch.ops.cgs.refine_mlp(x0, [w for w, _ in layers],
                                    [b for _, b in layers], int(steps),
                                    float(rate))


_build.define_op("refine_mlp(Tensor x0, Tensor[] weights, Tensor[] biases, "
                 "int steps, float rate) -> (Tensor, Tensor)",
                 _refine_mlp_cpu, _refine_mlp_cuda, _refine_mlp_fake,
                 fused_refine_mlp)
