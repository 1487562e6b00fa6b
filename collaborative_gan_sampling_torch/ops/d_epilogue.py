"""D's per-layer epilogue in eval mode, forward and VJP, as hand kernels.

After each conv of a DCGAN D, ``DCGANDiscriminator.forward`` applies
BatchNorm (conv1 onward), leaky ReLU (slope ``SLOPE``) and the next conv's
SAME pad. In eval mode, on bf16 activations that are channels-last NCHW
tensors with C a multiple of 8, the kernel (``csrc/d_epilogue_bf16.cu``)
does the three in one pass, and a second entry does their VJP. It replaces
no TPU kernel (XLA fuses the chain into its neighbours there); eager
PyTorch runs it as a chain of elementwise kernels, most of which do not
vectorize, and the autograd refinement of such a D runs that chain 21
times a candidate at K = 10.

Two ``torch.library`` ops in the ``cgs`` namespace (``ops/registry.py``):

* ``cgs::d_epilogue_bf16(x, mean, mul, bias, lo, hi)``: conv_i's output
  x (B, C, H, W) and the BN's ``FlaxBatchNorm.eval_affine()``, or three
  Nones after conv0, into leaky(BN(x)) padded by (lo, hi) on both spatial
  axes, (B, C, H + lo + hi, W + lo + hi), border zeros included;
* ``cgs::d_epilogue_bf16_backward(grad, out, mul, lo, hi)``: the VJP at
  x of the padded output's gradient, from the forward's output (its sign is
  the pre-activation's) and mul.

Each has a CPU implementation (the plain version: the eager composition,
``epilogue_plain`` and autograd's VJP of it, ``epilogue_backward_plain``),
a CUDA implementation (the kernel's launch, counted on ``d_epilogue`` or
``d_epilogue_backward``'s ``launches``) and a fake implementation. On the
card they launch or raise, never falling back to the plain version. Both
keep every rounding point of the eager chain, so each gives the plain
version's bits. Every call of either op, on any device, counts one
``d_epilogue_kernels`` (``utils/profiling.py::count``); a CUDA graph's
replay counts what its capture tallied (``utils/graphs.py``).

The forward op's autograd formula (``torch.library.register_autograd``)
calls the backward op, so ``make_fx``, ``torch.export`` and a CUDA graph's
capture see two ``cgs::`` ops. It differentiates x alone: ``routes``
sends a forward whose BN parameters need a gradient while autograd
records to the plain composition, whose parameter gradients are autograd's
own, and the refinements run D over its parameters detached, eagerly and
in a graph alike (``sampling/refine.py::_frozen_d``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.ops.nn import batch_norm_affine
from collaborative_gan_sampling_torch.utils.profiling import count

SLOPE = 0.2  # ops/nn.py::lrelu's slope (SLOPE in the .cu)
CHUNK = 8  # bf16 channels in the kernel's 16-byte vector
_DEVICES = ("cuda",)  # where DCGANDiscriminator routes its epilogues here

Affine = tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]
NO_AFFINE: Affine = (None, None, None)  # conv0's epilogue


def routes(h: torch.Tensor, bn: torch.nn.Module | None) -> bool:
    """Whether an eval-mode epilogue of conv output ``h`` with BatchNorm
    ``bn`` (None after conv0) goes through the op: ``h`` a bf16
    channels-last-dense 4-D tensor on a device of ``_DEVICES``, square, with
    C a multiple of ``CHUNK``, and no parameter of ``bn`` needing a gradient
    while autograd records."""
    return (h.device.type in _DEVICES and h.dtype == torch.bfloat16
            and h.ndim == 4 and h.shape[1] % CHUNK == 0
            and h.shape[2] == h.shape[3]
            and h.is_contiguous(memory_format=torch.channels_last)
            and not (bn is not None and torch.is_grad_enabled()
                     and any(p.requires_grad for p in bn.parameters())))


def epilogue_plain(x: torch.Tensor, mean: torch.Tensor | None,
                   mul: torch.Tensor | None, bias: torch.Tensor | None,
                   lo: int, hi: int) -> torch.Tensor:
    """The eager composition: ``FlaxBatchNorm`` in eval mode (where ``mul``
    is given), ``lrelu``, then ``SameConv2d``'s ``F.pad``; channels-last."""
    if mul is not None:
        x = batch_norm_affine(x.float(), mean, mul, bias).to(x.dtype)
    y = F.pad(F.leaky_relu(x, SLOPE), (lo, hi, lo, hi))
    return y.contiguous(memory_format=torch.channels_last)


def epilogue_backward_plain(grad: torch.Tensor, out: torch.Tensor,
                            mul: torch.Tensor | None, lo: int,
                            hi: int) -> torch.Tensor:
    """Autograd's VJP of ``epilogue_plain`` at x: the pad's crop, leaky
    ReLU's backward (on the output, whose sign is the input's), then the
    BN's bf16 -> float32 -> times mul -> bf16; channels-last."""
    h, w = out.shape[2] - lo - hi, out.shape[3] - lo - hi
    inner = (..., slice(lo, lo + h), slice(lo, lo + w))
    g = torch.ops.aten.leaky_relu_backward(grad[inner], out[inner], SLOPE,
                                           True)
    if mul is not None:
        g = (g.float() * mul.view(1, -1, 1, 1)).to(grad.dtype)
    return g.contiguous(memory_format=torch.channels_last)


def _forward_fake(x, mean, mul, bias, lo, hi):
    """The output: (B, C, H + lo + hi, W + lo + hi), channels-last."""
    b, c, h, w = x.shape
    return torch.empty((b, c, h + lo + hi, w + lo + hi), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


def _backward_fake(grad, out, mul, lo, hi):
    """dx: the forward's input shape, channels-last."""
    b, c, hp, wp = out.shape
    return torch.empty((b, c, hp - lo - hi, wp - lo - hi), dtype=out.dtype,
                       device=out.device, memory_format=torch.channels_last)


def _check_activation(t: torch.Tensor, shape: tuple, what: str) -> None:
    if (len(shape) != 4 or tuple(t.shape) != tuple(shape)
            or t.dtype != torch.bfloat16
            or not t.is_contiguous(memory_format=torch.channels_last)
            or t.data_ptr() % 16 or shape[1] % CHUNK):
        raise ValueError(
            f"d_epilogue kernel: {what} must be bf16 {tuple(shape)}, "
            f"channels-last, 16-byte aligned, C a multiple of {CHUNK}; got "
            f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _check_params(params, channels: int) -> None:
    given = [p is not None for p in params]
    if any(given) and not all(given):
        raise ValueError("d_epilogue kernel: mean, mul and bias come "
                         "together or not at all")
    for p in params:
        if p is not None and (p.shape != (channels,)
                              or p.dtype != torch.float32
                              or not p.is_contiguous()):
            raise ValueError("d_epilogue kernel: BN parameters must be "
                             f"float32 ({channels},), contiguous")


# The C entries' arguments before the stream (csrc/d_epilogue_bf16.cu).
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"d_epilogue_bf16": [_P] * 5 + [_I] * 6,
             "d_epilogue_bf16_backward": [_P] * 4 + [_I] * 6}


def _lib() -> ctypes.CDLL:
    return _build.load("d_epilogue_bf16")


def _forward_cuda(x, mean, mul, bias, lo, hi):
    _check_activation(x, x.shape, "x")
    _check_params((mean, mul, bias), x.shape[1])
    out = _forward_fake(x, mean, mul, bias, lo, hi)
    _build.launch(_lib(), "d_epilogue_bf16", _ARGTYPES["d_epilogue_bf16"],
                  x, mean, mul, bias, out, *x.shape, lo, hi)
    count("d_epilogue_kernels")
    return out


def _backward_cuda(grad, out, mul, lo, hi):
    _check_activation(out, out.shape, "out")
    _check_activation(grad, out.shape, "grad")
    _check_params((mul,), out.shape[1])
    dx = _backward_fake(grad, out, mul, lo, hi)
    _build.launch(_lib(), "d_epilogue_bf16_backward",
                  _ARGTYPES["d_epilogue_bf16_backward"], grad, out, mul, dx,
                  *dx.shape, lo, hi)
    count("d_epilogue_kernels")
    return dx


def _forward_cpu(x, mean, mul, bias, lo, hi):
    count("d_epilogue_kernels")
    return epilogue_plain(x, mean, mul, bias, lo, hi)


def _backward_cpu(grad, out, mul, lo, hi):
    count("d_epilogue_kernels")
    return epilogue_backward_plain(grad, out, mul, lo, hi)


def d_epilogue(x: torch.Tensor, affine: Affine, lo: int,
               hi: int) -> torch.Tensor:
    """leaky(BN(x)) (leaky(x) for ``NO_AFFINE``) padded by (lo, hi) on
    both spatial axes: ``cgs::d_epilogue_bf16``, differentiable in x."""
    _build.check_device(x, "d_epilogue")
    return torch.ops.cgs.d_epilogue_bf16(x, *affine, lo, hi)


def d_epilogue_backward(grad: torch.Tensor, out: torch.Tensor,
                        mul: torch.Tensor | None, lo: int,
                        hi: int) -> torch.Tensor:
    """The VJP at x of ``d_epilogue``'s output ``out``, for its gradient
    ``grad``: ``cgs::d_epilogue_bf16_backward``."""
    return torch.ops.cgs.d_epilogue_bf16_backward(grad, out, mul, lo, hi)


def _setup_context(ctx, inputs, output):
    x, mean, mul, bias, lo, hi = inputs
    if any(t is not None and t.requires_grad for t in (mean, mul, bias)):
        raise RuntimeError(
            "cgs::d_epilogue_bf16 differentiates x alone: BN parameters "
            "that need a gradient take the plain composition "
            "(ops/d_epilogue.py::routes)")
    ctx.save_for_backward(output, mul)
    ctx.pads = (lo, hi)


def _backward(ctx, grad):
    out, mul = ctx.saved_tensors
    dx = d_epilogue_backward(
        grad.contiguous(memory_format=torch.channels_last), out, mul,
        *ctx.pads)
    return dx, None, None, None, None, None


_build.define_op("d_epilogue_bf16(Tensor x, Tensor? mean, Tensor? mul, "
                 "Tensor? bias, int lo, int hi) -> Tensor",
                 _forward_cpu, _forward_cuda, _forward_fake, d_epilogue)
_build.define_op("d_epilogue_bf16_backward(Tensor grad, Tensor out, "
                 "Tensor? mul, int lo, int hi) -> Tensor",
                 _backward_cpu, _backward_cuda, _backward_fake,
                 d_epilogue_backward)
torch.library.register_autograd("cgs::d_epilogue_bf16", _backward,
                                setup_context=_setup_context,
                                lib=_build.OPS)
