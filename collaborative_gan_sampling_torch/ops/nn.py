"""NN layers with the JAX package's (TF / Flax) semantics, in PyTorch.

Counterpart of ``collaborative_gan_sampling_tpu/ops/nn.py``. The modules take
and return NCHW; the model wrappers convert from the NHWC of the public
functions. Three places where PyTorch's stock layers differ from Flax:

* **SAME conv padding.** XLA's SAME pads a stride-2 5x5 conv on an even input
  low 1, high 2 (input index ``iy = 2*oy + dy - 1``). ``nn.Conv2d(padding=2)``
  pads 2 on both sides and shifts the grid, so :class:`SameConv2d` pads
  explicitly.
* **SAME transposed conv.** Flax ``ConvTranspose(padding='SAME')`` dilates the
  input, pads it (3, 2) for k=5, s=2 and cross-correlates with the kernel
  *unflipped*. ``F.conv_transpose2d`` with the flipped kernel and padding 1
  gives the same values plus one extra trailing row and column, which
  :class:`SameConvTranspose2d` crops. Its weight is the torch-native
  ``(in, out, kh, kw)`` array, i.e. the Flax kernel permuted and flipped
  (``utils/weights.py`` converts).
* **BatchNorm.** Flax momentum 0.9 is torch momentum 0.1, eps 1e-5, and Flax
  updates the running variance with the *biased* batch variance;
  :class:`FlaxBatchNorm` does the same.

Data parallelism (``parallel/mesh.py``): inside ``batch_stats_group(group)``
a train-mode :class:`FlaxBatchNorm` takes its two moments, E[x] and E[x^2],
over the whole batch of the group's ranks, as GSPMD computes them over a
sharded batch in the JAX package; with no group (the default) nothing
changes.

Each forward converts the float32 weights (and ``Embed``'s gathered rows)
to the activation's dtype; each conversion that changes a dtype adds one
to ``utils/profiling.py``'s counter ``weight_casts`` while a profiler
session records (a float32 model counts none).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from collaborative_gan_sampling_torch.parallel.mesh import all_reduce_mean
from collaborative_gan_sampling_torch.utils.profiling import count

DCGAN_INIT_STD = 0.02  # carpedm20 DCGAN init: N(0, 0.02) kernels, zero bias
# Std of a unit normal truncated at +-2 (jax.nn.initializers.variance_scaling)
LECUN_TRUNC_STD = 0.87962566103423978


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's SAME for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None, stride: int = 2) -> torch.Tensor:
    """SAME conv on NCHW with a torch-layout ``(out, in, kh, kw)`` weight."""
    kh, kw = weight.shape[-2:]
    py = same_pads(x.shape[-2], kh, stride)
    px = same_pads(x.shape[-1], kw, stride)
    x = F.pad(x, (px[0], px[1], py[0], py[1]))
    return F.conv2d(x, weight, bias, stride=stride)


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in ``dtype``; a conversion counts one ``weight_casts``."""
    if t.dtype == dtype:
        return t
    count("weight_casts")
    return t.to(dtype)


def _normal_(t: torch.Tensor, generator: torch.Generator | None) -> None:
    with torch.no_grad():
        dev = generator.device if generator is not None else t.device
        t.copy_(torch.randn(t.shape, generator=generator, device=dev)
                * DCGAN_INIT_STD)


class SameConv2d(nn.Module):
    """Stride-2 SAME 5x5 conv (the reference's ``conv2d``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 5, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator=None) -> None:
        _normal_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def pads(self, size: int) -> tuple[int, int]:
        """(low, high) SAME padding of an input side of ``size``."""
        return same_pads(size, self.weight.shape[-1], self.stride)

    def forward(self, x: torch.Tensor, padded: bool = False) -> torch.Tensor:
        """The conv of x; ``padded``: x already carries the SAME pads, its
        border zeros included (``ops/d_epilogue.py`` writes them)."""
        w, b = _cast(self.weight, x.dtype), _cast(self.bias, x.dtype)
        if padded:
            return F.conv2d(x, w, b, stride=self.stride)
        return conv2d_same(x, w, b, self.stride)


class FlaxConv(nn.Module):
    """Flax ``nn.Conv``: any (kh, kw) kernel, SAME (XLA's pads, possibly
    asymmetric) or VALID padding, optional bias. ``forward`` may take
    another stride than the module's (the feature nets pick it by input
    size). Weight in torch's (out, in, kh, kw) layout."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 stride: int = 1, padding: str = "SAME", bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        """Flax's default: lecun-normal kernel (fan_in = in * kh * kw),
        zero bias."""
        fan_in = self.weight[0].numel()
        std = (1.0 / fan_in) ** 0.5 / LECUN_TRUNC_STD
        dev = generator.device if generator is not None else self.weight.device
        w = torch.empty(self.weight.shape, device=dev)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        with torch.no_grad():
            self.weight.copy_(w * std)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, stride: int | None = None
                ) -> torch.Tensor:
        stride = stride or self.stride
        if self.padding == "SAME":
            return conv2d_same(x, self.weight, self.bias, stride)
        return F.conv2d(x, self.weight, self.bias, stride=stride)


class SameConvTranspose2d(nn.Module):
    """Flax ``ConvTranspose(kernel 5, strides 2, padding='SAME')``: out = 2*in.

    ``weight`` is torch's ``(in, out, kh, kw)`` layout and already flipped
    relative to the Flax kernel."""

    def __init__(self, cin: int, cout: int, kernel: int = 5, stride: int = 2):
        super().__init__()
        if kernel - 1 < stride:
            raise ValueError("SAME transposed conv needs kernel > stride")
        self.stride = stride
        # lax pads the dilated input low ceil((k + s - 2) / 2); the torch
        # padding that reproduces it is k - 1 - that.
        self.padding = kernel - 1 - -(-(kernel + stride - 2) // 2)
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator=None) -> None:
        _normal_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        y = F.conv_transpose2d(x, _cast(self.weight, x.dtype),
                               _cast(self.bias, x.dtype), stride=self.stride,
                               padding=self.padding)
        return y[..., :h * self.stride, :w * self.stride]


class Dense(nn.Module):
    """``nn.Dense`` with the DCGAN init; weight in torch's (out, in) layout."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout))

    def reset_parameters(self, generator=None) -> None:
        _normal_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x.dtype),
                        _cast(self.bias, x.dtype))


class Embed(nn.Module):
    """Flax ``nn.Embed`` with the DCGAN init: a ``(num, features)`` float32
    table named ``embedding``, N(0, 0.02); rows gathered by integer index
    and cast to ``dtype``."""

    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(num, features))

    def reset_parameters(self, generator=None) -> None:
        _normal_(self.embedding, generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return _cast(F.embedding(idx, self.embedding), self.dtype)


class LecunDense(Dense):
    """``nn.Dense`` with Flax's default init (the MLP models): lecun-normal
    kernels, i.e. a unit normal truncated at +-2 and scaled to
    std sqrt(1 / fan_in) / 0.8796 (the truncated normal's own std), zero
    bias."""

    def reset_parameters(self, generator=None) -> None:
        fan_in = self.weight.shape[1]
        std = (1.0 / fan_in) ** 0.5 / LECUN_TRUNC_STD
        dev = generator.device if generator is not None else self.weight.device
        w = torch.empty(self.weight.shape, device=dev)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        with torch.no_grad():
            self.weight.copy_(w * std)
        nn.init.zeros_(self.bias)


_BATCH_STATS_GROUP: list = [None]


@contextlib.contextmanager
def batch_stats_group(group):
    """Within, every train-mode ``FlaxBatchNorm`` all-reduces its batch
    moments over ``group`` (None: each process keeps its own)."""
    saved = _BATCH_STATS_GROUP[0]
    _BATCH_STATS_GROUP[0] = group
    try:
        yield
    finally:
        _BATCH_STATS_GROUP[0] = saved


class FlaxBatchNorm(nn.Module):
    """BatchNorm over the channel axis of NCHW (or the last axis of (B, C))
    with Flax semantics: momentum 0.9 on the running averages, eps 1e-5,
    biased batch variance in both the normalisation and the running update.
    Statistics are taken in float32 whatever the compute dtype.

    In training mode the running averages are updated in place, and inside
    ``batch_stats_group(group)`` the moments are the mean of the ranks'
    moments, through an all-reduce that autograd differentiates (twice,
    for R1)."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def eval_affine(self) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """(mean, mul, bias) of the eval-mode normalisation
        ``(x - mean) * mul + bias``, float32 (C,): the running mean,
        rsqrt(running_var + eps) * weight and the bias."""
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return self.running_mean, mul, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            # Flax's fast variance: E[x^2] - E[x]^2, clipped at 0.
            axes = [0] + list(range(2, x.ndim))
            mean, sq = xf.mean(dim=axes), xf.square().mean(dim=axes)
            group = _BATCH_STATS_GROUP[0]
            if group is not None:
                mean, sq = all_reduce_mean(group, torch.stack([mean, sq]))
            var = (sq - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
            mul = torch.rsqrt(var + self.eps) * self.weight
        else:
            mean, mul, _ = self.eval_affine()
        return batch_norm_affine(xf, mean, mul, self.bias).to(x.dtype)


def batch_norm_affine(xf: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """``(xf - mean) * mul + bias`` over the channel axis (1) of float32
    ``xf``, each step rounded to float32: ``FlaxBatchNorm``'s normalisation
    and the plain version of ``ops/d_epilogue.py``'s kernel."""
    shape = (1, -1) + (1,) * (xf.ndim - 2)
    return (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
