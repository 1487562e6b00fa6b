"""Float32 that stays float32 on the card.

PyTorch lets cuDNN convolutions use TF32 (10-bit mantissas) by default.
The evaluation path (feature nets, moments, the Frechet distance, KID,
precision/recall, FID-backprop) computes the JAX package's float32
functions, so it runs with TF32 off for cuDNN and for matmuls alike, and
restores the caller's settings afterwards. On the CPU the flags do
nothing.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN and CUDA matmuls inside the block."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def full_f32(fn):
    """Decorator: run ``fn`` under ``no_tf32``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with no_tf32():
            return fn(*args, **kwargs)
    return wrapped
