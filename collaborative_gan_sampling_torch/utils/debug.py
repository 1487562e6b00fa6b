"""``--debug-nans``: stop at the first op that makes a NaN.

Counterpart of the JAX CLI's ``jax_debug_nans`` (JAX ``cli.py:124-125``,
``:138-139``): a ``TorchDispatchMode`` looks at every op's floating outputs
as the op returns, the port's ``cgs::`` kernel ops among them, and raises
``FloatingPointError`` naming the op at the first NaN; infinities pass, as
in JAX. ``torch.autograd.set_detect_anomaly(True)`` covers the backward
pass (autograd's nodes, named in its error). Each check reads a flag back
from the device, so every op synchronises: for development runs only, as
JAX's is.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


# Ops that hand out uninitialised memory: their bits are not results.
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "set_"}


class NaNCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op whose floating output
    holds a NaN, naming the op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.device.type != "meta" and t.numel()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape "
                    f"{tuple(t.shape)}, {t.dtype}, {t.device}); "
                    "--debug-nans stops at the first op that makes one")
        return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Within, the forward ops are checked by ``NaNCheckMode`` and the
    backward pass by autograd's anomaly mode; a no-op when not
    ``enabled``."""
    if not enabled:
        yield
        return
    with torch.autograd.set_detect_anomaly(True), NaNCheckMode():
        yield
