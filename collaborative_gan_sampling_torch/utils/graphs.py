"""One CUDA graph per key, over a static copy of a module.

``ModuleGraph(fn, module, *inputs)`` captures ``fn(module, *inputs)`` on
the card as a CUDA graph, after PyTorch's recipe: warm-up calls on a side
stream, then ``torch.cuda.graph`` with its private memory pool. The graph
reads a deep copy of the module (parameters and buffers) and copies of the
inputs, made once. A call copies the caller's module into that copy (one
``torch._foreach_copy_`` over the parameters, one over the buffers) and
its inputs into theirs, every time, with no test of versions or identity,
replays the graph and returns clones of the outputs. So a module changed
in place, or another module of the same layout, gives what ``fn`` would
give on it. The copies, the replay and the clones run on the caller's
current stream, from one thread at a time, as the sampling paths run.

What the capture counts (``utils/profiling.py``'s ``count``, such as
``ops/nn.py``'s ``weight_casts``) is tallied once, profiler or not, and
counted again at each replay, which performs it again on the device.

``cached(key, build)`` keeps the last ``SLOTS`` graphs of the process by
key, the least recently used dropped with its pool; the key names all that
the captured work depends on (``sampling/refine.py``). ``capturable(x)``
is False wherever a capture or a replay would not be the eager work: under
``torch.compile``, ``torch.jit`` tracing, any dispatch mode (``make_fx``,
``torch.export``, fake tensors), autocast, or inside another capture.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Callable

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from collaborative_gan_sampling_torch.utils.profiling import count, tallied

SLOTS = 4  # graphs kept per process
WARMUP = 3  # eager calls on a side stream before the capture

_GRAPHS: OrderedDict[tuple, ModuleGraph] = OrderedDict()


def capturable(x: torch.Tensor) -> bool:
    """Whether work on ``x`` may be captured and replayed as the eager calls
    would run it (x on any device: the caller tests the device)."""
    return not (torch.compiler.is_compiling() or torch.jit.is_tracing()
                or is_in_torch_dispatch_mode()
                or torch.is_autocast_enabled(x.device.type)
                or (x.is_cuda and torch.cuda.is_current_stream_capturing()))


class ModuleGraph:
    """``fn(module, *inputs) -> tuple of tensors`` captured over a static
    copy of ``module`` and of ``inputs`` (a tensor or None each); see the
    module's docstring."""

    def __init__(self, fn: Callable, module: torch.nn.Module,
                 *inputs: torch.Tensor | None):
        self.module = copy.deepcopy(module)
        for p in self.module.parameters():
            p.grad = None
        self.params = list(self.module.parameters())
        self.buffers = list(self.module.buffers())
        self.inputs = [None if t is None else t.clone() for t in inputs]
        self.device = self.inputs[0].device
        self.counts, self.outputs = self._capture(
            lambda: fn(self.module, *self.inputs))

    def _capture(self, run: Callable) -> tuple[dict, tuple]:
        """(the counts one run performs, the static outputs)."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    run()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with tallied() as counts, torch.cuda.graph(self.graph):
                outputs = run()
        return counts, tuple(outputs)

    def _replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()

    def __call__(self, module: torch.nn.Module,
                 *inputs: torch.Tensor | None) -> tuple[torch.Tensor, ...]:
        with torch.no_grad():
            torch._foreach_copy_(self.params, list(module.parameters()))
            if self.buffers:
                torch._foreach_copy_(self.buffers, list(module.buffers()))
            for static, t in zip(self.inputs, inputs):
                if static is not None:
                    static.copy_(t)
        self._replay()
        for name, n in self.counts.items():
            count(name, n)
        return tuple(t.clone() for t in self.outputs)


def cached(key: tuple, build: Callable[[], ModuleGraph]) -> ModuleGraph:
    """The graph kept under ``key``, else ``build()``'s, kept; the least
    recently used dropped beyond ``SLOTS``."""
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        while len(_GRAPHS) >= SLOTS:
            _GRAPHS.popitem(last=False)
        graph = build()
    _GRAPHS[key] = graph
    return graph
