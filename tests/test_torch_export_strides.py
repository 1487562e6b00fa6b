"""The serving export against strides that differ between the real run and
``torch.export``'s fake one (``sampling/export.py::_views_as_reshapes``).

``export_sampler`` records the round with ``make_fx`` on real tensors, where
a ``reshape`` whose input the real strides let it view becomes
``aten.view``, and ``torch.export`` then traces that graph on fake tensors.
On the card, cuDNN's real strides and the fake ones part at D's features,
and the export of a round refined by autograd failed at D's NHWC flatten.
Here an op whose real output is channels-last and whose fake output is
contiguous stands in for the card's convolution, on the CPU."""

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from collaborative_gan_sampling_torch.sampling import export

_LIB = torch.library.Library("cgs_strides_test", "DEF")
_LIB.define("channels_last(Tensor x) -> Tensor")
_LIB.impl("channels_last",
          lambda x: x.clone(memory_format=torch.channels_last), "CPU")
torch.library.register_fake(
    "cgs_strides_test::channels_last",
    lambda x: torch.empty_like(x, memory_format=torch.contiguous_format),
    lib=_LIB)


def flatten_nhwc(x):
    """D's feature flatten (``models/dcgan.py``) after the stand-in conv."""
    h = torch.ops.cgs_strides_test.channels_last(x) * 2.0
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _x():
    return torch.randn(4, 16, 3, 3, generator=torch.Generator().manual_seed(0))


def _targets(gm):
    return [n.target for n in gm.graph.nodes if n.op == "call_function"]


def test_recorded_view_fails_the_fake_trace():
    """The fault: the view that the real strides allowed does not trace on
    the fake ones."""
    traced = make_fx(flatten_nhwc, tracing_mode="real")(_x())
    assert torch.ops.aten.view.default in _targets(traced)
    with pytest.raises(Exception, match="[Vv]iew"):
        torch.export.export(export._Program(traced), (_x(),))


def test_views_as_reshapes_export_the_same_values():
    x = _x()
    traced = export._views_as_reshapes(
        make_fx(flatten_nhwc, tracing_mode="real")(x))
    targets = _targets(traced)
    assert torch.ops.aten.view.default not in targets
    assert torch.ops.aten.reshape.default in targets
    program = torch.export.export(export._Program(traced), (x,)).module()
    want = flatten_nhwc(x)
    assert torch.equal(traced(x), want)
    assert torch.equal(program(x), want)
