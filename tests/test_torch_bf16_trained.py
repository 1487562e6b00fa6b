"""``bf16_trained.py``'s lrelu' flip count on the CPU: its float64 step is
the plain bf16 version's at float64 (``refine_conv28_plain_bf16``), a
version's step that flipped one candidate unit is found with its layer, and
a step that only rounds to float32 flips nothing. The mnist D at full width
with its random init, four samples."""

import pytest
import torch

import bf16_trained as bt
from collaborative_gan_sampling_torch.config import get_preset
from collaborative_gan_sampling_torch.models import make_bundle
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    fold_dcgan_d,
    refine_conv28_plain_bf16,
)


@pytest.fixture(scope="module")
def case():
    bundle = make_bundle(get_preset("mnist").model, device="cpu")
    _, d = bundle.init(torch.Generator().manual_seed(3))
    x = torch.tanh(torch.randn(4, 28, 28, 1,
                               generator=torch.Generator().manual_seed(4)))
    params = fold_dcgan_d(d)
    return params, x, bt.flip_candidates(params, x)


def test_step64_is_the_plain_step_in_float64(case):
    params, x, (y64, _, _) = case
    ref = refine_conv28_plain_bf16(params, x, 1, bt.RATE,
                                   dtype=torch.float64)[0]
    torch.testing.assert_close(y64, ref, rtol=0, atol=1e-15)


@pytest.mark.parametrize("sample", [0, 3])
def test_a_flipped_candidate_is_found(case, sample):
    params, x, (y64, idx, yc) = case
    y = y64.clone()
    y[sample] = yc[sample, 0]
    layer, err = bt.flip_attribution(y.float(), y64, idx, yc)
    assert err[sample] > 0
    expected = int(idx[sample, 0] >= 64 * 14 * 14)
    assert layer.tolist() == [expected if i == sample else -1
                              for i in range(4)]


def test_float32_rounding_is_no_flip(case):
    _, _, (y64, idx, yc) = case
    layer, _ = bt.flip_attribution(y64.float(), y64, idx, yc)
    assert layer.tolist() == [-1] * 4
