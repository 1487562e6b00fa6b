"""The refine kernels' criterion on trained weights, proven on the reference.

On trained weights bn1's running variance falls to ~1e-4 .. 1e-3 and, folded
into conv1, amplifies conv1 up to ~90 times, so the absolute bounds that
hold the kernels on random weights (1e-5 on x, 1e-4 on logits) fail for the
JAX package's own TPU kernel as much as for the port's. The criterion that
replaces them on trained weights (``ops/conv_refine_ref.py``): from each
x_t of the plain version's trajectory, one step of a version is compared
with the same step in float64 (the same bf16-rounded operands for the bf16
versions); over the batch, the median and the 90th percentile of its
per-sample |error|, on x and on the logit, may be at most 4 times the plain
float32 version's (f32), or the plain version's plus a tenth of what bf16
rounding itself does to the step (bf16).

Here the reference, ``fused_refine_conv28_v2`` in interpret mode (bf16 and
f32 matmuls), meets that criterion against the port's plain versions on a
DCGAN D whose bn1 running variance is drawn from [1e-4, 1e-3], at B = 128
over K = 5 steps, for four weight draws; the plain versions meet it by
construction. The yardstick is the port's float64 plain function, which
takes the same folded parameters as the float32 one. The test prints the
reference's worst statistic against its allowance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    BF16_FRACTION,
    F32_FACTOR,
    GATED,
    beyond_criterion,
    fold_dcgan_d,
    refine_conv28_plain,
    refine_conv28_plain_bf16,
    step_errors,
)
from collaborative_gan_sampling_torch.utils.weights import load_jax_variables
from collaborative_gan_sampling_tpu.ops.conv_refine_pallas import (
    fused_refine_conv28_v2,
)
from tests.test_torch_models import MNIST, make_pair

B, STEPS, RATE = 128, 5, 0.02


def _amplified_pair(seed):
    """JAX variables and the port's D of the mnist D with bn1's running
    variance in [1e-4, 1e-3], as training leaves it; and x0."""
    _, _, _, d_vars, _, d = make_pair(MNIST, seed=seed)
    rng = np.random.default_rng(seed)
    bn1 = d_vars["batch_stats"]["bn1"]
    bn1["var"] = rng.uniform(1e-4, 1e-3, bn1["var"].shape).astype(np.float32)
    load_jax_variables(d, d_vars)
    x0 = (rng.standard_normal((B, 28, 28, 1)) * 0.5).astype(np.float32)
    return d_vars, fold_dcgan_d(d), torch.from_numpy(x0)


@pytest.mark.parametrize("seed", [21, 34, 55, 89])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_reference_meets_trained_weight_criterion(seed, bf16):
    d_vars, params, x = _amplified_pair(seed)
    plain = refine_conv28_plain_bf16 if bf16 else refine_conv28_plain
    worst = dict.fromkeys(GATED, 0.0)
    for _ in range(STEPS):
        ref = fused_refine_conv28_v2(d_vars, jnp.asarray(x.numpy()), 1, RATE,
                                     tile=4, interpret=True, bf16=bf16)
        ref = tuple(torch.from_numpy(np.array(t)) for t in ref)
        got = plain(params, x, 1, RATE)
        yard = plain(params, x, 1, RATE, dtype=torch.float64)
        e_ref, e_plain = step_errors(ref, yard), step_errors(got, yard)
        effect = (step_errors(refine_conv28_plain(
            params, x, 1, RATE, dtype=torch.float64), yard) if bf16
            else None)
        assert beyond_criterion(e_ref, e_plain, effect) == [], (
            e_ref, e_plain, effect)
        assert beyond_criterion(e_plain, e_plain, effect) == []
        for k in GATED:  # the share of its allowance the reference takes
            allowed = (F32_FACTOR * e_plain[k] if effect is None
                       else e_plain[k] + BF16_FRACTION * effect[k])
            worst[k] = max(worst[k], e_ref[k] / allowed)
        x = got[0]
    print(f"seed {seed}: the reference's worst share of its allowance "
          f"{worst}")
