"""The frozen operation counts of the yardstick."""

from __future__ import annotations

import math

from cardbench import flops

MNIST = {"image_size": 28, "channels": 1, "d_base_filters": 64,
         "g_base_filters": 64, "z_dim": 100}


def test_pipeline_count_of_the_mnist_step():
    assert flops.d_forward_flops(MNIST) == 20_710_144
    assert flops.g_forward_flops(MNIST) == 21_952_000
    assert round(flops.pipeline_flops_per_sample(MNIST, 10) / 1e6, 1) \
        == 456.9


def test_kernel4_count_and_bound():
    assert flops.KERNEL4_D_FORWARD_FLOPS == 17_364_352
    assert flops.taps_in_range(28, 14) == 67 and flops.taps_in_range(14, 7) \
        == 32
    bound_ms = (flops.refine_flops_per_sample(10) * 2048
                / flops.PEAK_BF16_FLOPS * 1e3)
    assert math.isclose(bound_ms, 0.7551, abs_tol=5e-5)
