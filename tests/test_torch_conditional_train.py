"""Parity of the port's train chunk on the class-conditional DCGAN with the
JAX package's ``make_train_chunk``: the real batch keeps its labels, and
the D, G and FusedProp updates draw fake labels beside z (the JAX chunk's
own draws fed through the ``TrainDraws`` seam, labels included). Params
(``label_embed`` and ``proj_embed`` among them), BatchNorm statistics,
Adam's moments, the step and the metrics after 1 or 2 iterations, at the
tolerances of tests/test_torch_train.py (float32, and bfloat16 against
JAX's own bf16-vs-f32 spread).

The conditional x-space draw-and-refine unit is in
tests/test_torch_conditional_refine.py.
"""

import pytest
import torch

from tests.test_torch_conditional import (  # noqa: F401 (a fixture)
    COND,
    COND_BF16,
    make_cond_pair,
    one_torch_thread,
)
from tests.test_torch_train import OPTIONS, compare, run_both


@pytest.mark.parametrize("option,spc", [("d1g1", 2), ("fused", 1),
                                        ("r1", 1), ("ema", 2)])
def test_conditional_chunk_matches_jax_f32(option, spc):
    out = run_both(COND, dict(OPTIONS[option], steps_per_call=spc))
    compare(*out)
    t_state = out[2]
    # Both embedding tables were stepped by their own Adam, and no gradient
    # is left on them.
    for module, opt, name in ((t_state.g, t_state.g_opt, "label_embed"),
                              (t_state.d, t_state.d_opt, "proj_embed")):
        table = getattr(module, name).embedding
        assert table.grad is None
        assert float(opt.state[table]["exp_avg"].abs().max()) > 0


def test_conditional_chunk_matches_jax_bf16():
    kw = dict(OPTIONS["d1g1"], steps_per_call=1)
    j32 = run_both(COND, kw, port=False)[0]
    compare(*run_both(COND_BF16, kw), j32=j32)


def test_train_draws_keep_labels():
    from collaborative_gan_sampling_torch.training.gan import TrainDraws

    _, tb, _, _, _, _ = make_cond_pair()
    seen = []

    def data_fn(gen, n):
        labels = torch.randint(0, 10, (n,), generator=gen)
        seen.append(labels)
        return torch.zeros(n, 16, 16, 3), labels

    draws = TrainDraws(tb, data_fn, seed=3, batch_size=6)
    x, labels_r, z, labels_f = draws.d_batch(2)
    assert labels_r is seen[0] and labels_f.shape == (6,)
    z2, labels_g = draws.g_batch(2)
    assert labels_g.dtype == torch.int64 and int(labels_g.max()) < 10
    assert torch.equal(draws.d_batch(2)[3], labels_f)  # keyed, repeatable
