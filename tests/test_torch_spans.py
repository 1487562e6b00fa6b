"""The port's spans and counters (``utils/profiling.py``) in the sampling
paths, on the CPU at tiny sizes.

* With no profiler recording, a collab call and a ``generate`` record
  nothing and enter no ``record_function``.
* Under ``torch.profiler``, each stored span has a profiler event of the
  same name, nested under the same span; every span of a call or a request
  falls under its one root; the span counts follow the loops.
* ``host_syncs``: 1 + 3 a round for an unconditional ``generate`` (one
  more a round for the labels of a conditional one); 0 for a collab call,
  one a shaping step with a shaping target.
* ``summary()``'s self time is the duration less the child spans'.
* The exported serving round holds no profiler node when exported under a
  recording profiler, and the same ``cgs::`` nodes as without one.
"""

import collections
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collaborative_gan_sampling_torch.config import ModelConfig, RefineConfig
from collaborative_gan_sampling_torch.models import make_bundle
from collaborative_gan_sampling_torch.sampling.collab import sample
from collaborative_gan_sampling_torch.sampling.export import export_sampler
from collaborative_gan_sampling_torch.sampling.serve import ServingSampler
from collaborative_gan_sampling_torch.utils import profiling

MLP = dict(kind="mlp", z_dim=4, data_dim=2, g_hidden=16, d_hidden=16,
           g_layers=2, d_layers=2, compute_dtype="float32")
COND = dict(kind="dcgan", z_dim=8, image_size=16, channels=1,
            g_base_filters=8, d_base_filters=8, compute_dtype="float32",
            num_classes=4)
# 2 burn-in batches, 5 rounds of 8, shaping every 2nd round: 3 shaping
# rounds of 2 steps.
REFINE = dict(steps=2, rate=0.05, batch_size=8, num_batches=5, burn_in=16,
              shape_every=2, shaping_steps=2, use_pallas=True)
ROOTS = {"collab": "cgs.collab.call", "generate": "cgs.serve.generate",
         "generate_cond": "cgs.serve.generate"}


def _pair(model=MLP):
    bundle = make_bundle(ModelConfig(**model), "cpu")
    g, d = bundle.init(torch.Generator().manual_seed(3))
    return bundle, g, d


def _data_fn(gen, n):
    return torch.randn(n, 2, generator=gen), None


def _run(case, **refine):
    """One call of the case; returns what its counts depend on."""
    cfg = RefineConfig(**dict(REFINE, **refine))
    gen = torch.Generator().manual_seed(7)
    if case == "collab":
        bundle, g, d = _pair()
        sample(bundle, g, d, cfg, gen, method="collab", data_fn=_data_fn)
        return {}
    bundle, g, d = _pair(COND if case == "generate_cond" else MLP)
    srv = ServingSampler(bundle, cfg, method="collab")
    _, _, stats = srv.generate(g, d, gen, 12)
    return stats


def _traced(case, **refine):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(case, **refine)
    return prof, out


def test_span_off_is_one_shared_no_op():
    profiling.reset()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("host_syncs")
    assert profiling.records() == []
    assert profiling.summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("case", ["collab", "generate"])
def test_no_profiler_records_nothing(monkeypatch, case):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    _run(case)
    assert profiling.records() == []
    assert profiling.summary() == {"spans": {}, "counters": {}}


def _innermost_span(event, names):
    p = event.cpu_parent
    while p is not None and p.name not in names:
        p = p.cpu_parent
    return p.name if p is not None else None


@pytest.mark.parametrize("case", ["collab", "generate"])
def test_spans_match_the_profilers_events(case):
    prof, stats = _traced(case)
    recs = profiling.records()
    names = {r.name for r in recs}
    events = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start)
    assert collections.Counter(e.name for e in events) == \
        collections.Counter(r.name for r in recs)
    by_id = {r.id: r for r in recs}
    ours = [(r.name, by_id[r.parent].name if r.parent is not None else None)
            for r in sorted(recs, key=lambda r: r.start_ns)]
    assert [(e.name, _innermost_span(e, names)) for e in events] == ours

    (root,) = [r for r in recs if r.parent is None]
    assert root.name == ROOTS[case]
    for r in recs:
        assert r.root == root.id
        parent = by_id.get(r.parent, r)
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns

    n = collections.Counter(r.name for r in recs)
    cfg = RefineConfig(**REFINE)
    burn = max(1, cfg.burn_in // cfg.batch_size)
    if case == "collab":
        batches = burn + cfg.num_batches
        assert n["cgs.collab.burn_in"] == 1
        assert n["cgs.collab.accept"] == cfg.num_batches
        assert n["cgs.collab.shape"] == math.ceil(cfg.num_batches
                                                  / cfg.shape_every)
    else:
        rounds = stats["rounds"]
        batches = burn + rounds * cfg.num_batches
        assert n["cgs.serve.calibrate"] == 1
        assert n["cgs.serve.round"] == rounds
        assert n["cgs.serve.accept"] == rounds * cfg.num_batches
        assert n["cgs.serve.compact"] == n["cgs.serve.fetch"] == rounds
    assert n["cgs.drs.score"] == burn
    # The MLP kernel's gate holds: the layers' read, then the launch (its
    # CUDA implementation's own prepare span does not run on the CPU).
    assert n["cgs.refine.prepare"] == n["cgs.refine.steps"] == batches
    assert n["cgs.refine.draw"] == 2 * batches  # z and labels; G


@pytest.mark.parametrize("case,refine,want", [
    ("generate", {}, lambda s: 1 + 3 * s["rounds"]),
    ("generate_cond", {"steps": 1},
     lambda s: 1 + 4 * s["rounds"]),  # the labels' fetch
    ("collab", {}, lambda s: 0),
    ("collab", {"shaping_target": 1e-6},  # each step reads sep > target
     lambda s: 3 * 2),
], ids=["generate", "generate_conditional", "collab", "collab_target"])
def test_host_syncs(case, refine, want):
    _, stats = _traced(case, **refine)
    assert profiling.summary()["counters"].get("host_syncs", 0) == want(stats)


def test_self_time_is_duration_less_children():
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            for _ in range(2):
                with profiling.span("inner"):
                    with profiling.span("leaf"):
                        torch.ones(64).sum()
            with profiling.span("leaf"):
                pass
    recs = profiling.records()
    s = profiling.summary()["spans"]
    assert {k: v["count"] for k, v in s.items()} == {"outer": 1, "inner": 2,
                                                     "leaf": 3}
    dur = {r.id: r.end_ns - r.start_ns for r in recs}
    for name, row in s.items():
        mine = [r for r in recs if r.name == name]
        kids = sum(dur[c.id] for c in recs
                   if c.parent in {r.id for r in mine})
        total = sum(dur[r.id] for r in mine)
        assert row["total_ms"] == pytest.approx(total / 1e6, abs=1e-9)
        assert row["self_ms"] == pytest.approx((total - kids) / 1e6,
                                               abs=1e-9)
    assert s["leaf"]["self_ms"] == pytest.approx(s["leaf"]["total_ms"])
    assert s["outer"]["self_ms"] < s["outer"]["total_ms"]


def test_export_under_profiler_holds_no_profiler_node(tmp_path):
    bundle, g, d = _pair()
    srv = ServingSampler(bundle, RefineConfig(**dict(REFINE, num_batches=1)),
                         method="collab")
    path = str(tmp_path / "sampler.pt2")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        export_sampler(srv, g, d, torch.Generator().manual_seed(5), path)
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"]
    assert not [t for t in targets if t.startswith("profiler.")]
    # The nodes tests/test_torch_export.py finds in an export without a
    # profiler: one kernel node of each a batch.
    assert collections.Counter(t for t in targets if t.startswith("cgs.")) \
        == {"cgs.refine_mlp.default": 1, "cgs.drs_accept_philox.default": 1}
    # The calibration, outside the trace, recorded its spans; the traced
    # round (the only accept step) opened none, so no record_function
    # reached the trace's graph.
    spans = profiling.summary()["spans"]
    assert "cgs.serve.calibrate" in spans
    assert "cgs.serve.accept" not in spans
