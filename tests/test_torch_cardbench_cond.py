"""The conditional cell of the port's benchmark (``imagenet64.collab_cond``)
on the CPU at a tiny size: 16x16x3, 8 filters, z 8, 5 classes, batches of
8, 4 batches after a burn-in of 16, shaping every 2nd batch.

* The plain conditional reference (``cardbench/reference/cond_dcgan.py``,
  ``cond_sampler.py``) against the port on the same seed weights in
  float32: G and D, then one whole collab call on the same generator.
* The cell's entry through ``harness.run_cell`` at the configuration's
  bf16: ``correct``, and each planted fault of
  ``cardbench/tests/cond_faults.py`` (and the fp8 control) breaks a limit
  that the clean run keeps.
* The two readers the cell adds, on a store filled by the entry's units,
  and the ``weight_casts`` counter of ``ops/nn.py``.
"""

from __future__ import annotations

import functools
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cardbench import harness
from cardbench.reference import cond_dcgan
from cardbench.reference import cond_sampler as ref
from cardbench.tests import cond_faults
from collaborative_gan_sampling_torch.data.images import ImageDataset
from collaborative_gan_sampling_torch.models.dcgan import DCGANDiscriminator
from collaborative_gan_sampling_torch.utils import profiling

WORKLOAD = "imagenet64.collab_cond"
SEED = 2 ** 31 + 23
TINY_MODEL = {"image_size": 16, "z_dim": 8, "g_base_filters": 8,
              "d_base_filters": 8, "num_classes": 5}
# The pool's labels span the dataset's 1,000 classes: 4,000 images give the
# model's 5 classes about 4 images each. Shaping at 10 times the preset's
# rate, so that the two steps of a tiny call move D enough for a fault in
# the real batch to show in the shaped D.
TINY = {"refine": {"batch_size": 8, "num_batches": 4, "burn_in": 16,
                   "shape_every": 2, "shaping_lr": 1e-3},
        "mix": {"real_images": 4000, "check": 1, "check_from": 1}}
CPU = torch.device("cpu")


class TinySpec(harness.Spec):
    """The benchmark's files, the configuration's model cut to TINY_MODEL
    and computed in ``dtype``."""

    def __init__(self, dtype: str = "bfloat16"):
        super().__init__()
        self.dtype = dtype

    def config(self, name):
        c = super().config(name)
        return dict(c, model=dict(c["model"], compute_dtype=self.dtype,
                                  **TINY_MODEL))


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _entry(dtype: str = "bfloat16"):
    spec = TinySpec(dtype)
    cell = harness.make_cell(spec, WORKLOAD, SEED, CPU, TINY)
    return spec.entry(cell.mix["entry"])(cell)


def _run(control: bool = False) -> dict:
    return harness.run_cell(TinySpec(), WORKLOAD, SEED, 0.1, False,
                            time.perf_counter(), CPU, TINY, control=control)


def test_reference_pair_is_the_ports(one_thread):
    e = _entry("float32")
    gen = torch.Generator().manual_seed(5)
    z, y = torch.randn(16, 8, generator=gen), torch.randint(0, 5, (16,),
                                                            generator=gen)
    m = e.cell.model
    with torch.no_grad():
        x = e.g(z, y)
        x_ref = cond_dcgan.generate(e.gw, z, y, m["image_size"],
                                    m["channels"], m["g_base_filters"])
        torch.testing.assert_close(x, x_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            e.d(x, y), cond_dcgan.discriminate(e.dw, x, y, m["image_size"]),
            rtol=1e-5, atol=1e-5)
        # The projection term is a part of the logit: another label moves it.
        assert (e.d(x, (y + 1) % 5) - e.d(x, y)).abs().max() > 1e-2


def test_reference_collab_call_is_the_ports(one_thread):
    e = _entry("float32")
    out = e.outputs(e.call(torch.Generator().manual_seed(9)))
    index = ref.ClassIndex(e.dataset.labels, TINY_MODEL["num_classes"])
    r = ref.collab_call(e.ref_model(), e.dataset.images, index,
                        torch.Generator().manual_seed(9), e.cell.refine)
    assert torch.equal(out["labels"], r["labels"])
    assert torch.equal(out["accepted"], r["accepted"])
    torch.testing.assert_close(out["samples"], r["samples"], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(out["logits"], r["logits"], rtol=1e-4,
                               atol=1e-5)
    assert out["losses"] == pytest.approx(r["losses"], rel=1e-5)
    assert set(out["dw"]) == set(r["dw"])
    for k, v in out["dw"].items():
        torch.testing.assert_close(v, r["dw"][k], rtol=1e-4, atol=1e-6)


def test_class_index_is_the_ports_table():
    labels = torch.tensor([3, 0, 3, 1, 3, 0], dtype=torch.int32)
    images = torch.arange(6, dtype=torch.uint8).view(6, 1, 1, 1)
    ds = ImageDataset(images=images, labels=labels)
    index = ref.ClassIndex(labels, 4)
    y = torch.tensor([0, 1, 2, 3, 3, 3, 1, 0])  # class 2 has no image
    got, _ = index.batch(images, torch.Generator().manual_seed(1), y)
    want, _ = ds.batch_by_labels(torch.Generator().manual_seed(1), y)
    assert torch.equal(got, want)


@pytest.mark.parametrize("change", [
    {"refine": {"per_class_drs": True}}, {"refine": {"noise": 0.1}},
    {"refine": {"space": "z"}}, {"refine": {"shaping_class_weight": True}},
    {"model": {"num_classes": 0}}],
    ids=["per_class_drs", "noise", "z_space", "class_weight",
         "unconditional"])
def test_entry_refuses_what_the_reference_lacks(change):
    spec = TinySpec()
    config = spec.config("imagenet64")
    for group, values in change.items():
        config[group] = dict(config[group], **values)
    cell = harness.Cell(WORKLOAD, config, spec.mix("collab_cond"), SEED, CPU)
    with pytest.raises(ValueError, match="does not implement"):
        spec.entry("collab_cond")(cell)


def test_cell_is_correct(one_thread):
    r = _run()
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert r["check"]["label_gap"]["value"] == 0


@functools.cache
def _clean_check() -> dict:
    return _run()["check"]


@pytest.mark.parametrize("fault", cond_faults.FAULTS + ["fp8_control"],
                         ids=cond_faults.IDS + ["fp8_control"])
def test_fault_breaks_a_limit(fault, monkeypatch, one_thread):
    clean = _clean_check()
    if fault == "fp8_control":
        control = _run(control=True)["_control"]
        faulty = {k: {"value": control[k], "limit": row["limit"]}
                  for k, row in clean.items()}
    else:
        with monkeypatch.context() as m:
            fault(m)
            faulty = _run()["check"]
    assert cond_faults.broken_limits(clean, faulty), faulty


def _share(parts, root):
    ms = {}
    for rec in profiling.records():
        ms[rec.name] = ms.get(rec.name, 0) + rec.end_ns - rec.start_ns
    return 100.0 * sum(ms.get(p, 0) for p in parts) / ms[root]


def test_readers_on_the_store(one_thread):
    e = _entry()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        units = [e.run_one(i) for i in range(2)]
    spec = harness.Spec()
    reading = harness.Reading(e.cell, 0.0, 1.0, [], None)
    share = spec.reader("real_batch_pct.collab_cond")(reading)
    want = _share(("cgs.collab.real_batch",), "cgs.collab.call")
    assert 0 < want < 100 and share == pytest.approx(want, rel=1e-9)
    # A batch: G (label table, project, two deconvs) and 11 D forwards
    # (10 steps and the logits; D: two convs, out, the projection table),
    # 7 casts each; a burn-in batch's score; two D forwards a shaping step.
    per_call = (units[0]["batches"] * 12 * 7 + e.burn * 7
                + units[0]["shaping_steps"] * 2 * 7)
    assert profiling.summary()["counters"]["weight_casts"] == 2 * per_call
    assert spec.reader("weight_casts_per_call.collab_cond")(reading) \
        == per_call
    # An empty store, and one with the root alone, as a program without
    # the span and the counter fills it.
    for root_only in (False, True):
        profiling.reset()
        if root_only:
            with profile(activities=[ProfilerActivity.CPU]):
                with profiling.span("cgs.collab.call"):
                    pass
        for name in ("real_batch_pct.collab_cond",
                     "weight_casts_per_call.collab_cond"):
            assert spec.reader(name)(reading) is None


@pytest.mark.parametrize("dtype,traced", [(torch.float32, True),
                                          (torch.bfloat16, False)],
                         ids=["float32_traced", "bfloat16_untraced"])
def test_weight_casts_count_conversions_under_a_profiler(dtype, traced):
    d = DCGANDiscriminator(16, 3, 8, dtype, 5).eval()
    x, y = torch.zeros(2, 16, 16, 3), torch.tensor([0, 4])
    profiling.reset()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            d(x, y)
    else:
        d(x, y)
    assert profiling.summary()["counters"].get("weight_casts", 0) == 0
    with profile(activities=[ProfilerActivity.CPU]):
        DCGANDiscriminator(16, 3, 8, torch.bfloat16, 5).eval()(x, y)
    assert profiling.summary()["counters"]["weight_casts"] == 7
    profiling.reset()
