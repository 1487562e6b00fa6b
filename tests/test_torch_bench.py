"""``bench_torch.py``, the port's counterpart of ``bench.py``: the analytic
FLOP count against ``bench.py``'s for every DCGAN preset, the measurement's
result on the CPU at a tiny size, the mnist path through the bf16 conv
kernel's wrapper once a round, and ``main``'s line with and without a card.
The JAX side (``bench.py``) is imported here only; ``bench_torch.py``
imports nothing of it."""

import json

import pytest
import torch

import bench
import bench_torch
from collaborative_gan_sampling_torch.config import get_preset, list_presets
from collaborative_gan_sampling_tpu.config import get_preset as jax_preset

DCGAN_PRESETS = [p for p in list_presets()
                 if get_preset(p).model.kind == "dcgan"]
KEYS = {"samples_per_sec", "sec_per_batch", "batch_size", "steps_k",
        "rounds", "mfu_pct", "device"}


@pytest.mark.parametrize("steps_k", [1, 10])
@pytest.mark.parametrize("preset", DCGAN_PRESETS)
def test_pipeline_flops_match_bench(preset, steps_k):
    assert bench_torch._pipeline_flops_per_sample(
        get_preset(preset).model, steps_k) == \
        bench._pipeline_flops_per_sample(jax_preset(preset).model, steps_k)


def test_mnist_flops_are_bench_docstring_counts():
    """bench.py's hand counts: D forward 20.71 MFLOP, G 21.95 MFLOP."""
    m = get_preset("mnist").model
    d_fwd = (bench_torch._pipeline_flops_per_sample(m, 1)
             - bench_torch._pipeline_flops_per_sample(m, 0)) / 2
    g = bench_torch._pipeline_flops_per_sample(m, 0) - d_fwd
    assert round(d_fwd / 1e6, 2) == 20.71 and round(g / 1e6, 2) == 21.95
    assert bench_torch.BF16_PEAK_FLOPS == 989e12


def test_measure_on_cpu_goes_through_the_conv_kernel(monkeypatch):
    """The mnist preset refines through the bf16 conv kernel's wrapper once
    a round: rounds x (1 + repeats) calls; the result has bench.py's keys,
    a positive rate and no MFU off the card."""
    from collaborative_gan_sampling_torch.sampling import refine

    calls = []
    wrapped = refine.fused_refine_conv28_bf16

    def spy(params, x0, steps, rate):
        calls.append((tuple(x0.shape), steps))
        return wrapped(params, x0, steps, rate)

    monkeypatch.setattr(refine, "fused_refine_conv28_bf16", spy)
    out = bench_torch.measure_refine_throughput(
        batch_size=8, steps_k=2, rounds=2, repeats=1, device="cpu")
    assert set(out) == KEYS
    assert out["samples_per_sec"] > 0 and out["sec_per_batch"] > 0
    assert (out["batch_size"], out["steps_k"], out["rounds"]) == (8, 2, 2)
    assert out["mfu_pct"] is None and out["device"] == "cpu"
    assert calls == [((8, 28, 28, 1), 2)] * 4


def test_run_is_seeded():
    """The same seed gives the same sum; another seed another."""
    run, cfg, dev = bench_torch.make_run(4, 1, rounds=1, device="cpu")
    assert cfg.name == "mnist" and dev.type == "cpu"
    assert run(5) == run(5) != run(6)


def test_main_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] is None and "no CUDA device" in line["error"]
    assert line["metric"] == "refined_samples_per_sec_per_chip_k10_mnist"
    assert line["vs_baseline"] is None


def test_main_on_cpu(monkeypatch, capsys):
    """One line with bench.py's keys (secondary presets nested), the
    device named, vs_baseline null."""
    seen = []

    def fake(batch_size, steps_k, preset="mnist", device=None):
        seen.append((preset, batch_size, steps_k, str(device)))
        return {"samples_per_sec": 123.45, "mfu_pct": None}

    monkeypatch.setattr(bench_torch, "measure_refine_throughput", fake)
    assert bench_torch.main(["--device", "cpu",
                             "--secondary", "celeba,imagenet64"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen == [("mnist", 2048, 10, "cpu"), ("celeba", 512, 10, "cpu"),
                    ("imagenet64", 512, 10, "cpu")]
    for entry in (line, line["celeba"], line["imagenet64"]):
        assert {"metric", "value", "unit", "vs_baseline",
                "mfu_pct"} <= set(entry)
        assert entry["value"] == 123.5 and entry["vs_baseline"] is None
    assert line["device"] == "cpu"


def test_secondary_failure_raises(monkeypatch):
    def fake(batch_size, steps_k, preset="mnist", device=None):
        if preset == "celeba":
            raise RuntimeError("celeba broke")
        return {"samples_per_sec": 1.0, "mfu_pct": None}

    monkeypatch.setattr(bench_torch, "measure_refine_throughput", fake)
    with pytest.raises(RuntimeError, match="celeba broke"):
        bench_torch.main(["--device", "cpu", "--secondary", "celeba"])
