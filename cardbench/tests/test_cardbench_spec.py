"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name; a configuration, a mix, an entry, a metric and a cell
added as new files are picked up with no edit."""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from cardbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert w in moved.get("workloads", WORKLOADS)


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    spec = harness.Spec()
    for w in WORKLOADS:
        e2e = [m["name"] for m in spec.metrics(w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(w, True)
        assert spec.workload(w)["chips"] == 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_files_found_by_name(workload):
    spec = harness.Spec()
    w = spec.workload(workload)
    config, mix = spec.config(w["config"]), spec.mix(w["traffic"])
    assert callable(spec.entry(mix["entry"]))
    assert config["reduced"] == [] and config["preset"] == w["config"]
    assert set(spec.limits(workload))
    for m in spec.metrics(workload, False) + spec.metrics(workload, True):
        assert callable(spec.reader(m["name"]))
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (REPO / entry["file"]).is_file()


def test_configs_hold_the_presets_values():
    import dataclasses

    from collaborative_gan_sampling_torch.config import get_preset

    for c in BENCH["configs"]:
        config = json.loads((REPO / c["file"]).read_text())
        preset = get_preset(config["preset"])
        for group, obj in (("model", preset.model),
                           ("refine", preset.refine)):
            asdict = dataclasses.asdict(obj)
            assert {k: asdict[k] for k in config[group]} == config[group]


# An entry that no cell of the repository uses: calls of the program's G
# alone, judged against the reference's G on the same z.
G_ONLY = '''
import torch

from cardbench.dcgan_entry import DcganEntry, worst


class Entry(DcganEntry):
    def z(self, i):
        return torch.randn((self.cell.mix["batch"], self.cell.model["z_dim"]),
                           generator=self.cell.generator("call", i),
                           device=self.cell.device)

    def warm(self):
        self.run_one(-1)

    def run_one(self, i):
        with torch.no_grad():
            x = self.bundle.generate(self.g, self.z(i))
        if i == 0:
            self.kept[i] = x.float()
        return {"batches": 1, "candidates": x.shape[0]}

    def _judge(self, control):
        x_ref = self.ref_model().g(self.z(0))
        gap = float((self.kept[0].to(x_ref.device) - x_ref).abs().max())
        return worst([{"x_gap": gap}]), {}
'''


def _copy(tmp_path) -> Path:
    root = tmp_path / "cardbench"
    shutil.copytree(REPO / "cardbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def test_new_entry_is_a_new_file(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "entries" / "g_only.py").write_text(G_ONLY)
    (root / "traffic" / "g_b64.json").write_text(
        json.dumps({"entry": "g_only", "batch": 64}))
    (root / "limits" / "mnist.g_b64.json").write_text(
        json.dumps({"x_gap": 0.12}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mnist.g_b64", "config": "mnist",
                               "traffic": "g_b64", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        m.setdefault("workloads", WORKLOADS + ["mnist.g_b64"])
    spec = harness.Spec(root, bench)
    result = harness.run_cell(spec, "mnist.g_b64", 7, 0.1, False,
                              time.perf_counter(), torch.device("cpu"))
    assert result["correct"] and result["attempted"] >= 1
    assert result["check"]["x_gap"]["value"] < 0.12
    assert all(p.read_bytes() == b for p, b in before.items())


def test_dcgan_entries_refuse_what_the_reference_lacks(tmp_path):
    spec = harness.Spec()
    for change in ({"refine": {"noise": 0.1}},
                   {"model": {"num_classes": 10}}):
        config = spec.config("mnist")
        for group, values in change.items():
            config[group] = dict(config[group], **values)
        cell = harness.Cell("mnist.collab", config, spec.mix("collab"), 3,
                            torch.device("cpu"))
        with pytest.raises(ValueError, match="does not implement"):
            spec.entry("collab")(cell)


def test_new_config_mix_metric_and_cell_are_new_files(tmp_path):
    root = _copy(tmp_path)
    config = json.loads((root / "configs" / "mnist.json").read_text())
    config["refine"]["rate"] = 0.03
    (root / "configs" / "mnist_r3.json").write_text(json.dumps(config))
    mix = json.loads((root / "traffic" / "refine_b2048.json").read_text())
    mix["rounds"] = 3
    (root / "traffic" / "refine_r3.json").write_text(json.dumps(mix))
    (root / "limits" / "mnist_r3.refine_r3.json").write_text(
        (root / "limits" / "mnist.refine_b2048.json").read_text())
    (root / "metrics" / "rounds_per_call.py").write_text(
        "def read(r):\n    return r.total('batches') / len(r.units)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mnist_r3.refine_r3",
                               "config": "mnist_r3", "traffic": "refine_r3",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "rounds_per_call", "unit": "rounds",
                               "better": "lower", "source": "host_clock",
                               "layer": "the test", "moves": "setup_s",
                               "workloads": ["mnist_r3.refine_r3"]})
    spec = harness.Spec(root, bench)
    cell = harness.make_cell(spec, "mnist_r3.refine_r3", 5,
                             torch.device("cpu"))
    assert cell.refine["rate"] == 0.03 and cell.mix["rounds"] == 3
    assert [m["name"] for m in spec.metrics("mnist_r3.refine_r3", True)] \
        == ["rounds_per_call"]
    tiny = {"refine": {"batch_size": 8}, "mix": {"batch": 8, "check": 1,
                                                  "check_from": 1}}
    result = harness.run_cell(spec, "mnist_r3.refine_r3", 5, 0.1, False,
                              time.perf_counter(), torch.device("cpu"), tiny)
    assert result["correct"]
    reading = harness.Reading(cell, 0.0, 1.0, [{"batches": 3,
                                                 "traced": False}], None)
    assert spec.reader("rounds_per_call")(reading) == 3
