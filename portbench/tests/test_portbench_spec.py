"""`BENCHMARK.json` against the benchmark's contract, and every name it
gives found as a file: workloads, configurations, metric readers."""

import json
import os
import re

import pytest

from portbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.benchmark()


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w)
                                               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    path = os.path.join(spec.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_their_keys(kind, keys):
    for entry in BENCH[kind]:
        assert set(entry) == keys, entry["name"]
        assert NAME.match(entry["name"])
        assert _line(entry["why"])


def test_metric_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        e2e = {m["name"] for m in spec.metrics_for(BENCH, cell,
                                                   "end_to_end")}
        per = spec.metrics_for(BENCH, cell, "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_cells_and_configs_are_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        wl = spec.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        for m in spec.metrics_for(BENCH, w["name"], "per_layer"):
            spec.reader(m["name"])
    assert used == set(configs)
    for name, c in configs.items():
        assert c["file"] == f"portbench/configs/{name}.json"
        cfg = spec.config(name)
        assert cfg["source"] == c["source"] or cfg["source"].startswith(
            c["source"])
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_files_under_paths_are_named_from_name_characters():
    root = os.path.join(spec.ROOT, "portbench")
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert PATH.match(rel), rel


NUMBERS = {
    "train": {"loss_gap", "loss1_gap", "code_gap", "code1_gap", "grad_gap",
              "grad_median_gap", "change_gap", "change_median_gap"},
    "codec_batch": {"code_gap", "code_mean_gap", "code_flip_share",
                    "audio_gap"},
}


def test_workload_files_parse():
    for w in BENCH["workloads"]:
        wl = spec.workload(w["name"])
        json.dumps(wl)
        kind = wl["traffic"]["kind"]
        limits = wl["check"]["limits"]
        assert limits and set(limits) <= NUMBERS[kind], w["name"]
        assert all(isinstance(v, float) and v > 0 for v in limits.values())
