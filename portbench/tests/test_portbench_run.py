"""`run.py` end to end at a tiny size on the CPU: the command refuses to
run without a card and prints no result; the harness driven on the CPU
runs every step of a cell and reports no device metric."""

import json
import os
import subprocess
import sys

import pytest

from portbench.lib import harness, spec

TINY = {
    "breathing_default.recon": {
        "workload": {"traffic": {"batch": 2, "length": 30000, "pool": 3},
                     "trace": {"iterations": 2}},
        "config": {"config": {"model": {"filters": 8, "dimension": 16,
                                        "bins": 16}}}},
    "encodec_24khz.batch16": {
        "workload": {"traffic": {"batch": 2, "length": 4800, "pool": 2},
                     "trace": {"batches": 4}}},
}


def run_tiny(cell, capsys, trace=0, seed=3000000001):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", str(trace)],
                      allow_cpu=True, overrides=TINY[cell])
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "portbench", "run.py"),
         "--workload", "encodec_24khz.batch16", "--seed", "1",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        env=env, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA card" in p.stderr


def test_unknown_cell_is_refused(capsys):
    assert harness.main(["--workload", "no_such.cell", "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) != 0


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cpu_run_reports_no_device_metric(cell, trace, capsys):
    line, err = run_tiny(cell, capsys, trace)
    assert list(line)[-1] == "checks"
    assert line["metrics"] == {}
    assert line["device"]["platform"] == "cpu"
    assert line["attempted"] > 0 and line["failed"] == 0
    for name, c in line["checks"].items():
        assert c["limit"] == spec.workload(cell)["check"]["limits"][name]
        assert f"check {name} " in err
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_cpu_run_agrees_with_the_reference(cell, capsys):
    line, _ = run_tiny(cell, capsys, seed=7)
    for name, c in line["checks"].items():
        # float32 on both sides; the change is Adam's ±lr·sign(g), which
        # flips on elements whose gradient is rounding
        assert c["value"] < (1e-2 if name.startswith("change") else 1e-4), \
            name


@pytest.mark.parametrize("kind", sorted({spec.workload(w["name"])["traffic"]
                                         ["kind"] for w in
                                         spec.benchmark()["workloads"]}))
def test_traffic_kinds_find_their_driver_by_name(kind):
    driver = harness._driver(kind)
    assert driver.__name__ == f"portbench.lib.{kind}_cell"
    assert callable(driver.run)


@pytest.mark.parametrize("kind", ["no_such_kind", "../harness", "train.x"])
def test_a_kind_without_a_driver_is_refused(kind):
    with pytest.raises(ValueError):
        harness._driver(kind)
