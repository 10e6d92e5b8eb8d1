"""The correctness check's control on the card: the lower precision
stands in the program's place (TF32 with the configurations' FP32) and
the check must call it not correct. The training cells' control is the
plain reference with TF32 on; the codec's is the program's own TF32 mode
(`set_precision('high')`). At the cells' batch on shorter signals, so
that a test run holds it; the cells' own size is measured by
`portbench/run.py --control tf32`."""

import json

import pytest

from portbench.lib import harness

CELLS = {
    "breathing_default.recon": {
        "workload": {"traffic": {"length": 36000, "pool": 3}}},
    "encodec_24khz.batch16": {
        "workload": {"traffic": {"length": 48000, "pool": 2}}},
}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [3000000101, 3000000102, 3000000103])
def test_tf32_control_is_not_correct(card, cell, seed, capsys):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "1", "--trace", "0", "--control", "tf32"],
                      overrides=CELLS[cell])
    out = capsys.readouterr()
    assert rc == 0, out.err
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
