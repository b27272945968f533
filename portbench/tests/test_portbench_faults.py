"""The check fails what it should, at sizes a CPU holds (full widths and
depth, small images and batches): a whole run past the harness's look for a
card, with a fault planted under the timed path, comes out not correct; a
sound run of a serving cell comes out correct; and the control (the
reference in the program's place, one precision below the configuration's)
fails at least one of each cell's limits."""

import pytest
import torch

from portbench import harness as H
from portbench.run import Run, run_cell

CPU = torch.device("cpu")
SMALL = {
    "resnet50.serve_b32": {"batch": 2, "pool": 2, "image_size": 64, "warm_batches": 1,
                           "sample_every": 1, "check_max": 3},
    "ssd300.detect_b4": {"batch": 1, "pool": 2, "image_size": 268, "warm_requests": 1,
                         "sample_every": 1, "check_max": 2},
    "resnet50.train_b32": {"batch": 4, "pool": 3, "image_size": 64},
}
FAULTS = [("resnet50.serve_b32", "answer"), ("ssd300.detect_b4", "answer"),
          ("resnet50.train_b32", "unchanged"), ("resnet50.train_b32", "half")]
CELLS = ["resnet50.serve_b32", "ssd300.detect_b4", "resnet50.train_b32"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    res = run_cell(cell, 2**31 + 21, 0.3, False, dev=CPU, overrides=SMALL[cell], fault=fault)
    assert res["correct"] is False, res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS[:2])
def test_a_sound_run_is_correct(cell):
    """The serving cells only: the training cell's limits hold at its own
    size (batch statistics over 32 images of 224x224), not at a CPU's."""
    res = run_cell(cell, 2**31 + 22, 0.3, False, dev=CPU, overrides=SMALL[cell])
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    c, cfg = H.load_cell(cell)
    r = Run(c, cfg, 2**31 + 23, 0.3, False, CPU, 0.0, SMALL[cell])
    got = H.traffic_driver(c["kind"]).control(r)
    assert not H.judge(H.checks_of(got, c["limits"])), got
