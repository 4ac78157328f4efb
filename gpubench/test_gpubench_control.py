"""The controls, put in the program's place, must come out not correct:
the reference one precision lower than the configuration states (the
serving latency arithmetic in bfloat16; the microcircuit's delivery
product in TF32, which only the card has)."""
from __future__ import annotations

import time

import pytest
import torch

from gpubench.harness import runner


def run(root, cell, device):
    return runner.run_cell(root, cell, seed=2**31 + 99, seconds=0.4,
                           trace=False, device=device,
                           t_start=time.perf_counter(), control=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA device")
    return "cuda"


def test_bf16_latency_control_is_not_correct(tiny_root):
    line = run(tiny_root, "tiny_contended", "cpu")
    assert not line["correct"]
    assert line["compared"]["float_gap"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny_torus", "tiny_alltoall"])
def test_tf32_delivery_control_is_not_correct(tiny_root, card, cell):
    line = run(tiny_root, cell, card)
    assert not line["correct"]
