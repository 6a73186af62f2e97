"""The lower-precision control, the reference put in the program's place
with its per-pixel arithmetic in bfloat16, comes out not correct in every
cell, while the float32 stand-in (the reference against itself) comes out
correct, and so does a fault planted in the float32 stand-in of a fit. At
a small size on the CPU; ``tools/control.py`` reads the same at the cells'
own sizes on the card."""

import pytest
import torch

from conftest import TINY, manifest


def _run(workload, dtype, fault="none"):
    import run
    from lib import control, program

    prog = control.stand_in(program.load(), dtype, fault)
    return run.run_cell(workload, 2718281828, 0.0, False, "cpu", prog=prog,
                        overrides=TINY[workload], log=lambda m: None,
                        man=manifest())


@pytest.mark.parametrize("workload", sorted(TINY))
def test_bfloat16_control_is_not_correct(workload):
    res = _run(workload, torch.bfloat16)
    assert not res["correct"]
    assert any(r["value"] > r["limit"] for r in res["checks"].values())


@pytest.mark.parametrize("workload", sorted(TINY))
def test_float32_stand_in_is_correct(workload):
    res = _run(workload, torch.float32)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_faults_planted_in_the_stand_in_are_not_correct(fault):
    res = _run("mini1k.jobs", torch.float32, fault)
    assert not res["correct"], res["checks"]
