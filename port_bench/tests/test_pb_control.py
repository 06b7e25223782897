"""On the card, at each cell's own size: the lower precisions the check
must refuse (TF32 in the reference put in the program's place; the
port's bfloat16 weights) come out not correct."""
import time

import pytest

from port_bench import harness

CELLS = ["alike_t.repeatability.b32", "r2d2.repeatability.b4",
         "alike_t.auc_8pt.b16"]


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["tf32", "bf16"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, control):
    r = harness.run(cell, 987654321, 1.0, False, time.perf_counter(),
                    control=control)
    assert r["correct"] is False
    over = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert {"keypoints_mismatch", "matches_mismatch"} & set(over), over
