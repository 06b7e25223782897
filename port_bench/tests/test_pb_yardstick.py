"""The yardstick's arithmetic, pinned: the bounds at the shapes PERF.md
quotes, the window's rate and percentile."""
import math

import numpy as np
import pytest
import torch

from port_bench import yardstick as Y
from port_bench.harness import Run
from port_bench.spec import load, reader


def test_match_bound_at_16_pairs():
    ms, by = Y.match_bound(16, 1000, 1000, 65)
    assert by == "operations"
    assert round(ms, 4) == 0.0334


def test_nms_bound_counts_rounds():
    # 16 maps of 512 x 512 that needed 5 rounds each
    ms, by = Y.nms_bound(16, 512, 512, 80)
    ops = (80 * 21 + 16 * 14) * 512 * 512
    assert by == "operations"
    assert ms == pytest.approx(ops / Y.PEAK_F32_OPS * 1e3)
    ms0, by0 = Y.nms_bound(16, 512, 512, 0)
    assert by0 == "bytes"
    assert ms0 == pytest.approx(2 * 16 * 512 * 512 * 4 / Y.PEAK_BYTES * 1e3)


def test_sample_bound_reads_distinct_values_once():
    # every keypoint on one pixel: one value a channel of each map's taps
    shapes = [(1, 16, 64, 64), (1, 16, 32, 32), (1, 16, 8, 8), (1, 16, 4, 4)]
    one = torch.full((1, 10), 20.0)
    ms1, _ = Y.sample_bound(shapes, 4, one, one, 64, 64)
    spread = torch.linspace(5.0, 55.0, 10)[None]
    ms2, _ = Y.sample_bound(shapes, 4, spread, spread, 64, 64)
    assert 0 < ms1 < ms2


def test_rate_is_all_work_over_all_time():
    assert Y.rate(3200, 4.0) == 800.0
    with pytest.raises(ValueError):
        Y.rate(1, 0.0)


def test_p95_of_every_step():
    steps = list(range(1, 101))
    assert Y.p95(steps) == pytest.approx(95.05)
    assert Y.p95([7.0]) == 7.0


def test_end_to_end_readers():
    run = Run(load("alike_t.repeatability.b32"), setup_s=12.5,
              step_s=[0.04] * 19 + [0.08], window_s=1.0, pairs=640)
    assert reader("pairs_per_s").read(run) == 640.0
    assert reader("setup_s").read(run) == 12.5
    assert reader("step_ms_p95").read(run) == pytest.approx(
        float(np.percentile(run.step_s, 95)) * 1e3)


def test_step_mfu_counts_the_sparse_head_at_the_keypoints():
    mfu = reader("step_mfu")
    cell = load("alike_t.repeatability.b32")
    dense = dict(cell.config, sparse_desc=False)
    k, hw = 1000, 512 * 512
    gap = mfu.pair_flops(dense, 512) - mfu.pair_flops(cell.config, 512)
    assert gap == pytest.approx(2 * 2.0 * 64 * 64 * (hw - k))
    r2d2 = mfu.pair_flops(load("r2d2.repeatability.b4").config, 512)
    assert 2 * 250e9 < r2d2 < 2 * 260e9
    assert not math.isnan(r2d2)
