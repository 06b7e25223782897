"""`debug_nans: true` on the CPU: the port's runner under
`utils.debug_nans.DebugNans` against the JAX runner under
`jax.debug_nans(True)`, on a small synthetic config of every task type
(64^2, 2 or 3 frames or pairs, top_k 100). Both packages finish, the
port with the results of its run without the flag (exactly equal), or
both raise FloatingPointError; `jax.debug_nans` leaves a finished run's
results as they are, so the JAX side runs once, with the flag. A NaN
planted in one pixel of the first image makes both raise.
"""
import copy

import numpy as np
import pytest
import torch

from keypoint_bench_tpu import runner as jax_runner
from keypoint_bench_tpu_torch import runner
from keypoint_bench_tpu_torch.utils.debug_nans import (DebugNans,
                                                       check_kernel_outputs)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 64
EP = {"nms_dist": 4, "threshold": 0, "border_dist": 8, "top_k": 100,
      "min_score": 0.0}
SEQ = {"type": "synthetic_sequence", "num_frames": 3, "image_size": S,
       "seed": 0}
SPLAT = {"type": "synthetic_splat_sequence", "num_frames": 3,
         "image_size": S}
HOMO = {"type": "synthetic_homography", "num_pairs": 2, "image_size": S}
OF = {"type": "optical_flow",
      "optical_flow_params": {"distance": 3, "win_size": 7, "levels": 2,
                              "interation": 5}}
BF = {"type": "brute_force"}
CASES = {
    "repeatability": dict(data_params=HOMO, task_params={"th": 3}),
    "MHA": dict(data_params=HOMO, matcher_params=BF),
    "AUC": dict(data_params={"type": "synthetic_se3", "num_pairs": 2,
                             "image_size": S}, matcher_params=BF),
    "FundamentalMatrix": dict(data_params=SEQ, matcher_params=OF,
                              task_params={"th": 3}),
    "FundamentalMatrixRansac": dict(data_params=SEQ, matcher_params=BF,
                                    task_params={"th": 3}),
    "visual_odometer": dict(data_params=SPLAT, matcher_params=BF),
    "VisualizeTrackingError": dict(data_params=HOMO, matcher_params=OF),
}


def _cfg(name, out, debug_nans):
    return dict(model_type="Alike", task_type=name,
                extractor_params=EP, output_dir=str(out),
                debug_nans=debug_nans, **copy.deepcopy(CASES[name]))


def _run(pkg, cfg):
    """The run's results, or the FloatingPointError it raised."""
    try:
        if pkg == "jax":
            return jax_runner.Evaluator(jax_runner.EvalConfig(**cfg)).run()
        return runner.Evaluator(runner.EvalConfig(**cfg), "cpu").run()
    except FloatingPointError as e:
        return e


def _assert_results_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            np.testing.assert_equal(np.asarray(got[k], np.float64),
                                    np.asarray(want[k], np.float64), k)


@pytest.mark.parametrize("name", list(CASES))
def test_debug_nans_finishes_or_raises_as_jax(tmp_path, name):
    jax_out = _run("jax", _cfg(name, tmp_path, True))
    plain = _run("torch", _cfg(name, tmp_path, False))
    got = _run("torch", _cfg(name, tmp_path, True))
    assert not isinstance(plain, FloatingPointError)
    assert isinstance(got, FloatingPointError) == isinstance(
        jax_out, FloatingPointError), (got, jax_out)
    if not isinstance(got, FloatingPointError):
        _assert_results_equal(got, plain)


class _NanPixel:
    """The dataset with a NaN in one pixel of the first pair's image0."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = self.ds[i]
        if i == 0:
            item = dict(item)
            img = np.array(item["image0"], np.float32)
            img[S // 2, S // 2, 0] = np.nan
            item["image0"] = img
        return item


def test_planted_nan_raises_in_both(tmp_path, monkeypatch):
    for mod in (jax_runner, runner):
        get = mod.get_dataset
        monkeypatch.setattr(mod, "get_dataset",
                            lambda p, get=get: _NanPixel(get(p)))
    for pkg in ("jax", "torch"):
        out = _run(pkg, _cfg("repeatability", tmp_path / pkg, True))
        assert isinstance(out, FloatingPointError), (pkg, out)
        assert "nan" in str(out)


def test_mode_checks_operations_and_kernel_outputs():
    """An operation's NaN output raises naming the operation; a constant
    NaN (a sentinel) and a select that drops it do not; a kernel's NaN
    output raises under the mode and passes outside it."""
    nan = torch.tensor([float("nan"), 1.0])
    with DebugNans():
        x = torch.zeros(2)
        sentinel = torch.full_like(x, float("nan"))
        assert torch.equal(torch.where(x == 0, x, sentinel), x)
        with pytest.raises(FloatingPointError, match="aten.div"):
            x / x
        with pytest.raises(FloatingPointError, match="kernel kbt_x"):
            check_kernel_outputs("kbt_x", x, nan)
        check_kernel_outputs("kbt_x", x, torch.isnan(nan))
    check_kernel_outputs("kbt_x", nan)
