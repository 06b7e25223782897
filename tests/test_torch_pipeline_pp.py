"""The two-stage pipeline on the CPU (mirrors tests/test_pipeline_pp.py):
the port's `two_stage_pipeline` and `pipeline_extract` over 2 stage ranks
(threads over gloo) against the JAX package's on its 2-device stage mesh,
on the JAX tests' inputs and tolerances: the pipeline bit-equal to the
sequential stage1(stage0(x)) map, and the extract pipeline's keypoints
within 1e-6 (masks equal) of single-device detection. The PP-vs-DP
comparison runs both on the same images and checks that they agree;
their times are reported, not compared (a CPU speed assertion would be
unsteady beside other test workers; the card measures it in
chip_smoke.py phase 59).
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from keypoint_bench_tpu.models import get_model as jax_model
from keypoint_bench_tpu.ops.detect import DetectParams as JaxDetectParams
from keypoint_bench_tpu.parallel.pipeline import \
    make_stage_mesh as jax_stage_mesh
from keypoint_bench_tpu.parallel.pipeline import \
    pipeline_extract as jax_pipeline_extract
from keypoint_bench_tpu.parallel.pipeline import \
    two_stage_pipeline as jax_pipeline
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection_batch
from keypoint_bench_tpu_torch.parallel.evaluate import block
from keypoint_bench_tpu_torch.parallel.mesh import thread_ranks
from keypoint_bench_tpu_torch.parallel.pipeline import (make_stage_mesh,
                                                        pipeline_extract,
                                                        two_stage_pipeline)
from keypoint_bench_tpu_torch.weights import load_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DP = dict(nms_dist=4, border_dist=4, top_k=64, max_nms_iter=8)


def _staged(fn):
    """fn(stage mesh) on 2 thread ranks; both ranks' results, equal."""
    outs = thread_ranks(lambda mesh: fn(make_stage_mesh(mesh)), 2,
                        device="cpu")
    a, b = (tree_leaves(o) for o in outs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    return outs


def test_two_stage_pipeline_matches_sequential():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)

    def stages(tanh, mm, xp):
        def stage0(x):
            return tanh(mm(x, w)), x.sum(-1)

        def stage1(act):
            h, s = act
            return {"y": h * 2.0 + s[:, None], "m": s > 0.0}
        return stage0, stage1

    j0, j1 = stages(jnp.tanh, jnp.matmul, jnp)
    want_j = jax_pipeline(jax_stage_mesh(), j0, j1, jnp.asarray(xs))
    w_t = torch.from_numpy(w)
    t0, t1 = stages(torch.tanh, lambda x, _: x @ w_t, torch)
    xs_t = torch.from_numpy(xs)
    want = [t1(t0(x)) for x in xs_t]
    for got in _staged(lambda m: two_stage_pipeline(m, t0, t1, xs_t)):
        assert torch.equal(got["y"], torch.stack([o["y"] for o in want]))
        assert torch.equal(got["m"], torch.stack([o["m"] for o in want]))
        np.testing.assert_allclose(got["y"].numpy(),
                                   np.asarray(want_j["y"]), atol=1e-5)
        np.testing.assert_array_equal(got["m"].numpy(),
                                      np.asarray(want_j["m"]))


@pytest.fixture(scope="module")
def alike():
    params = load_params("Alike")
    return get_model("Alike")(params).eval()


def test_pipeline_extract_matches_single_device_and_jax(alike):
    imgs = np.random.default_rng(1).random((4, 64, 64, 3), np.float32)
    x = torch.from_numpy(imgs)
    dp = DetectParams(**DP)
    with torch.inference_mode():
        score, _ = alike(x)
    kref, vref = detection_batch(score[..., 0], dp)
    for kpts, valid in _staged(
            lambda m: pipeline_extract(m, alike, dp, x, 2)):
        np.testing.assert_allclose(kpts.numpy(), kref.numpy(), rtol=0,
                                   atol=1e-6)
        assert torch.equal(valid, vref)
    jp = jax_load_params("Alike")
    kj, vj = jax_pipeline_extract(jax_stage_mesh(), jax_model("Alike"), jp,
                                  JaxDetectParams(**DP), jnp.asarray(imgs),
                                  n_micro=2)
    # against the JAX pipeline at tests/test_torch_pipeline.py's
    # tolerances between the packages: positions and masks equal, scores
    # within 1e-5 (the forwards' float summation order)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kpts[..., :2].numpy(),
                                  np.asarray(kj)[..., :2])
    np.testing.assert_allclose(kpts[..., 2].numpy(), np.asarray(kj)[..., 2],
                               atol=1e-5)


def test_pp_vs_dp_measured_comparison(alike):
    """The 2-stage pipeline and the data-parallel step (each of 2 ranks
    detects its block of the 8 images) give the same keypoints; both
    times are printed."""
    imgs = torch.from_numpy(
        np.random.default_rng(2).random((8, 64, 64, 3), np.float32))
    dp = DetectParams(**DP)

    def run_pp():
        t0 = time.perf_counter()
        out = _staged(lambda m: pipeline_extract(m, alike, dp, imgs, 4))[0]
        return out, time.perf_counter() - t0

    def run_dp():
        def rank(mesh):
            with torch.inference_mode():
                score, _ = alike(imgs[block(mesh, len(imgs))])
            k, v = detection_batch(score[..., 0], dp)
            return (torch.cat(mesh.all_gather(k)),
                    torch.cat(mesh.all_gather(v)))
        t0 = time.perf_counter()
        out = thread_ranks(rank, 2, device="cpu")[0]
        return out, time.perf_counter() - t0

    (k_pp, v_pp), t_pp = run_pp()
    (k_dp, v_dp), t_dp = run_dp()
    print(f"PP {t_pp * 1e3:.1f} ms, DP {t_dp * 1e3:.1f} ms (CPU, 8 images "
          f"at 64^2)")
    assert torch.equal(v_pp, v_dp)
    np.testing.assert_allclose(k_pp.numpy(), k_dp.numpy(), rtol=0, atol=1e-6)
