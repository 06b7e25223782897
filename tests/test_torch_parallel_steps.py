"""The port's data-parallel MHA and AUC steps on the CPU against the JAX
package's `sharded_mha_step` and `sharded_auc_step` on the conftest's
mesh (mirrors tests/test_parallel_mha.py and test_parallel_auc.py), ranks
as threads over gloo, world sizes 1, 2 and 4.

The port's steps are fed the JAX steps' RANSAC draws (JAX's
`_sample_minimal` on each pair's split key, over the port's match mask).
Tolerances: MHA hits equal (the corner test on RANSAC-H from the same
samples and matches). AUC (8-point; the five-point solver is held as
test_parallel_auc.py holds it, to its own gates): essential RANSAC on raw normalized
coordinates is ill-conditioned in float32, and the two packages' LAPACK
solves part on noisy sets (tests/test_torch_auc.py), so as
test_parallel_auc.py does the step is held to what is stable: the same
failed pairs, inlier counts within 5% of JAX's, and pose errors within 1
degree of JAX's on the pairs whose inlier counts are equal. World sizes
1, 2 and 4 give bit-equal per-pair outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.datasets.synthetic import SyntheticSE3Dataset
from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.models import get_model as jax_model
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.ops.detect import DetectParams as JaxDetectParams
from keypoint_bench_tpu.parallel.evaluate import (sharded_auc_step as
                                                  jax_auc_step)
from keypoint_bench_tpu.parallel.evaluate import (sharded_mha_step as
                                                  jax_mha_step)
from keypoint_bench_tpu.parallel.mesh import make_mesh
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.parallel import evaluate as tev
from keypoint_bench_tpu_torch.parallel.mesh import thread_ranks
from keypoint_bench_tpu_torch.weights import load_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


def _jax_draws(monkeypatch, keys):
    def draws(mask, seeds, n_hyp, size):
        return torch.stack([torch.from_numpy(np.array(jr._sample_minimal(
            keys[int(s)], jnp.asarray(mask[j].cpu().numpy()), n_hyp,
            size))).long() for j, s in enumerate(seeds)])

    monkeypatch.setattr(tev, "pair_samples", draws)


def _worlds(fn):
    """fn's outputs at world size 1, asserted bit-equal on every rank of
    world sizes 2 and 4."""
    one = thread_ranks(fn, 1, device="cpu")[0]
    for n in (2, 4):
        for out in thread_ranks(fn, n, device="cpu"):
            for a, b in zip(out, one):
                assert torch.equal(a, b), n
    return one


def test_sharded_mha_matches_jax(highest, monkeypatch):
    n, s = 8, 128
    ds = get_dataset({"type": "synthetic_homography", "num_pairs": n,
                      "image_size": s, "seed": 5})
    items = [ds[i] for i in range(n)]
    batch = [np.stack([f(x) for x in items]) for f in (
        lambda x: x["image0"], lambda x: x["image1"],
        lambda x: x["warp01_params"]["homography_matrix"],
        lambda x: x["warp10_params"]["homography_matrix"],
        lambda x: [float(x["warp01_params"]["width"]),
                   float(x["warp01_params"]["height"])])]
    dp = dict(nms_dist=4, border_dist=8, top_k=200)
    keys = jax.random.split(jax.random.key(0), n)
    mesh = make_mesh(n_data=8)
    step = jax_mha_step(mesh, jax_model("Alike"), jax_load_params("Alike"),
                        JaxDetectParams(**dp))
    with mesh:
        want = np.asarray(step(*[jnp.asarray(x) for x in batch],
                               jnp.full((n,), float(s)), keys))
    _jax_draws(monkeypatch, keys)
    model = get_model("Alike")(load_params("Alike"))

    def fn(mesh):
        return (tev.sharded_mha_step(mesh, model, DetectParams(**dp))(
            *batch, list(range(n))),)

    hits = _worlds(fn)[0]
    np.testing.assert_array_equal(hits.numpy(), want)
    assert hits.shape == (n, 3) and float(hits[:, 2].mean()) > 0.5


@pytest.fixture(scope="module")
def se3_batch():
    n = 4
    ds = SyntheticSE3Dataset(n, 256)
    items = [ds[i] for i in range(n)]
    return [np.stack([np.asarray(f(x), np.float32) for x in items]) for f in (
        lambda x: x["image0"], lambda x: x["image1"],
        lambda x: x["warp01_params"]["intrinsics0"],
        lambda x: x["warp01_params"]["intrinsics1"],
        lambda x: x["warp01_params"]["pose01"])]


def test_sharded_auc_matches_jax(highest, monkeypatch, se3_batch):
    solver = "8pt"
    n = len(se3_batch[0])
    dp = dict(nms_dist=4, border_dist=8, top_k=500)
    keys = jax.random.split(jax.random.key(0), n)
    mesh = make_mesh(n_data=n, devices=jax.devices()[:n])
    step = jax_auc_step(mesh, jax_model("Alike"), jax_load_params("Alike"),
                        JaxDetectParams(**dp), solver=solver, n_hyp=2048)
    with mesh:
        errs_j, inl_j = (np.asarray(x) for x in step(
            *[jnp.asarray(x) for x in se3_batch], keys))
    _jax_draws(monkeypatch, keys)
    model = get_model("Alike")(load_params("Alike"))

    def fn(mesh):
        return tev.sharded_auc_step(mesh, model, DetectParams(**dp),
                                    solver=solver, n_hyp=2048)(
            *se3_batch, list(range(n)))

    errs, inl = (x.numpy() for x in _worlds(fn))
    assert errs.shape == inl.shape == (n,)
    assert np.all(np.isfinite(errs)) and np.all((errs >= 0) & (errs <= 180))
    assert np.all(inl > 30), inl
    np.testing.assert_array_equal(errs == 180.0, errs_j == 180.0)
    np.testing.assert_allclose(inl, inl_j, rtol=0.05)
    same = inl == inl_j
    assert same.sum() >= n // 2, (inl, inl_j)
    np.testing.assert_allclose(errs[same], errs_j[same], atol=1.0)


def test_sharded_auc_5pt_solver(se3_batch):
    """The five-point solver through the sharded step (test_parallel_auc.py's
    5pt case): every error in [0, 180], real consensus sets, world sizes
    1, 2 and 4 bit-equal."""
    n = len(se3_batch[0])
    model = get_model("Alike")(load_params("Alike"))

    def fn(mesh):
        return tev.sharded_auc_step(
            mesh, model, DetectParams(nms_dist=4, border_dist=8, top_k=500),
            solver="5pt", n_hyp=2048)(*se3_batch, list(range(n)))

    errs, inl = (x.numpy() for x in _worlds(fn))
    assert np.all((errs >= 0) & (errs <= 180)) and np.all(inl > 30), (
        errs, inl)
