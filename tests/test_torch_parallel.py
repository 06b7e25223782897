"""The port's parallel layer on the CPU: the rank mesh and its collectives,
and the data-parallel repeatability step against the JAX package's
`sharded_eval_step` on the conftest's 8-device mesh (mirrors
tests/test_parallel.py).

Ranks run as threads of the test process over gloo groups
(`parallel.mesh.thread_ranks`), world sizes 1, 2 and 4. The port's step
is fed the JAX step's RANSAC draws (`jax_pair_samples`: JAX's
`_sample_minimal` on the split key of each pair, over the port's match
mask). Tolerances: keypoint counts, gt_num and RANSAC-H inliers exact;
repeatability (a ratio of counts) 1e-7; the mean error (a mean of f32
distances) rtol 1e-5. World sizes 1, 2 and 4 give bit-equal per-pair
outputs: each rank's forward runs on a block of 2 or more images, where
oneDNN's maps do not depend on the block's size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.models import get_model as jax_model
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.ops.detect import DetectParams as JaxDetectParams
from keypoint_bench_tpu.parallel.evaluate import \
    sharded_eval_step as jax_sharded_eval_step
from keypoint_bench_tpu.parallel.mesh import make_mesh
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.parallel import evaluate as tev
from keypoint_bench_tpu_torch.parallel.mesh import Mesh, thread_ranks
from keypoint_bench_tpu_torch.weights import load_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, S = 8, 64
DP = dict(nms_dist=4, border_dist=4, top_k=64, max_nms_iter=8)


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


def jax_keys(n=B, seed=0):
    return jax.random.split(jax.random.key(seed), n)


@pytest.fixture
def jax_pair_samples(monkeypatch):
    """The port's steps draw pair j's samples as the JAX steps do: JAX's
    `_sample_minimal` on key j of the batch's split (the seeds are the
    pairs' indices)."""
    keys = jax_keys()

    def draws(mask, seeds, n_hyp, size):
        return torch.stack([torch.from_numpy(np.array(jr._sample_minimal(
            keys[int(s)], jnp.asarray(mask[j].cpu().numpy()), n_hyp,
            size))).long() for j, s in enumerate(seeds)])

    monkeypatch.setattr(tev, "pair_samples", draws)


def warped_pairs(n=B, s=S):
    """Textured pairs one pixel apart (tests/test_parallel.py's)."""
    rng = np.random.default_rng(0)
    imgs0 = rng.random((n, s, s, 3), np.float32)
    imgs1 = np.roll(imgs0, 1, axis=2)
    H = np.eye(3, dtype=np.float32)
    H[0, 2] = 1.0
    Hs = np.tile(H[None], (n, 1, 1))
    Hinvs = np.tile(np.linalg.inv(H).astype(np.float32)[None], (n, 1, 1))
    return (imgs0, imgs1, Hs, Hinvs, np.full((n, 2), float(s)),
            np.full((n,), float(s)))


@pytest.mark.parametrize("layout", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_mesh_collectives(layout):
    """psum, the host gather and the ring ppermute of the JAX code, over
    thread ranks; rank r at (r // n_model, r % n_model)."""
    n_data, n_model = layout

    def fn(mesh):
        return (mesh.data_rank, mesh.model_rank,
                float(mesh.all_reduce(torch.tensor([mesh.rank + 1.0]),
                                      "world")),
                [int(x) for x in mesh.all_gather(torch.tensor([mesh.rank]))],
                int(mesh.ring_shift(torch.tensor([mesh.rank]))),
                float(mesh.all_reduce(torch.ones(1), "model")),
                mesh.broadcast_json({"r": mesh.rank}))

    out = thread_ranks(fn, n_data, n_model, device="cpu")
    n = n_data * n_model
    for r, (d, m, total, gathered, prev, heads, sent) in enumerate(out):
        assert (d, m) == (r // n_model, r % n_model)
        assert total == n * (n + 1) / 2 and heads == n_model
        assert gathered == [i * n_model + m for i in range(n_data)]
        assert prev == ((d - 1) % n_data) * n_model + m
        assert sent == {"r": 0}


def test_single_mesh_is_the_identity():
    mesh = Mesh.single("cpu")
    t = torch.arange(3.0)
    assert mesh.all_reduce(t) is t and mesh.ring_shift(t) is t
    assert mesh.all_gather(t) == [t] and mesh.subset(1) is mesh
    assert (mesh.world_size, mesh.data_rank, mesh.model_rank) == (1, 0, 0)


def test_subset_and_a_failing_rank():
    """subset(n) leaves the ranks past n outside; a rank's exception
    reaches the caller."""
    def fn(mesh):
        sub = mesh.subset(2)
        if sub is None:
            return None
        return [int(x) for x in sub.all_gather(torch.tensor([mesh.rank]))]

    assert thread_ranks(fn, 3, device="cpu") == [[0, 1], [0, 1], None]

    def bad(mesh):
        raise ValueError(f"rank {mesh.rank}")

    with pytest.raises(ValueError, match="rank"):
        thread_ranks(bad, 2, device="cpu")


def test_pair_samples_are_the_generators_draws():
    """pair_samples draws pair j from its own seed: the same samples as
    `_sample_minimal` of that pair alone, whatever the batch around it."""
    from keypoint_bench_tpu_torch.geometry.ransac import _sample_minimal
    mask = torch.from_numpy(np.random.default_rng(2).random((3, 40)) > 0.3)
    got = tev.pair_samples(mask, [5, 9, 11], 16, 4)
    for j, s in enumerate([5, 9, 11]):
        want = _sample_minimal(mask[j], 16, 4,
                               torch.Generator().manual_seed(s))
        assert torch.equal(got[j], want)
    assert torch.equal(tev.pair_samples(mask[1:2], [9], 16, 4)[0], got[1])


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX sharded step on the 8-device CPU mesh (HIGHEST convs)."""
    set_conv_precision(jax.lax.Precision.HIGHEST)
    try:
        assert len(jax.devices()) == 8
        step = jax_sharded_eval_step(make_mesh(n_data=8),
                                     jax_model("Alike"),
                                     jax_load_params("Alike"),
                                     JaxDetectParams(**DP))
        batch = [jnp.asarray(x) for x in warped_pairs()]
        with make_mesh(n_data=8):
            out = step(*batch, jax_keys())
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        set_conv_precision(None)


@pytest.mark.parametrize("model", ["Alike", "Alike_s2d"])
def test_sharded_eval_matches_jax_and_world_sizes(jax_reference, model,
                                                  jax_pair_samples):
    """World sizes 1, 2 and 4 against the JAX step; Alike_s2d takes the
    sparse sampler (the same values as sampling the dense map)."""
    m = get_model(model)(load_params(model))
    batch = warped_pairs()

    def fn(mesh):
        step = tev.sharded_eval_step(mesh, m, DetectParams(**DP),
                                     sparse=model == "Alike_s2d")
        return step(*batch, list(range(B)))

    ref = jax_reference
    one = thread_ranks(fn, 1, device="cpu")[0]
    for k in ("num_feat", "gt_num", "homography_inliers"):
        np.testing.assert_array_equal(one[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(one["repeatability"].numpy(),
                               ref["repeatability"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(one["mean_error"].numpy(), ref["mean_error"],
                               rtol=1e-5)
    assert float(one["repeatability"].mean()) > 0.1
    for n in (2, 4):
        for out in thread_ranks(fn, n, device="cpu"):
            for k in one:
                assert torch.equal(out[k], one[k]), (n, k)


def test_shard_takes_the_rank_block():
    """step.shard on this rank's block alone gives the whole batch's
    outputs, as the whole-batch call does."""
    m = get_model("Alike")(load_params("Alike"))
    batch = warped_pairs(4)

    def fn(mesh):
        step = tev.sharded_eval_step(mesh, m, DetectParams(**DP))
        sl = tev.block(mesh, 4)
        return step(*batch, [0, 1, 2, 3]), step.shard(
            *(x[sl] for x in batch), [0, 1, 2, 3][sl])

    for whole, part in thread_ranks(fn, 2, device="cpu"):
        for k in whole:
            assert torch.equal(whole[k], part[k])
    with pytest.raises(ValueError, match="does not split"):
        tev.block(Mesh(2, 1, 0, torch.device("cpu")), 3)


def test_dryrun_certificates():
    """The port's counterpart of __graft_entry__.py's dryrun on 4 ranks:
    the dp, tp, sp, ba and vo-ba certificates hold (the JAX dryrun's
    numbers on 8 devices: MULTICHIP_r05.json)."""
    from keypoint_bench_tpu_torch.parallel.dryrun import dryrun
    lines = []
    out = dryrun(4, "cpu", log=lines.append)
    assert sorted(out) == ["ba", "dp", "sp", "tp", "vo-ba"]
    assert out["dp"]["repeatability"] > 0.5
    assert out["sp"]["max_score_dev"] < 2e-3
    assert any(ln.startswith("dryrun sp ok") for ln in lines)
