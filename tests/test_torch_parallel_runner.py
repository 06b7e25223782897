"""The runner's batch paths (`data_params.batch_size > 1`) on the CPU:
homography repeatability, brute-force MHA and brute-force AUC through the
data-parallel steps, their ragged tails per pair, against the JAX
runner's sharded paths and the port's per-pair runs (mirrors
tests/test_sharded_tail.py); world sizes 1, 2, 3 and 4 (ranks as threads
over gloo), the resume journal, and the CLI as two real processes under
torchrun.

Tolerances (tests/test_sharded_tail.py's): repeatability within 1e-5 and
the mean error within 1e-4 of JAX's sharded run and of the per-pair run
(the batched forward and the per-pair one differ in float order on the
CPU; detection and the metric's counts agree); MHA within one pair's
worth of hits of the JAX runner (the two runners' RANSAC draws differ);
AUC, fed the JAX runner's RANSAC draws: the same failed pairs as the JAX
runner's sharded run, and errors within 1 degree of its where the inlier
counts are equal; every pair present, finite, and the inliers comparable
to the per-pair run's. Every world size returns the same results, and rank 0
alone writes.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu_torch.parallel import evaluate as tev
from keypoint_bench_tpu_torch.parallel.mesh import thread_ranks
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.tasks import auc as ta


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, BATCH, S = 7, 4, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(task, batch_size, out, model="Alike", data="synthetic_homography",
         size=S, n=N, top_k=200, **task_params):
    return dict(
        model_type=model, task_type=task,
        data_params={"type": data, "num_pairs": n, "image_size": size,
                     "seed": 11, "batch_size": batch_size},
        extractor_params={"nms_dist": 4, "threshold": 0, "border_dist": 8,
                          "top_k": top_k, "min_score": 0.0},
        matcher_params={"type": "brute_force",
                        "brute_force_params": {"max_distance": 5.0}},
        task_params=task_params, output_dir=str(out), seed=3)


def _run(cfg, world=1):
    """The port's results on `world` thread ranks (all ranks' results)."""
    return thread_ranks(lambda mesh: Evaluator(
        EvalConfig(**cfg), "cpu", mesh=mesh).run(), world, device="cpu")


@pytest.mark.parametrize("model", ["Alike", "Alike_s2d"])
def test_repeatability_sharded_tail(tmp_path, model):
    """Alike_s2d's batch path takes the sparse sampler; repeatability does
    not read descriptors, so it equals the per-pair dense run (as in
    test_sharded_tail.py, held there to the port's per-pair run)."""
    sharded = _run(_cfg("repeatability", BATCH, tmp_path / "sh", model,
                        th=3.0))[0]
    refs = [Evaluator(EvalConfig(**_cfg(
        "repeatability", 1, tmp_path / "pp", model, th=3.0)), "cpu").run()]
    if model == "Alike":
        refs.append(JaxEvaluator(JaxEvalConfig(**_cfg(
            "repeatability", BATCH, tmp_path / "jax", model,
            th=3.0))).run())
    assert len(sharded["per_pair_repeatability"]) == N
    for other in refs:
        np.testing.assert_allclose(sharded["per_pair_repeatability"],
                                   other["per_pair_repeatability"],
                                   atol=1e-5)
        np.testing.assert_allclose(sharded["rep_mean_err"],
                                   other["rep_mean_err"], atol=1e-4)
        np.testing.assert_allclose(sharded["num_feat"], other["num_feat"],
                                   atol=1e-5)
    assert sharded["repeatability"] > 0.1


@pytest.mark.parametrize("model", ["Alike", "Alike_s2d"])
def test_mha_sharded_tail(tmp_path, model):
    """Alike against the JAX runner's batch path; Alike_s2d (the sparse
    sampler) against the port's per-pair dense run, as
    test_sharded_tail.py holds it."""
    ths = [3, 5, 7]
    sharded = _run(_cfg("MHA", BATCH, tmp_path / "sh", model, th=ths))[0]
    if model == "Alike":
        ref = JaxEvaluator(JaxEvalConfig(**_cfg(
            "MHA", BATCH, tmp_path / "jax", model, th=ths))).run()
    else:
        ref = Evaluator(EvalConfig(**_cfg("MHA", 1, tmp_path / "pp", model,
                                          th=ths)), "cpu").run()
    assert len(sharded["per_pair"]) == N
    for t in ths:
        assert abs(sharded[f"MHA@{t}"] - ref[f"MHA@{t}"]) <= 1.0 / N + 1e-6, \
            (t, sharded, ref)
    assert sharded["MHA@7"] > 0.5


@pytest.fixture
def jax_runner_draws(monkeypatch):
    """The port's runner draws its RANSAC samples from the JAX runner's
    keys (seed 3): one split a batch, split again into a key a pair of the
    batch (`_batch_seeds` returns the keys' places), and one split a pair
    of the ragged tail."""
    state = {"key": jax.random.key(3), "keys": []}

    def next_key():
        state["key"], k = jax.random.split(state["key"])
        return k

    def batch_seeds(self, b):
        n = len(state["keys"])
        state["keys"] += list(jax.random.split(next_key(), b))
        return list(range(n, n + b))

    def draws(key, mask, n_hyp, size):
        return torch.from_numpy(np.array(jr._sample_minimal(
            key, jnp.asarray(mask.cpu().numpy()), n_hyp, size))).long()

    monkeypatch.setattr(Evaluator, "_batch_seeds", batch_seeds)
    monkeypatch.setattr(tev, "pair_samples", lambda mask, seeds, n, size: (
        torch.stack([draws(state["keys"][s], mask[j], n, size)
                     for j, s in enumerate(seeds)])))
    monkeypatch.setattr(ta, "_sample_minimal", lambda mask, n, size, g: (
        draws(next_key(), mask, n, size)))


def _journal(out):
    with open(out / "progress.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return {r["i"]: r for r in recs if "i" in r}


def test_auc_sharded_tail(tmp_path, jax_runner_draws):
    """7 SE3 pairs, batch 4: one batch and a 3-pair tail, on the JAX
    runner's draws, against the JAX runner's sharded run pair by pair: the
    same failed pairs, and errors within 1 degree where the inlier counts
    are equal (tests/test_torch_parallel_steps.py says why no closer)."""
    cfg = dict(data="synthetic_se3", size=128, th=[5, 10, 20])
    sharded = _run(_cfg("AUC", BATCH, tmp_path / "sh", **cfg))[0]
    ref = JaxEvaluator(JaxEvalConfig(**_cfg("AUC", BATCH, tmp_path / "jax",
                                            **cfg))).run()
    per_pair = Evaluator(EvalConfig(**_cfg("AUC", 1, tmp_path / "pp",
                                           **cfg)), "cpu").run()
    assert len(sharded["per_pair_error"]) == N
    assert np.isfinite(sharded["per_pair_error"]).all()
    assert sharded["AUC_inliers"] > 0.6 * per_pair["AUC_inliers"] > 0
    errs = np.asarray(sharded["per_pair_error"])
    errs_j = np.asarray(ref["per_pair_error"])
    inl, inl_j = ([_journal(tmp_path / d)[i]["inliers"] for i in range(N)]
                  for d in ("sh", "jax"))
    np.testing.assert_array_equal(errs == 180.0, errs_j == 180.0)
    same = np.asarray(inl) == np.asarray(inl_j)
    assert same.sum() >= N // 2, (inl, inl_j)
    np.testing.assert_allclose(errs[same], errs_j[same], atol=1.0)


@pytest.mark.parametrize("task", ["repeatability", "MHA", "AUC"])
def test_world_sizes_return_the_same_results(tmp_path, task):
    """World sizes 1, 2, 3 and 4 over batches of 4 (3 ranks: the batch
    splits over 2, the third rank gets the records from rank 0); rank 0
    alone writes."""
    kw = {"th": 3.0} if task == "repeatability" else {}
    if task == "AUC":
        kw = dict(data="synthetic_se3", size=64, n=5, top_k=64)
    one = _run(_cfg(task, BATCH, tmp_path / "w1", **kw))[0]
    for world in (2, 3, 4):
        out = tmp_path / f"w{world}"
        for res in _run(_cfg(task, BATCH, out, **kw), world):
            assert res == one, world
        assert sorted(os.listdir(out)) == ["progress.jsonl", "results.json"]
        with open(out / "results.json") as f:
            assert json.load(f) == {k: v for k, v in one.items()}


def test_resume_replays_the_journal(tmp_path):
    """A sharded run cut after 5 journal records resumes on 2 ranks: the
    journal's pairs are replayed, the rest computed, the results those of
    the uncut run."""
    cfg = _cfg("repeatability", BATCH, tmp_path / "r", th=3.0)
    full = _run(cfg)[0]
    log = tmp_path / "r" / "progress.jsonl"
    lines = log.read_text().splitlines()
    assert len(lines) == N + 1 and "meta" in json.loads(lines[0])
    log.write_text("\n".join(lines[:6]) + "\n")
    resumed = _run({**cfg, "resume": True}, 2)
    for res in resumed:
        assert res == full
    assert len(log.read_text().splitlines()) == N + 1


def test_cli_under_torchrun_equals_one_rank(tmp_path):
    """`python -m keypoint_bench_tpu_torch.cli` as two processes under
    torchrun (gloo on the CPU): the one-rank run's results, results.json
    written once."""
    cfg = _cfg("repeatability", BATCH, tmp_path / "two", n=6, th=3.0)
    path = tmp_path / "two.yaml"
    path.write_text(yaml.safe_dump(cfg))
    one = _run({**cfg, "output_dir": str(tmp_path / "one")})[0]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "2", "-m",
                          "keypoint_bench_tpu_torch.cli", "-c", str(path),
                          "test", "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr
    assert two.stdout.count("(sharded, 2 ranks)") == 1
    want = {k: v for k, v in one.items() if not isinstance(v, list)}
    assert json.loads(two.stdout.strip().splitlines()[-1]) == want
    with open(tmp_path / "two" / "results.json") as f:
        assert json.load(f) == one
