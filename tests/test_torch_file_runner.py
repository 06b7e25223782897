"""The shipped file-backed configs through the port's CLI against the JAX
runner on the same small trees (CPU; chip_smoke.py's tree writers at
96-256 px): configs/repeatability_hpatches.yaml, mha_hpatches.yaml,
long_term.yaml, auc_megadepth.yaml, fund_tartanair.yaml and vo_kitti.yaml,
each a copy with its data root (and ground truth) replaced and cut to
size (image_size 128, top_k 300, LK at 2 levels and 8 iterations). The
tolerances are those of the synthetic runner tests: repeatability per
pair equal; with the port's RANSAC fed the JAX runner's minimal samples,
MHA hits equal, the RANSAC-F inlier ratio within 0.02 and AUC pose errors
within 3 degrees, their medians within 1 (float32 solves on raw
coordinates part on some samples and flip the consensus, ROADMAP Queue 3;
2.0 degrees seen on one pair of three); LK at jitter distance 0, where
the protocol is deterministic: epipolar errors within 1e-3 relative and
hit counts equal (tests/test_torch_fund_runner.py); VO's pair-solver
inputs with JAX's solver on both sides: keypoints within a float32 ulp,
masks equal, tracks within 1e-2 px (tests/test_torch_vo_runner.py). The port's runs of the HPatches, KITTI,
TartanAir and image-pair configs take place with cv2, PIL and h5py
blocked (the card's condition), after the JAX runner's; its MegaDepth run
with h5py blocked (its JPEGs need PIL). The VO runs solve
at 256 hypotheses on both sides (RANSAC-E at the runner's 4096 dominates
a CPU run). Then the resume journal per task: a run cut after one pair
and resumed replays the journal and computes the rest only."""
import functools
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu import runner as jrunner
from keypoint_bench_tpu.tasks import vo as jvo
from keypoint_bench_tpu_torch import cli
from keypoint_bench_tpu_torch import runner as trunner
from keypoint_bench_tpu_torch.geometry import ransac as tr
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.tasks import auc as ta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                       run_name="not_main")
SHIPPED = {"repeatability_hpatches": "hpatches", "mha_hpatches": "hpatches",
           "long_term": "image_pair", "auc_megadepth": "megadepth",
           "fund_tartanair": "tartanair", "vo_kitti": "kitti"}
LK = {"distance": 0, "win_size": 11, "levels": 2, "interation": 8}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These runs are many small ops at batch 1, which torch's intra-op
    threads slow down where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    hp = SMOKE["hpatches_tree"](str(root / "hpatches"),
                                sizes=((96, 128), (120, 96), (96, 128)),
                                n_images=3)
    kitti = SMOKE["kitti_tree"](str(root / "kitti"), frames=3,
                                hw=(96, 192), step=(0.04, 0.005, 0.02))
    tartan = SMOKE["tartanair_tree"](str(root / "tartanair"), frames=3,
                                     hw=(96, 128))
    lst = SMOKE["image_pairs_tree"](str(root / "pairs"), pairs=2,
                                    hw=(96, 128))
    trees = {"hpatches": {"root": hp}, "image_pair": {"root": lst},
             "kitti": {"root": kitti[0], "gt": kitti[1]},
             "tartanair": {"root": tartan[0], "gt": tartan[1]}}
    try:
        trees["megadepth"] = {"root": SMOKE["megadepth_tree"](
            str(root / "megadepth"), pairs=2, hw=(192, 256), n_blobs=900)}
    except ImportError:
        pass
    return trees


def _config(name, trees, out, **changes):
    """A copy of configs/<name>.yaml on the test tree, cut to size (the AUC
    pairs at tests/test_torch_auc.py's NMS 4 and top_k 500, which pose
    them within 10 degrees)."""
    cfg = SMOKE["file_config"](name, str(out), **trees[SHIPPED[name]])
    if "image_size" in cfg["data_params"]:
        cfg["data_params"]["image_size"] = 128
    cfg["extractor_params"] = {**cfg["extractor_params"], "top_k": 300}
    if name == "auc_megadepth":
        cfg["extractor_params"].update(nms_dist=4, top_k=500)
    of = cfg.get("matcher_params", {}).get("optical_flow_params")
    if of is not None:
        cfg["matcher_params"]["optical_flow_params"] = {**of, **LK}
    cfg.update(changes)
    return cfg


def _port_cli(cfg):
    """The port's CLI on cfg (as a YAML file), on the CPU; its
    results.json and, for VO, the trajectory."""
    os.makedirs(cfg["output_dir"], exist_ok=True)
    path = os.path.join(cfg["output_dir"], "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    assert cli.main(["-c", path, "--device", "cpu"]) == 0
    import json
    with open(os.path.join(cfg["output_dir"], "results.json")) as f:
        res = json.load(f)
    if "trajectory_path" in res:
        from keypoint_bench_tpu_torch.tasks.trajectory import \
            read_kitti_trajectory
        res["t_est"] = read_kitti_trajectory(res["trajectory_path"])[1]
    return res


def _jax(cfg):
    return JaxEvaluator(JaxEvalConfig(**cfg)).run()


def _block_readers(monkeypatch, keep=()):
    """The card's condition: no OpenCV, PIL or h5py (less those in
    `keep`)."""
    for mod in ("cv2", "PIL", "PIL.Image", "h5py"):
        if mod not in keep:
            monkeypatch.setitem(sys.modules, mod, None)


VO_NHYP = 256


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's RANSAC draws its minimal samples as the JAX runner does:
    one split of the seed-0 key per pair."""
    state = {"key": jax.random.key(0)}

    def draws(mask, n_hyp, size, generator):
        state["key"], k = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jr._sample_minimal(
            k, jnp.asarray(mask.numpy()), n_hyp, size))).long()

    monkeypatch.setattr(tr, "_sample_minimal", draws)
    monkeypatch.setattr(ta, "_sample_minimal", draws)


def test_shipped_configs_read_file_backed_types():
    for name, kind in SHIPPED.items():
        cfg = EvalConfig.from_yaml(os.path.join(ROOT, "configs",
                                                f"{name}.yaml"))
        assert cfg.data_params["type"] == kind
        assert not cfg.resume


def test_repeatability_hpatches_matches_jax(trees, tmp_path, highest,
                                           monkeypatch):
    cfg = _config("repeatability_hpatches", trees, tmp_path / "t")
    ref = _jax(dict(cfg, output_dir=str(tmp_path / "j")))
    _block_readers(monkeypatch)
    got = _port_cli(cfg)
    assert len(got["per_pair_repeatability"]) == 4     # v_a, v_b: 2 each
    assert got["per_pair_repeatability"] == ref["per_pair_repeatability"]
    assert got["repeatability"] == ref["repeatability"] > 0.3
    np.testing.assert_allclose(got["rep_mean_err"], ref["rep_mean_err"],
                               rtol=1e-5)


def test_mha_hpatches_matches_jax(trees, tmp_path, highest, jax_draws):
    cfg = _config("mha_hpatches", trees, tmp_path / "t")
    got = _port_cli(cfg)
    ref = _jax(dict(cfg, output_dir=str(tmp_path / "j")))
    assert len(got["per_pair"]) == 6
    assert got["per_pair"] == ref["per_pair"]
    assert got["MHA@7"] == ref["MHA@7"] > 0.5


def test_long_term_matches_jax(trees, tmp_path, highest, jax_draws,
                              monkeypatch):
    cfg = _config("long_term", trees, tmp_path / "t")
    ref = _jax(dict(cfg, output_dir=str(tmp_path / "j")))
    _block_readers(monkeypatch)
    got = _port_cli(cfg)
    assert 0.3 < got["fundamental_radio"] <= 1.0
    assert abs(got["fundamental_radio"] - ref["fundamental_radio"]) <= 0.02


def test_auc_megadepth_matches_jax(trees, tmp_path, highest, jax_draws,
                                  monkeypatch):
    if "megadepth" not in trees:
        pytest.skip("PIL is not installed")
    cfg = _config("auc_megadepth", trees, tmp_path / "t")
    ref = _jax(dict(cfg, output_dir=str(tmp_path / "j")))
    _block_readers(monkeypatch, keep=("PIL", "PIL.Image"))
    got = _port_cli(cfg)
    np.testing.assert_allclose(got["per_pair_error"], ref["per_pair_error"],
                               rtol=0, atol=3.0)
    assert abs(np.median(got["per_pair_error"])
               - np.median(ref["per_pair_error"])) <= 1.0
    assert np.median(got["per_pair_error"]) < 10.0
    assert got["AUC_inliers"] > 0


def test_fund_tartanair_matches_jax(trees, tmp_path, highest, monkeypatch):
    cfg = _config("fund_tartanair", trees, tmp_path / "t")
    ref = _jax(dict(cfg, output_dir=str(tmp_path / "j")))
    _block_readers(monkeypatch)
    got = _port_cli(cfg)
    np.testing.assert_allclose(got["per_frame_error"],
                               ref["per_frame_error"], rtol=1e-3, atol=1e-5)
    assert got["fundamental_num"] == ref["fundamental_num"] > 20


@pytest.fixture
def jax_pair_solver(monkeypatch):
    """The port's runner solves its VO pairs with JAX's vo_pair_pose on the
    keys the JAX runner draws from seed 0: one for the pair's LK, then one
    for the pose; the JAX runner's solves at the same VO_NHYP. Records
    both sides' solver inputs."""
    state = {"key": jax.random.key(0), "port": [], "jax": []}

    def next_key():
        state["key"], k = jax.random.split(state["key"])
        return k

    def solve(p0, p1, mask, fx, cx, cy, generator, **kw):
        f = [jnp.asarray(float(v), jnp.float32) for v in (fx, cx, cy)]
        a = [jnp.asarray(x.numpy()) for x in (p0, p1, mask)]
        state["port"].append([np.asarray(x) for x in a])
        next_key()
        out = jvo.vo_pair_pose(*a, *f, next_key(), n_hyp=VO_NHYP)
        return tuple(torch.from_numpy(np.array(x)) for x in out)

    def jax_solve(p0, p1, mask, *args):
        state["jax"].append([np.asarray(x) for x in (p0, p1, mask)])
        return jvo.vo_pair_pose(p0, p1, mask, *args, n_hyp=VO_NHYP)

    monkeypatch.setattr(trunner, "vo_pair_pose", solve)
    monkeypatch.setattr(jrunner, "vo_pair_pose", jax_solve)
    return state


def test_vo_kitti_matches_jax(trees, tmp_path, highest, jax_pair_solver,
                              monkeypatch):
    cfg = _config("vo_kitti", trees, tmp_path / "t")
    ref = _jax(dict(cfg, output_dir=str(tmp_path / "j")))
    _block_readers(monkeypatch)
    got = _port_cli(cfg)
    assert got["t_est"].shape == ref["t_est"][:, :, 0].shape == (4, 3)
    assert np.isfinite(got["t_est"]).all()
    port, jx = jax_pair_solver["port"], jax_pair_solver["jax"]
    assert len(port) == len(jx) == 3
    for (p0, p1, m), (q0, q1, n) in zip(port, jx):
        # a float32 ulp of a pixel where x / (w - 1) * (w - 1) rounds
        np.testing.assert_allclose(p0, q0, rtol=0, atol=1e-4)
        assert np.array_equal(m, n)
        assert m.sum() > 50
        assert np.abs(p1 - q1)[m].max() <= 1e-2


RESUMABLE = {"repeatability_hpatches": "per_pair_repeatability",
             "mha_hpatches": "per_pair", "auc_megadepth": "per_pair_error",
             "vo_kitti": "t_est"}


@pytest.mark.parametrize("name", list(RESUMABLE))
def test_resume_replays_the_journal_and_computes_the_rest(
        trees, tmp_path, monkeypatch, name):
    """A run cut after one pair (its journal's first record), then
    resumed: the replayed pairs load and detect nothing and keep their
    records; repeatability (no RANSAC draw) equals the uncut run, and the
    other tasks' later pairs take the generator's draws from the start of
    the run, as the JAX runner's keys do (runner.py's docstring)."""
    if SHIPPED[name] not in trees:
        pytest.skip("PIL is not installed")
    monkeypatch.setattr(trunner, "vo_pair_pose", functools.partial(
        trunner.vo_pair_pose, n_hyp=VO_NHYP))
    cfg = _config(name, trees, tmp_path / "run")
    full = _port_cli(cfg)
    journal = os.path.join(cfg["output_dir"], "progress.jsonl")
    with open(journal) as f:
        lines = f.readlines()
    head = 1 if '"meta"' in lines[0] else 0
    n = len(lines) - head
    with open(journal, "w") as f:
        f.writelines(lines[:head + 1])
    calls = []
    real = Evaluator.detect
    monkeypatch.setattr(Evaluator, "detect",
                        lambda self, img: calls.append(1) or real(self, img))
    got = _port_cli(dict(cfg, resume=True))
    key = RESUMABLE[name]
    seq = name == "vo_kitti"
    # a sequence re-detects the frame before the cut, then one a pair
    assert len(calls) == (n - 1 + 1 if seq else 2 * (n - 1))
    if seq:
        np.testing.assert_array_equal(got[key][:2], full[key][:2])
        assert got[key].shape == full[key].shape
    else:
        assert got[key][:1] == full[key][:1]
        assert len(got[key]) == len(full[key]) == n
    if name == "repeatability_hpatches":
        assert got == full
    with open(journal) as f:
        assert len(f.readlines()) == head + n
    # a journal written under another meta (the threshold) is discarded,
    # not replayed
    if name in ("repeatability_hpatches", "mha_hpatches"):
        calls.clear()
        other = dict(cfg, resume=True,
                     task_params={**cfg.get("task_params", {}),
                                  "th": [9] if name.startswith("mha")
                                  else 9})
        _port_cli(other)
        assert len(calls) == 2 * n


@pytest.mark.cuda
def test_homography_hypotheses_keep_their_inliers_on_the_card():
    """RANSAC-H's raw-pixel hypotheses at HPatches' 800 px on the card:
    cuSOLVER's float32 SVD of A^T A left most pairs of the HPatches phase
    without a hypothesis holding a second inlier (MHA@3 0.53 against the
    JAX package's 1.0); solved in float64 every hypothesis of clean
    correspondences holds nearly all of them, as LAPACK's float32 does on
    the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    H = SMOKE["random_homography"](600, 800, rng)
    p0 = rng.uniform([0, 0], [799, 599], (800, 2))
    q = np.c_[p0, np.ones(800)] @ H.T
    p1 = q[:, :2] / q[:, 2:]
    mask = torch.ones(800, dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    idx = tr._sample_minimal(mask, 512, 4, gen)
    counts = {}
    for dev in ("cpu", "cuda"):
        a, b = (torch.tensor(x, dtype=torch.float32, device=dev)
                for x in (p0, p1))
        hs = tr._solve_dlt_h(tr._take(a, idx.to(dev)), tr._take(b, idx.to(
            dev)), torch.ones(512, 4, device=dev))
        res = tr._homography_residual(hs, a[None], b[None])
        counts[dev] = (res < 3.0).sum(-1).cpu()
        H_est, inl, ok = tr.ransac_homography_from_samples(
            a, b, mask.to(dev), idx.to(dev))
        assert bool(ok) and int(inl.sum()) >= 790, dev
    assert float(counts["cuda"].float().median()) >= 700
