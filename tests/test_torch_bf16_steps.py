"""bf16 mode's steps, runner and sweep in the port vs the JAX reference
(CPU, 128^2), and against the port's own float32 run.

The JAX side is bench.py's bf16 step rebuilt from the JAX functions, on
`cast_params_bf16` weights at the backend's default conv precision. bf16
score maps hold few distinct values, so a one-ulp difference in a map
(the two packages sum each conv in another f32 order before rounding,
tests/test_torch_bf16_models.py) moves NMS and top-k decisions between
tied and near-tied pixels. The steps are therefore held at the metric
level, with bounds measured on these inputs:
- the keypoint sets: Jaccard overlap of the valid keypoints' pixels, per
  image, at least `JACCARD` (0.83-0.94 seen against JAX's ALIKE step,
  0.77-0.84 between the port's bf16 and f32 runs);
- match counts within `COUNT_REL` of the reference's (1% seen on
  ALIKE's step; 9% on D2Net's randomized golden weights, whose ~80
  matches a pair are the fewest);
- the runner's and the sweep's repeatability within 0.02 and the mean
  error within 0.05 of the JAX bf16 run, and of the port's own f32 run
  (tests/test_precision.py's bounds for the JAX package's bf16 shift).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from keypoint_bench_tpu.datasets.synthetic import _texture
from keypoint_bench_tpu.models import get_model as jax_get_model
from keypoint_bench_tpu.models.alike_s2d import (alike_s2d_feats_cm,
                                                 transform_params_s2d)
from keypoint_bench_tpu.models.common import cast_params_bf16 as jcast
from keypoint_bench_tpu.ops import detect as jd
from keypoint_bench_tpu.ops import lk as jlk
from keypoint_bench_tpu.ops import matching as jm
from keypoint_bench_tpu.ops import sparse_desc as jsd
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu.sweep import run_sweep as jax_run_sweep
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.ops.lk import LKParams
from keypoint_bench_tpu_torch.pipeline import (dense_extract_match,
                                               extract_match,
                                               lk_fundamental_step,
                                               superpoint_mha_step, vo_step,
                                               xfeat_auc_step)
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.sweep import run_sweep
from keypoint_bench_tpu_torch.weights import (lightglue_input_proj_params,
                                              load_params, params_from_jax,
                                              stage_golden_weights)
from keypoint_bench_tpu_torch.weights.io import golden_npz


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 128
BF = "bfloat16"
JACCARD = 0.7
COUNT_REL = 0.15
GOLDEN = ("SuperPoint", "XFeat", "DISK", "sfd2", "D2Net")


def _np_params(name):
    if name in GOLDEN:
        return golden_npz(name)
    return {k: np.asarray(v) for k, v in jax_load_params(name).items()}


def _port(name, precision=BF):
    params = params_from_jax(_np_params(name))
    if precision == BF:
        from keypoint_bench_tpu_torch.models.common import cast_params_bf16
        params = cast_params_bf16(params)
    return get_model(name)(params), params


def jaccard(k_a, v_a, k_b, v_b, h=S, w=S):
    """Per image: |A & B| / |A | B| of the valid keypoints' pixels."""
    size = np.array([w, h])
    out = []
    for ka, va, kb, vb in zip(k_a, v_a, k_b, v_b):
        a = {tuple(p) for p in np.round(np.asarray(ka)[np.asarray(va), :2]
                                        * size - 0.5).astype(int)}
        b = {tuple(p) for p in np.round(np.asarray(kb)[np.asarray(vb), :2]
                                        * size - 0.5).astype(int)}
        out.append(len(a & b) / max(len(a | b), 1))
    return np.asarray(out)


def _assert_close_count(n, n_ref, what=""):
    assert abs(int(n) - int(n_ref)) <= COUNT_REL * max(int(n_ref), 20), (
        f"{what}: {int(n)} against {int(n_ref)}")


def _pairs(n=2, seed=0):
    ds = get_dataset({"type": "synthetic_homography", "num_pairs": n,
                      "image_size": S, "seed": seed})
    return (np.stack([ds[i]["image0"] for i in range(n)]),
            np.stack([ds[i]["image1"] for i in range(n)]), ds)


def _port_keypoints(model, imgs, dp, sparse=True):
    with torch.no_grad():
        if sparse:
            score, _ = model.feats(torch.from_numpy(imgs))
        else:
            score, _ = model(torch.from_numpy(imgs))
    from keypoint_bench_tpu_torch.ops.detect import detection_batch
    k, v = detection_batch(score, dp)
    return k.numpy(), v.numpy()


def test_extract_match_bf16_matches_jax_bench_step():
    """bench.py's default step (bench.py:594-622): Alike_s2d's channel-major
    features, the y-ordered Pallas sampler (interpreted), bf16 descriptors
    into mutual NN."""
    imgs0, imgs1, _ = _pairs(4)
    kw = dict(nms_dist=6, border_dist=8, top_k=200)
    jp = jcast(transform_params_s2d(jax_load_params("Alike")))
    dp = jd.DetectParams(**kw)

    def ext(imgs):
        s, f = alike_s2d_feats_cm(jp, jnp.asarray(imgs))
        k, v = jd.detection_batch(s[..., 0], dp)
        return jsd.alike_sparse_descriptors_cm_batch_yorder(
            jp, tuple(f), k, v, S, S, interpret=True)

    d0, k0r, v0r = ext(imgs0)
    d1, _, v1r = ext(imgs1)
    _, ok_ref = jax.vmap(lambda a, b, va, vb: jm.mutual_nn_match(
        a, b, va, vb, 5.0))(d0.astype(jnp.bfloat16),
                            d1.astype(jnp.bfloat16), v0r, v1r)
    n_ref = int(jnp.sum(ok_ref))
    results = {}
    for prec in ("float32", BF):
        params = load_params("Alike", precision=prec)
        model = get_model("Alike")(params)
        n, k0, _ = extract_match(model, params, imgs0, imgs1,
                                 DetectParams(**kw), device="cpu")
        results[prec] = (int(n), *_port_keypoints(model, imgs0,
                                                    DetectParams(**kw)))
    n, k0, v0 = results[BF]
    assert k0.shape == (4, 200, 3)
    _assert_close_count(n, n_ref, "bf16 vs JAX")
    _assert_close_count(n, results["float32"][0], "bf16 vs f32")
    assert n_ref > 100
    assert (jaccard(k0, v0, np.asarray(k0r), np.asarray(v0r))
            >= JACCARD).all()
    assert (jaccard(k0, v0, *results["float32"][1:]) >= JACCARD).all()


def test_extract_match_bf16_matches_bf16_descriptors():
    """The step on bf16 weights rounds the sampled descriptors to bf16
    before the match (exactly upcast again for kernel D on the card): its
    count equals matching
    the f32 step's descriptors rounded to bf16 by hand."""
    from keypoint_bench_tpu_torch.ops.matching import mutual_nn_match
    from keypoint_bench_tpu_torch.pipeline import extract
    imgs0, imgs1, _ = _pairs(2, seed=1)
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=200)
    params = load_params("Alike", precision=BF)
    model = get_model("Alike")(params)
    with torch.no_grad():
        d0, _, v0 = extract(model, params, torch.from_numpy(imgs0), dp)
        d1, _, v1 = extract(model, params, torch.from_numpy(imgs1), dp)
    assert d0.dtype == torch.float32
    _, ok = mutual_nn_match(d0.to(torch.bfloat16), d1.to(torch.bfloat16),
                            v0, v1, 5.0)
    n = extract_match(model, params, imgs0, imgs1, dp, device="cpu")[0]
    assert int(n) == int(ok.sum()) > 50


def test_steps_check_the_weights_precision():
    """A step runs in its weights' precision: all of rank >= 2 in float32
    or all in bfloat16, and nothing else; LightGlue's stay float32."""
    params = load_params("Alike")
    imgs = np.zeros((1, 64, 64, 3), np.float32)
    first = next(k for k, v in params.items() if v.dim() >= 2)
    mixed = dict(params, **{first: params[first].to(torch.bfloat16)})
    with pytest.raises(ValueError, match="all in float32 or all in"):
        extract_match(get_model("Alike")(mixed), mixed, imgs, imgs,
                      DetectParams(), device="cpu")
    half = {k: v.half() if v.dim() >= 2 else v for k, v in params.items()}
    with pytest.raises(ValueError, match="all in float32 or all in"):
        dense_extract_match(get_model("Alike")(half), imgs, imgs,
                            DetectParams(), device="cpu")
    from keypoint_bench_tpu_torch.models.common import cast_params_bf16
    lg = cast_params_bf16(lightglue_input_proj_params())
    with pytest.raises(ValueError, match="LightGlue's params stay float32"):
        xfeat_auc_step(_port("XFeat")[0], lg, imgs, imgs, np.eye(3)[None],
                       np.eye(4)[None], DetectParams(), None, device="cpu")
    with pytest.raises(ValueError, match="precision must be one of"):
        load_params("Alike", precision="float16")


def _jax_pair_step(name, p, kw):
    """bench.py:626-640's `pair_step` (bf16 maps sampled in f32, matched
    in f32), vmapped over the pairs."""
    from keypoint_bench_tpu.ops.detect import detection
    fn, dp = jax_get_model(name), jd.DetectParams(**kw)

    def pair_step(img0, img1):
        s0, d0 = fn(p, img0[None])
        s1, d1 = fn(p, img1[None])
        k0, v0 = detection(s0[0], dp)
        k1, v1 = detection(s1[0], dp)
        _, m1, ok = jm.brute_force_match(k0, v0, k1, v1, d0[0], d1[0], 5.0)
        return jnp.sum(ok), k0, v0
    return jax.jit(jax.vmap(pair_step))


@pytest.mark.parametrize("name", ["EdgePoint", "r2d2", "DISK", "D2Net"])
def test_dense_extract_match_bf16_matches_jax_pair_step(name):
    rng = np.random.default_rng(0)
    imgs0 = np.stack([_texture(S, S, rng) for _ in range(2)])
    imgs1 = np.stack([_texture(S, S, rng) for _ in range(2)])
    kw = dict(nms_dist=6, border_dist=8, top_k=300)
    jp = jcast({k: jnp.asarray(v) for k, v in _np_params(name).items()})
    n_ref, k_ref, v_ref = (np.asarray(x) for x in _jax_pair_step(
        name, jp, kw)(jnp.asarray(imgs0), jnp.asarray(imgs1)))
    model, _ = _port(name)
    n, k0, _ = dense_extract_match(model, imgs0, imgs1, DetectParams(**kw),
                                   device="cpu")
    v0 = k0[..., 2].numpy() > 0
    assert (jaccard(k0.numpy(), v0, k_ref, v_ref) >= JACCARD).all()
    _assert_close_count(n, n_ref.sum(), name)
    model32, _ = _port(name, "float32")
    n32 = dense_extract_match(model32, imgs0, imgs1, DetectParams(**kw),
                              device="cpu")[0]
    _assert_close_count(n, n32, f"{name} bf16 vs f32")
    assert int(n) > 20


def test_superpoint_mha_step_bf16_matches_jax():
    """bench.py's `bench_superpoint_mha` step in bf16 (brute force): the
    keypoints against JAX's, the match count against JAX's and the
    port's f32 run."""
    from keypoint_bench_tpu.geometry.warp import warp_homography
    imgs0, imgs1, ds = _pairs(2, seed=2)
    Hs = np.stack([ds[i]["warp01_params"]["homography_matrix"]
                   for i in range(2)])
    Hinvs = np.stack([ds[i]["warp10_params"]["homography_matrix"]
                      for i in range(2)])
    kw = dict(nms_dist=4, border_dist=8, top_k=300)
    jp = jcast({k: jnp.asarray(v) for k, v in
                golden_npz("SuperPoint").items()})
    fn = jax_get_model("SuperPoint")
    s0, d0 = fn(jp, jnp.asarray(imgs0))
    s1, d1 = fn(jp, jnp.asarray(imgs1))
    k0, v0 = jd.detection_batch(s0, jd.DetectParams(**kw))
    k1, v1 = jd.detection_batch(s1, jd.DetectParams(**kw))

    def tail(a, va, b, vb, da, db, H, Hi):
        _, _, wa = warp_homography(a, va, H, float(S), float(S))
        _, _, wb = warp_homography(b, vb, Hi, float(S), float(S))
        return jnp.sum(jm.brute_force_match(a, wa, b, wb, da, db, 5.0)[2])
    n_ref = int(jnp.sum(jax.vmap(tail)(k0, v0, k1, v1, d0, d1,
                                       jnp.asarray(Hs),
                                       jnp.asarray(Hinvs))))
    got = {}
    for prec in ("float32", BF):
        model, _ = _port("SuperPoint", prec)
        hits, m0, _, ok = superpoint_mha_step(
            model, imgs0, imgs1, Hs, Hinvs, DetectParams(**kw),
            torch.Generator().manual_seed(0), n_hyp=64, device="cpu")
        got[prec] = (int(ok.sum()), hits)
    with torch.no_grad():
        s, _ = _port("SuperPoint")[0](torch.from_numpy(imgs0))
    from keypoint_bench_tpu_torch.ops.detect import detection_batch
    kp, vp = detection_batch(s, DetectParams(**kw))
    assert (jaccard(kp.numpy(), vp.numpy(), np.asarray(k0), np.asarray(v0))
            >= JACCARD).all()
    _assert_close_count(got[BF][0], n_ref, "bf16 vs JAX")
    _assert_close_count(got[BF][0], got["float32"][0], "bf16 vs f32")
    assert got[BF][1].shape == (2, 3)


def test_lk_fundamental_step_bf16_matches_jax_step():
    """bench.py's `bench_lk_fund` step in bf16: the ALIKE keypoints against
    JAX's bf16 forward, the tracks and epipolar counts against the port's
    f32 run (LK runs on the f32 images in both)."""
    ds = get_dataset({"type": "synthetic_sequence", "num_frames": 3,
                      "image_size": S, "seed": 1})
    imgs0 = np.stack([ds[0]["image0"], ds[1]["image0"]])
    imgs1 = np.stack([ds[1]["image0"], ds[2]["image0"]])
    Fs = np.stack([ds[1]["fundamental"], ds[2]["fundamental"]])
    kw = dict(nms_dist=4, border_dist=8, top_k=120)
    lkw = dict(distance=0.0, win_size=11, levels=3, iterations=8)
    jp = jcast(jax_load_params("Alike"))
    s0, _ = jax_get_model("Alike")(jp, jnp.asarray(imgs0))
    k_ref, v_ref = jd.detection_batch(s0[..., 0], jd.DetectParams(**kw))
    keys = jax.random.split(jax.random.key(0), 2)
    jlk.optical_flow_batch(jnp.asarray(imgs0), jnp.asarray(imgs1),
                           k_ref[:, :, 0:2], k_ref[:, :, 0:2], keys,
                           jlk.LKParams(**lkw))
    out = {}
    for prec in ("float32", BF):
        params = load_params("Alike", precision=prec)
        out[prec] = lk_fundamental_step(
            get_model("Alike")(params), params, imgs0, imgs1, Fs,
            torch.Generator().manual_seed(0), DetectParams(**kw),
            LKParams(**lkw), device="cpu")
    m, k0, v0, _ = out[BF]
    assert (jaccard(k0.numpy(), v0.numpy(), np.asarray(k_ref),
                    np.asarray(v_ref)) >= JACCARD).all()
    for i in range(2):
        _assert_close_count(m["fundamental_num"][i],
                            out["float32"][0]["fundamental_num"][i],
                            "epipolar inliers bf16 vs f32")


def test_xfeat_auc_step_bf16_runs_as_jax():
    """bench.py's `bench_xfeat_auc` step in bf16: XFeat's keypoints against
    JAX's bf16 forward; LightGlue stays f32 and gets f32 maps."""
    from keypoint_bench_tpu.datasets.synthetic import \
        SyntheticSE3Dataset as JaxSE3Dataset
    items = [JaxSE3Dataset(2, S, 0, 200)[i] for i in range(2)]
    imgs0, imgs1 = (np.stack([it[k] for it in items])
                    for k in ("image0", "image1"))
    Ks = np.stack([it["warp01_params"]["intrinsics0"] for it in items])
    poses = np.stack([it["warp01_params"]["pose01"] for it in items])
    kw = dict(nms_dist=6, border_dist=8, top_k=300)
    jp = jcast({k: jnp.asarray(v) for k, v in golden_npz("XFeat").items()})
    s0, _ = jax_get_model("XFeat")(jp, jnp.asarray(imgs0))
    k_ref, v_ref = jd.detection_batch(s0, jd.DetectParams(**kw))
    model, _ = _port("XFeat")
    lg = lightglue_input_proj_params()
    err, n_in, k0, _, _, mask = xfeat_auc_step(
        model, lg, imgs0, imgs1, Ks, poses, DetectParams(**kw),
        torch.Generator().manual_seed(0), n_hyp=64, device="cpu")
    v0 = k0[..., 2].numpy() > 0
    assert (jaccard(k0.numpy(), v0, np.asarray(k_ref), np.asarray(v_ref))
            >= JACCARD).all()
    assert err.shape == n_in.shape == (2,) and bool(torch.isfinite(err).all())
    assert all(v.dtype == torch.float32 for v in lg.values())


def test_vo_step_bf16_against_jax_detection_and_f32():
    """`vo_step` in bf16 (Alike_s2d, sparse descriptors through the bf16
    sampler): its keypoints against JAX's bf16 `Alike` detections, its
    matches and poses against the port's f32 run on the same RANSAC
    samples."""
    from keypoint_bench_tpu_torch.datasets.synthetic import \
        SyntheticSplatSequenceDataset
    ds = SyntheticSplatSequenceDataset(num_frames=4, image_size=S, seed=0)
    frames = np.stack([ds[i]["image0"] for i in range(4)])
    scales = [0.0] + [float(np.linalg.norm(
        ds[i]["ground_truth"][:3, 3] - ds[i]["last_ground_truth"][:3, 3]))
        for i in range(1, 4)]
    kw = dict(nms_dist=6, border_dist=8, top_k=300)
    jp = jcast(jax_load_params("Alike"))
    s, _ = jax_get_model("Alike")(jp, jnp.asarray(frames))
    k_ref, v_ref = jd.detection_batch(s[..., 0], jd.DetectParams(**kw))
    samples = torch.from_numpy(np.random.default_rng(0).integers(
        0, 300, (4, 64, 8)))
    out = {}
    for prec in ("float32", BF):
        model, _ = _port("Alike_s2d", prec)
        out[prec] = vo_step(model, frames, ds.base.K, scales,
                            DetectParams(**kw), None, n_hyp=64,
                            samples=samples, device="cpu")
    got, f32 = out[BF], out["float32"]
    assert (jaccard(got["kpts"].numpy(), got["valid"].numpy(),
                    np.asarray(k_ref), np.asarray(v_ref)) >= JACCARD).all()
    for i in range(1, 4):
        _assert_close_count(got["match_mask"][i].sum(),
                            f32["match_mask"][i].sum(), f"frame {i}")
    assert np.isfinite(got["t_est"]).all()


def _rep_config(tmp_path, name, precision):
    """configs/repeatability_synthetic.yaml with the precision set here and
    the scale cut for the CPU (2 pairs at 128^2)."""
    with open("configs/repeatability_synthetic.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["precision"] = precision
    cfg["data_params"].update(num_pairs=2, image_size=S)
    cfg["output_dir"] = str(tmp_path / name)
    return cfg


def test_repeatability_runner_bf16_matches_jax(tmp_path):
    ref = JaxEvaluator(JaxEvalConfig.from_dict(
        _rep_config(tmp_path, "jax", BF))).run()
    got = Evaluator(EvalConfig.from_dict(_rep_config(tmp_path, "bf", BF)),
                    device="cpu").run()
    f32 = Evaluator(EvalConfig.from_dict(
        _rep_config(tmp_path, "f32", "float32")), device="cpu").run()
    assert all(v.dtype == torch.bfloat16 for v in
               Evaluator(EvalConfig.from_dict(_rep_config(
                   tmp_path, "x", BF)), device="cpu").params.values()
               if v.dim() >= 2)
    for other in (ref, f32):
        assert abs(got["repeatability"] - other["repeatability"]) < 0.02
        assert abs(got["rep_mean_err"] - other["rep_mean_err"]) < 0.05
    assert got["repeatability"] > 0.3


def test_unknown_precision_raises(tmp_path):
    with pytest.raises(ValueError, match="precision must be one of"):
        Evaluator(EvalConfig.from_dict(
            _rep_config(tmp_path, "x", "float16")), device="cpu")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return stage_golden_weights(str(tmp_path_factory.mktemp("w")))


def test_sweep_bf16_matches_jax(weights, tmp_path):
    """`precision: bfloat16` from the sweep's base config reaches every
    model's runner, as in the JAX sweep."""
    # D2Net's randomized golden weights leave ~100 keypoints a map here,
    # whose mean error moves more: 0.062 px seen, 0.1 allowed
    for models, wd, err_tol in (
            (["Alike", "LETNet", "r2d2", "Harris"], None, 0.05),
            (["D2Net"], weights, 0.1)):
        base = dict(_rep_config(tmp_path, "sweep", BF), weights_dir=wd)
        ref = jax_run_sweep(dict(base, output_dir=str(tmp_path / "j")),
                            models)
        got = run_sweep(base, models, device="cpu")
        for m in models:
            assert abs(got[m]["repeatability"]
                       - ref[m]["repeatability"]) < 0.02, m
            assert abs(got[m]["rep_mean_err"]
                       - ref[m]["rep_mean_err"]) < err_tol, m
            assert got[m]["repeatability"] > 0.1, m
