"""DISK + LightGlue through the runners on converted weights (CPU, 128^2,
2 pairs, top_k 128).

The reference's checkpoints of DISK (nested under 'extractor') and of
the disk LightGlue (with its 128 -> 256 input_proj, std 1) are written
from the golden randomized parameters (weights/upstream.py) and converted
by the port's converter; both runners load that directory.

The randomized LightGlue reaches log assignment scores of thousands, and
float32 rounding grows from layer to layer (from 2e-5 of the largest
score at depth 1 to about 0.2 at depth 9, against float64), so at full
depth two float32 programs agree only by chance, and the fixed-depth run
finds no match (its mscores are about 1e-20). So, for each pair, at
LightGlue's fixed depth and in adaptive mode:
- the runners in float32: keypoints and masks equal, the matched
  keypoints and match mask equal, the runs' MHA values equal, no
  fallback to brute force;
- LightGlue in float64 on the port's runner's inputs, both packages:
  the log assignment scores at depth 9 within 1e-6 of the largest score
  (masked entries masked on both sides; about 4e-8 measured); then, in
  adaptive mode, the layers run, and at the fixed depth, the forward cut
  to 2 layers, where matches exist: the matches equal and their mscores
  within 1e-9.
Each case holds mscores far above that tolerance (some match above
0.5), so a wrong transformer, rotary encoding or assignment head fails.
The adaptive case reuses the fixed case's JAX evaluator (and its
compiled DISK detection) under the adaptive config: the two configs load
the same parameters, and the JAX runner reads `adaptive` when it matches.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models import lightglue as jlg
from keypoint_bench_tpu.models import lightglue_adaptive as jla
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.models import lightglue as tlg
from keypoint_bench_tpu_torch.models import lightglue_adaptive as tla
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.weights import load_npz, load_params
from keypoint_bench_tpu_torch.weights.convert import main as convert
from keypoint_bench_tpu_torch.weights.upstream import (
    upstream_params, write_upstream_checkpoints)

S = 128
EP = {"nms_dist": 4, "threshold": 0, "border_dist": 8, "top_k": 128,
      "min_score": 0.0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's converter's output from the upstream checkpoints."""
    src = str(tmp_path_factory.mktemp("upstream"))
    write_upstream_checkpoints(src, upstream_params(["DISK",
                                                     "lightglue_disk"]))
    dst = str(tmp_path_factory.mktemp("converted"))
    converted, _ = convert(src, dst)
    assert [n for n, _ in converted] == ["DISK", "lightglue_disk"]
    return dst


def _cfg(weights_dir, out, adaptive):
    return dict(model_type="DISK", task_type="MHA",
                data_params={"type": "synthetic_homography", "num_pairs": 2,
                             "image_size": S},
                extractor_params=EP,
                matcher_params={"type": "light_glue", "light_glue_params": {
                    "adaptive": adaptive, "allow_fallback": False}},
                task_params={"th": [3, 5, 7]},
                weights_dir=weights_dir, output_dir=str(out))


@pytest.fixture(scope="module")
def jax_fixed(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    return JaxEvaluator(JaxEvalConfig(**_cfg(weights, out, False)))


def _jax_evaluator(jax_fixed, weights, out, adaptive):
    if not adaptive:
        return jax_fixed
    ev = copy.copy(jax_fixed)
    ev.cfg = JaxEvalConfig(**_cfg(weights, out, True))
    return ev


def _pair(ev, batch, to_np):
    """(kpts0, valid0, m0, m1, ok) of one pair through the runner's maps
    and matcher, and the port's LightGlue inputs (numpy) from the port's
    runner (None from the JAX one)."""
    img0, img1, s0, d0, k0, v0, s1, d1, k1, v1 = ev._pair_maps(batch)
    _, _, va = ev._warp(k0, v0, batch["warp01_params"])
    _, _, vb = ev._warp(k1, v1, batch["warp10_params"])
    w, h = img0.shape[1], img0.shape[0]
    m0, m1, ok = ev._match(k0, va, k1, vb, d0, d1, w, h)
    ins = None
    if isinstance(k0, torch.Tensor):
        p0, p1 = k0[:, :2] * (w - 1.0), k1[:, :2] * (w - 1.0)
        ins = [x.numpy() for x in (p0, va, tlg.sample_descriptors_lg(
            p0, d0, 1), p1, vb, tlg.sample_descriptors_lg(p1, d1, 1))]
    return [to_np(x) for x in (k0, v0, m0, m1, ok)], ins


def _jax_scores(p, k0, v0, d0, k1, v1, d1, n_layers):
    """The JAX forward up to the assignment head, from its own blocks."""
    d0 = jlg._linear(p, "input_proj", d0)
    d1 = jlg._linear(p, "input_proj", d1)
    enc0 = jlg._posenc(p, jlg.normalize_keypoints_masked(k0, v0))
    enc1 = jlg._posenc(p, jlg.normalize_keypoints_masked(k1, v1))
    for i in range(n_layers):
        pre = f"transformers.{i}"
        d0 = jlg._self_block(p, f"{pre}.self_attn", d0, enc0, v0, 4)
        d1 = jlg._self_block(p, f"{pre}.self_attn", d1, enc1, v1, 4)
        d0, d1 = jlg._cross_block(p, f"{pre}.cross_attn", d0, d1, v0, v1, 4)
    return jlg._assignment_scores(p, f"log_assignment.{n_layers - 1}", d0,
                                  d1, v0, v1)


_jax_scores_jit = jax.jit(_jax_scores, static_argnames="n_layers")


def _check_f64(weights, ins, adaptive):
    """LightGlue in float64 on one pair's inputs, JAX against the port:
    the scores at depth 9, then the adaptive forward, or the fixed one cut
    to 2 layers. Returns the mscores of the matches compared."""
    raw = load_npz("lightglue_disk", weights)
    p64 = {k: v.double() for k, v in
           load_params("lightglue_disk", weights).items()}
    x64 = [x.astype(np.float64) if x.dtype == np.float32 else x
           for x in ins]
    t_in = [torch.from_numpy(x) for x in x64]
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v, jnp.float64) for k, v in raw.items()}
        j_in = [jnp.asarray(x) for x in x64]
        want = np.asarray(_jax_scores_jit(jp, *j_in, n_layers=9))
        ref = [np.asarray(x) for x in (
            jla.lightglue_forward_adaptive(jp, *j_in) if adaptive else
            jlg.lightglue_forward(jp, *j_in, n_layers=2))]
    got = tlg.lightglue_scores(p64, *t_in).numpy()
    live = want > -1e8
    assert np.array_equal(got > -1e8, live)
    scale = np.abs(want[live]).max()
    assert scale > 1e3         # the randomized weights' large scores
    assert np.abs(got - want)[live].max() <= 1e-6 * scale
    if adaptive:
        m0, ms, ok, i_fin = tla.lightglue_forward_adaptive(p64, *t_in)
        assert i_fin == int(ref[3])
    else:
        m0, ms, ok = tlg.lightglue_forward(p64, *t_in, n_layers=2)
    np.testing.assert_array_equal(m0.numpy(), ref[0])
    np.testing.assert_array_equal(ok.numpy(), ref[2])
    np.testing.assert_allclose(ms.numpy(), ref[1], atol=1e-9, rtol=0)
    return ms.numpy()[ok.numpy()]


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed", "adaptive"])
def test_disk_lightglue_equals_jax_runner(weights, jax_fixed, tmp_path,
                                          adaptive):
    cfg = _cfg(weights, tmp_path / "t", adaptive)
    jev = _jax_evaluator(jax_fixed, weights, tmp_path / "j", adaptive)
    tev = Evaluator(EvalConfig(**cfg), "cpu")
    assert tev.matcher_fallback is None and tev.lightglue_params is not None
    assert tuple(tev.lightglue_params["input_proj.weight"].shape) == (256,
                                                                      128)
    assert (tev.lightglue_forward is tla.lightglue_forward_adaptive) \
        == adaptive
    ds = get_dataset(cfg["data_params"])
    compared = []
    for i in range(len(ds)):
        ref, _ = _pair(jev, ds[i], np.asarray)
        got, ins = _pair(tev, ds[i], lambda t: t.numpy())
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[1].sum() == EP["top_k"]
        np.testing.assert_array_equal(got[0][:, :2], ref[0][:, :2])
        np.testing.assert_allclose(got[0][:, 2], ref[0][:, 2], atol=1e-5)
        np.testing.assert_array_equal(got[4], ref[4])
        np.testing.assert_array_equal(got[2][:, :2], ref[2][:, :2])
        np.testing.assert_array_equal(got[3][got[4], :2],
                                      ref[3][ref[4], :2])
        compared.append(_check_f64(weights, ins, adaptive))
    # real matches were compared, far above the mscores' tolerance
    assert np.concatenate(compared).max() > 0.5
    res, jres = tev.run(), jev.run()
    assert "matcher_fallback" not in res
    for t in (3, 5, 7):
        assert res[f"MHA@{t}"] == jres[f"MHA@{t}"]
    assert res["per_pair"] == [list(map(float, r)) for r in
                               jres["per_pair"]]


def test_converted_input_proj_is_the_disk_schema(weights):
    """The converted lightglue_disk file holds the 128 -> 256 projection
    in the JAX layout [in, out], beside the 256-wide transformer."""
    p = load_npz("lightglue_disk", weights)
    assert p["input_proj.weight"].shape == (128, 256)
    assert p["transformers.0.self_attn.Wqkv.weight"].shape == (256, 768)
