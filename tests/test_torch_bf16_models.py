"""bf16 mode's forwards in the PyTorch port vs the JAX reference (CPU).

Both sides take the same numpy weights: the JAX side through its
`cast_params_bf16`, jitted at the backend's default conv precision, as
bench.py and the JAX runner run bf16; the port through its own
`cast_params_bf16` on `params_from_jax`'s tensors (numpy has no bf16, so
the cast is made on the torch side from the same f32 arrays).

Both round to bf16 at the same points (every conv with bf16 weights
stores bf16; an f32 bias promotes to f32; BatchNorm in f32, stored back)
and differ in the f32 summation order inside each conv. Where a sum lies
next to a bf16 rounding boundary the two round it to neighbouring bf16
values, and later layers carry that ulp on. So each map is held in bf16
ulps of its largest value (ulp = 2^(floor(log2 max|ref|) - 7)): at most
`cap` ulps everywhere and at most a share `frac` of the elements beyond
4 ulps. The caps are about twice, the shares three times, the largest
seen at both shapes on the CPU (the measurements are in the table). The
outliers sit behind a saturating head: a softmax or sigmoid of logits in
the tens or hundreds (SuperPoint's, XFeat's, DISK's randomized golden
weights), where one flipped ulp upstream moves a logit by more than 1.
sfd2's golden head overflows `exp` on about 55% of its pixels on both
sides: the NaN positions may part on the pixels whose logit is at the
overflow threshold (0.25% seen, 1% allowed), and the finite pixels are
held as the other maps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models import common as jc
from keypoint_bench_tpu.models import get_model as jax_get_model
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.models.common import cast_params_bf16
from keypoint_bench_tpu_torch.weights import load_params, params_from_jax
from keypoint_bench_tpu_torch.weights.io import golden_npz


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN_PARAMS = ("SuperPoint", "XFeat", "DISK", "sfd2", "D2Net")
# (cap ulps, share beyond 4 ulps) of the score and of the descriptor map;
# seen at 64^2 / 96x128 in the comments (max ulps, share beyond 4)
TOL = {
    "Alike": ((12, 0.003), (6, 0)),          # 4.5/6.0, 7e-4; 2.25/1.25
    "SuperPoint": ((256, 0.002), (4, 0)),    # 64/128, 5e-4; 1.69/1.87
    "XFeat": ((40, 0.02), (10, 0.001)),      # 16.6/9.28, 6e-3; 3.1/4.31
    "EdgePoint": ((4, 0), (6, 0)),           # 1.11/1.08; 2.75/1.5
    "GoodPoint": ((4, 0), (4, 0)),           # 1.0/1.5; 2.0/2.0
    "LETNet": ((20, 0.005), (4, 0)),         # 5/10, 1.3e-3; 2.0/2.0
    "KeyNet": ((4, 0), None),                # 0.76/0.60
    "r2d2": ((10, 0.001), (6, 0.001)),       # 2.85/4.45; 2.0/2.88
    "DISK": ((28, 0.06), (8, 0.001)),        # 9.92/13.24, 0.018; 2.47/3.33
    "sfd2": ((4, 0), (6, 0)),                # finite pixels 0; 1.94/2.12
    "D2Net": ((6, 0.001), (4, 0)),           # 1.41/2.21; 1.09/1.26
}
NAN_PARTED = 0.01   # sfd2: NaN positions that may part


def _np_params(name):
    if name in GOLDEN_PARAMS:
        return golden_npz(name)
    return {k: np.asarray(v) for k, v in jax_load_params(name).items()}


def ulp_errors(ref: np.ndarray, got: np.ndarray) -> np.ndarray:
    """|got - ref| in bf16 ulps of ref's largest finite magnitude, over
    the elements finite on both sides (a map of zeros, as sfd2's finite
    pixels are, must be matched exactly)."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    fin = np.isfinite(ref) & np.isfinite(got)
    top = np.abs(ref[fin]).max()
    ulp = (2.0 ** (np.floor(np.log2(top)) - 7) if top > 0
           else np.finfo(np.float32).tiny)
    return np.abs(got[fin] - ref[fin]) / ulp


def assert_ulps(ref, got, cap, frac, what=""):
    err = ulp_errors(ref, got)
    beyond = float((err > 4).mean())
    assert err.max() <= cap and beyond <= frac, (
        f"{what}: max {err.max():.2f} ulps (cap {cap}), {beyond:.5f} "
        f"beyond 4 ulps (allowed {frac})")


def _both(name, img, jax_name=None):
    """(JAX, port) (score, desc) in f32 numpy, each with its dtypes."""
    p = _np_params(name)
    jp = jc.cast_params_bf16({k: jnp.asarray(v) for k, v in p.items()})
    tp = cast_params_bf16(params_from_jax(p))
    fn = jax_get_model(jax_name or name)
    s_ref, d_ref = jax.jit(lambda x: fn(jp, x))(jnp.asarray(img))
    with torch.no_grad():
        s, d = get_model(name)(tp)(torch.from_numpy(img))

    def jnp32(x):
        return None if x is None else (np.asarray(x.astype(jnp.float32)),
                                       str(x.dtype))

    def t32(x):
        return None if x is None else (x.float().numpy(),
                                       str(x.dtype).replace("torch.", ""))
    return (jnp32(s_ref), jnp32(d_ref)), (t32(s), t32(d))


@pytest.mark.parametrize("name", sorted(TOL))
def test_cast_params_bf16_matches_jax(name):
    """Same keys; rank >= 2 in bf16, the rest f32; equal values."""
    p = _np_params(name)
    ref = jc.cast_params_bf16({k: jnp.asarray(v) for k, v in p.items()})
    got = cast_params_bf16(params_from_jax(p))
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        want = torch.bfloat16 if v.dim() >= 2 else torch.float32
        assert v.dtype == want and str(ref[k].dtype) == str(want)[6:], k
        # params_from_jax carries the JAX package's bf16 arrays across
        carried = params_from_jax({k: np.asarray(ref[k])})[k]
        assert carried.dtype == v.dtype and torch.equal(carried, v), k


def test_load_params_precision():
    f32 = load_params("Alike")
    bf = load_params("Alike", precision="bfloat16")
    assert sorted(bf) == sorted(f32)
    for k, v in bf.items():
        assert torch.equal(v, cast_params_bf16(f32)[k])
    with pytest.raises(ValueError, match="precision must be one of"):
        load_params("Alike", precision="float16")


@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 96, 128, 3)],
                         ids=["64x64", "96x128"])
@pytest.mark.parametrize("name", sorted(TOL))
def test_forward_bf16_matches_jax(name, shape):
    img = np.random.default_rng(0).random(shape, np.float32)
    (s_ref, d_ref), (s, d) = _both(name, img)
    (sc, sf), dtol = TOL[name]
    assert s[1] == s_ref[1] and s[0].shape == shape[:3] + (1,)
    if name == "sfd2":
        parted = np.isnan(s[0]) != np.isnan(s_ref[0])
        assert parted.mean() <= NAN_PARTED
    assert_ulps(s_ref[0], s[0], sc, sf, f"{name} score")
    if dtol is None:
        assert d is None and d_ref is None
    else:
        assert d[1] == d_ref[1] and d[0].shape == d_ref[0].shape
        assert_ulps(d_ref[0], d[0], *dtol, f"{name} desc")


def test_alike_s2d_bf16_is_alike():
    """The port's Alike_s2d is Alike (the JAX package's s2d layout is a TPU
    layout that rounds at other points, compared at the metric level in
    tests/test_torch_bf16_steps.py): held against JAX `Alike` as Alike
    is."""
    img = np.random.default_rng(3).random((1, 64, 96, 3), np.float32)
    (s_ref, d_ref), (s, d) = _both("Alike_s2d", img, jax_name="Alike")
    assert get_model("Alike_s2d") is get_model("Alike")
    assert s[1] == s_ref[1] == "bfloat16" == d[1] == d_ref[1]
    assert_ulps(s_ref[0], s[0], *TOL["Alike"][0], "score")
    assert_ulps(d_ref[0], d[0], *TOL["Alike"][1], "desc")


def test_alike_feats_bf16():
    """`feats` in bf16: branch features in bf16 (kernel B's bf16 maps), the
    score as `forward`'s within its bound (the head is split per branch
    before upsampling, so it rounds at other points)."""
    img = np.random.default_rng(4).random((2, 64, 64, 3), np.float32)
    params = load_params("Alike", precision="bfloat16")
    model = get_model("Alike")(params)
    with torch.no_grad():
        s_fwd, _ = model(torch.from_numpy(img))
        s, feats = model.feats(torch.from_numpy(img))
    assert s.dtype == torch.bfloat16 and s.shape == s_fwd.shape
    assert [f.dtype for f in feats] == [torch.bfloat16] * 4
    assert [tuple(f.shape[-2:]) for f in feats] == [(64, 64), (32, 32),
                                                    (8, 8), (2, 2)]
    assert_ulps(s_fwd.float().numpy(), s.float().numpy(), 12, 0.01)


@pytest.mark.parametrize("name", ["Harris", "ORB", "SIFT"])
def test_classic_detectors_hold_no_weights_to_cast(name, tmp_path):
    """Harris, ORB and SIFT take `model_params` numbers: the runner in bf16
    mode leaves them as they are, as the JAX runner casts only loaded
    weights."""
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    cfg = {"Harris": {"block_size": 5, "ksize": 3, "k": 0.04},
           "ORB": {"threshold": 10.0},
           "SIFT": {"n_scales": 5, "contrast_th": 0.015}}[name]
    ev = Evaluator(EvalConfig(
        model_type=name, task_type="repeatability",
        data_params={"type": "synthetic_homography", "num_pairs": 1,
                     "image_size": 64},
        model_params=cfg, precision="bfloat16",
        output_dir=str(tmp_path)), device="cpu")
    assert ev.params == cfg
