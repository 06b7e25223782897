"""The detector family in the PyTorch port vs the JAX reference (CPU,
float32): EdgePoint, GoodPoint, LETNet, KeyNet, r2d2, DISK, sfd2, D2Net,
Harris, ORB and SIFT, the s2d aliases and the shared blocks they need.

Inputs are numpy draws from a seed; JAX-layout parameters go through
`params_from_jax` unchanged (ConvTranspose and grouped kernels included);
the JAX forwards run jitted at HIGHEST conv precision, as the JAX runner
calls them. Both sides are exact float32 and differ in summation order,
so the tolerances are a few ulps of each map's scale: 1e-5 absolute for
maps in [0, 1], relative to the scale where a map is raw (EdgePoint's
score reaches ~40, ORB's ~2e3, KeyNet's ~1e4), and the instance norms of
DISK sum 64^2 values per channel (2e-5 seen, 1e-4 allowed). sfd2's
randomized golden weights overflow its exp-normalized head on about half
of the pixels: the NaNs must sit at the same places on both sides. The
golden checks use tests/test_models.py's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from keypoint_bench_tpu.models import common as jc
from keypoint_bench_tpu.models import get_model as jax_get_model
from keypoint_bench_tpu.models.tiny_s2d import (transform_goodpoint_s2d,
                                                transform_letnet_s2d)
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch.models import common as tc
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.weights import load_params, params_from_jax
from keypoint_bench_tpu_torch.weights.io import GOLDEN_DIR, golden_npz

GOLDEN_PARAMS = ("DISK", "sfd2", "D2Net")
CLASSIC = {"Harris": {"block_size": 5, "ksize": 3, "k": 0.04},
           "ORB": {"threshold": 10.0},
           "SIFT": {"n_scales": 5, "contrast_th": 0.015}}
# (atol, rtol) of the score and of the descriptor map, port vs JAX
TOL = {"LETNet": ((1e-5, 0), (1e-5, 0)),
       "GoodPoint": ((1e-5, 0), (1e-5, 0)),
       "EdgePoint": ((1e-4, 1e-5), (1e-5, 0)),
       "r2d2": ((1e-5, 0), (1e-5, 0)),
       "KeyNet": ((1e-2, 1e-5), None),
       "DISK": ((1e-4, 0), (1e-5, 0)),
       "sfd2": ((1e-5, 0), (1e-5, 0)),
       "D2Net": ((1e-7, 1e-5), (1e-5, 0)),
       "Harris": ((1e-7, 1e-5), None),
       "ORB": ((1e-3, 1e-6), None),
       "SIFT": ((1e-7, 0), None)}
# tests/test_models.py's golden tolerances (atol, rtol)
GOLDEN_TOL = {"LETNet": (2e-4, 0), "GoodPoint": (2e-4, 0),
              "EdgePoint": (2e-4, 0), "KeyNet": (1e-2, 1e-4),
              "r2d2": (5e-4, 0), "DISK": (5e-4, 0), "sfd2": (1e-3, 1e-3),
              "D2Net": (1e-3, 1e-3)}


@pytest.fixture
def highest():
    jc.set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    jc.set_conv_precision(None)


def _np_params(name):
    if name in CLASSIC:
        return CLASSIC[name]
    if name in GOLDEN_PARAMS:
        return golden_npz(name)
    return {k: np.asarray(v) for k, v in jax_load_params(name).items()}


def _both(name, img, np_params=None):
    """(JAX (score, desc), port (score, desc)) as numpy, desc None for a
    detector-only model."""
    p = np_params if np_params is not None else _np_params(name)
    if name in CLASSIC:
        jp, tp = p, p
    else:
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = params_from_jax(p)
    fn = jax_get_model(name)
    s_ref, d_ref = jax.jit(lambda x: fn(jp, x))(jnp.asarray(img))
    with torch.no_grad():
        s, d = get_model(name)(tp)(torch.from_numpy(img))

    def npy(x):
        return None if x is None else np.asarray(x)
    return (npy(s_ref), npy(d_ref)), (s.numpy(), npy(d))


@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 96, 128, 3)],
                         ids=["64x64", "96x128"])
@pytest.mark.parametrize("name", sorted(TOL))
def test_forward_matches_jax(highest, name, shape):
    img = np.random.default_rng(0).random(shape, np.float32)
    p = _np_params(name)
    (s_ref, d_ref), (s, d) = _both(name, img, p)
    (sa, sr), dtol = TOL[name]
    assert s.shape == s_ref.shape == shape[:3] + (1,)
    _assert_close(s, s_ref, sa, sr, lambda mode: _port_rerun(
        name, img, p, mode)[0])
    if dtol is None:
        assert d is None and d_ref is None
    else:
        assert d.shape == d_ref.shape
        _assert_close(d, d_ref, *dtol, lambda mode: _port_rerun(
            name, img, p, mode)[1])


def _port_rerun(name, img, np_params, mode):
    """The port's forward once more in this process: "again" as the first
    one, "mkldnn-off" with oneDNN's convolutions off, "float64" in float64
    (parameters and image). Returns (score, desc) as numpy."""
    p = np_params if name in CLASSIC else params_from_jax(np_params)
    x = torch.from_numpy(img)
    if mode == "float64":
        x = x.double()
        if name not in CLASSIC:
            p = {k: v.double() for k, v in p.items()}
    with torch.no_grad(), torch.backends.mkldnn.flags(
            enabled=mode != "mkldnn-off"):
        s, d = get_model(name)(p)(x)
    return s.numpy(), None if d is None else d.numpy()


def _assert_close(got, ref, atol, rtol, rerun):
    """assert_allclose(got, ref, atol, rtol); a failure's message adds
    `_diagnosis` with the port's forward rerun (`rerun(mode)` -> the same
    map) right after the failing one."""
    try:
        np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)
    except AssertionError as e:
        raise AssertionError(
            f"{e}\n{_diagnosis(got, ref, atol, rtol, rerun)}") from None


def _cpu_flags() -> str:
    """The vector extensions of the CPU that decide the convs' kernels."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln.split(":", 1)[1].split() for ln in f
                          if ln.startswith("flags")), [])
    except OSError:
        return "unknown"
    return " ".join(x for x in ("avx2", "avx512f", "amx_tile", "amx_bf16")
                    if x in flags) or "none of avx2 / avx512f / amx"


def _diagnosis(got, ref, atol, rtol, rerun=None) -> str:
    """What decides an assert_allclose(got, ref, atol, rtol): the worst
    point by |got - ref| / (atol + rtol |ref|), its values, and the state
    of the process that sets the convs' summation order. With `rerun`,
    the port's value there from a second forward (does a process's first
    forward differ from its second?), from a forward with oneDNN off (is
    oneDNN the part at fault?) and from a float64 forward (which side
    lies nearer to it?)."""
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    tol = atol + rtol * np.abs(ref.astype(np.float64))
    ratio = np.where(np.isnan(diff), 0.0, diff / tol)
    i = np.unravel_index(int(np.argmax(ratio)), ratio.shape)
    msg = (f"worst index {tuple(int(j) for j in i)}: port {got[i]!r}, "
           f"JAX {ref[i]!r}, |diff| {diff[i]:.3e}, tolerance "
           f"{tol[i]:.3e}, worst ratio {ratio[i]:.4f}, "
           f"{int((ratio > 1).sum())} of {ratio.size} out of tolerance; "
           f"torch threads {torch.get_num_threads()}, mkldnn enabled "
           f"{torch.backends.mkldnn.enabled}, CPU flags {_cpu_flags()}")
    if rerun is None:
        return msg
    for mode in ("again", "mkldnn-off", "float64"):
        try:
            v = rerun(mode)
        except Exception as e:  # the message must not hide the failure
            msg += f"; {mode} forward raised {e!r}"
            continue
        gap = np.abs(v.astype(np.float64) - got.astype(np.float64))
        msg += (f"; {mode} forward {v[i]!r} (max |it - first| over the "
                f"map {np.nanmax(gap):.3e}")
        if mode == "float64":
            dp = abs(float(got[i]) - float(v[i]))
            dj = abs(float(ref[i]) - float(v[i]))
            msg += (f", |port - f64| {dp:.3e}, |JAX - f64| {dj:.3e}: "
                    f"{'port' if dp < dj else 'JAX'} nearer")
        msg += ")"
    return msg


@pytest.mark.parametrize("name", sorted(GOLDEN_TOL))
def test_forward_matches_golden(name):
    g = np.load(f"{GOLDEN_DIR}/{name}.npz")
    params = (params_from_jax(golden_npz(name)) if name in GOLDEN_PARAMS
              else load_params(name))
    with torch.no_grad():
        s, d = get_model(name)(params)(
            torch.from_numpy(g["image"].transpose(0, 2, 3, 1).copy()))
    atol, rtol = GOLDEN_TOL[name]
    np.testing.assert_allclose(s[..., 0].numpy(), g["score"][:, 0],
                               atol=atol, rtol=rtol)
    if "desc" in g.files:
        np.testing.assert_allclose(d.numpy(), g["desc"].transpose(0, 2, 3, 1),
                                   atol=atol, rtol=rtol)
    else:
        assert d is None


@pytest.mark.parametrize("name,transform", [
    ("LETNet", transform_letnet_s2d), ("GoodPoint", transform_goodpoint_s2d)])
def test_s2d_aliases_match_jax_s2d(highest, name, transform):
    """`<name>_s2d` is the same class on the same checkpoint in the port;
    the JAX package runs its space-to-depth layout on transformed
    weights. Equal within 1e-5, the JAX layouts' own parity bound
    (tests/test_tiny_s2d.py)."""
    img = np.random.default_rng(1).random((2, 64, 96, 3), np.float32)
    jp = transform(jax_load_params(name))
    s_ref, d_ref = jax_get_model(f"{name}_s2d")(jp, jnp.asarray(img))
    model = get_model(f"{name}_s2d")
    assert model is get_model(name)
    params = load_params(f"{name}_s2d")
    assert sorted(params) == sorted(load_params(name))
    with torch.no_grad():
        s, d = model(params)(torch.from_numpy(img))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-5)


def test_registry_resolves_every_model():
    names = {"Alike", "Alike_s2d", "SuperPoint", "XFeat", "EdgePoint",
             "GoodPoint", "GoodPoint_s2d", "LETNet", "LETNet_s2d", "KeyNet",
             "r2d2", "DISK", "sfd2", "D2Net", "Harris", "ORB", "SIFT"}
    assert all(isinstance(get_model(n), type) for n in names)
    with pytest.raises(KeyError, match="unknown model"):
        get_model("tiny_s2d")


def test_sfd2_stability_takes_the_first_class_on_ties():
    from keypoint_bench_tpu_torch.models.sfd2 import stability
    logits = torch.tensor([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0], [0.0, 0.0, 3.0],
                           [5.0, 5.0, 5.0]]).T.reshape(1, 3, 2, 2)
    got = stability(logits).reshape(-1).tolist()
    ref = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=1))
    assert ref.reshape(-1).tolist() == [0, 1, 2, 0]
    np.testing.assert_allclose(got, [0.1, 0.5, 1.0, 0.1])


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dilation,groups,stride,pad", [
    (1, 1, 1, 1), (4, 1, 1, 4), (8, 1, 1, 4), (1, 32, 1, 1), (1, 1, 2, 1),
    (1, 1, 8, 0)])
def test_conv2d_matches_jax(highest, dilation, groups, stride, pad):
    """Dilated (r2d2's k=2 convs pad ((k-1)*d)//2), grouped (sfd2's 32
    groups) and strided convs from JAX HWIO kernels via params_from_jax."""
    rng = np.random.default_rng(2)
    ci, co, k = 64, 64, 2 if dilation > 4 else 3
    x = rng.normal(size=(2, 33, 40, ci)).astype(np.float32)
    w = rng.normal(size=(k, k, ci // groups, co)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    ref = jc.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                    pad, dilation=dilation, groups=groups)
    tp = params_from_jax({"w": w, "b": b})
    got = tc.conv2d(_nchw(x), tp["w"], tp["b"], stride, pad, dilation, groups)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("stride", [2, 4])
def test_conv_transpose2d_matches_jax(highest, stride):
    """torch's [I, O, kh, kw] ConvTranspose weight, stored [kh, kw, O, I]
    by the converter, comes back from params_from_jax as torch's own."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 24)).astype(np.float32)
    w_torch = rng.normal(size=(24, 16, stride, stride)).astype(np.float32)
    w_jax = w_torch.transpose(2, 3, 1, 0)
    b = rng.normal(size=(16,)).astype(np.float32)
    ref = jc.conv_transpose2d(jnp.asarray(x), jnp.asarray(w_jax),
                              jnp.asarray(b), stride)
    tp = params_from_jax({"w": w_jax, "b": b})
    assert torch.equal(tp["w"], torch.from_numpy(w_torch))
    got = tc.conv_transpose2d(_nchw(x), tp["w"], tp["b"], stride)
    assert got.shape == (2, 16, 5 * stride, 7 * stride)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def test_norms_prelu_and_filters_match_jax(highest):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 20, 24, 6)).astype(np.float32)
    gamma, beta, alpha = (rng.normal(size=(6,)).astype(np.float32)
                          for _ in range(3))
    tx = _nchw(x)
    pairs = [
        (tc.instance_norm(tx), jc.instance_norm(jnp.asarray(x))),
        (tc.instance_norm(tx, torch.from_numpy(gamma),
                          torch.from_numpy(beta)),
         jc.instance_norm(jnp.asarray(x), jnp.asarray(gamma),
                          jnp.asarray(beta))),
        (tc.prelu(tx, torch.from_numpy(alpha)),
         jc.prelu(jnp.asarray(x), jnp.asarray(alpha))),
        (tc.gaussian_pyr_blur(tx), jc.gaussian_pyr_blur(jnp.asarray(x)))]
    pairs += list(zip(tc.sobel_gradients(tx),
                      jc.sobel_gradients(jnp.asarray(x))))
    for got, ref in pairs:
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)
    # bn_eval without affine against the JAX package's 1.0 / 0.0 form
    # (the two rsqrt implementations part by an ulp)
    mean, var = rng.normal(size=(6,)).astype(np.float32), \
        rng.random(6).astype(np.float32)
    np.testing.assert_allclose(
        _nhwc(tc.bn_eval(tx, None, None, torch.from_numpy(mean),
                         torch.from_numpy(var))),
        np.asarray(jc.bn_eval(jnp.asarray(x), 1.0, 0.0, jnp.asarray(mean),
                              jnp.asarray(var))), rtol=1e-6, atol=1e-6)


def test_gray_mean_matches_jitted_jax():
    img = np.random.default_rng(5).random((2, 16, 16, 3), np.float32)
    for scale in (1.0, 255.0):
        ref = jax.jit(lambda x: jnp.mean(x, axis=-1) * scale)(
            jnp.asarray(img))
        np.testing.assert_array_equal(
            tc.gray_mean(torch.from_numpy(img), scale).numpy(),
            np.asarray(ref))


def test_uint8_input_is_scaled():
    """uint8 frames are divided by 255 in every model (the JAX per-pair
    path's missing /255 is not copied)."""
    img = np.random.default_rng(6).integers(0, 256, (1, 64, 64, 3),
                                            dtype=np.uint8)
    for name in ("LETNet", "r2d2", "Harris"):
        m = get_model(name)(CLASSIC.get(name) or load_params(name))
        with torch.no_grad():
            su, _ = m(torch.from_numpy(img))
            sf, _ = m(torch.from_numpy(img.astype(np.float32) / 255.0))
        assert torch.equal(su, sf)


def _im2col_conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """F.conv2d (groups 1) as unfold + matmul: another summation order."""
    n, _, h, wd = x.shape
    cols = F.unfold(x, w.shape[-2:], dilation, padding, stride)
    oh = (h + 2 * padding - dilation * (w.shape[-2] - 1) - 1) // stride + 1
    y = (w.reshape(w.shape[0], -1) @ cols).reshape(n, w.shape[0], oh, -1)
    return y if b is None else y + b[:, None, None]


@pytest.mark.parametrize("order", ["threads-1", "threads-2", "onednn-off",
                                   "im2col"])
def test_d2net_score_spread_over_summation_orders(monkeypatch, order):
    """D2Net's score in f32 under other conv summation orders (torch
    threads, oneDNN off, an unfold + matmul conv) against its float64
    forward, on test_forward_matches_jax's 64x64 input: within 1e-5 of
    the largest score (5.1e-7 to 8.5e-7 seen), under that test's rtol.
    Soft detection's channel-max ratio has no 0/0 there: every pixel's
    largest relu'd conv4_3 feature is far above 0 (6.9e8 seen)."""
    p = params_from_jax(golden_npz("D2Net"))
    img = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3),
                                                           np.float32))
    model = get_model("D2Net")
    with torch.no_grad():
        s64 = model({k: v.double() for k, v in p.items()})(img.double())[0]
    threads = torch.get_num_threads()
    if order.startswith("threads-"):
        torch.set_num_threads(int(order[-1]))
    elif order == "onednn-off":
        monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    else:
        monkeypatch.setattr(F, "conv2d", _im2col_conv2d)
    try:
        with torch.no_grad():
            s = model(p)(img)[0]
            feat = model(p).features(img)
    finally:
        torch.set_num_threads(threads)
    top = float(s64.abs().max())
    assert float((s.double() - s64).abs().max()) <= 1e-5 * top
    assert float(feat.clamp_min(0).amax(1).min()) > 1e3
