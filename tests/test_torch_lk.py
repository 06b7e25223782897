"""Pyramidal Lucas-Kanade in the PyTorch port vs the JAX reference (CPU).

The port runs its plain versions here (`_lk_level` is the plain version of
the CUDA LK-level kernel). Tolerances:
  * `_gradients`, `_avg_pool_img`, `_window_bilinear`: 1e-6 absolute, the
    same float32 arithmetic in another summation order;
  * `_lk_level`: 5e-3 px absolute, the JAX package's own tolerance between
    its Pallas kernel and `_lk_level` (tests/test_pallas_lk.py): up to 10
    Gauss-Newton steps amplify summation-order differences of the five
    sums;
  * `optical_flow_batch_from_angles` fed JAX's own jitter angles: tracked
    points 1e-4 in normalized coordinates (5e-3 px at these sizes), `err`
    5e-3 px.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ops import lk as jlk
from keypoint_bench_tpu.ops.pallas_lk import lk_level_pallas
from keypoint_bench_tpu_torch.ops import lk as tlk
from keypoint_bench_tpu_torch.ops.cuda_lk import lk_level, lk_level_cuda


def _textured(h, w, seed, c=3):
    rng = np.random.default_rng(seed)
    base = rng.random((h // 4, w // 4, c)).astype(np.float32)
    img = np.kron(base, np.ones((4, 4, 1), np.float32))
    # a smooth ramp keeps gradients informative inside the 4x4 blocks
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return img + 0.1 * np.sin(xs / 3.0)[..., None] * np.cos(ys / 5.0)[
        ..., None]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("c", [1, 3])
def test_gradients_match_jax(c):
    img = _textured(48, 64, 0, c)
    dx, dy = tlk._gradients(_t(img))
    jdx, jdy = jlk._gradients(jnp.asarray(img))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-6)
    np.testing.assert_allclose(dy.numpy(), np.asarray(jdy), atol=1e-6)


def test_gradients_take_a_batch():
    imgs = np.stack([_textured(32, 48, s) for s in range(3)])
    dx, dy = tlk._gradients(_t(imgs))
    for b in range(3):
        one = tlk._gradients(_t(imgs[b]))
        np.testing.assert_array_equal(dx[b].numpy(), one[0].numpy())
        np.testing.assert_array_equal(dy[b].numpy(), one[1].numpy())


@pytest.mark.parametrize("k", [2, 4, 3])
def test_avg_pool_matches_jax(k):
    img = _textured(52, 64, 1)[:50]   # 50 % 4 != 0: VALID drops the rest
    got = tlk._avg_pool_img(_t(img), k)
    want = np.asarray(jlk._avg_pool_img(jnp.asarray(img), k))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _points(kind, h, w, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "interior":
        return rng.uniform(12, min(h, w) - 12, (n, 2)).astype(np.float32)
    if kind == "border":
        edge = np.array([[3.2, 4.1], [w - 4.0, 2.5], [2.2, h - 3.5],
                         [w - 3.3, h - 2.9], [40.0, 3.0], [0.0, 0.0],
                         [w - 1.0, h - 1.0], [0.4, h / 2]], np.float32)
        return edge
    # off the image, some beyond the padded field: the start clamp holds
    return np.array([[-5.5, 10.0], [w + 3.2, 20.0], [30.0, -7.7],
                     [30.0, h + 9.1], [-40.0, -40.0], [w + 60.0, h + 60.0],
                     [-12.0, h / 2], [w / 2, h + 30.0]], np.float32)


@pytest.mark.parametrize("win", [3, 11, 21])
@pytest.mark.parametrize("kind", ["interior", "border", "off"])
def test_window_bilinear_matches_jax(kind, win):
    h, w = 64, 80
    img = _textured(h, w, 2)
    pad = win + 1
    pts = _points(kind, h, w, 16, 3)
    fp = np.pad(img, ((pad, pad), (pad, pad), (0, 0)))
    got = tlk._window_bilinear(_t(fp), _t(pts), win, pad)
    want = np.asarray(jlk._window_bilinear(jnp.asarray(fp), jnp.asarray(pts),
                                           win, pad))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("win", [3, 11, 21])
@pytest.mark.parametrize("kind", ["interior", "border", "off"])
def test_lk_level_matches_jax(kind, win, c):
    h, w = 64, 80
    img1 = _textured(h, w, 4, c)
    img2 = np.roll(img1, (1, -2), axis=(0, 1))
    pts1 = _points(kind, h, w, 24, 5)
    rng = np.random.default_rng(6)
    pts2 = pts1 + rng.uniform(-2, 2, pts1.shape).astype(np.float32)
    got = tlk._lk_level(_t(img1), _t(img2), _t(pts1), _t(pts2), win, 8)
    want = np.asarray(jlk._lk_level(jnp.asarray(img1), jnp.asarray(img2),
                                    jnp.asarray(pts1), jnp.asarray(pts2),
                                    win, 8))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)


def test_lk_level_batch_matches_pallas_interpret():
    """The batched plain level against the TPU kernel in interpret mode, on
    interior points (the TPU kernel clamps the point, `_lk_level` the
    window's start: they agree where no window leaves the padded field)."""
    h, w, b, n, win = 64, 80, 2, 40, 11
    imgs1 = np.stack([_textured(h, w, s) for s in range(b)])
    imgs2 = np.stack([np.roll(im, (1, -2), axis=(0, 1)) for im in imgs1])
    rng = np.random.default_rng(3)
    pts1 = rng.uniform(12, min(h, w) - 12, (b, n, 2)).astype(np.float32)
    pts2 = pts1 + rng.uniform(-2, 2, (b, n, 2)).astype(np.float32)
    got = lk_level(_t(imgs1), _t(imgs2), _t(pts1), _t(pts2), win, 8)
    want = np.asarray(lk_level_pallas(
        jnp.asarray(imgs1), jnp.asarray(imgs2), jnp.asarray(pts1),
        jnp.asarray(pts2), win, 8, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)


def test_lk_level_cuda_refuses_cpu_tensors():
    """The kernel's launcher never takes the plain version: a CPU tensor
    is an error there (on a machine without nvcc the build fails first)."""
    x = torch.zeros(1, 16, 16, 3)
    p = torch.zeros(1, 4, 2)
    with pytest.raises((ValueError, RuntimeError)):
        lk_level_cuda(x, x, p, p, 3, 2)


def _jax_angles(seed, b, n):
    keys = jax.random.split(jax.random.key(seed), b)
    ang = np.stack([np.asarray(jax.random.normal(k, (n,)) * 6.28)
                    for k in keys])
    return keys, ang


@pytest.mark.parametrize("levels,distance", [(2, 0.0), (2, 10.0), (3, 0.0),
                                             (3, 10.0)])
def test_optical_flow_batch_matches_jax(levels, distance):
    h, w, b, n = 96, 128, 2, 32
    imgs1 = np.stack([_textured(h, w, 10 + s) for s in range(b)])
    imgs2 = np.stack([np.roll(im, (2, -3), axis=(0, 1)) for im in imgs1])
    rng = np.random.default_rng(11)
    pts = rng.uniform(0.05, 0.95, (b, n, 3)).astype(np.float32)
    keys, ang = _jax_angles(7, b, n)
    jp = jlk.LKParams(distance=distance, win_size=11, levels=levels,
                      iterations=10)
    tp = tlk.LKParams(distance=distance, win_size=11, levels=levels,
                      iterations=10)
    # on the CPU the JAX package takes its XLA level loop
    want_t, want_e = jlk.optical_flow_batch(
        jnp.asarray(imgs1), jnp.asarray(imgs2), jnp.asarray(pts),
        jnp.asarray(pts), keys, jp)
    got_t, got_e = tlk.optical_flow_batch_from_angles(
        _t(imgs1), _t(imgs2), _t(pts), _t(pts), _t(ang), tp)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-4)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=5e-3)


def test_jitter_radius_and_clip():
    """With no iteration the tracked points are the jittered start: on a
    circle of radius `distance` around the point, clipped to [10, S-10]."""
    h, w, n = 64, 96, 50
    img = _t(_textured(h, w, 0))[None]
    rng = np.random.default_rng(2)
    pts = _t(rng.uniform(0.0, 1.0, (1, n, 2)).astype(np.float32))
    g = torch.Generator().manual_seed(3)
    p = tlk.LKParams(distance=7.0, win_size=3, levels=1, iterations=0)
    tracked, err = tlk.optical_flow_batch(img, img, pts, pts, g, p)
    scale = torch.tensor([w - 1.0, h - 1.0])
    start = tracked * scale
    assert float(start[..., 0].min()) >= 10 - 1e-4
    assert float(start[..., 0].max()) <= w - 10 + 1e-4
    assert float(start[..., 1].min()) >= 10 - 1e-4
    assert float(start[..., 1].max()) <= h - 10 + 1e-4
    p0 = pts * scale
    inside = ((p0[..., 0] > 17) & (p0[..., 0] < w - 17) & (p0[..., 1] > 17)
              & (p0[..., 1] < h - 17))
    assert int(inside.sum()) > 5
    r = torch.linalg.vector_norm(start - p0, dim=-1)
    np.testing.assert_allclose(r[inside].numpy(), 7.0, atol=1e-3)
    np.testing.assert_allclose(err[inside].numpy(), 7.0, atol=1e-3)
    assert float(err.max()) <= 8.0


def test_generator_seed_is_deterministic():
    h, w, n = 64, 96, 20
    img1 = _t(_textured(h, w, 0))
    img2 = _t(np.roll(_textured(h, w, 0), (1, 2), axis=(0, 1)))
    pts = _t(np.random.default_rng(1).uniform(0.2, 0.8, (n, 2)).astype(
        np.float32))
    p = tlk.LKParams(distance=3.0, win_size=5, levels=2, iterations=5)
    runs = [tlk.optical_flow(img1, img2, pts, pts,
                             torch.Generator().manual_seed(s), p)[0]
            for s in (5, 5, 6)]
    np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())
    assert not np.array_equal(runs[0].numpy(), runs[2].numpy())


def test_lk_recovers_translation():
    """The protocol end to end, as tests/test_lk.py holds the JAX package:
    most points recover a known shift to within half a pixel."""
    from scipy.signal import convolve2d
    h, w = 128, 160
    rng = np.random.default_rng(0)
    base = rng.random((h // 4, w // 4, 1)).astype(np.float32)
    img = np.kron(base, np.ones((4, 4, 1), np.float32))
    img[..., 0] = convolve2d(img[..., 0], np.ones((3, 3)) / 9, mode="same",
                             boundary="symm")
    img = np.repeat(img, 3, axis=2)
    dx, dy = 3, -2
    img2 = np.zeros_like(img)
    img2[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        img[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    pts = np.random.default_rng(1).uniform(0.25, 0.75, (50, 2)).astype(
        np.float32)
    tracked, _ = tlk.optical_flow(
        _t(img), _t(img2), _t(pts), _t(pts), torch.Generator().manual_seed(0),
        tlk.LKParams(distance=3, win_size=11, levels=2, iterations=30))
    flow = (tracked.numpy() - pts) * np.array([w - 1, h - 1])
    good = (np.abs(flow[:, 0] - dx) < 0.5) & (np.abs(flow[:, 1] - dy) < 0.5)
    assert good.mean() > 0.8, flow[:5]


def test_optical_flow_cv_equals_jax_package():
    """Both are cv2 on the host with the same arguments: equal."""
    h, w = 96, 128
    img0 = np.clip(_textured(h, w, 3), 0, 1)
    img1 = np.roll(img0, (1, 2), axis=(0, 1))
    pts = np.random.default_rng(4).uniform(0.1, 0.9, (30, 3)).astype(
        np.float32)
    got = tlk.optical_flow_cv(img0, img1, pts, pts, 15, 3)
    want = jlk.optical_flow_cv(img0, img1, pts, pts, 15, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
