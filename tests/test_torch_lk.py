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


# --- kernel F's per-point loop, rehearsed in numpy float32 -----------------

def _mirror_window(img, sy, sx, s):
    """The s x s x C window whose top-left pixel is (sy, sx); 0 outside."""
    h, w, c = img.shape
    out = np.zeros((s, s, c), np.float32)
    r0, r1 = max(0, -sy), min(s, h - sy)
    c0, c1 = max(0, -sx), min(s, w - sx)
    if r1 > r0 and c1 > c0:
        out[r0:r1, c0:c1] = img[sy + r0:sy + r1, sx + c0:sx + c1]
    return out.reshape(s, s * c)


def _mirror_start(p0, half, win, n):
    f = min(max(float(p0), -1.0e8), 1.0e8)
    return min(max(int(f) - half, -(win + 1)), n)


def _mirror_gradients(wnd, sy, sx, h, w, c, g):
    """Separable, as the kernel forms them: 3-tap row sums shared by the
    corner above and below, 3-tap column sums left and right; 0 at corners
    outside the image."""
    gc = g * c
    two = np.float32(2.0)
    left, mid, right = wnd[:, 0:gc], wnd[:, c:c + gc], wnd[:, 2 * c:2 * c + gc]
    hs = (left + two * mid) + right
    gx = ((left[0:g] + two * left[1:g + 1]) + left[2:g + 2]) - (
        (right[0:g] + two * right[1:g + 1]) + right[2:g + 2])
    gy = hs[0:g] - hs[2:g + 2]
    rows_in = (sy + np.arange(g) >= 0) & (sy + np.arange(g) < h)
    j = np.arange(gc)
    cols_in = (j >= max(0, -sx) * c) & (j < min(g, w - sx) * c)
    keep = rows_in[:, None] & cols_in[None, :]
    return (np.where(keep, gx, 0).astype(np.float32),
            np.where(keep, gy, 0).astype(np.float32))


def lk_point_mirror(img1, img2, p1, p2, win, iterations, nwarps):
    """One point through csrc/lk.cu's loop: windows cached on the integer
    start, a warp per band of patch rows, a lane per row element walking
    down its band, xor-tree sums within a warp, warps added in order, the
    2x2 solve in f32. Returns (point, number of window loads)."""
    f32 = np.float32
    h, w, c = img1.shape
    half, s, g, rl = win // 2, win + 3, win + 1, win * c
    sc, gc = s * c, g * c
    one = f32(1.0)

    def split(p):
        x0, y0 = np.floor(p[0]), np.floor(p[1])
        return (p[0] - x0, p[1] - y0, _mirror_start(x0, half, win, w),
                _mirror_start(y0, half, win, h))

    def weights(fx, fy):
        return ((one - fy) * (one - fx), (one - fy) * fx, fy * (one - fx),
                fy * fx)

    fx, fy, sx, sy = split(p1.astype(f32))
    w00, w01, w10, w11 = weights(fx, fy)
    w1 = _mirror_window(img1, sy - 1, sx - 1, s)
    c0 = w1[1:, c:]
    tmpl = (w00 * c0[0:win, 0:rl] + w01 * c0[0:win, c:c + rl]
            + w10 * c0[1:win + 1, 0:rl] + w11 * c0[1:win + 1, c:c + rl])
    p = p2.astype(f32).copy()
    cached, loads = None, 0
    for _ in range(iterations):
        fx, fy, sx, sy = split(p)
        if cached != (sx, sy):
            w2 = _mirror_window(img2, sy - 1, sx - 1, s)
            gx, gy = _mirror_gradients(w2, sy, sx, h, w, c, g)
            p2c = w2[1:, c:]                  # corner (y, e) of image 2
            cached, loads = (sx, sy), loads + 1
        w00, w01, w10, w11 = weights(fx, fy)
        warp_sums = []
        for wi in range(nwarps):
            y0, y1 = wi * win // nwarps, (wi + 1) * win // nwarps
            acc = np.zeros((5, 32), f32)      # one column per lane
            for e0 in range(0, rl, 32):
                e = np.arange(e0, min(e0 + 32, rl))
                ln = e - e0
                for y in range(y0, y1):
                    def tap(fld):
                        return (w00 * fld[y, e] + w01 * fld[y, e + c]
                                + w10 * fld[y + 1, e] + w11 * fld[y + 1, e + c])
                    jx, jy = tap(gx), tap(gy)
                    di = tmpl[y, e] - tap(p2c)
                    for r, term in enumerate((jx * jx, jx * jy, jy * jy,
                                              di * jx, di * jy)):
                        acc[r, ln] += term
            o = 16
            while o:
                acc = acc + acc[:, np.arange(32) ^ o]
                o >>= 1
            warp_sums.append(acc[:, 0])
        g00, g01, g11, bx, by = _add_in_order(warp_sums)
        det = g00 * g11 - g01 * g01
        if det > f32(1e-6):
            inv = one / det
            p = np.array([p[0] - (g11 * bx - g01 * by) * inv,
                          p[1] - (-g01 * bx + g00 * by) * inv], f32)
    return p, loads


def _add_in_order(parts):
    tot = np.zeros(5, np.float32)
    for part in parts:
        tot = tot + part
    return tot


@pytest.mark.parametrize("win,nwarps", [(5, 1), (21, 2), (21, 1), (5, 4)])
def test_lk_point_mirror_matches_plain_level_and_jax(win, nwarps):
    """The kernel's loop (window cache, separable gradients, its order of
    sums) against the plain `_lk_level` (1e-4 px: the same products in
    another order) and the JAX `_lk_level` (5e-3 px, as above), on eight
    points: interior ones, one whose window start moves while it is
    tracked, one on the border and one off the image."""
    h, w = 64, 80
    img1 = _textured(h, w, 4)
    img2 = np.roll(img1, (1, -2), axis=(0, 1))
    rng = np.random.default_rng(8)
    pts1 = rng.uniform(14, 50, (8, 2)).astype(np.float32)
    pts2 = pts1 + rng.uniform(-1.5, 1.5, pts1.shape).astype(np.float32)
    # tracked towards -x from just right of a pixel border: it crosses it
    pts2[0] = [np.floor(pts1[0, 0]) + 3.02, pts1[0, 1] - 2.4]
    pts1[6] = pts2[6] = [1.3, 30.6]                 # on the border
    pts1[7] = pts2[7] = [-6.5, h + 4.2]             # off the image
    want = tlk._lk_level(_t(img1), _t(img2), _t(pts1), _t(pts2), win,
                         8).numpy()
    got, loads = zip(*(lk_point_mirror(img1, img2, pts1[i], pts2[i], win, 8,
                                       nwarps) for i in range(8)))
    got = np.stack(got)
    assert loads[0] > 1, "the first point's window start should move"
    assert min(loads) >= 1 and loads[7] == 1
    np.testing.assert_allclose(got, want, atol=1e-4)
    ref = np.asarray(jlk._lk_level(jnp.asarray(img1), jnp.asarray(img2),
                                   jnp.asarray(pts1), jnp.asarray(pts2),
                                   win, 8))
    np.testing.assert_allclose(got, ref, atol=5e-3)


def test_lk_wrapper_shared_memory_and_threads():
    """`smem_bytes` mirrors the kernel's layout (window with its ring, two
    gradient windows, template) and the block has a lane per row element."""
    from keypoint_bench_tpu_torch.ops import cuda_lk
    assert cuda_lk.smem_bytes(21, 3) == 4 * 3 * (24 * 24 + 2 * 22 * 22
                                                 + 21 * 21)
    assert cuda_lk.smem_bytes(21, 3) < 48 * 1024 < cuda_lk.smem_bytes(31, 16)
    assert cuda_lk.smem_bytes(31, 16) > cuda_lk.MAX_SMEM_BYTES
    assert cuda_lk.block_threads(3, 3) == 32
    assert cuda_lk.block_threads(21, 3) == 64
