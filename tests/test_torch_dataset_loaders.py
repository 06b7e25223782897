"""The port's file-backed loaders (datasets/pairs.py, sequences.py,
registry.py) and IMU preintegration (tasks/imu.py) against the JAX
package's on the same files (tests/test_dataset_loaders.py's layouts,
small): every item's keys, dtypes and shapes equal; images bit-equal
where both decode the same way (PNG and PNM through cv2 in JAX and
imageio in the port, the native HPatches loader), within RESIZE_TOL where
JAX resizes with cv2.resize and the port with resize_linear (one float32
ulp of [0, 1] measured); poses and fundamental matrices equal; IMU deltas
in float64 within 1e-9 (JAX in x64, its float32 GRAVITY constant on both
sides). With h5py blocked (the card's condition) MegaDepth's items still
equal the JAX loader's; with cv2, PIL and h5py blocked, HPatches, KITTI,
TartanAir, image pairs, UMA and Images still load, and MegaDepth (its
JPEGs), EuRoC and Video raise ImportError naming what they need."""
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.datasets import pairs as jpairs
from keypoint_bench_tpu.datasets import registry as jregistry
from keypoint_bench_tpu.datasets import sequences as jseq
from keypoint_bench_tpu.tasks import imu as jimu
from keypoint_bench_tpu_torch.datasets import pairs, registry, sequences
from keypoint_bench_tpu_torch.tasks import imu

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

RESIZE_TOL = 1e-6


def _assert_items_equal(got, want, tol=0.0, path="item"):
    """Same keys, types, dtypes and shapes; arrays equal (within tol)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_items_equal(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if tol:
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _png(path, img):
    cv2.imwrite(str(path), img)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One small tree a layout, written once."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    t = {}
    # HPatches: two sequences of three PPMs, non-square, one P5
    hp = root / "hpatches"
    for name, (h, w, c) in (("v_a", (48, 64, 3)), ("i_b", (70, 52, 1))):
        (hp / name).mkdir(parents=True)
        for k in range(1, 4):
            img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
            magic = "P6" if c == 3 else "P5"
            (hp / name / f"{k}.ppm").write_bytes(
                f"{magic}\n{w} {h}\n255\n".encode() + img.tobytes())
            if k > 1:
                H = np.eye(3) + rng.normal(0, 1e-3, (3, 3))
                np.savetxt(str(hp / name / f"H_1_{k}"), H)
    t["hpatches"] = str(hp)
    # KITTI: gray frames at its raw size (the 352 x 1216 crop bites)
    seq = root / "kitti" / "00"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    for i in range(3):
        img = rng.integers(0, 255, (370, 1226), dtype=np.uint8)
        _png(seq / "image_0" / f"{i:06d}.png", img)
        _png(seq / "image_1" / f"{i:06d}.png", img[::-1].copy())
    with open(root / "kitti" / "00.txt", "w") as f:
        for i in range(3):
            T = np.eye(4)
            T[0, 3], T[2, 3] = 0.5 * i, 0.1 * i
            f.write(" ".join(str(v) for v in T[:3].reshape(-1)) + "\n")
    t["kitti"] = (str(seq) + "/", str(root / "kitti" / "00.txt"))
    # TartanAir
    ta = root / "tartanair"
    ta.mkdir()
    for i in range(3):
        _png(ta / f"{i:06d}.png", rng.integers(0, 255, (48, 64, 3),
                                               dtype=np.uint8))
    with open(root / "ME000.txt", "w") as f:
        for i in range(3):
            f.write(f"{0.3 * i} 0.1 0 0 {0.05 * i} 0 1\n")
    t["tartanair"] = (str(ta) + "/", str(root / "ME000.txt"))
    # EuRoC and UMA: cam0 / cam1 CSVs, ground truth, IMU
    for name, w in (("mav0", 752), ("uma", 96)):
        base = root / name
        for cam in ("cam0", "cam1"):
            (base / cam / "data").mkdir(parents=True)
            with open(base / cam / "data.csv", "w") as f:
                f.write("#timestamp,filename\n")
                for i in range(2):
                    f.write(f"{1000 + i},{1000 + i}.png\n")
                    _png(base / cam / "data" / f"{1000 + i}.png",
                         rng.integers(0, 255, (40, w, 3), dtype=np.uint8))
    gtd = root / "mav0" / "state_groundtruth_estimate0"
    gtd.mkdir()
    with open(gtd / "data.csv", "w") as f:
        f.write("#ts,px,py,pz,qw,qx,qy,qz\n")
        for i in range(3):
            f.write(f"{999.6 + 0.5 * i},{0.1 * i},0,0,1,0,{0.01 * i},0\n")
    (root / "mav0" / "imu0").mkdir()
    with open(root / "mav0" / "imu0" / "data.csv", "w") as f:
        f.write("#ts,gx,gy,gz,ax,ay,az\n")
        for k in range(10):
            f.write(f"{1000 + k / 10},0.1,0,0.5,0.2,0,9.81\n")
    t["euroc"] = str(root / "mav0") + "/"
    t["uma"] = str(root / "uma") + "/"
    # Images and a video
    ims = root / "imgs"
    ims.mkdir()
    for i in range(3):
        _png(ims / f"{i}.png", rng.integers(0, 255, (32, 48, 3),
                                            dtype=np.uint8))
    t["images"] = str(ims)
    vpath = str(root / "v.avi")
    wr = cv2.VideoWriter(vpath, cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 32))
    for i in range(3):
        wr.write(rng.integers(0, 255, (32, 48, 3), dtype=np.uint8))
    wr.release()
    t["video"] = vpath
    # image pairs
    lst = root / "pairs.txt"
    with open(lst, "w") as f:
        for i in range(2):
            a, b = root / f"p{i}a.png", root / f"p{i}b.png"
            _png(a, rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
            _png(b, rng.integers(0, 255, (44, 60, 3), dtype=np.uint8))
            f.write(f"{a} {b}\n")
    t["image_pair"] = str(lst)
    # MegaDepth: JPEG views, h5 depths and calibrations
    md = root / "md"
    for d in ("imgs", "depths", "calib"):
        (md / d).mkdir(parents=True)
    names = []
    for i in range(2):
        names.append(f"im{i}.jpg")
        _png(md / "imgs" / names[-1], rng.integers(0, 255, (48, 64, 3),
                                                   dtype=np.uint8))
        with h5py.File(md / "depths" / f"im{i}.h5", "w") as f:
            f.create_dataset("/depth", data=rng.uniform(
                4.0, 6.0, (48, 64)).astype("float32"))
        with h5py.File(md / "calib" / f"calibration_im{i}.h5", "w") as f:
            f.create_dataset("K", data=np.array(
                [[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]]))
            f.create_dataset("R", data=np.eye(3))
            f.create_dataset("T", data=np.array([0.1 * i, 0.0, 0.0]))
    with open(md / "dataset.json", "w") as f:
        json.dump({"scene0": {"image_path": "imgs", "depth_path": "depths",
                              "calib_path": "calib", "images": names,
                              "tuples": [[0, 1]]}}, f)
    t["megadepth"] = str(md)
    return t


def _gt_copy(path, tag):
    """A copy of a ground-truth file per package, so each writes and reads
    its own cached fundamental matrices."""
    root, ext = os.path.splitext(path)
    out = f"{root}_{tag}{ext}"
    shutil.copy(path, out)
    return out


@pytest.mark.parametrize("alteration,gray,native", [
    ("all", False, True), ("v", False, True), ("i", True, True),
    ("all", False, False)])
def test_hpatches_items_equal_jax(tree, alteration, gray, native):
    got = pairs.HPatchesDataset(tree["hpatches"], alteration, 40, gray,
                                use_native=native)
    want = jpairs.HPatchesDataset(tree["hpatches"], alteration, 40, gray,
                                  use_native=native)
    assert len(got) == len(want) == {"all": 4, "v": 2, "i": 2}[alteration]
    tol = 0.0 if native and not gray else RESIZE_TOL
    for i in range(len(got)):
        _assert_items_equal(got[i], want[i], tol)


def test_pnm_size_reads_past_comment_lines(tmp_path):
    p = tmp_path / "c.ppm"
    p.write_bytes(b"P6\n# made by a scanner v2\n7 5\n255\n" + bytes(105))
    assert pairs._pnm_size(p) == (7, 5)


def test_kitti_items_equal_jax(tree):
    seq, gt = tree["kitti"]
    port_gt = _gt_copy(gt, "port")
    got = sequences.KittiDataset(seq, port_gt)
    want = jseq.KittiDataset(seq, _gt_copy(gt, "jax"))
    assert len(got) == len(want) == 3
    for i in range(3):
        _assert_items_equal(got[i], want[i])
    assert got[1]["image0"].shape == (352, 1216, 3)
    cache = port_gt.replace(".txt", "_fundamental.npy")
    assert os.path.exists(cache)
    # the cache is read back on the next open
    np.save(cache, got.Fs * 2)
    np.testing.assert_array_equal(sequences.KittiDataset(seq, port_gt).Fs,
                                  got.Fs * 2)
    gray = sequences.KittiDataset(seq, _gt_copy(gt, "port_gray"), gray=True)
    jgray = jseq.KittiDataset(seq, _gt_copy(gt, "jax_gray"), gray=True)
    _assert_items_equal(gray[2], jgray[2])


@pytest.mark.parametrize("gray", [False, True])
def test_tartanair_items_equal_jax(tree, gray):
    seq, gt = tree["tartanair"]
    got = sequences.TartanAirDataset(seq, _gt_copy(gt, f"p{gray}"), gray)
    want = jseq.TartanAirDataset(seq, _gt_copy(gt, f"j{gray}"), gray)
    assert len(got) == len(want) == 3
    for i in range(3):
        _assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("gray", [False, True])
def test_euroc_items_and_imu_equal_jax(tree, gray):
    got = sequences.EurocDataset(tree["euroc"], gray)
    want = jseq.EurocDataset(tree["euroc"], gray)
    assert len(got) == len(want) == 2
    for i in range(2):
        _assert_items_equal(got[i], want[i])
    assert got[1]["image0"].shape[1] == 736
    assert got.imu_between(0) is None
    pre, jpre = got.imu_between(1), want.imu_between(1)
    for k in ("dR", "dv", "dp", "dt"):
        assert pre[k].dtype == torch.float32
        np.testing.assert_allclose(pre[k].numpy(), np.asarray(jpre[k]),
                                   rtol=0, atol=1e-6)
    assert float(pre["dt"]) > 0


def test_uma_images_video_items_equal_jax(tree):
    for got, want in (
            (sequences.UMADataset(tree["uma"]), jseq.UMADataset(tree["uma"])),
            (sequences.ImagesDataset(tree["images"]),
             jseq.ImagesDataset(tree["images"])),
            (sequences.VideoDataset(tree["video"]),
             jseq.VideoDataset(tree["video"]))):
        assert len(got) == len(want) > 0
        for i in range(len(got)):
            _assert_items_equal(got[i], want[i])
    got = sequences.ImagesDataset(tree["images"], gray=True, resize=(20, 12))
    want = jseq.ImagesDataset(tree["images"], gray=True, resize=(20, 12))
    for i in range(len(got)):
        # cv2.resize drops the gray axis and the JAX loader puts it back
        _assert_items_equal(got[i], want[i], RESIZE_TOL)


@pytest.mark.parametrize("gray,resize", [(False, None), (True, None),
                                         (False, [32, 24])])
def test_image_pairs_items_equal_jax(tree, gray, resize):
    got = pairs.ImagePairsDataset(tree["image_pair"], gray, resize)
    want = jpairs.ImagePairsDataset(tree["image_pair"], gray, resize)
    assert len(got) == len(want) == 2
    for i in range(2):
        _assert_items_equal(got[i], want[i], RESIZE_TOL if resize else 0.0)


@pytest.mark.parametrize("train,mode", [(False, "scale"), (True, "scale"),
                                        (True, "crop"), (True, "crop_scale")])
def test_megadepth_items_equal_jax(tree, train, mode):
    got = pairs.MegaDepthDataset(tree["megadepth"], 32, train=train,
                                 crop_or_scale=mode)
    want = jpairs.MegaDepthDataset(tree["megadepth"], 32, train=train,
                                   crop_or_scale=mode)
    assert len(got) == len(want) == 1
    # resized depths carry their metres: 6 m times the float32 weights'
    # rounding
    _assert_items_equal(got[0], want[0], 1e-5 if train else 0.0)


def _imu_case(name):
    """tests/test_imu.py's four cases: (gyro, accel, dts, mask)."""
    if name == "rotation":
        n = 200
        return (np.tile([0, 0, 0.5], (n, 1)), np.zeros((n, 3)),
                np.full(n, 1.0 / n), np.ones(n, bool))
    if name == "acceleration":
        n = 400
        return (np.zeros((n, 3)), np.tile([2.0, 0, 0], (n, 1)),
                np.full(n, 1.0 / n), np.ones(n, bool))
    n = 100
    mask = np.ones(n, bool)
    if name == "mask":
        mask[50:] = False
        accel = np.tile([1.0, 0, 0], (n, 1))
    else:
        accel = np.tile([0, 0, 9.81], (n, 1))
    rng = np.random.default_rng(3)
    return (rng.normal(0, 0.3, (n, 3)), accel + rng.normal(0, 0.1, (n, 3)),
            np.full(n, 0.01), mask)


@pytest.mark.parametrize("name", ["rotation", "acceleration", "mask",
                                  "gravity"])
def test_preintegrate_matches_jax_in_float64(name):
    gyro, accel, dts, mask = _imu_case(name)
    with jax.enable_x64(True):
        want = jimu.preintegrate(*(jnp.asarray(x) for x in (gyro, accel,
                                                             dts, mask)))
        jdp, jdv = jimu.gravity_aligned_deltas(
            want, jnp.asarray(np.eye(3)), jnp.asarray([0.1, 0.0, -0.2]))
        want = {k: np.asarray(v) for k, v in want.items()}
        jdp, jdv = np.asarray(jdp), np.asarray(jdv)
    got = imu.preintegrate(*(torch.from_numpy(x) for x in (gyro, accel, dts,
                                                           mask)))
    dp, dv = imu.gravity_aligned_deltas(got, torch.eye(3, dtype=torch.float64),
                                        torch.tensor([0.1, 0.0, -0.2],
                                                     dtype=torch.float64))
    for k in ("dR", "dv", "dp", "dt"):
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(dp.numpy(), jdp, rtol=0, atol=1e-9)
    np.testing.assert_allclose(dv.numpy(), jdv, rtol=0, atol=1e-9)


def test_preintegrate_float32_closed_forms():
    """tests/test_imu.py's closed forms on the port in float32."""
    gyro, accel, dts, mask = _imu_case("rotation")
    f32 = [torch.tensor(x, dtype=torch.float32) for x in (gyro, accel, dts)]
    pre = imu.preintegrate(*f32, torch.from_numpy(mask))
    R = np.array([[np.cos(0.5), -np.sin(0.5), 0], [np.sin(0.5), np.cos(0.5),
                                                   0], [0, 0, 1]])
    assert pre["dR"].dtype == torch.float32
    np.testing.assert_allclose(pre["dR"].numpy(), R, atol=1e-3)
    n = 100
    pre = imu.preintegrate(torch.zeros(n, 3), torch.tensor([[0, 0, 9.81]]
                                                           * n),
                           torch.full((n,), 0.01), torch.ones(n, dtype=bool))
    dp, dv = imu.gravity_aligned_deltas(pre, torch.eye(3), torch.zeros(3))
    np.testing.assert_allclose(dv.numpy(), 0, atol=1e-3)
    np.testing.assert_allclose(dp.numpy(), 0, atol=1e-2)


def _registry_params(tree):
    return {
        "hpatches": {"root": tree["hpatches"], "image_size": 32},
        "megadepth": {"root": tree["megadepth"]},
        "image_pair": {"root": tree["image_pair"], "image_size": 24},
        "kitti": {"root": tree["kitti"][0],
                  "gt": _gt_copy(tree["kitti"][1], "reg")},
        "tartanair": {"root": tree["tartanair"][0],
                      "gt": _gt_copy(tree["tartanair"][1], "reg")},
        "euroc": {"root": tree["euroc"]}, "uma": {"root": tree["uma"]},
        "video": {"root": tree["video"]}, "images": {"root": tree["images"]},
        "synthetic_homography": {"num_pairs": 1, "image_size": 32},
        "synthetic_se3": {"num_pairs": 1, "image_size": 32},
        "synthetic_splat_sequence": {"num_frames": 2, "image_size": 32},
        "synthetic_sequence": {"num_frames": 2, "image_size": 64}}


@pytest.mark.parametrize("kind", [
    "hpatches", "megadepth", "image_pair", "kitti", "tartanair", "euroc",
    "uma", "video", "images", "synthetic_homography", "synthetic_se3",
    "synthetic_splat_sequence", "synthetic_sequence"])
def test_registry_builds_every_jax_type(tree, kind):
    params = {"type": kind, **_registry_params(tree)[kind]}
    got = registry.get_dataset(params)
    want = jregistry.get_dataset(params)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) > 0
    if kind in ("hpatches", "image_pair", "images"):
        _assert_items_equal(got[0], want[0], RESIZE_TOL)


def test_registry_unknown_type_raises():
    with pytest.raises(ValueError, match="invalid dataset type 'nope'"):
        registry.get_dataset({"type": "nope"})


def test_loaders_without_cv2_pil_h5py(tree, monkeypatch):
    """The card's condition: no OpenCV, PIL or h5py."""
    seq, gt = tree["kitti"]
    ta, ta_gt = tree["tartanair"]
    cases = {
        "hpatches": lambda: pairs.HPatchesDataset(tree["hpatches"], "all",
                                                  32),
        "hpatches gray": lambda: pairs.HPatchesDataset(tree["hpatches"],
                                                       "all", 32, True),
        "kitti": lambda: sequences.KittiDataset(seq, _gt_copy(gt, "nocv")),
        "tartanair": lambda: sequences.TartanAirDataset(
            ta, _gt_copy(ta_gt, "nocv")),
        "image_pair": lambda: pairs.ImagePairsDataset(tree["image_pair"],
                                                      resize=[24, 24]),
        "uma": lambda: sequences.UMADataset(tree["uma"]),
        "images": lambda: sequences.ImagesDataset(tree["images"]),
    }
    want = {k: make()[len(make()) - 1] for k, make in cases.items()}
    md_want = jpairs.MegaDepthDataset(tree["megadepth"], 32)[0]
    monkeypatch.setitem(sys.modules, "h5py", None)
    # MegaDepth's depths and calibrations without h5py (datasets/h5.py)
    _assert_items_equal(pairs.MegaDepthDataset(tree["megadepth"], 32)[0],
                        md_want, path="megadepth")
    for mod in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    for k, make in cases.items():
        ds = make()
        _assert_items_equal(ds[len(ds) - 1], want[k], path=k)
    with pytest.raises(ImportError, match="PIL") as e:
        pairs.MegaDepthDataset(tree["megadepth"])[0]
    assert "h5py" not in str(e.value)
    with pytest.raises(ImportError, match="cv2"):
        sequences.EurocDataset(tree["euroc"])[0]
    with pytest.raises(ImportError, match="cv2"):
        sequences.VideoDataset(tree["video"])
