"""Write the HDF5 fixtures under tests/data/h5/ with h5py, each dataset's
array beside it as .npy, and MANIFEST.json listing them.

    python tools/make_h5_fixtures.py [--out tests/data/h5]

They hold the layouts that h5py writes and that a machine without h5py
cannot make: chunked datasets under a v1 B-tree (libver "earliest") and
under single-chunk and fixed-array indexes (libver "latest"), deflate,
shuffle and fletcher32, compact and big-endian data, and a partly
written chunked dataset with a fill value. chip_smoke.py
(`h5_fixture_check`) and tests/test_torch_h5.py read them with
keypoint_bench_tpu_torch/datasets/h5.py. The arrays come from seed 0, so
a rerun writes the same arrays (the files' bytes may differ with the
HDF5 library's version).
"""
from __future__ import annotations

import argparse
import json
import os

import h5py
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fixtures(rng):
    """{file: (libver, {dataset: (array, create_dataset keywords)})}."""
    depth = rng.uniform(0, 50, (16, 32)).astype("f4")
    depth[rng.random(depth.shape) < 0.3] = 0.0      # MegaDepth's holes
    K = np.array([[960.0, 0, 800], [0, 960.0, 533], [0, 0, 1]])
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T = rng.normal(size=3)
    partly = np.full((12, 18), -1.5, "f4")
    partly[4:9, 7:13] = rng.normal(size=(5, 6)).astype("f4")
    return {
        "depth_latest_fixed_array.h5": ("latest", {
            "/depth": (depth, {"chunks": (8, 16), "compression": "gzip",
                               "shuffle": True})}),
        "calib_earliest_btree.h5": ("earliest", {
            "K": (K, {"chunks": (2, 2), "fletcher32": True}),
            "R": (R, {"chunks": (3, 2), "compression": "gzip",
                      "shuffle": True, "fletcher32": True}),
            "T": (T, {})}),
        "latest_single_chunk.h5": ("latest", {
            "/g/x": (rng.integers(-900, 900, (6, 7)).astype(">i2"),
                     {"chunks": (6, 7), "compression": "gzip",
                      "fletcher32": True})}),
        "latest_compact_scalar.h5": ("latest", {
            "/c": (rng.normal(size=(2, 3)).astype(">f8"), {"compact": True}),
            "/s": (np.float32(2.5), {})}),
        "earliest_partly_written.h5": ("earliest", {
            "/p": (partly, {"chunks": (4, 6), "fillvalue": -1.5,
                            "compression": "gzip", "written": (4, 9, 7,
                                                              13)})}),
    }


def write(path, libver, datasets):
    with h5py.File(path, "w", libver=libver) as f:
        for name, (a, kw) in datasets.items():
            kw = dict(kw)
            if kw.pop("compact", False):
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_layout(h5py.h5d.COMPACT)
                f.create_dataset(name, data=a, dcpl=dcpl)
            elif "written" in kw:
                r0, r1, c0, c1 = kw.pop("written")
                d = f.create_dataset(name, shape=a.shape, dtype=a.dtype, **kw)
                d[r0:r1, c0:c1] = a[r0:r1, c0:c1]
            else:
                f.create_dataset(name, data=a, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  "h5"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    manifest = {}
    for fname, (libver, datasets) in fixtures(
            np.random.default_rng(0)).items():
        path = os.path.join(args.out, fname)
        write(path, libver, datasets)
        entry = {}
        with h5py.File(path, "r") as f:
            for name in datasets:
                npy = f"{fname[:-3]}.{name.strip('/').replace('/', '_')}.npy"
                np.save(os.path.join(args.out, npy), np.array(f[name]))
                entry[name] = npy
        manifest[fname] = {"libver": libver, "datasets": entry}
    with open(os.path.join(args.out, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, n))
                for n in os.listdir(args.out))
    print(f"{len(manifest)} files, {total} bytes in {args.out}")


if __name__ == "__main__":
    main()
