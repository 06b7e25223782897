"""The port's demo (`python -m keypoint_bench_tpu_torch.demo --device cpu
--size 128`) against examples/demo.py at the same size (CPU).

The keypoint and match lines they print are equal and the three PNGs
are pixel-equal. RANSAC-H draws from a torch.Generator in the port and
from a JAX key in examples/demo.py, so the estimated homographies are
each held to the ground truth the demo prints beside them: the image
corners mapped by the estimate lie within RANSAC's 3-pixel threshold of
where the ground truth maps them.
"""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from keypoint_bench_tpu_torch import demo

cv2 = pytest.importorskip("cv2")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 128
FILES = ("keypoints0.png", "keypoints1.png", "matches.png")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrix(lines):
    return np.array([[float(v) for v in ln.strip(" []").split()]
                     for ln in lines])


def test_demo_equals_examples_demo(tmp_path, monkeypatch, capsys):
    tout, jout = tmp_path / "torch", tmp_path / "jax"
    assert demo.main(["--device", "cpu", "--size", str(S), "--out",
                      str(tout)]) == 0
    tlines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["demo.py", "--size", str(S), "--out",
                                      str(jout)])
    runpy.run_path(os.path.join(ROOT, "examples", "demo.py"),
                   run_name="__main__")
    jlines = capsys.readouterr().out.splitlines()
    assert tlines[:2] == jlines[:2]
    assert tlines[0].startswith("Alike: ") and tlines[1].startswith(
        "matches: ")
    assert tlines[2] == jlines[2] == "estimated H vs GT (normalized):"
    assert tlines[6:9] == jlines[6:9]          # the ground truth
    gt = _matrix(tlines[6:9])
    for lines in (tlines, jlines):
        assert demo.corner_gap(_matrix(lines[3:6]), gt, S) < 3.0
    for name in FILES:
        a = cv2.imread(str(tout / name))
        b = cv2.imread(str(jout / name))
        assert a is not None and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def test_run_returns_what_it_prints(tmp_path, capsys):
    res = demo.run("Alike", str(tmp_path), S, "cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"Alike: {res['keypoints'][0]} / {res['keypoints'][1]} " \
        "keypoints"
    assert out[1] == f"matches: {res['matches']}"
    assert res["files"] == list(FILES)
    assert demo.corner_gap(res["H"], res["gt"], S) < 3.0


def test_detector_without_descriptors_writes_keypoints_only(tmp_path,
                                                            capsys):
    res = demo.run("Harris", str(tmp_path), S, "cpu")
    assert res["matches"] is None and res["H"] is None
    assert sorted(os.listdir(tmp_path)) == ["keypoints0.png",
                                            "keypoints1.png"]
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"outputs in {tmp_path}"
