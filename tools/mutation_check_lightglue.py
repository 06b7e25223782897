"""Planted faults in the port's LightGlue, each in a copy of the tree, and
whether tests/test_torch_disk_lightglue.py catches them (CPU).

    JAX_PLATFORMS=cpu python tools/mutation_check_lightglue.py [--work DIR]

Each mutant is a copy of the checkout (without .git and the directories
.gitignore lists) under --work (output/mutants by default) with one edit
to keypoint_bench_tpu_torch/models/lightglue.py:
- layer: the transformer runs one layer fewer;
- rotary: the rotary encoding's sine term changes sign;
- matchability: the assignment head drops its matchability term;
- input_proj: the [256, 128] projection read in the wrong layout.
Prints one line a mutant, "caught" when the test file fails, and exits 1
if a mutant passes.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join("keypoint_bench_tpu_torch", "models", "lightglue.py")
TEST = os.path.join("tests", "test_torch_disk_lightglue.py")
MUTANTS = {
    "layer": (
        "    d0, d1 = desc0, desc1\n    for i in range(n_layers):",
        "    d0, d1 = desc0, desc1\n    for i in range(n_layers - 1):"),
    "rotary": ("    return t * cos + _rotate_half(t) * sin",
               "    return t * cos - _rotate_half(t) * sin"),
    "matchability": (
        "    cert = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(-1, -2)",
        "    cert = 0.0 * (z0 + z1.transpose(-1, -2))"),
    "input_proj": (
        '        desc0 = _linear(p, "input_proj", desc0)\n'
        '        desc1 = _linear(p, "input_proj", desc1)\n'
        "    enc0 = _posenc(p, normalize_keypoints_masked(kpts0_px, valid0))"
        "\n    enc1 = _posenc(p, normalize_keypoints_masked(kpts1_px, "
        "valid1))\n\n    same",
        '        w = p["input_proj.weight"]\n'
        "        w = w.reshape(w.shape[1], w.shape[0]).T\n"
        '        desc0 = desc0 @ w.T + p["input_proj.bias"]\n'
        '        desc1 = desc1 @ w.T + p["input_proj.bias"]\n'
        "    enc0 = _posenc(p, normalize_keypoints_masked(kpts0_px, valid0))"
        "\n    enc1 = _posenc(p, normalize_keypoints_masked(kpts1_px, "
        "valid1))\n\n    same"),
}


def make_mutant(work: str, name: str) -> str:
    """A copy of the checkout under work/name with the mutant's edit."""
    dst = os.path.join(work, name)
    shutil.rmtree(dst, ignore_errors=True)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        skip = {ln.strip().rstrip("/") for ln in f if ln.strip().endswith("/")}
    skip |= {".git"}

    def ignore(d, names):
        return [n for n in names if n == "__pycache__" or os.path.relpath(
            os.path.join(d, n), ROOT) in skip]

    shutil.copytree(ROOT, dst, ignore=ignore)
    path = os.path.join(dst, TARGET)
    with open(path) as f:
        src = f.read()
    old, new = MUTANTS[name]
    if src.count(old) < 1:
        raise SystemExit(f"mutant {name}: its line is not in {TARGET}")
    with open(path, "w") as f:
        f.write(src.replace(old, new, 1))
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=os.path.join(ROOT, "output",
                                                   "mutants"))
    args = ap.parse_args(argv)
    survived = []
    for name in MUTANTS:
        tree = make_mutant(args.work, name)
        res = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             TEST], cwd=tree, capture_output=True, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        last = (res.stdout.strip().splitlines() or [""])[-1]
        print(f"{name}: {'caught' if res.returncode else 'SURVIVED'} "
              f"({last})", flush=True)
        if res.returncode == 0:
            survived.append(name)
        shutil.rmtree(tree, ignore_errors=True)
    return 1 if survived else 0


if __name__ == "__main__":
    raise SystemExit(main())
