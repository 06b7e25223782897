"""The port's checkpoint converter against the JAX package's (CPU).

Every SPECS entry gets an upstream-schema checkpoint written from the
parameters the repository holds (weights/upstream.py, as chip_smoke.py's
phase 62 writes them: weights_npz/ for the shipped models, the golden
randomized fixtures for the rest, the golden LightGlue with a seeded
128 -> 256 input_proj for the disk and aliked schemas): torch layout, SPECS' nesting, the r2d2
`module.` prefix and an int64 num_batches_tracked beside every
BatchNorm. JAX's `convert.main` and the port's run on the same source
into two directories; their npz files must hold the same keys with the
same dtype, shape and bits, equal to the source, with the same converted
and skipped lists and the same printed lines. Also the rank rule itself,
`save_params`, `load_params` from the converted directory, and
KBT_WEIGHTS_DIR (in a subprocess, since it is read at import).
"""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from keypoint_bench_tpu.weights import convert as jconvert
from keypoint_bench_tpu.weights import io as jio
from keypoint_bench_tpu_torch.weights import convert as tconvert
from keypoint_bench_tpu_torch.weights import (SPECS, load_npz, load_params,
                                              params_from_jax, save_params)
from keypoint_bench_tpu_torch.weights.upstream import (
    npz_equal, upstream_params, write_upstream_checkpoints)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _convert(main, src, dst):
    """main(src, dst) with its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(src, dst)
    return out.getvalue().splitlines(), ret


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    params = upstream_params()
    src = str(tmp_path_factory.mktemp("upstream"))
    write_upstream_checkpoints(src, params)
    return src, params


@pytest.fixture(scope="module")
def converted(staged, tmp_path_factory):
    src, _ = staged
    jdst = str(tmp_path_factory.mktemp("jax_npz"))
    tdst = str(tmp_path_factory.mktemp("torch_npz"))
    jlines, _ = _convert(jconvert.main, src, jdst)
    tlines, ret = _convert(tconvert.main, src, tdst)
    return {"jax": (jdst, jlines), "torch": (tdst, tlines), "ret": ret}


def test_specs_name_the_jax_files():
    assert list(SPECS) == list(jconvert.SPECS)
    assert {k: v[0] for k, v in SPECS.items()} == {
        k: v[0] for k, v in jconvert.SPECS.items()}
    assert sorted(upstream_params()) == sorted(SPECS)


def test_upstream_nesting_unwraps_as_jax():
    """Each unwrap of the port's SPECS takes the nesting the JAX unwrap
    takes to the same state dict (r2d2's `module.` stripped, D2Net with
    and without its 'model' key)."""
    sd = {"module.a.weight": torch.ones(2), "b.bias": torch.zeros(3)}
    for ckpt in (sd, {"state_dict": sd}, {"extractor": sd}, {"model": sd}):
        for name, (_, unwrap) in SPECS.items():
            try:
                want = jconvert.SPECS[name][1](ckpt)
            except KeyError:
                with pytest.raises(KeyError):
                    unwrap(ckpt)
                continue
            assert list(unwrap(ckpt)) == list(want), name


def test_every_spec_converts_bit_equal_to_jax(staged, converted):
    _, params = staged
    (jdst, _), (tdst, _) = converted["jax"], converted["torch"]
    for name in SPECS:
        tpath = os.path.join(tdst, f"{name}.npz")
        with np.load(os.path.join(jdst, f"{name}.npz")) as z:
            want = {k: z[k] for k in z.files}
        assert npz_equal(tpath, want), name
        assert npz_equal(tpath, params[name]), name
    assert sorted(os.listdir(tdst)) == sorted(os.listdir(jdst))


def test_printed_lines_and_lists_equal_jax(staged, converted):
    _, params = staged
    assert converted["torch"][1] == converted["jax"][1]
    conv, skipped = converted["ret"]
    assert conv == [(n, len(params[n])) for n in SPECS] and skipped == []


def test_pointer_and_absent_files_are_skipped(tmp_path):
    """A git-LFS pointer (under 1024 bytes) and an absent file are skipped
    by both converters alike."""
    src = str(tmp_path / "src")
    write_upstream_checkpoints(
        src, upstream_params(["GoodPoint", "LETNet"]),
        pointers=("LETNet",))
    assert os.path.getsize(os.path.join(src, SPECS["LETNet"][0])) < 1024
    jlines, _ = _convert(jconvert.main, src, str(tmp_path / "j"))
    tlines, (conv, skipped) = _convert(tconvert.main, src,
                                       str(tmp_path / "t"))
    assert tlines == jlines
    assert conv == [("GoodPoint", len(load_npz("GoodPoint")))]
    assert skipped == [n for n in SPECS if n != "GoodPoint"]
    assert sorted(os.listdir(tmp_path / "t")) == ["GoodPoint.npz"]


def test_load_params_from_converted_dir(staged, converted):
    """The port's load_params on the converted directory gives the staged
    source's tensors; the 128 -> 256 input_proj comes back as torch's
    [256, 128], the transpose of its converted [128, 256]."""
    _, params = staged
    tdst = converted["torch"][0]
    for name in SPECS:
        got = load_params(name, tdst)
        want = params_from_jax(params[name])
        assert list(got) == list(want), name
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    for name in ("lightglue_disk", "lightglue_aliked"):
        w = load_params(name, tdst)["input_proj.weight"]
        assert tuple(w.shape) == (256, 128)
        assert torch.equal(w.T, torch.from_numpy(
            load_npz(name, tdst)["input_proj.weight"]))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 3, 4), (2, 3, 4, 5),
                                   (2, 3, 4, 5, 6)])
def test_layout_rule_by_rank_equals_jax(shape):
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    got = tconvert.to_numpy_layout("x.weight", t)
    want = jconvert.to_numpy_layout("x.weight", t)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_convert_state_dict_keeps_floating_tensors_as_jax():
    sd = {"w": torch.ones(3, 2), "h": torch.ones(2, dtype=torch.float16),
          "d": torch.ones(4, 1, 2, 2, dtype=torch.float64),
          "n.num_batches_tracked": torch.tensor(7),
          "m": torch.ones(2, dtype=torch.bool), "s": 3.0}
    got, want = tconvert.convert_state_dict(sd), \
        jconvert.convert_state_dict(sd)
    assert list(got) == list(want) == ["w", "h", "d"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


def test_save_params_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    params = {"a.weight": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
              "a.bias": rng.normal(size=4).astype(np.float32),
              "l.weight": torch.randn(5, 6)}
    save_params("X", params, str(tmp_path / "t"))
    jio.save_params("X", {k: np.asarray(v) for k, v in params.items()},
                    str(tmp_path / "j"))
    with np.load(tmp_path / "j" / "X.npz") as z:
        want = {k: z[k] for k in z.files}
    assert npz_equal(str(tmp_path / "t" / "X.npz"), want)
    assert list(load_npz("X", str(tmp_path / "t"))) == list(params)


def test_kbt_weights_dir_is_honoured(tmp_path):
    """With KBT_WEIGHTS_DIR set (read at import, so in a subprocess), the
    port's WEIGHTS_DIR is it, the converter's command line writes there
    by default and load_npz reads from there."""
    src = str(tmp_path / "src")
    write_upstream_checkpoints(src, upstream_params(["LETNet"]))
    from keypoint_bench_tpu_torch.weights import WEIGHTS_DIR
    assert WEIGHTS_DIR == jio.WEIGHTS_DIR     # the same default, or env
    wdir = str(tmp_path / "weights")
    code = (
        "import runpy, sys\n"
        "sys.argv = ['convert', '--src', sys.argv[1]]\n"
        "runpy.run_module('keypoint_bench_tpu_torch.weights.convert', "
        "run_name='__main__', alter_sys=True)\n"
        "from keypoint_bench_tpu_torch.weights import WEIGHTS_DIR, load_npz\n"
        "print(WEIGHTS_DIR)\n"
        "print(sorted(load_npz('LETNet')))\n")
    env = {**os.environ, "KBT_WEIGHTS_DIR": wdir}
    res = subprocess.run([sys.executable, "-c", code, src], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == \
        f"converted LETNet: {len(load_npz('LETNet'))} tensors"
    assert lines[-2] == wdir
    assert lines[-1] == str(sorted(load_npz("LETNet")))
    assert npz_equal(os.path.join(wdir, "LETNet.npz"), load_npz("LETNet"))
