"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, its entry points refuse to run on a host without CUDA unless
asked for the CPU, and a failed kernel build raises instead of falling
back to the plain twin."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from keypoint_bench_tpu_torch.models import common
from keypoint_bench_tpu_torch.ops import (_build, cuda_attention, cuda_bn,
                                          cuda_lk, cuda_match, cuda_nms,
                                          cuda_sample)
from keypoint_bench_tpu_torch.ops.detect import fast_nms, peel_topk
from keypoint_bench_tpu_torch.ops.lk import _lk_level
from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "keypoint_bench_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "keypoint_bench_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys, runpy\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({os.path.join(ROOT, 'chip_smoke.py')!r}, "
        "run_name='not_main')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'keypoint_bench_tpu'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


def _default_device_calls(tmp_path):
    from keypoint_bench_tpu_torch import cli
    from keypoint_bench_tpu_torch.device import resolve_device
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.ops.detect import DetectParams
    from keypoint_bench_tpu_torch.ops.lk import LKParams
    from keypoint_bench_tpu_torch import demo, info, sweep
    from keypoint_bench_tpu_torch.utils.export import export_model
    from keypoint_bench_tpu_torch.utils.profiling import model_cost
    from keypoint_bench_tpu_torch.pipeline import (dense_detect,
                                                   dense_extract_match,
                                                   extract_match,
                                                   lk_fundamental_step,
                                                   vo_step, xfeat_auc_step)
    from keypoint_bench_tpu_torch.weights import (load_golden_params,
                                                  lightglue_input_proj_params)
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.tasks.vo_ba import refine_window
    from keypoint_bench_tpu_torch.weights import load_params
    cfg = {"model_type": "Alike", "task_type": "repeatability",
           "data_params": {"type": "synthetic_homography", "num_pairs": 1,
                           "image_size": 64},
           "output_dir": str(tmp_path)}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(__import__("yaml").safe_dump(cfg))
    sweep_path = tmp_path / "sweep.yaml"
    sweep_path.write_text(__import__("yaml").safe_dump(
        {"base": cfg, "models": ["KeyNet"]}))
    imgs = np.zeros((1, 64, 64, 3), np.float32)
    params = load_params("Alike")
    return {
        "resolve_device": lambda: resolve_device(),
        "extract_match": lambda: extract_match(
            get_model("Alike")(params), params, imgs, imgs, DetectParams()),
        "lk_fundamental_step": lambda: lk_fundamental_step(
            get_model("Alike")(params), params, imgs, imgs,
            np.zeros((1, 3, 3), np.float32), torch.Generator(),
            DetectParams(), LKParams()),
        "xfeat_auc_step": lambda: xfeat_auc_step(
            get_model("XFeat")(load_golden_params("XFeat")),
            lightglue_input_proj_params(), imgs, imgs,
            np.eye(3, dtype=np.float32)[None],
            np.eye(4, dtype=np.float32)[None], DetectParams(),
            torch.Generator()),
        "vo_step": lambda: vo_step(
            get_model("Alike")(params), imgs, np.eye(3), [0.0],
            DetectParams(), torch.Generator()),
        "refine_window": lambda: refine_window(
            np.zeros((2, 1, 2), np.float32), [], np.stack([np.eye(3)] * 2),
            np.zeros((2, 3)), np.eye(3)),
        "Evaluator": lambda: Evaluator(EvalConfig.from_dict(cfg)),
        "cli": lambda: cli.main(["-c", str(cfg_path)]),
        "dense_extract_match": lambda: dense_extract_match(
            get_model("LETNet")(load_params("LETNet")), imgs, imgs,
            DetectParams()),
        "dense_detect": lambda: dense_detect(
            get_model("Harris")({}), imgs, DetectParams()),
        "run_sweep": lambda: sweep.run_sweep(cfg, ["Harris", "DISK"]),
        "sweep_cli": lambda: sweep.main(["-c", str(sweep_path)]),
        "info": lambda: info.main(["LETNet", "--size", "64"]),
        "export_model": lambda: export_model(
            "LETNet", str(tmp_path / "m.pt2"), (1, 64, 64, 3)),
        "model_cost": lambda: model_cost("LETNet", (1, 64, 64, 3)),
        "demo": lambda: demo.main(["--size", "64", "--out",
                                   str(tmp_path / "demo")]),
    }


@pytest.mark.parametrize("entry", ["resolve_device", "extract_match",
                                   "lk_fundamental_step", "xfeat_auc_step",
                                   "vo_step", "refine_window", "Evaluator",
                                   "cli", "dense_extract_match",
                                   "dense_detect", "run_sweep", "sweep_cli",
                                   "info", "export_model", "model_cost",
                                   "demo"])
def test_default_device_raises_without_cuda(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _default_device_calls(tmp_path)[entry]()


def _failing_build(name):
    raise RuntimeError(f"build of {name} failed")


def _nms_args():
    return (torch.rand(2, 40, 48), 4)


def _sample_args():
    feats = tuple(torch.rand(1, 16, h, w) for h, w in
                  ((64, 64), (32, 32), (8, 8), (4, 4)))
    return (feats, torch.rand(1, 10) * 63, torch.rand(1, 10) * 63, 64, 64)


def _match_args():
    return (torch.rand(2, 30, 65), torch.rand(2, 20, 65))


def _attention_args():
    return (torch.rand(8, 30, 64), torch.rand(8, 20, 64),
            torch.rand(8, 20, 64), torch.rand(8, 20) > 0.5)


def _peel_args():
    return (torch.rand(2, 16, 256), 4, 8)


def _lk_args():
    return (torch.rand(2, 32, 40, 3), torch.rand(2, 32, 40, 3),
            torch.rand(2, 6, 2) * 30, torch.rand(2, 6, 2) * 30, 5, 3)


def _bn_args():
    return (torch.randn(2, 4, 6, 5), torch.randn(4), torch.randn(4),
            torch.randn(4), torch.rand(4), 1e-5, True, torch.randn(2, 4, 6, 5))


def _kernel_of(mod, launch):
    return mod.PEEL_KERNEL if launch is cuda_nms.peel_cuda else mod.KERNEL


@pytest.mark.parametrize("mod,launch,args", [
    (cuda_nms, cuda_nms.nms_cuda, _nms_args),
    (cuda_nms, cuda_nms.peel_cuda, _peel_args),
    (cuda_lk, cuda_lk.lk_level_cuda, _lk_args),
    (cuda_sample, cuda_sample.sample_cuda, _sample_args),
    (cuda_match, cuda_match.nn_dists_cuda, _match_args),
    (cuda_attention, cuda_attention.attention_cuda, _attention_args),
    (cuda_bn, cuda_bn.bn_epilogue, _bn_args)])
def test_failed_build_raises_on_the_kernel_path(monkeypatch, mod, launch,
                                                args):
    kernel = _kernel_of(mod, launch)
    monkeypatch.setattr(_build, "build", _failing_build)
    monkeypatch.setattr(kernel, "_fn", None)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="failed"):
        launch(*args())
    assert kernel.launches == before


def test_cpu_tensors_take_the_plain_twin_without_building(monkeypatch):
    monkeypatch.setattr(_build, "build", _failing_build)
    monkeypatch.setattr(cuda_nms.KERNEL, "_fn", None)
    monkeypatch.setattr(cuda_sample.KERNEL, "_fn", None)
    monkeypatch.setattr(cuda_nms.PEEL_KERNEL, "_fn", None)
    monkeypatch.setattr(cuda_lk.KERNEL, "_fn", None)
    monkeypatch.setattr(cuda_bn.KERNEL, "_fn", None)
    kernels = (cuda_nms.KERNEL, cuda_sample.KERNEL, cuda_nms.PEEL_KERNEL,
               cuda_lk.KERNEL, cuda_bn.KERNEL)
    before = [k.launches for k in kernels]
    maps, d = _nms_args()
    assert torch.equal(cuda_nms.nms_fixpoint(maps, d), fast_nms(maps, d))
    args = _sample_args()
    assert torch.equal(cuda_sample.fused_samples_batch(*args),
                       sample_branches(*args))
    peel = _peel_args()
    got = cuda_nms.peel_candidates(*peel)
    want = peel_topk(*peel)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    lk = _lk_args()
    assert torch.equal(cuda_lk.lk_level(*lk), _lk_level(*lk))
    bn = _bn_args()
    assert torch.equal(common.bn_eval(*bn[:5], relu=True, residual=bn[-1]),
                       common.bn_chain(*bn[:5], relu=True, residual=bn[-1]))
    assert [k.launches for k in kernels] == before


_READERS = ("cv2", "PIL", "h5py")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_eager_cv2_pil_h5py_imports(path):
    """The card's machine has no OpenCV, PIL or h5py: a module imports
    them, if at all, inside the function that reads such a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in _READERS]
        assert not bad, f"{path}:{node.lineno} imports {bad} eagerly"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_h5py_imports_anywhere(path):
    """HDF5 files are read by datasets/h5.py: no module of the port, and
    not chip_smoke.py, imports h5py, in a function or at the top."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] == "h5py"]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_the_port_imports_with_cv2_pil_h5py_blocked():
    """Every module of the port, and chip_smoke.py, import where cv2, PIL
    and h5py cannot, and the file-backed registry builds its loaders."""
    code = (
        "import importlib, sys, runpy\n"
        f"for m in {_READERS!r} + ('PIL.Image',):\n"
        "    sys.modules[m] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({os.path.join(ROOT, 'chip_smoke.py')!r}, "
        "run_name='not_main')\n"
        "from keypoint_bench_tpu_torch.datasets import registry\n"
        "for t in ('hpatches', 'image_pair', 'kitti', 'megadepth'):\n"
        "    try:\n"
        "        registry.get_dataset({'type': t, 'root': '/nonexistent/',\n"
        "                              'gt': '/nonexistent.txt'})\n"
        "    except (OSError, ImportError) as e:\n"
        "        assert not isinstance(e, ImportError), (t, e)\n"
        "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]\n"
        f"      in {_READERS!r} and sys.modules[m] is not None))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
