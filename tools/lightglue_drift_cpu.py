"""How far float32 LightGlue drifts from float64 with depth, in the JAX
package and in the port, on the DISK + LightGlue test's inputs (CPU).

    JAX_PLATFORMS=cpu python tools/lightglue_drift_cpu.py [--work DIR]

The disk LightGlue checkpoint (the golden randomized LightGlue with the
seeded std-1 128 -> 256 input_proj, weights/upstream.py) is converted
into --work (output/lightglue_drift by default); the port's runner gives
DISK's keypoints and descriptors of tests/test_torch_disk_lightglue.py's
2 synthetic pairs at 128^2, top_k 128. For depths 1 to 9 it prints the
largest |score_f32 - score_f64| over the valid entries of the log
assignment scores, over the largest |score_f64|: JAX float32 against JAX
float64 (jax.enable_x64), the port float32 against the port float64, and
the port float64 against JAX float64.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from keypoint_bench_tpu.models import lightglue as jlg
    from keypoint_bench_tpu_torch.datasets import get_dataset
    from keypoint_bench_tpu_torch.models import lightglue as tlg
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.weights import load_npz, load_params
    from keypoint_bench_tpu_torch.weights.convert import main as convert
    from keypoint_bench_tpu_torch.weights.upstream import (
        upstream_params, write_upstream_checkpoints)

    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=os.path.join(ROOT, "output",
                                                   "lightglue_drift"))
    args = ap.parse_args(argv)
    src, dst = (os.path.join(args.work, d) for d in ("upstream", "npz"))
    write_upstream_checkpoints(src, upstream_params(["DISK",
                                                     "lightglue_disk"]))
    convert(src, dst)
    cfg = dict(model_type="DISK", task_type="MHA",
               data_params={"type": "synthetic_homography", "num_pairs": 2,
                            "image_size": 128},
               extractor_params={"nms_dist": 4, "threshold": 0,
                                 "border_dist": 8, "top_k": 128,
                                 "min_score": 0.0},
               matcher_params={"type": "light_glue"}, weights_dir=dst,
               output_dir=os.path.join(args.work, "out"))
    ev = Evaluator(EvalConfig(**cfg), "cpu")
    raw = load_npz("lightglue_disk", dst)
    p32 = load_params("lightglue_disk", dst)
    p64 = {k: v.double() for k, v in p32.items()}

    def jax_scores(p, k0, v0, d0, k1, v1, d1, n_layers):
        d0 = jlg._linear(p, "input_proj", d0)
        d1 = jlg._linear(p, "input_proj", d1)
        e0 = jlg._posenc(p, jlg.normalize_keypoints_masked(k0, v0))
        e1 = jlg._posenc(p, jlg.normalize_keypoints_masked(k1, v1))
        for i in range(n_layers):
            pre = f"transformers.{i}"
            d0 = jlg._self_block(p, f"{pre}.self_attn", d0, e0, v0, 4)
            d1 = jlg._self_block(p, f"{pre}.self_attn", d1, e1, v1, 4)
            d0, d1 = jlg._cross_block(p, f"{pre}.cross_attn", d0, d1, v0,
                                      v1, 4)
        return jlg._assignment_scores(p, f"log_assignment.{n_layers - 1}",
                                      d0, d1, v0, v1)

    jit = jax.jit(jax_scores, static_argnames="n_layers")
    ds = get_dataset(cfg["data_params"])
    print("pair depth  jax_f32_vs_f64  port_f32_vs_f64  port_vs_jax_f64")
    for i in range(len(ds)):
        img0, _, _, d0, k0, v0, _, d1, k1, v1 = ev._pair_maps(ds[i])
        w = img0.shape[1]
        p0, p1 = k0[:, :2] * (w - 1.0), k1[:, :2] * (w - 1.0)
        ins = [x.numpy() for x in (
            p0, v0, tlg.sample_descriptors_lg(p0, d0, 1), p1, v1,
            tlg.sample_descriptors_lg(p1, d1, 1))]
        x64 = [x.astype(np.float64) if x.dtype == np.float32 else x
               for x in ins]
        for n in range(1, 10):
            t32 = tlg.lightglue_scores(p32, *map(torch.from_numpy, ins),
                                       n_layers=n).numpy()
            t64 = tlg.lightglue_scores(p64, *map(torch.from_numpy, x64),
                                       n_layers=n).numpy()
            j32 = np.asarray(jit({k: jnp.asarray(v) for k, v in raw.items()},
                                 *map(jnp.asarray, ins), n_layers=n))
            with jax.enable_x64(True):
                j64 = np.asarray(jit(
                    {k: jnp.asarray(v, jnp.float64) for k, v in raw.items()},
                    *map(jnp.asarray, x64), n_layers=n))
            live = j64 > -1e8
            scale = np.abs(j64[live]).max()

            def gap(a, b):
                return np.abs(np.asarray(a, np.float64) - b)[live].max() \
                    / scale
            print(f"{i:4d} {n:5d}  {gap(j32, j64):14.3e}  "
                  f"{gap(t32, t64):15.3e}  {gap(t64, j64):15.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
