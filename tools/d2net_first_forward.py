"""Probe the D2Net parity case of tests/test_torch_models.py
(test_forward_matches_jax[D2Net-64x64]): does the port's first D2Net
forward in a process differ from its later ones? CPU only.

    python tools/d2net_first_forward.py fresh N [--concurrency C]
           [--jax none|async|ready] [--out DIR]
    python tools/d2net_first_forward.py warm N [--overlap]
    python tools/d2net_first_forward.py pages SECONDS

fresh: N new processes, C at a time, each doing the test's steps (the
  golden D2Net parameters, the seed-0 64x64 image; with --jax the jitted
  JAX forward first, "async" leaving it running as the test does,
  "ready" waiting for it) and then three port forwards, every conv's
  input and output recorded. A process whose first forward differs from
  its second prints the largest gap of the score map and, per conv, the
  largest gap of its input and output (the first layer that parts names
  where the forward moved) and saves both forwards' layers under --out.
warm: N port forwards in one process, each (with --overlap) while XLA
  runs the JAX forward at 2x128x128; counts the forwards that differ
  from the most common result.
pages: parallel writes into freshly mapped memory for SECONDS (fills of
  3 GB, and convs and a cumsum; run it with MALLOC_MMAP_THRESHOLD_=65536
  so that every output is a fresh mapping), each checked bit for bit;
  counts the mismatches.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _setup(with_jax):
    import numpy as np

    from keypoint_bench_tpu_torch.weights import params_from_jax
    from keypoint_bench_tpu_torch.weights.io import golden_npz
    img = np.random.default_rng(0).random((1, 64, 64, 3), np.float32)
    p = golden_npz("D2Net")
    jf = None
    if with_jax:
        import jax
        import jax.numpy as jnp

        from keypoint_bench_tpu.models import common as jc
        from keypoint_bench_tpu.models import get_model as jax_get_model
        jc.set_conv_precision(jax.lax.Precision.HIGHEST)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        fn = jax_get_model("D2Net")
        jf = jax.jit(lambda x: fn(jp, x))
    return img, params_from_jax(p), jf


def _forward(tp, img, record=None):
    import torch

    from keypoint_bench_tpu_torch.models import common as tc
    from keypoint_bench_tpu_torch.models import get_model
    real = tc.conv2d

    def conv2d(x, w, b=None, *a, **k):
        y = real(x, w, b, *a, **k)
        record.append((x.clone(), y.clone()))
        return y

    if record is not None:
        tc.conv2d = conv2d
    try:
        with torch.no_grad():
            return get_model("D2Net")(tp)(torch.from_numpy(img))[0].numpy()
    finally:
        tc.conv2d = real


def one(jax_mode, out_dir):
    """One fresh process's check; prints one JSON line."""
    import numpy as np
    import torch
    img, tp, jf = _setup(jax_mode != "none")
    if jf is not None:
        import jax
        y = jf(jax.numpy.asarray(img))
        if jax_mode == "ready":
            jax.block_until_ready(y)
    recs = [[], [], []]
    fwd = [_forward(tp, img, r) for r in recs]
    gap = float(np.abs(fwd[0] - fwd[1]).max())
    res = {"first_vs_second": gap,
           "later_equal": bool(np.array_equal(fwd[1], fwd[2]))}
    if gap > 0:
        res["layers"] = [
            {"layer": i, "in_gap": float((x0 - x1).abs().max()),
             "out_gap": float((y0 - y1).abs().max()),
             "out_parted": int((y0 != y1).sum()), "shape": list(y0.shape)}
            for i, ((x0, y0), (x1, y1)) in enumerate(zip(recs[0], recs[1]))]
        os.makedirs(out_dir, exist_ok=True)
        torch.save({"first": recs[0], "second": recs[1]},
                   os.path.join(out_dir, f"first_forward_{os.getpid()}.pt"))
    print("RESULT " + json.dumps(res), flush=True)


def fresh(n, concurrency, jax_mode, out_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, os.path.abspath(__file__), "_one", jax_mode,
           out_dir]
    parted, done = [], 0
    while done < n:
        k = min(concurrency, n - done)
        procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True)
                 for _ in range(k)]
        for p in procs:
            out, _ = p.communicate()
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
            if not line:
                raise RuntimeError("a probe process failed")
            res = json.loads(line[0][7:])
            if res["first_vs_second"] > 0 or not res["later_equal"]:
                parted.append(res)
                print(json.dumps(res), flush=True)
        done += k
    print(json.dumps({"processes": n, "first_forward_parted": len(parted),
                      "jax": jax_mode}), flush=True)


def warm(n, overlap):
    import numpy as np
    img, tp, jf = _setup(overlap)
    big = block = None
    if overlap:
        import jax
        block = jax.block_until_ready
        big = jax.numpy.asarray(np.random.default_rng(1).random(
            (2, 128, 128, 3), np.float32))
        block(jf(big))
    outs = []
    for _ in range(n):
        y = jf(big) if overlap else None
        outs.append(_forward(tp, img))
        if overlap:
            block(y)
    keys = [hashlib.md5(o.tobytes()).hexdigest() for o in outs]
    mode = collections.Counter(keys).most_common(1)[0][0]
    ref = outs[keys.index(mode)]
    odd = [(i, float(np.abs(o - ref).max())) for i, (k, o) in
           enumerate(zip(keys, outs)) if k != mode]
    print(json.dumps({"forwards": n, "overlap": overlap,
                      "differ_from_mode": odd}), flush=True)


def pages(seconds):
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1, 64, 256, 256, generator=g)
    w = torch.rand(64, 64, 3, 3, generator=g) * 2 - 1

    def run():
        return F.conv2d(x, w, None, 1, 1), torch.cumsum(x.reshape(-1), 0)

    ref, n_fill = run(), (3 << 30) // 4
    t0, it, bad, gib = time.time(), 0, 0, 0.0
    while time.time() - t0 < seconds:
        a = torch.empty(n_fill)
        a.fill_(float(it % 997 + 1))
        bad += int((a != float(it % 997 + 1)).sum())
        gib += 3.0
        del a
        for _ in range(20):
            bad += sum(int((o != r).sum()) for o, r in zip(run(), ref))
        it += 1
        time.sleep(2.5)          # freed memory goes back before the next
    print(json.dumps({"rounds": it, "fill_gib": gib, "conv_calls": 20 * it,
                      "mismatched_elements": bad}), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "_one":
        return one(argv[1], argv[2])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("fresh")
    f.add_argument("n", type=int)
    f.add_argument("--concurrency", type=int, default=6)
    f.add_argument("--jax", choices=("none", "async", "ready"),
                   default="async")
    f.add_argument("--out", default=os.path.join(ROOT, "output",
                                                 "d2net_first_forward"))
    w = sub.add_parser("warm")
    w.add_argument("n", type=int)
    w.add_argument("--overlap", action="store_true")
    p = sub.add_parser("pages")
    p.add_argument("seconds", type=float)
    args = ap.parse_args(argv)
    if args.cmd == "fresh":
        fresh(args.n, args.concurrency, args.jax, args.out)
    elif args.cmd == "warm":
        warm(args.n, args.overlap)
    else:
        pages(args.seconds)


if __name__ == "__main__":
    main()
