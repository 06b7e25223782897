"""The premise of kernel A's recounted bound (chip_smoke.py
`nms_tile_work` / `nms_change_bound`), on the CPU.

The bound charges the local-max mask only to pixels within d of a change
of p, and the suppression only to pixels within d of a mask change. A run
of the fixpoint that recomputes just those pixels (and keeps the rest from
the round before) must give the maps and rounds of the port's `fast_nms`
and of the JAX `fast_nms` bit for bit, and `nms_tile_work` must count the
same pixels. Tolerance: none.
"""
import os
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F

from keypoint_bench_tpu.ops import detect as jd
from keypoint_bench_tpu_torch.ops import detect as td


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _near(changed, d):
    pooled = F.max_pool2d(changed.float()[:, None], 2 * d + 1, 1, d)
    return pooled[:, 0] > 0


def _fixpoint_near_changes(maps, d, max_iter=30):
    """fast_nms_rounds, recomputing each phase only within d of the last
    phase's changes. Returns (maps, rounds, mask pixels, suppression
    pixels) recomputed."""
    p = maps.clone()
    mask = td._local_max_mask(p, d)
    count = mask.sum((1, 2))
    prev = torch.full_like(count, -1)
    rounds = torch.zeros_like(count, dtype=torch.int32)
    mask_changed = torch.ones_like(mask)
    mask_px, supp_px = p.numel(), 0
    for _ in range(max_iter):
        active = count != prev
        if not bool(active.any()):
            break
        need = _near(mask_changed, d) & active[:, None, None]
        supp_px += int(need.sum())
        supp = td._others_in_window(mask, d) & need
        new_p = torch.where(supp, torch.zeros_like(p), p)
        need = _near(new_p.view(torch.int32) != p.view(torch.int32), d)
        mask_px += int(need.sum())
        p = new_p
        new_mask = torch.where(need, td._local_max_mask(p, d), mask)
        mask_changed = (new_mask != mask) & active[:, None, None]
        mask = torch.where(active[:, None, None], new_mask, mask)
        prev = torch.where(active, count, prev)
        count = torch.where(active, new_mask.sum((1, 2)), count)
        rounds += active.int()
    return p, rounds, mask_px, supp_px


@pytest.mark.parametrize("d", [1, 3])
def test_recomputing_only_near_changes_is_exact(d):
    base = np.random.default_rng(d).random((3, 40, 56)).astype(np.float32)
    maps_np = ndi.gaussian_filter(base, (0, 2.0, 2.0)).astype(np.float32)
    maps = torch.from_numpy(maps_np)
    got, rounds, mask_px, supp_px = _fixpoint_near_changes(maps, d)
    want, want_rounds = td.fast_nms_rounds(maps, d, 30)
    assert int(rounds.max()) >= 3       # the maps need several rounds
    assert torch.equal(got, want) and torch.equal(rounds, want_rounds)
    jax_out = np.stack([np.asarray(jd.fast_nms(jnp.asarray(m), d, 30))
                        for m in maps_np])
    np.testing.assert_array_equal(got.numpy(), jax_out)
    smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                           run_name="not_main")
    work = smoke["nms_tile_work"](maps, d)
    assert work[2:] == (mask_px, supp_px)
    assert mask_px < (int(rounds.max()) + 1) * maps.numel()
