"""The harness end to end on the CPU at a small size: each cell's files
are found by name, the reference agrees with the port's CPU path, and
planted faults in the timed step come out not correct."""
import json
import time

import pytest
import torch

from port_bench import harness, spec

CELLS = {
    "alike_t.repeatability.b32": dict(image_size=96, pairs_per_step=2,
                                      pool_pairs=4),
    "r2d2.repeatability.b4": dict(image_size=96, pairs_per_step=2,
                                  pool_pairs=4),
    "alike_t.auc_8pt.b16": dict(image_size=128, pairs_per_step=2,
                                pool_pairs=4, ransac_hypotheses=256),
}
SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, **kw):
    return harness.run(cell, SEED, 0.3, False, time.perf_counter(),
                       device="cpu", traffic=CELLS[cell], **kw)


def test_every_cell_finds_its_files():
    with open(f"{spec.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    assert {w["name"] for w in bench["workloads"]} == set(CELLS)
    for name in CELLS:
        cell = spec.load(name)
        assert cell.limits and cell.task.OUTPUTS
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]).read)
    with pytest.raises(KeyError):
        spec.load("no.such.cell")


@pytest.mark.parametrize("cell", list(CELLS))
def test_reference_agrees_with_the_cpu_path(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert set(r["metrics"]) == {"pairs_per_s", "step_ms_p95", "setup_s"}
    assert list(r)[-1] == "checks"


def _half_batch(step):
    """Half of the batch left out: the step runs on the first half and
    the rest of the outputs are the mean over it."""
    def broken(b):
        n = len(b["seeds"])
        half = {k: v[:n // 2] if hasattr(v, "__len__") else v
                for k, v in b.items()}
        out = step(half)
        return {k: torch.cat([v, v.float().mean().expand(n - n // 2)
                              .to(v.dtype)]) for k, v in out.items()}
    return broken


def _answer_altered(step):
    """One pair's first output altered where the step produces it."""
    def broken(b):
        out = step(b)
        k = next(iter(out))
        v = out[k].clone()
        v[0] = v[0] + 0.01 * (1 + v[0].abs())
        return {**out, k: v}
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _answer_altered])
@pytest.mark.parametrize("cell", list(CELLS))
def test_planted_faults_are_not_correct(cell, fault):
    r = _run(cell, break_step=fault)
    assert r["correct"] is False
    assert r["failed"] > 0


def test_no_card_no_result(monkeypatch, capsys):
    from port_bench import run as entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = entry.main(["--workload", "r2d2.repeatability.b4", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert rc == 3
    assert capsys.readouterr().out == ""
