"""The port's resume journal (runner.MetricLog) against the JAX runner's:
tests/test_metric_log.py's cases on torch scalars, the same
`progress.jsonl` bytes for the same records, and the meta guard that
discards a drifted journal."""
import json
import os

import jax.numpy as jnp
import pytest
import torch

from keypoint_bench_tpu.runner import MetricLog as JaxMetricLog
from keypoint_bench_tpu_torch.runner import MetricLog


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_lagged_flush_and_drain(tmp_path):
    log = MetricLog(str(tmp_path), resume=False)
    n = MetricLog._FLUSH_DEPTH + 3
    assert MetricLog._FLUSH_DEPTH == JaxMetricLog._FLUSH_DEPTH == 8
    for i in range(n):
        log.put(i, {"v": torch.tensor(float(i)) * 2.0})   # a tensor scalar
    # only the entries older than the lag are on disk
    assert len(_lines(log.path)) == n - MetricLog._FLUSH_DEPTH
    log.close()
    on_disk = _lines(log.path)
    assert [r["i"] for r in on_disk] == list(range(n))
    assert on_disk[4]["v"] == 8.0


def test_resume_replays_flushed_entries(tmp_path):
    log = MetricLog(str(tmp_path), resume=False)
    for i in range(MetricLog._FLUSH_DEPTH + 2):
        log.put(i, {"v": float(i)})
    # a crash: no close(); the pending tail is lost
    assert len(_lines(log.path)) == 2
    log._f.close()
    log2 = MetricLog(str(tmp_path), resume=True)
    assert log2.get(0) == {"i": 0, "v": 0.0}
    assert log2.get(1) == {"i": 1, "v": 1.0}
    assert log2.get(2) is None   # in flight at the crash: recomputed
    log2.close()


def test_no_resume_truncates(tmp_path):
    log = MetricLog(str(tmp_path), resume=False)
    log.put(0, {"v": 1.0})
    log.close()
    log2 = MetricLog(str(tmp_path), resume=False)
    assert log2.get(0) is None
    log2.close()
    assert _lines(os.path.join(tmp_path, "progress.jsonl")) == []


RECORDS = [{"repeatability": 0.5, "mean_error": 1.25, "num_feat": 300.0},
           {"h3": 1.0, "h5": 0.0, "h7": 1.0},
           {"error": 180.0, "inliers": 0},
           {"R": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0],
            "t": [0.0, 0.0, 1.0], "ok": True, "scale": 0.5}]


@pytest.mark.parametrize("meta", [None, {"task": "MHA", "th": [3.0, 5.0]}])
def test_journal_bytes_equal_jax(tmp_path, meta):
    """The same puts write the same progress.jsonl in both packages, scalars
    given as each package's device scalars."""
    logs = {"jax": (JaxMetricLog, jnp.float32), "torch": (MetricLog,
                                                           torch.tensor)}
    text = {}
    for name, (cls, scalar) in logs.items():
        log = cls(str(tmp_path / name), resume=False, meta=meta)
        for i in range(12):
            rec = dict(RECORDS[i % 4])
            if "mean_error" in rec:
                rec["mean_error"] = scalar(rec["mean_error"])
            log.put(i, rec)
        log.close()
        text[name] = (tmp_path / name / "progress.jsonl").read_text()
    assert text["torch"] == text["jax"]
    resumed = MetricLog(str(tmp_path / "jax"), resume=True, meta=meta)
    assert resumed.get(11) == {"i": 11, **RECORDS[3]}
    resumed.close()


@pytest.mark.parametrize("journal_meta,meta,kept", [
    ({"task": "MHA", "th": [3.0]}, {"task": "MHA", "th": [3.0]}, True),
    ({"task": "MHA", "th": [3.0]}, {"task": "MHA", "th": [5.0]}, False),
    ({"task": "AUC", "solver": "8pt"}, None, True)])
def test_meta_guard_discards_a_drifted_journal(tmp_path, journal_meta, meta,
                                               kept):
    log = MetricLog(str(tmp_path), resume=False, meta=journal_meta)
    log.put(0, {"v": 1.0})
    log.close()
    log2 = MetricLog(str(tmp_path), resume=True, meta=meta)
    assert (log2.get(0) is not None) == kept
    log2.close()
    lines = _lines(log2.path)
    if not kept and meta is not None:
        assert lines == [{"meta": meta}]


def test_a_run_that_raises_keeps_its_computed_pairs(tmp_path):
    """The runner closes its journal when a pair raises: the pairs before
    it reach progress.jsonl and a resume replays them."""
    from keypoint_bench_tpu_torch.runner import Evaluator

    class Items:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 3:
                raise IOError("a file that does not decode")
            return i

    log = MetricLog(str(tmp_path), resume=False, meta={"task": "t"})
    with pytest.raises(IOError):
        Evaluator._journaled(log, Items(), lambda i: {"v": float(i)})
    resumed = MetricLog(str(tmp_path), resume=True, meta={"task": "t"})
    assert [resumed.get(i) for i in range(4)] == [
        {"i": 0, "v": 0.0}, {"i": 1, "v": 1.0}, {"i": 2, "v": 2.0}, None]
    resumed.close()
