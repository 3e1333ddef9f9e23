"""The harness's arithmetic and BENCHMARK.json against the contract the
harness relies on."""

import json
import os
import re
import statistics

import numpy as np
import pytest

from portbench.harness import common, rooflines
from portbench.harness.trace import TraceData, merged

ROOT = common.ROOT


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_percentile_over_all_values():
    v = list(np.random.default_rng(1).exponential(size=1001))
    for q in (50, 95, 99):
        assert common.percentile(v, q) == pytest.approx(np.percentile(v, q))
    assert common.percentile([3.0], 95) == 3.0
    assert common.percentile(v, 50) == statistics.median(v)


def test_rate_is_taken_over_the_whole_window():
    assert common.rate(450, 5120.0, 10.5) == 450 * 5120.0 / 10.5


def test_busy_is_the_union_of_overlapping_intervals():
    ev = [("a", 0, 10, "kernel"), ("b", 5, 15, "kernel"),
          ("c", 20, 30, "copy"), ("d", 22, 25, "kernel"),
          ("e", 90, 200, "kernel")]
    assert merged(ev, (0, 100)) == [(0, 15), (20, 30), (90, 100)]
    tr = TraceData(window=(0, 100), device=ev,
                   spans=[(0, 18, "render"), (40, 95, "render")], units=2)
    assert tr.busy_s() == pytest.approx(35e-6)
    assert tr.window_s == pytest.approx(100e-6)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["between units", pytest.approx(60e-6)]
    assert gaps[1] == ["render", pytest.approx(5e-6)]
    assert tr.device_ops()[0] == ["e", pytest.approx(110e-6)]
    assert len(tr.kernels()) == 4


def test_held_and_rel_err():
    ok, checks = common.held({"out_rel_err": 1e-6}, {"out_rel_err": 1e-5})
    assert ok and checks == {"out_rel_err": {"value": 1e-6, "limit": 1e-5}}
    assert not common.held({"x": float("nan")}, {"x": 1.0})[0]
    assert not common.held({"x": 1.0}, {})[0]
    assert common.rel_err([1.0, np.nan], [1.0, 2.0]) == float("inf")
    assert common.rel_err([1.0, 2.5], [1.0, 2.0]) == 0.25


def test_segment_bytes_count_boundary_signals():
    for name, kernel, want in (("chain10", "chain_kernel", 8),
                               ("feedback16", "chain_kernel", 8),
                               ("feedback16", "cycle_kernel", 8)):
        with open(os.path.join(ROOT, "portbench", "configs",
                               name + ".json")) as f:
            cfg = json.load(f)
        (seg,) = cfg["segments"][kernel]
        assert rooflines.segment_bytes(cfg, seg) == want


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_names_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        for sub in ("traffic/" + w["traffic"], "limits/" + w["name"]):
            assert os.path.exists(os.path.join(ROOT, "portbench",
                                               sub + ".json"))


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_reports_setup_another_and_a_layer(cell):
    c = common.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and all(m["moves"] in e2e for m in c.per_layer)
    assert set(c.limits)
