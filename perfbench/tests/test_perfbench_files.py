"""Every file the benchmark finds by name is there and agrees with
``BENCHMARK.json``, which alone declares the metrics."""
import importlib
import json
import re

from perfbench import harness, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_config_and_metric_loads_by_name():
    bench = harness.benchmark()
    for c in bench["configs"]:
        cfg = harness.load("configs", c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        harness.program_config(cfg["pipeline"])
    for w in bench["workloads"]:
        wl = harness.load("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        importlib.import_module(f"perfbench.entries.{wl['entry']}")
        importlib.import_module(f"perfbench.traffic.{wl['traffic']['kind']}")
        assert set(wl["limits"]) == {"kp_miss", "desc_gap", "pose_gap",
                                     "chain_gap"}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(harness.reader(m["name"]).read), m["name"]


def test_benchmark_json_keeps_its_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in bench["end_to_end"] + bench["per_layer"]}
               ) == len(bench["end_to_end"]) + len(bench["per_layer"])
    for w in bench["workloads"] + bench["configs"]:
        assert _line(w["why"]), w["name"]
    for c in bench["configs"]:
        assert _line(c["source"]) and all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    assert all(_line(w) for w in bench["command"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        cell = w["name"]
        reports = {m["moves"] for m in harness.cell_metrics(
            bench, cell, "per_layer")}
        e2e_cell = {m["name"] for m in harness.cell_metrics(
            bench, cell, "end_to_end")}
        assert "setup_s" in e2e_cell and len(e2e_cell) >= 2
        assert reports and reports <= e2e_cell, cell
    assert len(json.dumps(bench)) < 64 * 1024


def test_spans_name_program_attributes():
    from perfbench.capture import resolve

    for name, spec in trace.span_files().items():
        for target in spec.get("targets", []):
            assert resolve(target)[0] is not None, (name, target)
    assert resolve("caelo_tpu_torch.frontend.odometry:no_such_fn") == (
        None, None)
