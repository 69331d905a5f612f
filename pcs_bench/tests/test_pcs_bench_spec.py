"""BENCHMARK.json against the rules its readers hold it to: names, units and
keys, one file for every configuration, traffic mix, limit set and
per-layer metric it names, every per-layer metric in cells that run the
entry its reader reads and that report the end-to-end metric it moves."""
import os
import re

import pytest

from pcs_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            assert set(e) - {"workloads"} == KEYS[group], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for m in bench["per_layer"]:
        assert LINE.match(m["layer"])
    for word in bench["command"]:
        assert LINE.match(word)


def test_bounds_and_sources(bench):
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_named_file_exists(bench):
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert harness.load_json(os.path.join(harness.ROOT, c["file"]))[
            "name"] == c["name"]
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        assert cell.traffic["name"] == w["traffic"]
        assert os.path.isfile(os.path.join(
            harness.HERE, "drivers", cell.traffic["entry"] + ".py"))
        assert cell.limits
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        mod = harness.reader(m["name"])
        assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"]
        # BENCHMARK.json alone names a metric's cells; each has to run the
        # entry whose context the reader was written for
        assert not hasattr(mod, "WORKLOADS"), m["name"]
        for w in m.get("workloads", cells):
            assert harness.Cell(bench, w).traffic["entry"] == mod.ENTRY, (
                m["name"], w)


@pytest.mark.parametrize("group", ["per_layer", "end_to_end"])
def test_cells_report_what_their_metrics_move(bench, group):
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    for cell in cells:
        # every cell reports setup_s and one other end-to-end metric
        reported = {n for n, ws in e2e.items() if cell in ws}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])
    for m in bench[group]:
        if group == "per_layer":
            for cell in m.get("workloads", cells):
                assert cell in e2e[m["moves"]], (m["name"], cell)


def test_every_cell_rate_is_the_traffic_rate(bench):
    """The end-to-end rate a cell reports is the one its traffic names."""
    cells = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert cell.traffic["rate_metric"] in names
        assert names <= {cell.traffic["rate_metric"], "peak_mem_gib",
                         "setup_s"}
    assert cells
