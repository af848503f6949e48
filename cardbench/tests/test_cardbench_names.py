"""BENCHMARK.json against the contract's shapes: keys, names, units, and
every file the harness finds by name."""
import re

import pytest

from cardbench import harness

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("cardbench/") and (harness.ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]} \
            if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    bench, w, config, traffic, limits = harness.load_cell(cell)
    assert config["name"] == w["config"] and harness.generator(config)
    assert set(limits) == {"start_gap", "rerun_mismatch", "day_gap", "site_gap", "nonfinite"}
    assert traffic["ring_days"] % traffic["days_per_call"] == 0
    end_to_end, per_layer = harness.reported(bench, cell)
    names = {m["name"] for m in end_to_end}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    assert all(m["moves"] in names for m in per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    reader = harness.metric_reader(metric)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"],
                                                         harness.quantity(entry["moves"]))
