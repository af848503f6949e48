"""A configuration, a traffic mix, a check and a per-layer metric placed in
a checkout as new files are found by their names, with no edit to a file
the harness has."""
import json
import shutil

from cardbench import harness
from cardbench.trace import Trace


def test_new_files_found_by_name(tmp_path):
    (tmp_path / "cardbench").mkdir()
    for sub in ("configs", "traffic", "checks", "metrics"):
        (tmp_path / "cardbench" / sub).mkdir()
    config = harness.read_json(harness.ROOT / "cardbench/configs/continental_synth.json")
    config.update(name="continental_half", nrows=600)
    (tmp_path / "cardbench/configs/continental_half.json").write_text(json.dumps(config))
    (tmp_path / "cardbench/traffic/single_long.json").write_text(json.dumps(
        {"router": "packed", "members": 1, "days_per_call": 30, "ring_days": 60,
         "warmup_calls": 1, "trace_calls": 2}))
    shutil.copy(harness.ROOT / "cardbench/checks/continental.single.json",
                tmp_path / "cardbench/checks/continental_half.long.json")
    (tmp_path / "cardbench/metrics/activities_per_day.py").write_text(
        'UNIT = "count"\nLAYER = "device"\nMOVES = "cell_steps_per_s"\n\n\n'
        "def read(t):\n    return len(t.activities) / t.days\n")
    bench = {"configs": [{"name": "continental_half", "source": "x",
                          "file": "cardbench/configs/continental_half.json", "reduced": ["nrows"],
                          "why": "x"}],
             "workloads": [{"name": "continental_half.long", "config": "continental_half",
                            "traffic": "single_long", "chips": 1, "why": "x"}],
             "end_to_end": [], "per_layer": [{"name": "activities_per_day"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, config, traffic, limits = harness.load_cell("continental_half.long", tmp_path)
    assert config["nrows"] == 600 and traffic["days_per_call"] == 30
    assert limits["rerun_mismatch"] == 0
    assert harness.generator(config).__name__ == "cardbench.inputs.continental"
    reader = harness.metric_reader("activities_per_day", tmp_path)
    assert reader.read(Trace(activities=[("k", 0.0, 1.0)] * 6, days=3, window_s=1.0)) == 2
    # a metric of the same quantity under a bound of its own reads through
    # its quantity's reader
    assert harness.metric_reader("activities_per_day.ens", tmp_path).read(
        Trace(activities=[("k", 0.0, 1.0)] * 6, days=2, window_s=1.0)) == 3
