"""The check's control and its readings, for setting a cell's limits.

    python3 cardbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3

For each seed, in one process: a run of the cell with a short window, its
check's numbers, held or not (the sound program's readings), and the
control: the plain reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place for the same day from
the same state and judged by the same verdict, which has to come out not
correct. One JSON line a seed; exits 1 where a sound run is not correct or
a control is.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cardbench import harness, run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        r = run.run_cell(args.workload, seed, args.seconds, False, t0=time.perf_counter(),
                         control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "readings": r["readings"],
                          "control": {"correct": r["control"]["correct"], "at": r["control"]["at"],
                                      **r["control"]["numbers"]},
                          **{k: v["value"] for k, v in r["metrics"].items()
                             if harness.quantity(k) == "cell_steps_per_s"}}),
              flush=True)
        bad += (not r["correct"]) + r["control"]["correct"]
        gc.collect()
        torch.cuda.empty_cache()
    if bad:
        print(f"{bad} verdict(s) came out wrong: a sound run not correct or a control correct",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
