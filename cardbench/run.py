"""Run one cell of the benchmark once and print its result line.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the line holds the cell's end-to-end metrics, measured over a
window of --seconds; with --trace 1 its per-layer metrics, read from a
profiled stretch of the same calls (traffic's `trace_calls`). Either way the
run ends with the check that decides `correct` (check.py). Exits 3 without a
result where the card is missing, 4 where the process holds JAX or the JAX
package once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cardbench import check, harness, roofline  # noqa: E402
from cardbench.reference.start import members_start  # noqa: E402
from cardbench.trace import Trace  # noqa: E402


# a device operation's name in the breakdown: its first characters (CUDA's
# template names run to thousands)
NAME_CHARS = 160


def traced_stretch(torch, ctx, n_calls):
    """The profiled calls: (Trace without bounds, host events). The
    stretch's length is its own timeline's, from the start of its first
    device activity to the end of its last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        calls, wall = harness.run_calls(ctx, n_calls=n_calls)
    device, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == DeviceType.CUDA else host).append(row)
    span = (max(e for _, _, e in device) - min(s for _, s, _ in device)) * 1e-6 if device else wall
    ctx.traced_wall = wall
    return Trace(activities=device, days=calls * ctx.D, window_s=span), host


def breakdown(trace, host, n=10):
    """The device operations that took most time, and the longest idle gaps
    with the host operation that overlapped each most."""
    by_name = {}
    for name, s, e in trace.activities:
        name = name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps, end = [], None
    for s, e in sorted((s, e) for _, s, e in trace.activities):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    idle = []
    for a, b in gaps:
        over = [(min(b, he) - max(a, hs), name) for name, hs, he in host if hs < b and he > a]
        idle.append([max(over)[1] if over else "none", (b - a) * 1e-6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def host_states(states):
    """Tensor states as float64 or integer NumPy arrays."""
    import torch
    return [{k: (v.to(torch.float64) if v.is_floating_point() else v).detach().cpu().numpy()
             for k, v in s.items()} for s in states]


def run_cell(name, seed, seconds, trace, device="cuda", t0=None, overrides=None, fault=None,
             control=False):
    """One run of the cell `name`: the result dict (without printing).
    `overrides` replaces parts of the cell's config, traffic or limits
    (tests run small grids on the CPU); `fault(ctx)` breaks the program
    after set-up (tests); `control` also puts the reference computed in
    bfloat16 in the program's place, judges it by the same limits and adds
    its verdict as `control`, and every number read, held or not, as
    `readings` (control.py)."""
    import torch
    t0 = T0 if t0 is None else t0
    bench, cell, config, traffic, limits = harness.load_cell(name)
    for part, new in (overrides or {}).items():
        {"config": config, "traffic": traffic, "limits": limits}[part].update(new)
    device = torch.device(device)
    on_card = device.type == "cuda"
    info = lambda msg: print(f"[{name} seed {seed}] {msg}", file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory(prefix="cardbench-") as workdir:
        ctx = harness.setup(torch, config, traffic, seed, device, workdir)
        setup_s = time.perf_counter() - t0 - ctx.t_excluded
        info(f"set-up {setup_s:.2f} s (inputs {ctx.t_inputs:.2f} s)")
        if fault is not None:
            fault(ctx)
        metrics = {}
        if trace:
            tr, host = traced_stretch(torch, ctx, int(traffic["trace_calls"]))
            info(f"traced {tr.days} days: {tr.window_s:.4f} s on the device's timeline, "
                 f"{ctx.traced_wall:.4f} s on the host's clock")
        else:
            calls, wall = harness.run_calls(ctx, seconds=seconds)
            days = calls * ctx.D
            ms = ctx.call_ms
            third = max(1, len(ms) // 3)
            info(f"window {wall:.3f} s, {calls} calls, {days} days; device ms a call: first "
                 f"third {sum(ms[:third]) / third:.2f}, last {sum(ms[-third:]) / third:.2f}, "
                 f"min {min(ms, default=0):.2f}, max {max(ms, default=0):.2f}")
            rate = days * ctx.prog.pixels / wall
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        attempted = (tr.days if trace else days) * ctx.prog.members
        members = ctx.prog.members

        # the check: the window's last call replayed, the program freed, the
        # reference's day
        t_star, before, after, forcing, mismatched = harness.replay_last_call(torch, ctx, seed)
        start = ctx.start
        harness.free_program(torch, ctx)
        t1 = time.perf_counter()
        from cardbench.reference import routing
        from cardbench.reference.step import ReferenceModel
        ref_model = ctx.gen.reference_model(ctx.inputs)
        ref = ReferenceModel(ref_model, device, torch.float64)
        ref_start = members_start(torch, ref_model["state"], traffic, seed, device, ctx.dtype)
        pixels, site_index = len(ref_model["down_kin"]), check.sites(ref_model)
        forcing = ctx.gen.reference_forcing(ctx.inputs, *forcing)
        if trace:
            ref_after, flops = roofline.step_flops(torch, lambda: ref.step(before, forcing),
                                                   solvers=[(routing, "newton_solve")])
            tr.step_flops = flops
            tr.bounds = roofline.day_bounds(roofline.graph_sizes(ref_model, members),
                                            config["no_rout_steps"], traffic["router"])
        else:
            ref_after = ref.step(before, forcing)
        ref_after = host_states(ref_after)
        gaps = check.member_day_gaps(after, ref_after, pixels, site_index, device=device)
        day = {n: max(g[n] for g in gaps) for n in check.DAY_GAPS}
        sgap, swhere = check.start_gap(start, ref_start, device=device)
        numbers = {"start_gap": sgap, "rerun_mismatch": len(mismatched),
                   **{n: g for n, (g, _) in day.items()}, "nonfinite": check.nonfinite(after)}
        correct, lines = check.verdict(numbers, limits)
        held = [n for n in check.DAY_GAPS if n in limits]
        failed = sum(any(g[n][0] > limits[n] for n in held) or check.nonfinite([a]) > 0
                     for g, a in zip(gaps, after))
        info(f"check {time.perf_counter() - t1:.1f} s: day {t_star} of the last call; "
             + ", ".join(f"{n} {g:.3e} at {w}" for n, (g, w) in day.items())
             + f"; start_gap at {swhere}; mismatched {mismatched[:5]}")
        if control:
            low = host_states(ReferenceModel(ref_model, device, torch.bfloat16)
                              .step(before, forcing))
            low_start = [{k: (torch.as_tensor(v).to(torch.bfloat16).to(torch.float64).numpy()
                              if np.asarray(v).dtype.kind == "f" else v) for k, v in s.items()}
                         for s in ref_start]
            low_day = check.day_gaps(low, ref_after, pixels, site_index, device=device)
            # the control is the reference's arithmetic, the same on a replay
            control_numbers = {"start_gap": check.start_gap(low_start, ref_start, device)[0],
                               "rerun_mismatch": 0,
                               **{n: g for n, (g, _) in low_day.items()},
                               "nonfinite": check.nonfinite(low)}
            control_correct, control_lines = check.verdict(control_numbers, limits)
            info("control: " + ", ".join(f"{n} {g:.3e} at {w}" for n, (g, w) in low_day.items()))
    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"the process holds {', '.join(forbidden)}", file=sys.stderr)
        return None
    end_to_end, per_layer = harness.reported(bench, name)
    if trace:
        for m in per_layer:
            v = harness.metric_reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        readings = {"cell_steps_per_s": rate, "peak_mem_gib": peak / harness.GIB,
                    "setup_s": setup_s}
        for m in end_to_end:
            metrics[m["name"]] = {"value": readings[harness.quantity(m["name"])],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr, host)
    if control:
        result["control"] = {"correct": bool(control_correct), "check": control_lines,
                             "numbers": control_numbers,
                             "at": {n: w for n, (_, w) in low_day.items()}}
        result["readings"] = {"numbers": numbers, "at": {n: w for n, (_, w) in day.items()}}
    result["check"] = lines
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    _, cell, *_ = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 4
    for k, v in result["check"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
