#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lisflood_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on lines of its own; any failure raises and the
script exits non-zero:
  1. the card's name and power limit; the CUDA kernels built from
     lisflood_tpu_torch/csrc with nvcc (sm_90a), with their build time;
  2. the sub-step kernel against its plain PyTorch version on the card, at a
     middle size with every main-path phase active (synthetic 240x200 model,
     NoRoutSteps=24, chunk 512, lakes, reservoirs, split routing, the
     evaporation chain): float32 within 1e-5 and float64 within 1e-12 of
     each output's max, and float32 once more with single routing and no
     evaporation chain; two kernel runs bitwise equal; and the whole float64
     step on the card against the same step on the CPU (within 1e-10);
  3. the main path: the continental synthetic model (1200x1000,
     NoRoutSteps=24, chunk 512, float32) through build_multi_step with
     ChanQAvg output, one warm-up step and five timed steps; the kernel's
     launch count must equal the steps run and every state entry must be
     finite;
  4. at the main-path shape: the kernel's time (CUDA events over repeated
     launches) and its bound; the plain version's time (one run, ~100 s)
     and the kernel held to it (float32, within 1e-5 of each output's max).
The line before the last is a JSON object of per-kernel figures; the last is
{"ok": true, "device": {...}}. Needs no network; stops what it starts.
"""
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor float32 /
# float64 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# floating-point operations per lane of the sub-step kernel, counted from
# csrc/kinwave_substep.cu (float32, beta = 3/5, split routing): per
# sub-step the sideflow (2), its split (10), lateral inflows (2), the two
# cc sums (6), two polynomial Newton solves (2 x 76: bit-hack guesses 7,
# five iterations of 13, v^3 and v^5 4), the state updates (10) and sumdis
# (1); per evaporation hop 7; per lane 12 of set-up. Upstream-inflow adds
# are counted from the tables (one per valid source, lane-row and sub-step).
FLOPS_PER_SUBSTEP = 2 + 10 + 2 + 6 + 2 * 76 + 10 + 1
FLOPS_PER_HOP = 7
FLOPS_PER_LANE = 12


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, n_rep):
    """Mean milliseconds of `fn()` on the card over `n_rep` runs after one
    warm-up run, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_rep):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_rep


def max_rel_err(ys, ref):
    """Largest over outputs of max |y - ref| / max |ref|, and the largest
    absolute difference; both printed with the output they come from."""
    rel, absd = (0.0, ""), (0.0, "")
    for k, r in ref.items():
        d = (ys[k].double() - r.double()).abs().max().item()
        rel = max(rel, (d / max(r.double().abs().max().item(), 1e-300), k))
        absd = max(absd, (d, k))
    print(f"  worst output: rel {rel[0]:.3e} ({rel[1]}), abs {absd[0]:.3e} ({absd[1]})", flush=True)
    return rel[0], absd[0]


def bound(xs, ys, spec):
    """(bound_ms, bound_by): bytes of every input read once and every output
    written once over the HBM rate, against the operations this run's
    inputs need over the non-tensor peak for their type."""
    import torch
    nbytes = sum(v.numel() * v.element_size() for v in list(xs.values()) + list(ys.values()))
    p_pad = spec.n_chunks * spec.chunk
    L = 2 if spec.split else 1
    n_ups = int((xs["ups"] >= 0).sum())
    n_ev = int((xs["ev_ups"] >= 0).sum()) if spec.E else 0
    flops = (p_pad * (spec.T * FLOPS_PER_SUBSTEP + spec.E * FLOPS_PER_HOP + FLOPS_PER_LANE)
             + n_ups * spec.T * L + n_ev * max(spec.E - 1, 0))
    dtype = str(xs["dx"].dtype).replace("torch.", "")
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    print(f"  bound: {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms; "
          f"{flops / 1e9:.2f} GFLOP ({dtype}) -> {t_ops:.4f} ms", flush=True)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(model, device, dtype, seed=0):
    """A built step, its state and forcing, and the sub-step operands its
    land phase gives the routing kernel."""
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.step import build_step
    from lisflood_tpu_torch.models.synthetic import synthetic_forcing
    from lisflood_tpu_torch.ops.routing_ops import kernel_operands
    cfg, params, state, aux = model
    step, p = build_step(cfg, params, aux, dtype=dtype, device=device)
    s = step.prepare_state(state)
    f = to_device(synthetic_forcing(cfg.num_pixels, seed=seed), device, dtype)
    spec, xs = kernel_operands(cfg, p, s, step.land_phase(s, f), step.routers)
    return step, s, f, spec, xs


def phase_mid(torch, ks):
    """Phase 2: kernel vs plain version at 240x200 in float32 and float64
    with every main-path phase, and in float32 with single routing and no
    evaporation chain (the kernel's one-lane sub-step); then the whole
    float64 step on the card vs on the CPU."""
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model
    model = build_synthetic_model(240, 200, no_rout_steps=24, chunk_size=512)
    single = build_synthetic_model(240, 200, no_rout_steps=24, chunk_size=512,
                                   split_routing=False, open_water=False)
    cases = ((model, torch.float32, 1e-5, "all phases"),
             (model, torch.float64, 1e-12, "all phases"),
             (single, torch.float32, 1e-5, "single routing, no evaporation chain"))
    for m, dtype, tol, what in cases:
        step, s, f, spec, xs = kernel_inputs(m, "cuda", dtype)
        assert (spec.split and spec.E > 0) == (m is model), spec
        assert "lk_pos" in xs and "rs_pos" in xs, spec
        ys = ks.kinwave_substep(spec, xs)
        ys2 = ks.kinwave_substep(spec, xs)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(ys[k], ys2[k]) for k in ys)
        t0 = time.perf_counter()
        ref = ks.substep_reference(spec, xs)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        rel, absd = max_rel_err(ys, ref)
        name = str(dtype).replace("torch.", "")
        kernel_ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), 3)
        print(f"  240x200 {name} ({what}): kernel vs plain max rel err {rel:.3e} "
              f"(tol {tol:g}), max abs {absd:.3e}; two kernel runs bitwise equal: "
              f"{bitwise}; kernel {kernel_ms:.3f} ms, plain version {plain_s:.2f} s "
              f"for {spec.n_chunks} chunks", flush=True)
        assert rel <= tol, f"{name}: kernel disagrees with the plain version: {rel}"
        assert bitwise, "two kernel runs differ"
    # the whole float64 step, card (kernel) vs CPU (plain version)
    outs = {}
    for dev in ("cuda", "cpu"):
        step, s, f, _, _ = kernel_inputs(model, dev, torch.float64)
        s2, _ = step(s, f)
        outs[dev] = step.natural_state(s2)
    worst = max((float((outs["cuda"][k].cpu() - v).abs().max()
                       / max(float(v.abs().max()), 1e-300)), k) for k, v in outs["cpu"].items())
    print(f"  240x200 float64 step, card vs CPU: max rel err {worst[0]:.3e} ({worst[1]})",
          flush=True)
    assert worst[0] <= 1e-10, worst


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.step import build_multi_step
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, synthetic_forcing
    from lisflood_tpu_torch.ops import _build
    from lisflood_tpu_torch.ops import kinwave_substep as ks
    from lisflood_tpu_torch.ops.routing_ops import kernel_operands

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    secs = _build.build()
    print(f"  built {list(_build.SOURCES)} in {secs:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}", flush=True)

    print("phase 2: kernel vs plain version, 240x200, T=24, C=512", flush=True)
    phase_mid(torch, ks)

    print("phase 3: main path, continental 1200x1000, T=24, C=512, float32", flush=True)
    t0 = time.perf_counter()
    cfg, params, state, aux = build_synthetic_model(1200, 1000, no_rout_steps=24, chunk_size=512)
    print(f"  model built on the host in {time.perf_counter() - t0:.1f} s: "
          f"P={cfg.num_pixels}, lakes={cfg.num_lakes}, reservoirs={cfg.num_reservoirs}",
          flush=True)
    t0 = time.perf_counter()
    multi, p = build_multi_step(cfg, params, aux, output_keys=("ChanQAvg",),
                                dtype=torch.float32, device="cuda")
    s = multi.prepare_state(state)
    torch.cuda.synchronize()
    print(f"  step built and moved to the card in {time.perf_counter() - t0:.1f} s; "
          f"pipeline {multi.step.pipeline}; {multi.routers['kin'].ps.n_chunks} chunks, "
          f"window {multi.routers['kin'].ps.window}", flush=True)
    forcing = [to_device(synthetic_forcing(cfg.num_pixels, seed=i), "cuda", torch.float32)
               for i in range(6)]
    stack = lambda fs: {k: torch.stack([f[k] for f in fs]) for k in fs[0]}
    ks.kinwave_substep.launches = 0
    s, _ = multi(s, stack(forcing[:1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, outs = multi(s, stack(forcing[1:]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ks.kinwave_substep.launches
    steps_run = 6
    print(f"  5 steps in {dt:.3f} s: {dt / 5 * 1e3:.1f} ms/step, "
          f"{cfg.num_pixels * 5 / dt:.4g} cells*steps/s on {card}", flush=True)
    print(f"  kinwave_substep launches {launches} for {steps_run} steps", flush=True)
    assert launches == steps_run, (launches, steps_run)
    bad = [k for k, v in s.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    q = outs["ChanQAvg"]
    assert q.shape == (5, cfg.num_pixels) and bool(torch.isfinite(q).all()) and bool((q >= 0).all())
    print(f"  every state entry finite ({len(s)} entries); ChanQAvg {tuple(q.shape)}, "
          f"mean {float(q.mean()):.4g} m3/s", flush=True)

    print("phase 4: kernel timing at the main-path shape", flush=True)
    d = multi.step.land_phase(s, forcing[0])
    spec, xs = kernel_operands(cfg, p, s, d, multi.routers)
    ys = ks.kinwave_substep(spec, xs)
    n_rep = 5
    kernel_ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), n_rep)
    land_ms = cuda_ms(torch, lambda: multi.step.land_phase(s, forcing[0]), n_rep)
    print(f"  step breakdown: land phase + surface routing {land_ms:.1f} ms, routing "
          f"kernel {kernel_ms:.1f} ms, operand build and post-routing "
          f"{dt / 5 * 1e3 - land_ms - kernel_ms:.1f} ms (rest of the phase 3 step)", flush=True)
    bound_ms, bound_by = bound(xs, ys, spec)
    # the plain version at the main-path shape: the comparison that holds the
    # kernel to it, and its time from this one run
    t0 = time.perf_counter()
    ref = ks.substep_reference(spec, xs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rel, absd = max_rel_err(ys, ref)
    print(f"  kernel {kernel_ms:.3f} ms/launch (mean of {n_rep}); bound {bound_ms:.4f} ms "
          f"({bound_by}); plain version {plain_ms:.1f} ms (one run), kernel vs plain max "
          f"rel err {rel:.3e} (tol 1e-05), max abs err {absd:.3e}, at the main-path shape "
          f"({spec.n_chunks} chunks); card {card}", flush=True)
    assert rel <= 1e-5, f"kernel disagrees with the plain version: {rel}"

    figures = {"kernels": [{
        "name": "kinwave_substep", "route": "cuda",
        "source": "lisflood_tpu_torch/csrc/kinwave_substep.cu",
        "replaces": "lisflood_tpu/ops/kinwave_pallas.py:654",
        "launches": launches, "max_abs_err": absd, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(figures))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
