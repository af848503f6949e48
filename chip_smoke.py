#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lisflood_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on lines of its own; any failure raises and the
script exits non-zero:
  1. the card's name and power limit; the CUDA kernels built from
     lisflood_tpu_torch/csrc with nvcc (sm_90a), with their build time; the
     arithmetic instructions of pow and powf counted from their SASS and
     held to POW_FLOPS below (the constants of the kernel's bound);
  2. the sub-step kernel against its plain PyTorch version on the card, at a
     middle size with every main-path phase active (synthetic 240x200 model,
     NoRoutSteps=24, chunk 512, lakes, reservoirs, split routing, the
     evaporation chain): float32 within 1e-5 and float64 within 1e-12 of
     each output's max, and float32 once more with single routing and no
     evaporation chain; the same with the optional sideflow terms (water
     use, inflow ramp, transmission loss) from with_options, in float32 and
     float64, and in float32 with the evaporation chain outside the kernel
     (operand `eva`); two kernel runs bitwise equal; and the whole float64
     step (default, all-options, and all-options with the evaporation
     chain outside the kernel) on the card against the same step on the CPU
     (within 1e-10);
  3. the main path: the continental synthetic model (1200x1000,
     NoRoutSteps=24, chunk 512, float32) through build_multi_step with
     ChanQAvg output, one warm-up step and two timed batches of five steps
     (the first still holds the start-up transient of a fresh process, the
     second is the steady state); the kernel's launch count must equal the
     steps run and every state entry must be finite; then one step under
     torch.profiler for the device's busy share;
  4. at the main-path shape: the kernel's time (CUDA events over repeated
     launches) and its bound; the plain version's time (one run, ~100 s)
     and the kernel held to it (float32, within 1e-5 of each output's max);
  5. the all-options path: the continental model with every option of
     with_options on (water use, rice, inflow, transmission loss, polders,
     water levels, pF, mass-balance reports) through build_multi_step, timed
     and profiled as in phase 3; launches equal steps, every state entry
     finite, TransCum non-negative and not all zero; the kernel's time with
     the sideflow terms on, its bound, and the plain version's time with the
     kernel held to it at this shape (float32, within 1e-5 of each output's
     max, `trans` included).
Run as `python3 chip_smoke.py --side-flag-ab` it only times the main path's
kernel launch against a build of the same source without the SIDE template
flag (the optional sideflow terms then guarded by their null pointers alone).
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
# csrc/kinwave_substep.cu. Polynomial path (float32, beta = 3/5, split
# routing): per sub-step the sideflow (2), its split (10), lateral inflows
# (2), the two cc sums (6), two polynomial Newton solves (2 x 76: bit-hack
# guesses 7, five iterations of 13, v^3 and v^5 4), the state updates (10)
# and sumdis (1); per evaporation hop 7; per lane 12 of set-up.
# Upstream-inflow adds are counted from the tables (one per valid source,
# lane-row and sub-step).
FLOPS_PER_SUBSTEP = 2 + 10 + 2 + 6 + 2 * 76 + 10 + 1
FLOPS_PER_HOP = 7
FLOPS_PER_LANE = 12
# q-space path (float64, or beta != 3/5), per routed lane-row and sub-step:
# the cc sum (3 and 1 pow), newton_q (8 and 3 pow of set-up; each of its 4
# (float32) or 6 (float64) unrolled iterations 9 and 1 pow; the loop has no
# early exit), the storage and discharge round trip (5 and 2 pow); shared by
# the rows: sideflow (2), and with split routing its split (10), lateral
# inflows (2), chanq and sumdis (4), against 1 for single routing.
QSPACE_ROW = lambda iters: (3 + 8 + 9 * iters + 5, 1 + 3 + iters + 2)     # (plain, pow)
QSPACE_ITERS = {"float32": 4, "float64": 6}
# one pow, by the arithmetic instructions (add, multiply; a fused
# multiply-add counts 2) in the SASS that nvcc 12 emits for pow / powf on
# sm_90a, every branch included: phase 1 counts them anew and fails if they
# differ
POW_FLOPS = {"float32": 63, "float64": 122}
# the optional sideflow terms: eva and wuse 1 per lane each; per sub-step
# the inflow ramp 3; the transmission loss 4, and on lanes with uptrans set
# 1 and 2 pow more
FLOPS_RAMP = 3
FLOPS_TRANS = (4, 1, 2)


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
    from lisflood_tpu_torch.ops.kinwave_substep import _poly
    nbytes = sum(v.numel() * v.element_size() for v in list(xs.values()) + list(ys.values()))
    p_pad = spec.n_chunks * spec.chunk
    L = 2 if spec.split else 1
    n_ups = int((xs["ups"] >= 0).sum())
    n_ev = int((xs["ev_ups"] >= 0).sum()) if spec.E else 0
    dtype = str(xs["dx"].dtype).replace("torch.", "")
    pow_flops = POW_FLOPS[dtype]
    if _poly(spec, xs["dx"].dtype):
        assert spec.split, "the polynomial path's count is split routing's"
        per_substep = FLOPS_PER_SUBSTEP
    else:
        plain, pows = QSPACE_ROW(QSPACE_ITERS[dtype])
        per_substep = L * (plain + pows * pow_flops) + 2 + (10 + 2 + 4 if spec.split else 1)
    per_lane = FLOPS_PER_LANE + ("eva" in xs) + ("wuse" in xs)
    flops = 0
    if "qin_old" in xs:
        per_substep += FLOPS_RAMP
    if "uptrans" in xs:
        every, masked, pows = FLOPS_TRANS
        per_substep += every
        flops += int((xs["uptrans"] != 0).sum()) * spec.T * (masked + pows * pow_flops)
    flops += (p_pad * (spec.T * per_substep + spec.E * FLOPS_PER_HOP + per_lane)
              + n_ups * spec.T * L + n_ev * max(spec.E - 1, 0))
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
    f = to_device({**synthetic_forcing(cfg.num_pixels, seed=seed),
                   **aux.get("forcing_options", {})}, device, dtype)
    spec, xs = kernel_operands(cfg, p, s, step.land_phase(s, f), step.routers)
    return step, s, f, spec, xs


def phase_mid(torch, ks):
    """Phase 2: kernel vs plain version at 240x200 in float32 and float64
    with every main-path phase, in float32 with single routing and no
    evaporation chain (the kernel's one-lane sub-step), and with the optional
    sideflow terms; then the whole float64 step, default and all-options, on
    the card vs on the CPU, the latter also with the evaporation chain outside
    the kernel. Returns the figures of the float32 sideflow case
    and of the float64 default case."""
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, with_options
    model = build_synthetic_model(240, 200, no_rout_steps=24, chunk_size=512)
    single = build_synthetic_model(240, 200, no_rout_steps=24, chunk_size=512,
                                   split_routing=False, open_water=False)
    options = with_options(model)
    eva_outside = with_options(model, eva_outside_window=True)
    side = {"wuse", "qin_old", "uptrans"}
    # (model, dtype, tolerance, label, optional operands expected)
    cases = ((model, torch.float32, 1e-5, "all phases", set()),
             (model, torch.float64, 1e-12, "all phases", set()),
             (single, torch.float32, 1e-5, "single routing, no evaporation chain", set()),
             (options, torch.float32, 1e-5, "all phases, sideflow terms", side),
             (options, torch.float64, 1e-12, "all phases, sideflow terms", side),
             (eva_outside, torch.float32, 1e-5, "sideflow terms, evaporation outside",
              side | {"eva"}))
    figures = {}
    for m, dtype, tol, what, terms in cases:
        step, s, f, spec, xs = kernel_inputs(m, "cuda", dtype)
        assert spec.split == (m is not single), spec
        assert (spec.E > 0) == (m is model or m is options), spec
        assert {k for k in ("eva", "wuse", "qin_old", "uptrans") if k in xs} == terms, sorted(xs)
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
        if "trans" in ys:
            assert bool(torch.isfinite(ys["trans"]).all()) and float(ys["trans"].max()) > 0
        name = str(dtype).replace("torch.", "")
        kernel_ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), 3)
        print(f"  240x200 {name} ({what}): kernel vs plain max rel err {rel:.3e} "
              f"(tol {tol:g}), max abs {absd:.3e}; two kernel runs bitwise equal: "
              f"{bitwise}; kernel {kernel_ms:.3f} ms, plain version {plain_s:.2f} s "
              f"for {spec.n_chunks} chunks", flush=True)
        assert rel <= tol, f"{name}: kernel disagrees with the plain version: {rel}"
        assert bitwise, "two kernel runs differ"
        if (m is options and dtype == torch.float32) or (m is model and dtype == torch.float64):
            bound_ms, bound_by = bound(xs, ys, spec)
            figures[name] = {"ms": kernel_ms, "plain_ms": plain_s * 1e3, "max_abs_err": absd,
                             "bound_ms": bound_ms, "bound_by": bound_by}
    # the whole float64 step, card (kernel) vs CPU (plain version)
    for m, what in ((model, "default"), (options, "all-options"),
                    (eva_outside, "all-options, evaporation outside")):
        outs = {}
        for dev in ("cuda", "cpu"):
            step, s, f, _, _ = kernel_inputs(m, dev, torch.float64)
            s2, d = step(s, f)
            outs[dev] = step.natural_state(s2)
            assert step.eva_in_kernel == (m is not eva_outside)
            if m is not model:
                outs[dev].update({k: d[k] for k in ("ChanQAvg", "MBError", "MBErrorSplitRoutingM3")})
        # the two mass-balance residuals are differences of catchment totals
        # (summed with atomics on the card): held on the scale of those totals
        scale = {k: float(outs["cpu"][total].abs().max()) for k, total in
                 (("MBError", "WaterInit"), ("MBErrorSplitRoutingM3", "StorageStepINIT"))
                 if k in outs["cpu"]}
        worst = max((float((outs["cuda"][k].cpu() - v).abs().max()
                           / scale.get(k, max(float(v.abs().max()), 1e-300))), k)
                    for k, v in outs["cpu"].items())
        print(f"  240x200 float64 {what} step, card vs CPU: max rel err {worst[0]:.3e} "
              f"({worst[1]})", flush=True)
        assert worst[0] <= 1e-10, worst
    return figures


STEPS_RUN = 11      # one warm-up step and two timed batches of five


def timed_steps(torch, ks, multi, s, forcing, card):
    """One warm-up step, then two batches of five timed steps over the six
    forcings, with the kernel's launch count set to 0 just before and read
    just after. The first batch still pays for a fresh process (the caching
    allocator grows, the soil columns relax from their initial state); the
    second is the steady state. Returns (state, the second batch's outputs,
    its milliseconds per step, launches)."""
    stack = lambda fs: {k: torch.stack([f[k] for f in fs]) for k in fs[0]}
    ks.kinwave_substep.launches = 0
    s, _ = multi(s, stack(forcing[:1]))
    torch.cuda.synchronize()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        s, outs = multi(s, stack(forcing[1:]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / 5 * 1e3)
    launches = ks.kinwave_substep.launches
    cells = next(iter(outs.values())).shape[1]
    print(f"  first 5 steps after the warm-up {ms[0]:.1f} ms/step, next 5 steps {ms[1]:.1f} "
          f"ms/step = {cells / ms[1] * 1e3:.4g} cells*steps/s on {card}", flush=True)
    print(f"  kinwave_substep launches {launches} for {STEPS_RUN} steps", flush=True)
    assert launches == STEPS_RUN, (launches, STEPS_RUN)
    return s, outs, ms[1], launches


def profile_step(torch, step, s, f, step_ms):
    """One step under torch.profiler: the device's busy time by kernel rows,
    against the unprofiled steady step time `step_ms` (the profiled step's
    own wall time holds the profiler's cost). The idle share is printed as
    it comes out, below 0 if the profiled kernels ran longer than that
    step. A profiler that records no device time is said so on a line of
    its own and is no failure: a machine may refuse the tracing."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(s, f)
        torch.cuda.synchronize()
    device_us = lambda e: (getattr(e, "self_device_time_total", 0)
                           or getattr(e, "self_cuda_time_total", 0))
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    if busy_ms == 0:
        print("  torch.profiler recorded no device time: idle share not measured", flush=True)
        return
    rows.sort(key=device_us, reverse=True)
    top = "; ".join(f"{e.key[:40]} {device_us(e) / 1e3:.1f} ms x{e.count}" for e in rows[:4])
    print(f"  one step under torch.profiler: device busy {busy_ms:.1f} ms in "
          f"{sum(e.count for e in rows)} kernels, {(1 - busy_ms / step_ms) * 100:.1f}% idle "
          f"of the unprofiled {step_ms:.1f} ms step; largest: {top}", flush=True)


def count_pow_ops():
    """Counts the arithmetic instructions in the SASS of pow and powf for
    sm_90a (an FMA as 2), by element type: the figures of POW_FLOPS."""
    import os
    import re
    import tempfile
    src = ('extern "C" __global__ void pow64(double* a, const double* b) '
           '{ a[threadIdx.x] = pow(a[threadIdx.x], b[threadIdx.x]); }\n'
           'extern "C" __global__ void pow32(float* a, const float* b) '
           '{ a[threadIdx.x] = powf(a[threadIdx.x], b[threadIdx.x]); }\n')
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    with tempfile.TemporaryDirectory() as tmp:
        cu, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
        with open(cu, "w") as fh:
            fh.write(src)
        subprocess.run([os.path.join(cuda, "bin", "nvcc"), "-arch=sm_90a", "-O3", "-fmad=false",
                        "-cubin", "-o", cubin, cu], check=True, timeout=300)
        sass = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True, timeout=300).stdout
    counted = {}
    for fn, prefix, dtype in (("pow64", "D", "float64"), ("pow32", "F", "float32")):
        body = sass[sass.index("Function : " + fn):]
        body = body[:body.index("Function : ", 20)] if "Function : " in body[20:] else body
        ops = re.findall(r"\b(%s(?:ADD|MUL|FMA))\b" % prefix, body)
        flops = sum(2 if op.endswith("FMA") else 1 for op in ops)
        print(f"  {fn}: {len(ops)} arithmetic instructions, {flops} operations", flush=True)
        counted[dtype] = flops
    return counted


def side_flag_ab(torch):
    """Times the main-path launch (continental shape, float32, no optional
    sideflow operand) with the kernel as it is and with a build of the same
    source in which the SIDE template flag is taken out, so that one
    instantiation serves both paths; flag, no flag, no flag, flag."""
    import ctypes
    import os
    import re
    import tempfile
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.step import build_multi_step
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, synthetic_forcing
    from lisflood_tpu_torch.ops import _build
    from lisflood_tpu_torch.ops import kinwave_substep as ks
    from lisflood_tpu_torch.ops.routing_ops import kernel_operands
    print(smi_line(), flush=True)
    src = _build.SOURCES["kinwave_substep"].read_text()
    src = src.replace("template <typename T, bool POLY, bool SIDE>",
                      "template <typename T, bool POLY>").replace("SIDE && ", "")
    src, n = re.subn(r"if \(side\) (substep_kernel<\w+, \w+), true>(.*)\n\s*else .*\n",
                     r"\1>\2\n", src)
    assert n == 3 and "SIDE &&" not in src, "the source's SIDE flag is not where it was"
    cfg, params, state, aux = build_synthetic_model(1200, 1000, no_rout_steps=24, chunk_size=512)
    multi, p = build_multi_step(cfg, params, aux, dtype=torch.float32, device="cuda")
    f = to_device(synthetic_forcing(cfg.num_pixels, seed=0), "cuda", torch.float32)
    s, _ = multi.step(multi.prepare_state(state), f)
    spec, xs = kernel_operands(cfg, p, s, multi.step.land_phase(s, f), multi.routers)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "noflag.cu"), os.path.join(tmp, "noflag.so")
        with open(cu, "w") as fh:
            fh.write(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu], check=True,
                       capture_output=True, timeout=600)
        libs = {"flag": _build.load("kinwave_substep"), "no flag": ctypes.CDLL(so)}
        outs = {}
        for name in ("flag", "no flag", "no flag", "flag"):
            _build._libs["kinwave_substep"] = libs[name]
            ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), 5)
            outs[name] = ks.kinwave_substep(spec, xs)
            print(f"main-path launch, {spec.n_chunks} chunks, {name}: {ms:.3f} ms (mean of 5)",
                  flush=True)
        torch.cuda.synchronize()
    assert all(torch.equal(outs["flag"][k], v) for k, v in outs["no flag"].items())
    print("outputs of the two builds bitwise equal", flush=True)
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--side-flag-ab"]:
        return side_flag_ab(torch)
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.step import build_multi_step
    from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                     with_options)
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

    assert count_pow_ops() == POW_FLOPS, "POW_FLOPS is not what this nvcc emits for pow"

    print("phase 2: kernel vs plain version, 240x200, T=24, C=512", flush=True)
    mid = phase_mid(torch, ks)

    print("phase 3: main path, continental 1200x1000, T=24, C=512, float32", flush=True)
    t0 = time.perf_counter()
    model = build_synthetic_model(1200, 1000, no_rout_steps=24, chunk_size=512)
    cfg, params, state, aux = model
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
    s, outs, step_ms, launches = timed_steps(torch, ks, multi, s, forcing, card)
    bad = [k for k, v in s.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    q = outs["ChanQAvg"]
    assert q.shape == (5, cfg.num_pixels) and bool(torch.isfinite(q).all()) and bool((q >= 0).all())
    print(f"  every state entry finite ({len(s)} entries); ChanQAvg {tuple(q.shape)}, "
          f"mean {float(q.mean()):.4g} m3/s", flush=True)
    profile_step(torch, multi.step, s, forcing[0], step_ms)

    print("phase 4: kernel timing at the main-path shape", flush=True)
    d = multi.step.land_phase(s, forcing[0])
    spec, xs = kernel_operands(cfg, p, s, d, multi.routers)
    ys = ks.kinwave_substep(spec, xs)
    n_rep = 5
    kernel_ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), n_rep)
    land_ms = cuda_ms(torch, lambda: multi.step.land_phase(s, forcing[0]), n_rep)
    print(f"  parts of the {step_ms:.1f} ms step, each timed alone (they overlap in the step: "
          f"the host enqueues the next land phase while the routing kernel runs): land phase "
          f"+ surface routing {land_ms:.1f} ms, routing kernel {kernel_ms:.1f} ms", flush=True)
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
    f64 = mid["float64"]
    print(f"  the float64 q-space kernel at 240x200: {f64['ms']:.3f} ms, bound "
          f"{f64['bound_ms']:.4f} ms ({f64['bound_by']}), plain version {f64['plain_ms']:.0f} ms",
          flush=True)

    print("phase 5: all-options path, continental 1200x1000, T=24, C=512, float32", flush=True)
    t0 = time.perf_counter()
    cfg5, params5, state5, aux5 = with_options(model)
    multi5, p5 = build_multi_step(cfg5, params5, aux5, output_keys=("ChanQAvg", "MBErrorMM"),
                                  dtype=torch.float32, device="cuda")
    s5 = multi5.prepare_state(state5)
    torch.cuda.synchronize()
    print(f"  options added, step built and moved to the card in {time.perf_counter() - t0:.1f} s; "
          f"evaporation chain in the kernel: {multi5.step.eva_in_kernel}; "
          f"{int(params5['UpTrans'].sum())} transmission-loss pixels, "
          f"{int((params5['InflowPoints'] > 0).sum())} inflow points", flush=True)
    forcing5 = [to_device({**synthetic_forcing(cfg5.num_pixels, seed=i), **aux5["forcing_options"]},
                          "cuda", torch.float32) for i in range(6)]
    s5, outs5, step5_ms, launches5 = timed_steps(torch, ks, multi5, s5, forcing5, card)
    bad = [k for k, v in s5.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    trans_cum = s5["pk$TransCum"]
    assert bool((trans_cum >= 0).all()) and float(trans_cum.max()) > 0, "TransCum"
    q5 = outs5["ChanQAvg"]
    assert q5.shape == (5, cfg5.num_pixels) and bool(torch.isfinite(q5).all()) and bool((q5 >= 0).all())
    assert bool(torch.isfinite(outs5["MBErrorMM"]).all())
    print(f"  every state entry finite ({len(s5)} entries); TransCum max {float(trans_cum.max()):.4g} "
          f"m3, sum {float(trans_cum.double().sum()):.4g} m3; ChanQAvg mean {float(q5.mean()):.4g} "
          f"m3/s; max |MBErrorMM| {float(outs5['MBErrorMM'].abs().max()):.3g} mm (the "
          f"reference's balance does not close with every option on; the port is held to "
          f"the reference's residual by the CPU tests)", flush=True)
    profile_step(torch, multi5.step, s5, forcing5[0], step5_ms)
    d5 = multi5.step.land_phase(s5, forcing5[0])
    spec5, xs5 = kernel_operands(cfg5, p5, s5, d5, multi5.routers)
    assert all(k in xs5 for k in ("wuse", "qin_old", "qdelta", "uptrans", "tp1", "tp2", "tsub"))
    ys5 = ks.kinwave_substep(spec5, xs5)
    kernel5_ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec5, xs5), n_rep)
    land5_ms = cuda_ms(torch, lambda: multi5.step.land_phase(s5, forcing5[0]), n_rep)
    bound5_ms, bound5_by = bound(xs5, ys5, spec5)
    print(f"  parts of the {step5_ms:.1f} ms step, each timed alone: land phase incl. water "
          f"abstraction + surface routing {land5_ms:.1f} ms, routing kernel {kernel5_ms:.1f} ms; "
          f"operand build, post-routing and the mass balance's catchment totals are the rest",
          flush=True)
    t0 = time.perf_counter()
    ref5 = ks.substep_reference(spec5, xs5)
    torch.cuda.synchronize()
    plain5_ms = (time.perf_counter() - t0) * 1e3
    assert "trans" in ref5 and bool(torch.isfinite(ys5["trans"]).all())
    rel5, absd5 = max_rel_err(ys5, ref5)
    side = mid["float32"]
    print(f"  kernel with the sideflow terms {kernel5_ms:.3f} ms/launch (mean of {n_rep}); bound "
          f"{bound5_ms:.4f} ms ({bound5_by}); plain version {plain5_ms:.1f} ms (one run), kernel "
          f"vs plain max rel err {rel5:.3e} (tol 1e-05), max abs err {absd5:.3e}, at this "
          f"path's shape ({spec5.n_chunks} chunks, window {spec5.window}); at 240x200 (phase 2) "
          f"kernel {side['ms']:.3f} ms, plain {side['plain_ms']:.0f} ms; card {card}", flush=True)
    assert rel5 <= 1e-5, f"kernel with the sideflow terms disagrees with the plain version: {rel5}"

    source = "lisflood_tpu_torch/csrc/kinwave_substep.cu"
    replaces = "lisflood_tpu/ops/kinwave_pallas.py:654"
    figures = {"kernels": [
        {"name": "kinwave_substep", "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches, "max_abs_err": absd, "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None},
        # the same kernel on the all-options path, every figure at its shape
        {"name": "kinwave_substep_sideflow", "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches5, "max_abs_err": absd5,
         "ms": kernel5_ms, "plain_ms": plain5_ms, "bound_ms": bound5_ms,
         "bound_by": bound5_by, "library_ms": None},
    ]}
    print(json.dumps(figures))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
