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
     each output's max, both also with five weighted feeders per lake and
     reservoir (the order of the owner's sum), and float32 once more with
     single routing and no evaporation chain; the same with the optional
     sideflow terms (water use, inflow ramp, transmission loss) from
     with_options, in float32 and float64, and in float32 with the
     evaporation chain outside the kernel (operand `eva`); in every case the
     outputs bitwise equal for 1 block, 2 blocks and the launcher's own block
     count, and over ten repeated launches (a race between blocks shows as a
     flaky bit); a launch with
     more blocks than the card holds at once must be refused; and the whole
     float64 step (default, all-options, and all-options with the
     evaporation chain outside the kernel) on the card against the same step
     on the CPU (within 1e-10); K8 in float64 at 240x200 against its plain
     version, on the land phase's operands and forced wet (within 1e-12);
  3. the main path: the continental synthetic model (1200x1000,
     NoRoutSteps=24, chunk 512, float32) through build_multi_step with
     ChanQAvg output, one warm-up step and two timed batches of five steps
     (the first still holds the start-up transient of a fresh process, the
     second is the steady state); the kernel's launch count must equal the
     steps run and every state entry must be finite; then one step under
     torch.profiler for the device's busy share;
  4. at the main-path shape: the chunk dependency graph (edges, longest
     chain), the kernel's block count, the co-resident limit and the ring
     depth, its time (CUDA events over repeated launches queued behind a
     sleep kernel, so the device's time: cuda_ms, which times every kernel)
     by block count from 1 to the limit, and its bound; the plain version's
     time (one run, ~100 s) and the kernel held to it (float32, within 1e-5
     of each output's max); K8, the soil Courant tail (csrc/soil_tail.cu),
     on the land phase's operands against its plain version
     (soil_tail_reference, within 1e-5 of each sum's max, bitwise equal in
     float32, the same bits in two runs), its lanes that sub-step, the
     largest count, its time (printed beside the time recorded before the
     redesign, PREVIOUS_MS), bound, chain floor (the lane with the largest count
     launched alone, its sums the same bits as in the whole launch) and the
     plain version's time; the same forced wet (KSat scaled up until the
     largest count reaches max_soil_substeps and SoilCourantCapHit is set);
  5. the all-options path: the continental model with every option of
     with_options on (water use, rice, inflow, transmission loss, polders,
     water levels, pF, mass-balance reports) through build_multi_step, timed
     and profiled as in phase 3; launches equal steps, every state entry
     finite, TransCum non-negative and not all zero; the kernel's time with
     the sideflow terms on (by block count as in phase 4), its bound, and the
     plain version's time with the kernel held to it at this shape (float32,
     within 1e-5 of each output's max, `trans` included);
  6. the InitLisflood prerun on the continental model (float32): one warm-up
     step and two timed batches of five as in phase 3, launches equal steps,
     every state entry finite, avgdis = CumQ / TimeSinceStart, one profiled
     step; the kernel's single-routing launch with the evaporation chain
     outside it (operand `eva`): its time by block count, its bound, and the
     plain version's time with the kernel held to it at this shape (float32,
     within 1e-5); the kernel held to its plain version at 240x200 in the
     prerun configuration in float64 (within 1e-12), bitwise equal for 1, 2
     and the launcher's blocks;
  7. the ensemble: M members of the main path (M = 8, or the largest power
     of two whose memory, by phase 3's peak per model, fits 90% of the card)
     folded into one model (models/ensemble.py), built on the host and timed
     (EnsembleRunner), one warm-up step and two timed batches of five with
     one kernel launch per ensemble step for all members; ms per ensemble
     step and per member-step, peak device memory, one profiled step's idle
     share; the kernel's time by block count and its bound; the timed
     launch's outputs on its first 32 M chunks (32 of each member's) held to
     the plain version run over those chunks (float32, within 1e-5); every
     member of the ensemble step against the single model's step on the same
     state (float32 within 1e-5); one EnKF analysis (its time, finite fields,
     the gauges' mean discharge moving toward the observation); the kernel
     held to its plain version at 240x200 with 2 members; the evaporation
     stencil's choice for the single model and the ensemble (equal: it is
     made on a member's grid);
  8. a catchment read from maps: write_catchment(tmp, 1200, 1000, seed=0,
     n_steps=11) with classic netCDF (the host seconds of the write, of
     load_settings and of build_model), its step at chunk 256 through
     build_multi_step at float32, each day's meteo read from the PCRaster
     stacks (meteo_forcing): one warm-up step and two timed batches of five
     consecutive days, one launch per step of each kernel, every state entry
     finite, one profiled step; the overland schedule's chunks, window and
     edges (edges required); K5, the overland sweep kernel, on the land
     phase's operands: the overland forest (trees, the largest, levels in a
     tile) and the tile tables' host seconds; the kernel at its default tile
     cap against its plain version (float32 within 1e-5 of each lane's max,
     whether bitwise equal printed), the same bits in two runs and at the
     caps of SWEEP_CAPS, its time at each cap and its bound; where its time
     goes, from one traced launch (sweep_where: blocks resident per SM,
     staging share, cycles per level, and the tile with the most levels in
     the launch and alone); the same in float64 at 240x200 (within 1e-12), also at a
     cap below its largest tree, where tiles keep q in global memory; the
     sub-step kernel's launch at chunk 256 held to its
     plain version on its first 256 chunks, its time and bound; K8 on the
     land phase's operands, as in phase 4;
  9. the settings-driven run (models/driver.py) on phase 8's catchment,
     written with its outputs bound: lisfloodexe in float32 (Precision
     single), the production run_scanned over the 11 days with PCRaster end
     maps, the LZ state-map stack and the discharge and mass-balance TSS;
     the host seconds of build_model, the run by part and close, seconds per
     simulated day against phase 8's step loop, one launch of each kernel a
     day; its end state and TSS rows held to phase 8's step loop over the
     same days (meteo_forcing, the TSS sampled from each series' field by
     its GaugeSampler), within 1e-5 of each
     field's max; one host accuflux at the full size (the TSS `total`
     operation, a day's cost for each TSS that takes it); a 96x80 catchment
     through lisfloodexe with -l in float64 on the card and on the CPU: the
     printed lines equal, the TSS and the end state within 1e-10; and
     MonteCarlo with EnKF through lisfloodexe, 4 members (fewer only if the
     reckoned device memory, the sub-step kernel's ring included, does not
     fit 90% of the card), one filter step, per-member PCRaster outputs: ms
     per member-day, the ring's bytes, one launch of each kernel per
     ensemble day, every member's files present and finite;
 10. RoutingKernel sharded (SHARDS = 4 logical shards) on phase 8's
     catchment, float32: the host seconds of catchment_partition, of both
     sharded schedules (channel and overland) and of their routers (with
     K6's tile tables), with each schedule's chunks, window, K and cut edges
     (cut edges required on the overland graph); the step through
     build_multi_step, one warm-up day and a timed batch of SHARDED_DAYS,
     with NoRoutSteps + 1 launches of K6 (csrc/kinwave_sharded.cu) a step
     and none of the sub-step kernel or K5, every state entry finite, one
     profiled step; K6's tables (trees, the largest, levels, host seconds);
     K6 against its plain version on the land phase's overland operands and
     on one channel sub-step's operands (float32 within 1e-5 of each lane's
     max and bitwise equal, the same bits in two runs and at the caps of
     SHARDED_CAPS), its plan (tiles, ring tiles, global tiles, padding
     blocks, threads, shared bytes), its time on both at each cap and its
     bound; where its time goes (sharded_where: one traced launch, the tile
     with the most levels in the launch and alone, its cycles a level and
     the chain floor); the float32 sharded state after SHARDED_DAYS days
     against phase 8's packed state after the same days from the same
     start (printed only: the two paths sum in other orders); lisfloodexe
     with RoutingKernel sharded over SHARDED_DAYS days, its seconds per
     simulated day and launches; K6 in float64 on the synthetic 240x200
     channel graph (48 cut edges) within 1e-12 and bitwise equal, at the
     caps too; the float64 sharded step on the card against the CPU on a
     96x80 catchment (overland cut edges), SHARDED_DAYS days, within 1e-10
     of each field's max.
 11. RoutingKernel scan on phase 8's catchment, float32: the host seconds of
     build_routers (the two ScanRouters with K6's tables on the natural
     graphs) and each graph's tables (trees, the largest, levels, tiles
     through the ring); the step through build_multi_step, one warm-up day
     and a timed batch of SCAN_DAYS, with NoRoutSteps + 1 launches of K6 a
     step and none of the sub-step kernel or K5, every state entry finite,
     one profiled step; K6 on the natural tables against its plain version
     (kinwave._sweep_scan, which _route_batched runs) on the overland and one
     channel sub-step's operands, bitwise, in two runs and at the caps 1024
     and SCAN_CAPS, its time, bound and chain floor; the scan state after
     SCAN_DAYS days against phase 8's packed state (printed only);
     lisfloodexe with RoutingKernel scan over SCAN_DAYS days; the float64
     scan step on the card against the CPU on a 96x80 catchment within
     1e-10 of each field's max; the state and reports after the timed days,
     which phase 14's scan ranks are held to;
 12. K7, the fixed-order segment sum (csrc/segment_sum.cu), on phase 8's
     catchment's Catchments, the sharded loop's kinp$Catchments, the
     water-use regions write_catchment writes (west and east halves) and
     downEva: segments, members, the largest segment, the kernel's warp
     items and segments of several pieces, bitwise equal to its plain
     version in two runs and through a second order of the same segments
     built apart, called between calls of the first (its own tickets and
     scratch), the kernels a call launches (one, two for a spread over a
     segment of several pieces), its time (printed beside the time recorded
     before the redesign, PREVIOUS_MS), its bound by bytes, and the time of index_add_
     with the gather, atomic and under torch.use_deterministic_algorithms
     (phase 5 does the same on the
     continental all-options grid's Catchments, WUseRegionC, downstruct and
     downEva, and counts K7's calls a step).
 13. the folded ensemble (models/ensemble.py) of ROUTER_MEMBERS = 4 members
     of phase 8's catchment, float32, on RoutingKernel sharded (SHARDS
     shards, phase 10's partition and schedules replicated, member m's shard
     s being shard m S + s) and on RoutingKernel scan (the natural schedules
     replicated): the host seconds of the folded schedules and K6's tables;
     one warm-up step and a timed batch of ROUTER_DAYS, ms per ensemble step
     and per member-step, NoRoutSteps + 1 launches of K6 a step for all
     members and one of K8, one profiled step; each member bitwise equal to
     phase 10's or 11's single step over 2 steps from the same state; two
     runs of the ensemble step bitwise; K6 on one channel sub-step's folded
     operands bitwise equal to its plain version, its time on the folded
     channel and overland tables against phases 10 and 11's single launch,
     its bound, chain floor and the deepest tile alone; then MonteCarlo and
     EnKF from the settings with RoutingKernel sharded (run_from_settings
     through lisfloodexe), 4 members over ROUTER_DAYS days with one filter
     step: ms per member-day and the analysis's seconds.
 14. the multi-process step (parallel/shard_model.py, multihost.py):
     CATCHMENT_RANKS = 2 rank processes on the one card over gloo (a file://
     store in the temporary directory, each process with a timeout; one that
     dies, hangs or differs fails the phase), each building phase 8's
     catchment on the host and its rank step (SHARDS shards, float32) on the
     card, one warm-up day and SHARDED_DAYS days: the gathered state and
     reports bitwise equal to phase 10's one-process step over the same
     days; per rank its pixels, each graph's own and halo positions and the
     positions it sends, collectives, bytes through the host and host
     synchronisations a step, K6 / K7 / K8 launches a step (K6 NoRoutSteps +
     1), ms/step (two processes time-slice the card: no speed-up is
     claimed), peak device memory and host seconds; K6 on rank 0's own and
     halo tables bitwise equal to its plain version (RankTiles.reference)
     and in two runs, its time against phase 10's launch, bound, chain floor
     and the deepest tile alone; then SYNTHETIC_RANKS = 4 ranks of the
     synthetic 240x200 model (SYNTHETIC_SHARDS = 8 shards, float64, channel
     edges between ranks: the channel halo exchanged every sub-step)
     bitwise equal to the one-process step on the card. Then the same
     processes, process group and host models run RoutingKernel packed
     (the default router) across the ranks (shard_model.PackedRankLayout:
     each rank's kept chunks of the whole packed schedules, the unchanged
     sub-step kernel and K5 on them): the gathered state and reports
     bitwise equal to phase 8's one-process packed step (the synthetic
     model's on the card, float64: K4a), per rank its own and halo
     positions and kept chunks of each graph, collectives, bytes and host
     synchronisations a step, the sub-step kernel and K5 once a step; each
     rank's sub-step launch on its kept chunks (captured in one step) the
     same bits twice, bitwise equal at its own positions and structures to
     the whole schedule's launch on the same step's operands, held to its
     plain version on its first CATCHMENT_PREFIX kept chunks (1e-5 float32,
     1e-12 float64), its time (the ranks one after the other) beside the
     whole launch's in this run, and its bound; rank 0's K5 on its tables
     bitwise equal to its plain version `_sweep`, in two runs and to the
     whole sweep at its own pixels, its time and bound. Then the same
     processes run RoutingKernel scan across the ranks
     (shard_model.ScanRankLayout: K6 on each rank's own natural pixels plus
     its upstream halo, ops/kinwave.RankScanRouter): the gathered state and
     reports bitwise equal to phase 11's one-process scan step (the
     synthetic model's on the card, float64), per rank its own and halo
     pixels of each graph, collectives, bytes and host synchronisations a
     step, K6 NoRoutSteps + 1 a step; K6 on rank 0's natural tables bitwise
     equal to its plain version (RankScanTiles.reference, `_sweep_scan` on
     the schedule's chunks cut to the rank's pixels) and in two runs, its
     time against phase 11's launch, bound, chain floor and the deepest
     tile alone. A rank process is `python3 chip_smoke.py --rank-child SPEC
     RANK`; `python3 chip_smoke.py --multi-process` runs this phase alone on
     a catchment of its own.
 15. the operational run paths through lisfloodexe at float32, each run
     with one launch of the sub-step kernel, K5 and K8 a day and K7 called:
     a warm start on phase 8's catchment (WARM_DAYS days cold, WARM_HALF
     days, and the rest warm from the half run's PCRaster end maps with LZ
     from its state-map stack's last map and timestepInit that day): the
     warm run's state held to the cold run's (WARM_BITWISE bit for bit, the
     rest of WARM_KEYS within 1.5e-4 of each field's max, Sideflow1Chan
     1e-2, as tests/test_torch_warmstart.py finds them) and its dis.tss rows
     within 1.5e-4 of their largest (whether equal as printed, the CPU
     test's gate at 48x40, is printed); then a geographic 1200x1000 write_catchment (0.05 degree
     cells, the PixelLengthUser and PixelAreaUser maps, gauges as coordinate
     pairs, classic netCDF meteo GEO_MARGIN cells wider than the mask and
     latitude ascending) run twice for GEO_DAYS days with MapsCaching on and
     the cache cleared before the first: build_model's host seconds, the
     cache's entries and hits after each run (the second adds none and
     hits), and the second run's state and output files the same bits as
     the first's; ms per simulated day of every run.
 16. every option read from maps through the production run: a 1200x1000
     write_catchment with the inputs of every option (synthetic.EVERY_OPTION:
     inflow, water use with transient average-year demand, water regions
     and groundwater smoothing, the indicators, transient land use, the
     variable water fraction, rice, polders, pF, water levels, drained
     irrigation, temperature in kelvin, transmission loss) and the reports
     they switch on, classic netCDF, EVERY_DAYS days from EVERY_START
     (a month and a year end) through lisfloodexe at float32: build_model's
     host seconds, ms per simulated day, the launches of each kernel (the
     sub-step kernel once a day in its sideflow instantiation, with water
     use, the inflow ramp and transmission loss among its operands, K5 and
     K8 once a day, K7 more than PHASE15_K7_PER_DAY times a day), the end
     state and every output finite where the mask is, and the output files
     the registry rule's (synthetic.expected_outputs); the last day's
     sub-step launch timed (by block count), bounded and held to its plain
     version on its first CATCHMENT_PREFIX chunks (float32, 3e-5 of each
     output's max, the transmission loss `trans` on the volume the largest
     discharge passes in a sub-step: the CPU tests' one-step gates of the
     all-options step); then the same options at
     96x80 in float64 with -l on the card and on the CPU: the printed lines
     and file sets equal, the TSS and end state within 1e-10 of each
     field's max. `python3 chip_smoke.py --every-option` runs this phase
     alone.
 17. The sub-step kernel's plain versions queued by phases 2 and 4-7 (the
     launch's operands and outputs kept on the host, plain_later), run
     after every timed phase in PLAIN_WORKERS worker processes side by
     side on the card (run_plain_jobs), each held within its tolerance;
     their times are side-by-side figures. In line they held the card
     ~550 s, the script's largest cost.
 18. the step as one captured CUDA graph (models/graph.py), which every
     entry point replays on the card, so that the timed batches of phases
     3-13 are replays: on each one-process path (main, all-options,
     prerun, the 8-member ensemble, the catchment, sharded, scan and the
     4-member folded ensembles on both) graph_figures, run where the phase
     has its step, holds GRAPH_STEPS replays bitwise to as many eager
     steps from the same state (every state entry and diagnostic), times
     GRAPH_TIMED steps each way in one run, profiles one eager step and
     one replay (device busy and idle), counts a replay's kernel launches
     (the counts its capture recorded, equal to an eager step's) and its
     host synchronisations (none), and prints the capture's seconds and
     the graph pool's bytes; after phase 9's production run and phase
     16's every-option run, graph_run_pair runs the same lisfloodexe on
     the eager step (eager_entry_points): every output file and the end
     state the same bits, ms per simulated day of each with the host
     seconds by part. Phase 18 prints the table, requires every path of
     GRAPH_PATHS and every kernel launched inside a graph. `python3
     chip_smoke.py --graphs` runs it alone on models of its own
     (graphs_check), the MonteCarlo/EnKF run's pair too.
Each driven path's step launches K8 once (its count is asserted with the
routing kernels'; the lanes that sub-step and the largest count are printed
by path), and one step of each path runs under
torch.cuda.set_sync_debug_mode("warn"): the host synchronisations it makes
are counted and printed (sync_count), and the main path's must be none.
Every sum of the step adds in a fixed order (K7), so every run computes the
same numbers: the all-options (phase 5), prerun (6), catchment (8), sharded
(10) and scan (11) steps run REPEAT_STEPS steps twice from the same state,
and every state entry and report must have the same bits (repeat_bitwise),
with no deterministic mode of PyTorch on.
Run as `python3 chip_smoke.py --side-flag-ab` it only times the main path's
kernel launch against a build of the same source without the SIDE template
flag (the optional sideflow terms then guarded by their null pointers alone).
Run as `python3 chip_smoke.py --k7-k8` (~1 min) it only builds K7 and K8 and
checks and times them at the continental grid's shapes (k7_k8_check).
Run as `python3 chip_smoke.py --operational` it runs phase 15 alone on its
own copy of phase 8's catchment (operational_check), and as
`python3 chip_smoke.py --every-option` phase 16 alone (every_option_check).
The line before the last but one is a JSON object of per-kernel figures (the
sub-step kernel on its five paths, kinwave_sweep, kinwave_sharded, K6 on the
scan router's natural tables, segment_sum, soil_tail, K6 on the two
folded ensembles' tables, K6 on a rank's tables, the sub-step kernel and
K5 on a packed rank's kept chunks, and K6 on a scan rank's natural tables;
phase 15's launches of each kernel its runs drive, by run, under
launches_phase15, and phase 16's under launches_phase16; the sub-step
kernel's sideflow launch on phase 16's catchment);
then
the card's name
and power limit; the last is {"ok": true, "device": {...}}. Needs no network;
stops what it starts.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
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
# the polynomial path with single routing (the InitLisflood prerun), per
# sub-step, by line of csrc/kinwave_substep.cu: the sideflow, :467 (a multiply
# and a divide, 2); cc, :481 (two multiplies and two adds, 4; the upstream
# adds are counted from the tables); newton_v, csrc/kinwave_common.cuh:35-48
# (its guesses, :36-39, 7: two bit-hack estimates of a multiply and an add
# each, a divide, a min and a multiply; five iterations of :42-45, 3 + 4 + 4 +
# 2 = 13 each); v^3, :484 (2); v^5, :486 (2); the storage, :487 (2); sumdis,
# :547 (1). Per lane: inv_dx, :336 (1), and the pow of qb1, :357
FLOPS_PER_SUBSTEP_SINGLE = 2 + 4 + (7 + 5 * 13) + 2 + 2 + 2 + 1
FLOPS_PER_LANE_SINGLE = (1, 1)     # (plain, pow)
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
# the overland sweep (csrc/kinwave_sweep.cu), float32 at beta = 3/5, per
# lane-row and position: cc = inflow + const (1) and the polynomial Newton
# solve (76, as above); one upstream add per edge and lane is counted apart
FLOPS_SWEEP = 1 + 76
# the optional sideflow terms: eva and wuse 1 per lane each; per sub-step
# the inflow ramp 3; the transmission loss 4, and on lanes with uptrans set
# 1 and 2 pow more
FLOPS_RAMP = 3
FLOPS_TRANS = (4, 1, 2)
# the soil Courant tail (csrc/soil_tail.cu, K8), per sub-step of a lane, by
# line of the kernel's loop: the three storages (3); each of the three
# conductivities (conductivity()): the pore space (1), the saturation's
# difference and division (2), its clamp (2 compares), the two `1 -` (2),
# inner * inner (1), sqrt (1) and the two multiplies (2): 11 and 2 pow; the
# three seepages' products (3), the two caps (2) and three mins (3); the
# storage updates (5) and the three sums (3)
FLOPS_SOIL_SUBSTEP = (3 + 3 * 11 + 3 + 2 + 3 + 5 + 3, 3 * 2)     # (plain, pow)
# bytes a lane that sub-steps reads and writes beyond its count: dt_sub, the
# three storages, the three sums and 15 parameters read (22 values), the three
# sums written (3 values), and its three masks (1 byte each)
SOIL_VALUES, SOIL_MASK_BYTES = 22 + 3, 3
# K8's and K7's times a launch and a call before their redesign (ms), as
# recorded by this script's run from a git archive of the tree of their first
# port, on an NVIDIA H100 80GB HBM3 at 700.00 W, by operand set: printed
# beside this run's times, labelled as recorded, and kept out of the kernels
# line, which holds only what this run measured
PREVIOUS_MS = {
    "soil_tail": {"main": 0.3336, "forced wet": 2.3226, "catchment": 0.0300,
                  "float64": 0.3097, "float64 forced wet": 1.1369},
    "segment_sum": {"Catchments": 0.0279, "WUseRegionC": 0.0179, "downstruct": 0.0161,
                    "downEva": 0.0156, "catchment Catchments": 0.0274,
                    "catchment kinp$Catchments": 0.0503, "catchment WUseRegionC": 0.0225,
                    "catchment downEva": 0.0076}}


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, n_rep):
    """Mean milliseconds of `fn()` on the card over `n_rep` runs after one
    warm-up run, from CUDA events, the queue kept full: a sleep kernel holds
    the stream while the host enqueues the runs, so a launch shorter than
    its wrapper's host time is timed on the device."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(n_rep):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_rep


def max_rel_err(ys, ref, scales=None):
    """Largest over outputs of max |y - ref| / max |ref| (or / scales[k]),
    and the largest absolute difference; both printed with the output they
    come from."""
    rel, absd = (0.0, ""), (0.0, "")
    for k, r in ref.items():
        d = (ys[k].double() - r.double()).abs().max().item()
        scale = (scales or {}).get(k) or max(r.double().abs().max().item(), 1e-300)
        rel = max(rel, (d / scale, k))
        absd = max(absd, (d, k))
    print(f"  worst output: rel {rel[0]:.3e} ({rel[1]}), abs {absd[0]:.3e} ({absd[1]})", flush=True)
    return rel[0], absd[0]


# the sub-step kernel's plain versions of phases 2 and 4-7: queued with the
# launch's operands and outputs on the host, run after every timed phase,
# PLAIN_WORKERS worker processes side by side on the card
PLAIN_WORKERS = 4
PLAIN_JOBS = []


def plain_later(spec, xs, ys, tol, what):
    """Queues the plain version of the sub-step kernel's launch on `xs`
    (its outputs `ys`, held within `tol`) for run_plain_jobs; returns the
    job's index."""
    import dataclasses
    host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
    PLAIN_JOBS.append((dataclasses.asdict(spec), host(xs), host(ys), tol, what))
    return len(PLAIN_JOBS) - 1


def plain_job(spec, xs, ys):
    """One queued job, in a worker process: substep_reference on the card
    and its outputs against the kernel's. Returns (max rel err, max abs
    err, the plain version's milliseconds)."""
    import torch
    from lisflood_tpu_torch.ops import kinwave_substep as ks
    xs = {k: torch.from_numpy(v).cuda() for k, v in xs.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ks.substep_reference(ks.SubstepSpec(**spec), xs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with contextlib.redirect_stdout(io.StringIO()):
        rel, absd = max_rel_err({k: torch.from_numpy(v) for k, v in ys.items()},
                                {k: v.cpu() for k, v in ref.items()})
    return rel, absd, plain_ms


def run_plain_jobs():
    """Runs every queued job, the largest first, PLAIN_WORKERS side by side
    in worker processes on the card, and holds each within its tolerance.
    Returns [(max rel err, max abs err, plain ms)] by job index."""
    import concurrent.futures
    import multiprocessing
    t0 = time.perf_counter()
    order = sorted(range(len(PLAIN_JOBS)), key=lambda i: -PLAIN_JOBS[i][0]["n_chunks"])
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(PLAIN_WORKERS, mp_context=ctx) as pool:
        futures = {i: pool.submit(plain_job, *PLAIN_JOBS[i][:3]) for i in order}
        results = [futures[i].result() for i in range(len(PLAIN_JOBS))]
    for (_, _, _, tol, what), (rel, absd, ms) in zip(PLAIN_JOBS, results):
        print(f"  {what}: kernel vs plain max rel err {rel:.3e} (tol {tol:g}), max abs "
              f"{absd:.3e}; plain version {ms:.0f} ms (one run, {PLAIN_WORKERS} side by side)",
              flush=True)
        assert rel <= tol, f"{what}: kernel disagrees with the plain version: {rel}"
    print(f"  {len(results)} plain-version runs, {PLAIN_WORKERS} side by side on the card: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


SCAN_BLOCKS = (1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 132)


def same_bits(a, b):
    """Whether two dicts of tensors hold the same bits, NaNs included."""
    import torch
    return all(tensor_bits_equal(torch, v, b[k]) for k, v in a.items())


def blocks_bitwise(torch, ks, spec, xs):
    """The launcher's plan, and whether the outputs have the same bits with 1
    block, 2 blocks and the launcher's count, and over ten launches with it."""
    ys = ks.kinwave_substep(spec, xs)
    plan = dict(ks.kinwave_substep.last_plan)
    by_blocks = all(same_bits(ys, ks._launch(spec, xs, blocks=g)) for g in (1, 2))
    repeats = all(same_bits(ys, ks.kinwave_substep(spec, xs)) for _ in range(10))
    torch.cuda.synchronize()
    return ys, plan, by_blocks, repeats


def plan_text(plan, spec):
    return (f"{plan['blocks']} blocks of {spec.chunk} threads (co-resident limit "
            f"{plan['limit']}), ring of {plan['ring']} slots")


def chunk_graph_text(xs):
    """The chunk dependency graph of the operands' wavefront tables: edges,
    the longest chain of dependent chunks (with T - 1 the critical path of
    the task graph) and the mean number of chunks per depth."""
    deps = xs["wf_deps"].tolist()
    ptr, feeders = xs["wf_sdep_ptr"].tolist(), xs["wf_sdep_list"].tolist()
    depth, edges = [], 0
    for c, row in enumerate(deps):
        sources = [d for d in row if d >= 0] + feeders[ptr[c]:ptr[c + 1]]
        edges += len(sources)
        depth.append(1 + max((depth[d] for d in sources), default=0))
    return (f"{len(deps)} chunks, {edges} chunk-to-chunk edges, longest chain {max(depth)}, "
            f"{len(deps) / max(depth):.2f} chunks per depth")


def block_scan(torch, ks, spec, xs, limit, n_rep):
    """The kernel's milliseconds by block count, 1 to the co-resident limit."""
    counts = sorted({min(g, limit, spec.n_chunks) for g in SCAN_BLOCKS})
    return {g: cuda_ms(torch, lambda: ks._launch(spec, xs, blocks=g), n_rep) for g in counts}


def scan_text(scan):
    return ", ".join(f"{g}: {ms:.3f}" for g, ms in scan.items())


def bound(xs, ys, spec, n_real=None):
    """(bound_ms, bound_by): bytes of every input read once and every output
    written once over the HBM rate, against the operations this run's
    inputs need over the non-tensor peak for their type. With `n_real` (a
    rank's kept chunks: its own and halo lanes, the other lanes padding)
    the per-position operands, outputs and operations count those lanes
    only."""
    from lisflood_tpu_torch.ops.kinwave_substep import _poly
    p_pad = spec.n_chunks * spec.chunk
    n = p_pad if n_real is None else n_real
    nbytes = sum(v.numel() * v.element_size() * (n if v.numel() % p_pad == 0 else p_pad)
                 // p_pad for v in list(xs.values()) + list(ys.values()))
    L = 2 if spec.split else 1
    n_ups = int((xs["ups"] >= 0).sum())
    n_ev = int((xs["ev_ups"] >= 0).sum()) if spec.E else 0
    dtype = str(xs["dx"].dtype).replace("torch.", "")
    pow_flops = POW_FLOPS[dtype]
    per_lane = FLOPS_PER_LANE
    if _poly(spec, xs["dx"].dtype) and spec.split:
        per_substep = FLOPS_PER_SUBSTEP
    elif _poly(spec, xs["dx"].dtype):
        per_substep = FLOPS_PER_SUBSTEP_SINGLE
        per_lane = FLOPS_PER_LANE_SINGLE[0] + FLOPS_PER_LANE_SINGLE[1] * pow_flops
    else:
        plain, pows = QSPACE_ROW(QSPACE_ITERS[dtype])
        per_substep = L * (plain + pows * pow_flops) + 2 + (10 + 2 + 4 if spec.split else 1)
    per_lane += ("eva" in xs) + ("wuse" in xs)
    flops = 0
    if "qin_old" in xs:
        per_substep += FLOPS_RAMP
    if "uptrans" in xs:
        every, masked, pows = FLOPS_TRANS
        per_substep += every
        flops += int((xs["uptrans"] != 0).sum()) * spec.T * (masked + pows * pow_flops)
    flops += (n * (spec.T * per_substep + spec.E * FLOPS_PER_HOP + per_lane)
              + n_ups * spec.T * L + n_ev * max(spec.E - 1, 0))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    print(f"  bound: {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms; "
          f"{flops / 1e9:.2f} GFLOP ({dtype}) -> {t_ops:.4f} ms", flush=True)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(model, device, dtype, seed=0):
    """A built step, its state and forcing, and the sub-step operands its
    land phase gives the routing kernel (the same in every run)."""
    import torch
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


def spread_feeders(torch, ks, spec, xs, seed=5):
    """The operands `xs` with every structure fed by five weighted lanes
    spread over the three chunks before its own, in shuffled feeder slots
    (the synthetic model's structures have at most two feeders, for which
    the order of the owner's sum cannot show)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    C = spec.chunk
    filled = (xs["ischan"] != 0).cpu().numpy()
    out = dict(xs)
    for prefix in ("lk", "rs"):
        fee = np.full(tuple(xs[prefix + "_fee"].shape), -1, np.int64)
        for s, pos in enumerate(xs[prefix + "_pos"].tolist()):
            chunks = pos // C - 1 - rng.integers(0, 3, 5)
            assert chunks.min() >= 0
            fee[s, rng.permutation(fee.shape[1])[:5]] = [
                c * C + int(rng.choice(np.flatnonzero(filled[c]))) for c in chunks]
        weights = np.where(fee >= 0, rng.uniform(0.5, 1.5, fee.shape), 0.0)
        out[prefix + "_fee"] = torch.as_tensor(fee, dtype=torch.int32, device=xs["dx"].device)
        out[prefix + "_fee_w"] = torch.as_tensor(weights, dtype=xs["dx"].dtype,
                                                 device=xs["dx"].device)
    out.update(ks.wavefront_operands(spec, out))
    return out


def held_to_plain(torch, ks, spec, xs, tol, what):
    """The kernel against its plain version on the operands `xs`: outputs
    within `tol` of each output's max, bitwise equal for 1, 2 and the
    launcher's blocks and over ten launches, the launcher's plan above one
    block; the plain version is queued (plain_later, the figures'
    "plain_job"). Returns the kernel's outputs and plan and the kernel's
    figures."""
    ys, plan, by_blocks, bitwise = blocks_bitwise(torch, ks, spec, xs)
    if "trans" in ys:
        assert bool(torch.isfinite(ys["trans"]).all()) and float(ys["trans"].max()) > 0
    name = str(xs["dx"].dtype).replace("torch.", "")
    job = plain_later(spec, xs, ys, tol, f"{name} ({what})")
    kernel_ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), 10)
    print(f"  {name} ({what}): {plan_text(plan, spec)}; bitwise equal with "
          f"1, 2 and {plan['blocks']} blocks: {by_blocks}, over "
          f"ten launches: {bitwise}; kernel {kernel_ms:.3f} ms for {spec.n_chunks} chunks; "
          f"held to the plain version after the timed phases", flush=True)
    assert by_blocks, "the outputs depend on the number of blocks"
    assert bitwise, "repeated kernel runs differ"
    assert plan["blocks"] > 1, plan
    return ys, plan, {"ms": kernel_ms, "plain_job": job}


def phase_mid(torch, ks, card):
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
             (model, torch.float32, 1e-5, "all phases, five feeders per structure", set()),
             (model, torch.float64, 1e-12, "all phases, five feeders per structure", set()),
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
        if "five feeders" in what:
            xs = spread_feeders(torch, ks, spec, xs)
        ys, plan, fig = held_to_plain(torch, ks, spec, xs, tol, "240x200, " + what)
        name = str(dtype).replace("torch.", "")
        if ((m is options and dtype == torch.float32)
                or (m is model and dtype == torch.float64 and what == "all phases")):
            print(f"  chunk graph: {chunk_graph_text(xs)}", flush=True)
            bound_ms, bound_by = bound(xs, ys, spec)
            one_block_ms = cuda_ms(torch, lambda: ks._launch(spec, xs, blocks=1), 3)
            print(f"  with one block {one_block_ms:.3f} ms", flush=True)
            figures[name] = {**fig, "bound_ms": bound_ms, "bound_by": bound_by,
                             "blocks": plan["blocks"], "ms_one_block": one_block_ms}
    # K8 in float64 at 240x200: the land phase's operands, and forced wet
    step, s, f, _, _ = kernel_inputs(model, "cuda", torch.float64)
    ops8, _ = soil_tail_operands(torch, step, s, f)
    was = PREVIOUS_MS["soil_tail"]
    figures["soil_tail_float64"] = soil_tail_figures(torch, card, ops8, 1e-12,
                                                     "240x200, float64", was["float64"])
    figures["soil_tail_float64_wet"] = forced_wet_figures(torch, card, step, s, f, 1e-12,
                                                          was["float64 forced wet"])
    del step, s, f, ops8
    # more blocks than the card holds at once: the launcher refuses
    try:
        ks._launch(spec, xs, blocks=plan["limit"] + 1)
    except RuntimeError as err:
        print(f"  {plan['limit'] + 1} blocks, one above the co-resident limit: refused ({err})",
              flush=True)
    else:
        raise AssertionError("a launch above the co-resident limit was not refused")
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


def stack_forcing(torch, fs):
    return {k: torch.stack([f[k] for f in fs]) for k in fs[0]}


def reset_launches():
    """Sets every kernel wrapper's launch count to 0."""
    from lisflood_tpu_torch.ops import (kinwave_packed, kinwave_sharded, kinwave_substep,
                                        segment_sum, soil_tail)
    kinwave_substep.kinwave_substep.launches = 0
    kinwave_packed.kinwave_sweep.launches = 0
    kinwave_sharded.kinwave_sharded_sweep.launches = 0
    segment_sum.segment_total.launches = 0
    soil_tail.soil_tail.launches = 0


def launch_counts():
    """Every kernel wrapper's launch count, by kernel."""
    from lisflood_tpu_torch.ops import (kinwave_packed, kinwave_sharded, kinwave_substep,
                                        segment_sum, soil_tail)
    return {"kinwave_substep": kinwave_substep.kinwave_substep.launches,
            "kinwave_sweep": kinwave_packed.kinwave_sweep.launches,
            "kinwave_sharded": kinwave_sharded.kinwave_sharded_sweep.launches,
            "segment_sum": segment_sum.segment_total.launches,
            "soil_tail": soil_tail.soil_tail.launches}


def routing_launches(launches):
    """The routing kernels' launch counts of `launches` (K7's and K8's
    apart)."""
    return {k: v for k, v in launches.items() if k not in ("segment_sum", "soil_tail")}


def timed_batches(torch, ks, run, forcing):
    """One warm-up step `run(forcing stack)`, then two batches of five timed
    steps, with every kernel's launch count set to 0 just before and read
    just after. With eleven forcings the batches take forcings 1-5 and 6-10
    (consecutive days), with fewer both take forcings 1-5. The first batch
    still pays for a fresh start (the caching allocator grows, the soil
    columns relax from their initial state, so their Courant sub-steps are
    more); the second is the steady state. Returns (the last batch's result,
    the batches' milliseconds per step, launches by kernel)."""
    reset_launches()
    run(stack_forcing(torch, forcing[:1]))
    torch.cuda.synchronize()
    batches = [forcing[1:6], forcing[6:11]] if len(forcing) >= 11 else [forcing[1:6]] * 2
    ms = []
    for batch in batches:
        t0 = time.perf_counter()
        out = run(stack_forcing(torch, batch))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / 5 * 1e3)
    return out, ms, launch_counts()


def timed_steps(torch, ks, multi, s, forcing, card, sweeps=0, sums=None):
    """timed_batches of the multi-step `multi` from state `s`; the sub-step
    kernel's launches must equal the steps, the overland sweep's `sweeps`
    (one a step on an overland graph with edges, none without), K7's be
    none where `sums` is False and some where it is True. Returns (state,
    the last batch's outputs, its milliseconds per step, launches by
    kernel)."""
    def run(stack):
        nonlocal s
        s, outs = multi(s, stack)
        return outs

    outs, ms, launches = timed_batches(torch, ks, run, forcing)
    cells = next(iter(outs.values())).shape[1]
    print(f"  batches of 5 steps after the warm-up: {', '.join(f'{t:.1f}' for t in ms)} ms/step; "
          f"the last = {cells / ms[-1] * 1e3:.4g} cells*steps/s on {card}", flush=True)
    print(f"  launches for {STEPS_RUN} steps: {launches} ({launches['segment_sum'] / STEPS_RUN:g} "
          f"of K7, the segment sums, a step)", flush=True)
    assert routing_launches(launches) == {"kinwave_substep": STEPS_RUN, "kinwave_sweep": sweeps,
                                          "kinwave_sharded": 0}, launches
    assert launches["soil_tail"] == STEPS_RUN, launches
    if sums is not None:
        assert (launches["segment_sum"] > 0) == sums, launches
    return s, outs, ms[-1], launches


N_REP = 20
# chunks of each member that phase 7 holds to the plain version
PREFIX_PER_MEMBER = 32


def kernel_figures(torch, ks, spec, xs, what):
    """At a main path's shape: the chunk graph, the launcher's plan, outputs
    bitwise equal for 1, 2 and its blocks and over ten launches, the time by
    block count (mean of 5 launches each), the time at the launcher's count
    (CUDA events, mean of N_REP) and the bound. Returns the kernel's outputs
    and the figures."""
    print(f"  chunk graph: {chunk_graph_text(xs)}", flush=True)
    ys, plan, by_blocks, repeats = blocks_bitwise(torch, ks, spec, xs)
    assert by_blocks and repeats and plan["blocks"] > 1, (by_blocks, repeats, plan)
    scan = block_scan(torch, ks, spec, xs, plan["limit"], 5)
    kernel_ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), N_REP)
    bound_ms, bound_by = bound(xs, ys, spec)
    print(f"  {what}: {plan_text(plan, spec)}, window {spec.window}; outputs bitwise equal with "
          f"1, 2 and {plan['blocks']} blocks and over ten launches; kernel ms by blocks: "
          f"{scan_text(scan)}; kernel {kernel_ms:.3f} ms/launch (mean of {N_REP}), bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return ys, {"ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "blocks": plan["blocks"], "ms_one_block": scan[1]}


def phase_prerun(torch, ks, model, card):
    """Phase 6: the InitLisflood prerun at the continental shape, float32;
    its kernel launch (single routing, `eva`) timed and held to its plain
    version there; the kernel held to its plain version at 240x200 in the
    prerun configuration in float64."""
    import dataclasses
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.step import build_multi_step
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, synthetic_forcing
    from lisflood_tpu_torch.ops.routing_ops import kernel_operands
    cfg, params, state, aux = model
    cfg = dataclasses.replace(cfg, init_lisflood=True)
    t0 = time.perf_counter()
    multi, p = build_multi_step(cfg, params, aux, output_keys=("ChanQAvg",),
                                dtype=torch.float32, device="cuda")
    s = multi.prepare_state(state)
    torch.cuda.synchronize()
    print(f"  prerun step built and moved to the card in {time.perf_counter() - t0:.1f} s; "
          f"evaporation chain in the kernel: {multi.step.eva_in_kernel}", flush=True)
    assert not multi.step.eva_in_kernel
    forcing = [to_device(synthetic_forcing(cfg.num_pixels, seed=i), "cuda", torch.float32)
               for i in range(6)]
    s, outs, step_ms, launches = timed_steps(torch, ks, multi, s, forcing, card, sums=True)
    bad = [k for k, v in s.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    busy = profile_step(torch, multi.step, s, forcing[0], step_ms)
    SYNCS["prerun"] = sync_count(torch, multi.step, s, forcing[0], "prerun")
    graph_figures(torch, card, "prerun", multi.stepper, multi.step, s, forcing, busy)
    SOIL_COUNTS["prerun"] = soil_tail_counts(torch, multi.step, s, forcing[0], "prerun")
    repeat_bitwise(torch, multi.step, multi.prepare_state(state), forcing, "prerun")
    assert "pk$Chan2QKin" not in s and "LakeStorageM3CC" not in s, sorted(s)
    assert torch.equal(s["pk$avgdis"], s["pk$CumQ"] / s["TimeSinceStart"]), "avgdis"
    print(f"  every state entry finite ({len(s)} entries, no floodplain, lake or reservoir "
          f"state); avgdis = CumQ / TimeSinceStart ({float(s['TimeSinceStart']):.0f} steps); "
          f"CumQ max {float(s['pk$CumQ'].max()):.4g}, LZInflowCUM max "
          f"{float(s['LZInflowCUM'].max()):.4g}", flush=True)
    spec, xs = kernel_operands(cfg, p, s, multi.step.land_phase(s, forcing[0]), multi.routers)
    assert not spec.split and spec.E == 0 and "eva" in xs and "lk_pos" not in xs, spec
    ys, fig = kernel_figures(torch, ks, spec, xs, "prerun launch at the continental shape")
    job = plain_later(spec, xs, ys, 1e-5,
                      f"prerun launch at the continental shape ({spec.n_chunks} chunks)")
    print(f"  prerun kernel {fig['ms']:.3f} ms/launch, held to the plain version after the "
          f"timed phases", flush=True)
    del multi, p, s, xs, ys
    mid = build_synthetic_model(240, 200, no_rout_steps=24, chunk_size=512)
    mid = (dataclasses.replace(mid[0], init_lisflood=True),) + mid[1:]
    _, _, _, spec_m, xs_m = kernel_inputs(mid, "cuda", torch.float64)
    assert not spec_m.split and "eva" in xs_m, spec_m
    held_to_plain(torch, ks, spec_m, xs_m, 1e-12, "240x200, InitLisflood prerun")
    return {**fig, "launches": launches["kinwave_substep"], "step_ms": step_ms,
            "plain_job": job, "plain_shape": "1200x1000, InitLisflood, float32"}


def held_on_prefix(torch, ks, spec, xs, ys, n, scales=None):
    """The kernel's outputs `ys` on the operands `xs` against the plain
    version run over the first `n` chunks alone: every dependence points to a
    lower chunk, so the outputs of those chunks' lanes, and of the
    structures they own, are final there. Returns (max rel err, max abs err,
    the plain version's milliseconds); `scales` as max_rel_err's."""
    import dataclasses
    C = spec.chunk
    part = {k: v for k, v in xs.items() if k not in ks.WAVEFRONT_TABLES}
    for k, v in part.items():
        if k in ("ups", "ev_ups"):
            part[k] = v[:, :n * C]
        elif v.dim() == 2 and tuple(v.shape) == (spec.n_chunks, C):
            part[k] = v[:n]
    t0 = time.perf_counter()
    ref = ks.substep_reference(dataclasses.replace(spec, n_chunks=n), part)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got, want = {}, {}
    for k, r in ref.items():
        if k.startswith(("lk_", "rs_")):
            owned = xs[k[:3] + "pos"] < n * C
            if bool(owned.any()):
                got[k], want[k] = ys[k][owned], r[owned]
        else:
            got[k], want[k] = ys[k][:n], r
    rel, absd = max_rel_err(got, want, scales)
    return rel, absd, plain_ms


def phase_ensemble(torch, ks, model, single, per_model_bytes, card):
    """Phase 7: M members of the main path in one step program; see the
    module docstring. `single` is phase 3's step of one model."""
    import numpy as np
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models import graph
    from lisflood_tpu_torch.models.ensemble import (EnsembleRunner, ensemble_model,
                                                    fold_states, member_state, tile_forcing)
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, synthetic_forcing
    from lisflood_tpu_torch.ops.routing_ops import kernel_operands
    cfg, params, state, aux = model
    P = cfg.num_pixels
    total = torch.cuda.get_device_properties(0).total_memory
    M = 8
    while M > 1 and M * per_model_bytes > 0.9 * total:
        M //= 2
    print(f"  {M} members: {per_model_bytes / 2**30:.2f} GiB per model in phase 3, "
          f"{total / 2**30:.1f} GiB on the card", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = EnsembleRunner(model, M, seed=0, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    kin = runner.step.routers["kin"]
    print(f"  {M}-member model built on the host, moved to the card and perturbed in "
          f"{time.perf_counter() - t0:.1f} s: {runner.cfg.num_pixels} cells, "
          f"{kin.ps.n_chunks} chunks, window {kin.ps.window}", flush=True)
    forcing = [to_device(synthetic_forcing(P, seed=i), "cuda", torch.float32) for i in range(6)]
    _, ms, counts = timed_batches(torch, ks, runner.advance, forcing)
    launches = counts["kinwave_substep"]
    step_ms = ms[-1]
    peak = torch.cuda.max_memory_allocated()
    print(f"  batches of 5 ensemble steps after the warm-up: {', '.join(f'{t:.1f}' for t in ms)} "
          f"ms per ensemble step; the last = {step_ms / M:.2f} ms per member-step = "
          f"{M * P / step_ms * 1e3:.4g} cells*steps/s on {card}; kinwave_substep launches "
          f"{launches} for {STEPS_RUN} ensemble steps of {M} members; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    assert routing_launches(counts) == {"kinwave_substep": STEPS_RUN, "kinwave_sweep": 0,
                                        "kinwave_sharded": 0}, (counts, "one a step")
    assert counts["soil_tail"] == STEPS_RUN, counts
    # the evaporation stencil is chosen by the member's grid, as for one model
    print(f"  evaporation stencil on the card: single model {cfg.use_eva_stencil('cuda')}, "
          f"{M}-member ensemble {runner.cfg.use_eva_stencil('cuda')}", flush=True)
    assert runner.cfg.use_eva_stencil("cuda") == cfg.use_eva_stencil("cuda")
    bad = [k for k, v in runner.state.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    f0 = tile_forcing(forcing[0], M, P)
    busy = profile_step(torch, runner.step, runner.state, f0, step_ms)
    SYNCS["ensemble"] = sync_count(torch, runner.step, runner.state, f0, "ensemble")
    graph_figures(torch, card, "ensemble", runner.stepper,
                  lambda s, f: runner.step(s, tile_forcing(f, M, P)), runner.state, forcing,
                  busy)
    # the graph's pool back to the card for the checks below
    runner.stepper = graph.stepper(runner.step, runner.stepper.prepare)
    torch.cuda.empty_cache()
    SOIL_COUNTS["ensemble"] = soil_tail_counts(torch, runner.step, runner.state, f0, "ensemble")

    spec, xs = kernel_operands(runner.cfg, runner.params, runner.state,
                               runner.step.land_phase(runner.state, f0), runner.step.routers)
    ys, fig = kernel_figures(torch, ks, spec, xs, f"ensemble launch, {M} members")
    n = M * PREFIX_PER_MEMBER
    rel, absd, plain_ms = held_on_prefix(torch, ks, spec, xs, ys, n)
    print(f"  ensemble launch vs the plain version on its first {n} chunks ({PREFIX_PER_MEMBER} "
          f"of each member's {spec.n_chunks // M}): max rel err {rel:.3e} (tol 1e-05), max abs "
          f"err {absd:.3e}; plain version {plain_ms:.1f} ms (one run)", flush=True)
    assert rel <= 1e-5, f"ensemble kernel disagrees with the plain version: {rel}"
    del xs, ys

    # every member against the single model's step on the same state
    C = kin.ps.chunk
    worst = []
    after, _ = runner.step(runner.state, f0)
    for m in range(M):
        one, _ = single(member_state(runner.state, m, M, C), forcing[0])
        mine = member_state(after, m, M, C)
        worst.append(max((float((mine[k] - v).abs().max() / max(float(v.abs().max()), 1e-30)),
                          k) for k, v in one.items()))
    print(f"  members 0..{M - 1} of the ensemble step vs the single model's step, max rel err "
          f"by member: {', '.join(f'{e:.3e} ({k})' for e, k in worst)} (tol 1e-5)", flush=True)
    assert max(worst)[0] <= 1e-5, worst
    del after

    # one EnKF analysis, gauges at the five cells of largest upstream area
    gauges = np.argsort(params["UpArea"])[-5:]
    hx = runner._gauge_discharge(gauges)
    obs, sigma = hx.mean(0) + 2 * hx.std(0), 0.1 * hx.std(0) + 1e-6
    pos = torch.as_tensor(kin.ps.inv_perm[(np.arange(M)[:, None] * P + gauges).reshape(-1)],
                          device="cuda")
    at_gauges = lambda: runner.state["pk$ChanQKin"][pos].double().cpu().numpy().reshape(M, -1)
    before = at_gauges().mean(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = runner.enkf_analysis(obs, gauges, sigma, seed=11)
    torch.cuda.synchronize()
    enkf_ms = (time.perf_counter() - t0) * 1e3
    after_g = at_gauges().mean(0)
    assert all(bool(torch.isfinite(v).all()) for v in new.values() if v.is_floating_point())
    moved = np.abs(after_g - obs).sum() < np.abs(before - obs).sum()
    print(f"  EnKF analysis of 7 fields x {M} members at 5 gauges: {enkf_ms:.1f} ms; finite; "
          f"gauge mean ChanQKin {before.sum():.6g} -> {after_g.sum():.6g} m3/s toward "
          f"{obs.sum():.6g}: {moved}", flush=True)
    assert moved, (before, after_g, obs)
    del runner, new

    # the kernel against its plain version at 240x200 with 2 members
    mid = build_synthetic_model(240, 200, no_rout_steps=24, chunk_size=512)
    cfg2, p2, aux2 = ensemble_model(mid[0], mid[1], mid[3], 2)
    state2 = fold_states([mid[2], mid[2]], 512)
    _, _, _, spec2, xs2 = kernel_inputs((cfg2, p2, state2, aux2), "cuda", torch.float32)
    held_to_plain(torch, ks, spec2, xs2, 1e-5, "240x200, 2 members")
    return {**fig, "launches": launches, "plain_ms": plain_ms, "max_abs_err": absd,
            "members": M, "step_ms": step_ms,
            "plain_shape": f"first {n} of the {spec.n_chunks} chunks of this launch, float32"}


# tile caps of the overland sweep at which phase 8 checks the same bits and
# times the kernel (its default, ops/wavefront.SWEEP_CAP, besides)
SWEEP_CAPS = (256, 512, 2048, 4096, 8192)
# chunks of the catchment's channel launch that phase 8 holds to the plain
# version
CATCHMENT_PREFIX = 256


def sweep_bound(ops, q, n_edges, n_real=None):
    """(bound_ms, bound_by) of one overland sweep (float32): const and adx
    read once, q written once and the graph at its least, one int32
    downstream index per position (what the JAX `_sweep` reads as
    `down_local`), over the HBM rate, against FLOPS_SWEEP per lane-row and
    position and one add per edge and lane over the float32 peak. The
    kernel's padded source table and its dependency table are its own
    design, not the function's inputs, and are not counted. With `n_real`
    (a rank's own and halo positions of its kept chunks) only those
    positions count."""
    n, L, C = q.shape
    pos = n * C if n_real is None else n_real
    nbytes = (sum(v.numel() * v.element_size() for v in (*ops, q)) * pos // (n * C)
              + pos * 4)
    flops = pos * L * FLOPS_SWEEP + n_edges * L
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    print(f"  bound: {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms; {flops / 1e9:.3f} GFLOP "
          f"(float32) -> {t_ops:.4f} ms", flush=True)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_operands(step, s, f):
    """The operands that the step's land phase gives the overland sweep:
    (const, adx) in the sweep's (n_chunks, L, C) layout, from the land
    phase's diagnostics as surface_routing_step forms them."""
    from lisflood_tpu_torch.ops.routing_ops import overland_operands
    p = step.step_params(f)
    d = step.land_phase(s, f, p)
    _, q0, lat, adx = overland_operands(step.cfg, p, s, d)
    return step.routers["tochan"].sweep_operands(q0, lat, adx, p["Beta"])


def sweep_held(torch, kp, tochan, ops, beta, tol, what, caps=SWEEP_CAPS):
    """The sweep kernel on `ops` at the default tile cap against its plain
    version: within `tol` of each lane's max, whether bitwise equal, the same
    bits in two runs and at every cap of `caps`. Returns (outputs, plan, max
    abs err, plain ms)."""
    q = kp.kinwave_sweep(*ops, tochan.sweep_tiles(), beta)
    plan = dict(kp.kinwave_sweep.last_plan)
    twice = same_bits({"q": q}, {"q": kp.kinwave_sweep(*ops, tochan.sweep_tiles(), beta)})
    by_cap = {}
    for cap in caps:
        by_cap[cap] = same_bits({"q": q}, {"q": kp.kinwave_sweep(*ops, tochan.sweep_tiles(cap), beta)})
        by_cap[cap] = (by_cap[cap], dict(kp.kinwave_sweep.last_plan))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = kp._sweep(*ops, tochan.ups.long(), beta)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diff = (q.double() - ref.double()).abs()
    rel = float((diff.amax(dim=(0, 2)) / ref.double().abs().amax(dim=(0, 2)).clamp_min(1e-300)).max())
    absd = float(diff.max())
    bits = torch.int32 if q.dtype == torch.float32 else torch.int64
    bitwise = bool(torch.equal(q.view(bits), ref.view(bits)))
    print(f"  {what}: sweep kernel vs plain max rel err {rel:.3e} of each lane's max (tol {tol:g}), "
          f"max abs {absd:.3e}, bitwise equal: {bitwise} ({int((q != ref).sum())} of {q.numel()} "
          f"values differ); {plan['tiles']} tiles of at most {plan['cap']} positions, "
          f"{plan['threads']} threads and {plan['smem_bytes']} shared bytes a block, "
          f"{plan['global_tiles']} tiles with q in global memory; the same bits in two runs: "
          f"{twice}, at caps "
          + ", ".join(f"{c} ({p['tiles']} tiles, {p['global_tiles']} in global memory): {ok}"
                      for c, (ok, p) in by_cap.items())
          + f"; plain version {plain_ms:.1f} ms (one run)", flush=True)
    assert rel <= tol, f"the sweep kernel disagrees with its plain version: {rel}"
    assert twice and all(ok for ok, _ in by_cap.values()), (twice, by_cap)
    return q, plan, absd, plain_ms


def tile_range(tiles, a, b):
    """The SweepTiles of tiles a..b-1 of `tiles` alone (a diagnostic)."""
    import dataclasses

    import numpy as np
    tp = tiles.tile_ptr.cpu().numpy().astype(np.int64)
    lp = tiles.lvl_ptr.cpu().numpy().astype(np.int64)
    K = tiles.ups.shape[0]
    return dataclasses.replace(
        tiles, tile_ptr=(tiles.tile_ptr[a:b + 1] - int(tp[a])).contiguous(),
        pos=tiles.pos[tp[a]:tp[b]].contiguous(), slots=tiles.slots[K * tp[a]:K * tp[b]].contiguous(),
        lvl_ptr=(tiles.lvl_ptr[a:b + 1] - int(lp[a])).contiguous(),
        lvl_off=tiles.lvl_off[lp[a]:lp[b]].contiguous(), count=tiles.count[a:b],
        padded=tiles.padded[a:b])


def sweep_where(torch, kp, ops, tiles, beta):
    """Where one launch of the sweep kernel spends its time, from its blocks'
    records (kinwave_packed.sweep_trace): the launch's span on the global
    clock, the blocks resident on an SM on average, the share of the blocks'
    cycles spent staging, the cycles per level; and the tile with the most
    levels, in the launch and launched alone: the kernel's critical path."""
    import numpy as np

    def records(t):
        rec = kp.sweep_trace(*ops, t, beta)[1].astype(np.float64)
        return rec[:, 1], rec[:, 2], rec[:, 3], rec[:, 4]
    levels = np.diff(tiles.lvl_ptr.cpu().numpy()) - 1
    g0, g1, staged, cycles = records(tiles)
    span = g1.max() - g0.min()
    ghz = cycles.sum() / (g1 - g0).sum()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    deep = int(np.argmax(levels))
    a0, a1, a_staged, a_cycles = records(tile_range(tiles, deep, deep + 1))
    print(f"  where the sweep's time goes (one traced launch at cap {tiles.cap}): span "
          f"{span / 1e3:.2f} us on the global clock, {(g1 - g0).sum() / (span * n_sm):.2f} blocks "
          f"resident per SM on average, a block {(g1 - g0).mean() / 1e3:.2f} us on average "
          f"({staged.sum() / cycles.sum():.3f} of its cycles staging, {staged.mean() / ghz / 1e3:.2f} "
          f"us), {((cycles - staged).sum() / levels.sum()):.0f} cycles per level at {ghz:.3f} GHz, "
          f"{levels.sum()} levels in {levels.size} tiles; the tile with the most levels "
          f"({levels[deep]}, {int(tiles.count[deep])} positions) takes "
          f"{(g1[deep] - g0[deep]) / 1e3:.2f} us in the launch and {(a1[0] - a0[0]) / 1e3:.2f} us "
          f"launched alone ({a_staged[0] / ghz / 1e3:.2f} us staging, "
          f"{(a_cycles[0] - a_staged[0]) / levels[deep]:.0f} cycles per level)", flush=True)


def phase_catchment(torch, ks, card, root):
    """Phase 8: a catchment read from maps (write_catchment at 1200x1000,
    classic netCDF, into the directory `root`, its outputs bound for phase
    9) through load_settings, build_model and the step; the overland sweep
    kernel and the sub-step kernel at chunk 256 held to their plain
    versions. See the module docstring. Returns the sweep's and the sub-step
    kernel's figures and what phase 9 reuses: the settings path, the model,
    the built step, the days' forcing on the card and the kernel's spec."""
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
    from lisflood_tpu_torch.models.step import build_multi_step, build_step
    from lisflood_tpu_torch.models.synthetic import write_catchment
    from lisflood_tpu_torch.ops import kinwave_packed as kp
    from lisflood_tpu_torch.ops.routing_ops import kernel_operands

    t0 = time.perf_counter()
    path = write_catchment(root, 1200, 1000, seed=0, n_steps=STEPS_RUN, nc_format="classic",
                           outputs=True, user={"EnsMembers": 1, "FilterSteps": ""})
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    settings = load_settings(path)
    t_settings = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, params, state, aux = build_model(settings)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    forcing_np = meteo_forcing(settings, cfg, aux)
    t_read = time.perf_counter() - t0
    print(f"  host seconds: write_catchment {t_write:.1f}, load_settings {t_settings:.2f}, "
          f"build_model {t_build:.1f}, the {len(forcing_np)} days of meteo from the PCRaster "
          f"stacks {t_read:.1f}; P={cfg.num_pixels}, {int(params['IsChannel'].sum())} channel "
          f"cells, lakes={cfg.num_lakes}, reservoirs={cfg.num_reservoirs}, "
          f"NoRoutSteps={cfg.no_rout_steps}", flush=True)
    assert len(forcing_np) == STEPS_RUN and cfg.no_rout_steps == 24 and cfg.split_routing
    t0 = time.perf_counter()
    multi, p = build_multi_step(cfg, params, aux, output_keys=("ChanQAvg",),
                                dtype=torch.float32, device="cuda")
    s = multi.prepare_state(state)
    forcing = [to_device(f, "cuda", torch.float32) for f in forcing_np]
    torch.cuda.synchronize()
    tochan, kin = multi.routers["tochan"], multi.routers["kin"]
    edges = int((tochan.ps.down_pos < tochan.ps.p_pad).sum())
    print(f"  step built and moved to the card in {time.perf_counter() - t0:.1f} s; channel "
          f"schedule {kin.ps.n_chunks} chunks of {kin.ps.chunk}, window {kin.ps.window}; "
          f"overland schedule {tochan.ps.n_chunks} chunks of {tochan.ps.chunk}, window "
          f"{tochan.ps.window}, {edges} edges, {tochan.ups.shape[0]} upstream rows", flush=True)
    assert edges > 0 and not tochan.no_edges and kin.ps.chunk == 256
    s, outs, step_ms, launches = timed_steps(torch, ks, multi, s, forcing, card, sweeps=STEPS_RUN,
                                             sums=True)
    bad = [k for k, v in s.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    q = outs["ChanQAvg"]
    assert q.shape == (5, cfg.num_pixels) and bool(torch.isfinite(q).all()) and bool((q >= 0).all())
    print(f"  every state entry finite ({len(s)} entries); ChanQAvg mean {float(q.mean()):.4g} "
          f"m3/s, max {float(q.max()):.4g} m3/s; overland discharge max "
          f"{float(torch.stack([s['OFQOther'], s['OFQForest'], s['OFQDirect']]).max()):.4g} m3/s",
          flush=True)
    busy = profile_step(torch, multi.step, s, forcing[0], step_ms)
    SYNCS["catchment"] = sync_count(torch, multi.step, s, forcing[0], "catchment")
    graph_figures(torch, card, "catchment", multi.stepper, multi.step, s, forcing, busy)
    repeat_bitwise(torch, multi.step, multi.prepare_state(state), forcing, "catchment")
    ops8, _ = soil_tail_operands(torch, multi.step, s, forcing[0])
    k8 = {**soil_tail_figures(torch, card, ops8, 1e-5, "1200x1000 catchment, float32",
                              PREVIOUS_MS["soil_tail"]["catchment"]),
          "launches": launches["soil_tail"]}
    del ops8

    print("  K5, the overland sweep, at the catchment's shape (float32):", flush=True)
    beta = float(p["Beta"])
    tiles = tochan.sweep_tiles()
    print(f"  overland forest: {tiles.stats['trees']} trees, the largest {tiles.stats['largest_tree']} "
          f"cells, {tiles.stats['levels']} levels at most in a tile; tile tables at cap "
          f"{tiles.cap} built in {tiles.stats['seconds']:.2f} s on the host with the step",
          flush=True)
    ops = sweep_operands(multi.step, s, forcing[0])
    q5, plan, absd, plain_ms = sweep_held(torch, kp, tochan, ops, beta, 1e-5,
                                          "1200x1000 catchment")
    by_cap = {}
    for cap in (tiles.cap, *SWEEP_CAPS):
        t = tochan.sweep_tiles(cap)
        by_cap[cap] = (cuda_ms(torch, lambda: kp.kinwave_sweep(*ops, t, beta), N_REP),
                       t.stats["seconds"])
    sweep_ms = by_cap[tiles.cap][0]
    bound_ms, bound_by = sweep_bound(ops, q5, edges)
    print(f"  sweep kernel {sweep_ms:.4f} ms/launch (mean of {N_REP}); by cap (ms, tables' host s): "
          + ", ".join(f"{c}: {m:.4f}, {b:.2f}" for c, (m, b) in sorted(by_cap.items()))
          + f"; launches per step 1 ({launches} steps); bound {bound_ms:.4f} ms ({bound_by}); "
          f"plain version {plain_ms:.1f} ms; card {card}", flush=True)
    sweep_where(torch, kp, ops, tiles, beta)
    sweep = {"ms": sweep_ms, "bound_ms": bound_ms, "bound_by": bound_by, "tiles": plan["tiles"],
             "cap": plan["cap"], "launches": STEPS_RUN, "plain_ms": plain_ms,
             "max_abs_err": absd, "plain_shape": "1200x1000 catchment, overland, float32"}
    del ops, q5

    # the float64 sweep at 240x200, also with a cap below its largest tree so
    # that tiles keep q in global memory
    with tempfile.TemporaryDirectory() as tmp:
        st = load_settings(write_catchment(tmp, 240, 200, seed=1, n_steps=1, nc_format="classic"))
        cfg_m, params_m, state_m, aux_m = build_model(st)
        f_m = meteo_forcing(st, cfg_m, aux_m)[0]
    step_m, _ = build_step(cfg_m, params_m, aux_m, dtype=torch.float64, device="cuda")
    ops_m = sweep_operands(step_m, step_m.prepare_state(state_m),
                           to_device(f_m, "cuda", torch.float64))
    tochan_m = step_m.routers["tochan"]
    small = max(tochan_m.sweep_tiles().stats["largest_tree"] // 2, 1)
    sweep_held(torch, kp, tochan_m, ops_m, beta, 1e-12, "240x200 catchment, float64",
               caps=(small, *SWEEP_CAPS))
    kp.kinwave_sweep(*ops_m, tochan_m.sweep_tiles(small), beta)
    assert kp.kinwave_sweep.last_plan["global_tiles"] > 0, kp.kinwave_sweep.last_plan
    del step_m, ops_m

    print("  the sub-step kernel at chunk 256 on this path:", flush=True)
    spec, xs = kernel_operands(cfg, p, s, multi.step.land_phase(s, forcing[0]), multi.routers)
    assert spec.chunk == 256 and spec.split and "lk_pos" in xs and "rs_pos" in xs, spec
    ys, fig = kernel_figures(torch, ks, spec, xs, "catchment launch, chunk 256")
    n = CATCHMENT_PREFIX
    rel, absd_k, plain_k = held_on_prefix(torch, ks, spec, xs, ys, n)
    print(f"  catchment launch vs the plain version on its first {n} of {spec.n_chunks} chunks: "
          f"max rel err {rel:.3e} (tol 1e-05), max abs err {absd_k:.3e}; plain version "
          f"{plain_k:.1f} ms (one run)", flush=True)
    assert rel <= 1e-5, f"the catchment launch disagrees with the plain version: {rel}"
    substep = {**fig, "launches": launches["kinwave_substep"], "plain_ms": plain_k,
               "max_abs_err": absd_k,
               "plain_shape": f"first {n} of the {spec.n_chunks} chunks of this launch, float32"}
    del xs, ys
    context = {"path": path, "model": (cfg, params, state, aux), "step": multi.step,
               "forcing": forcing, "spec": spec, "step_ms": step_ms, "blocks": fig["blocks"],
               "sums_per_step": launches["segment_sum"] / STEPS_RUN, "soil_tail": k8}
    return sweep, substep, context


# members of phase 9's ensemble, fewer only if they do not fit the card
DRIVER_MEMBERS = 4
# the ensemble's filter step (the 6th of the 11 days)
DRIVER_FILTER_STEP = 6


def field_gate(key, ref, got, state):
    """max |got - ref| over the scale of field `key`: its max, and for
    CrossSection2Area (a difference of storages ~1e6 times larger, the second
    lane's Chan2M3Kin and its start) Chan2M3Kin's max / 4000, as the CPU
    tests hold it."""
    ref, got = ref.double(), got.double()
    if key in ("CrossSection2Area", "crosssection2end"):
        scale = float(state["Chan2M3Kin"].double().abs().max()) / 4000.0
    else:
        scale = max(float(ref.abs().max()) if ref.numel() else 0.0, 1e-30)
    return float((ref - got).abs().max()) / scale if ref.numel() else 0.0


def ring_slot_bytes(spec):
    """Bytes of one slot of the sub-step kernel's float32 rings (discharge
    and evaporation hops, ops/kinwave_substep._launch)."""
    return (spec.T * (2 if spec.split else 1) + max(spec.E - 1, 1)) * spec.chunk * 4


def ensemble_ring_slots(spec, blocks, M):
    """The ring's slots for M members of the model of `spec` interleaved: the
    window and the chunks grow M times (models/ensemble.replicate_schedule),
    the ring holds 2 blocks + window slots (ops/kinwave_substep.ring_slots)."""
    window, n = spec.window * M, spec.n_chunks * M
    return max(min(2 * blocks + window, n), window + 1)


def phase_driver(torch, ks, card, ctx, tmp):
    """Phase 9: the settings-driven run on the card; see the module
    docstring. `ctx` is phase 8's context, `tmp` a scratch directory."""
    import numpy as np
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.io import csf
    from lisflood_tpu_torch.io.tss import read_tss
    from lisflood_tpu_torch.models.driver import (lisfloodexe, output_var_fields, resolve_output,
                                                  to_host)
    from lisflood_tpu_torch.models.synthetic import write_catchment
    path, (cfg, params, state, aux), step = ctx["path"], ctx["model"], ctx["step"]
    days = STEPS_RUN

    # the production run, float32
    out = os.path.join(tmp, "driver")
    os.makedirs(out)
    settings = load_settings(path, sys_args=["-v"],
                             vars_to_set={"Precision": "single", "PathOut": out})
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    runner = lisfloodexe(settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    per_model = torch.cuda.max_memory_allocated()
    sec = runner.seconds
    run_s = sum(v for k, v in sec.items() if k not in ("build_model", "to_device"))
    per_day = run_s / days
    print(f"  lisfloodexe, {days} days at float32 on {card}: {wall:.1f} s in all; host seconds: "
          f"build_model {sec['build_model']:.1f}, step built and state moved "
          f"{sec['to_device']:.1f}; the run {run_s:.2f} (forcing read and moved "
          f"{sec['forcing']:.2f}, step calls {sec['steps']:.2f}, the step's capture "
          f"{sec['capture']:.2f}, copies to the host "
          f"{sec['to_host']:.2f}, reports {sec['report']:.2f}, close {sec['close']:.2f}); "
          f"{per_day * 1e3:.1f} ms per simulated day end to end against phase 8's step loop "
          f"{ctx['step_ms']:.1f} ms/step; {len(runner.outputs.map_writers)} map outputs, "
          f"{len(runner.outputs.tss_writers)} TSS; peak device memory "
          f"{per_model / 2**30:.2f} GiB", flush=True)
    print(f"  launches in the run: {launches} for {days} days", flush=True)
    assert routing_launches(launches) == {"kinwave_substep": days, "kinwave_sweep": days,
                                          "kinwave_sharded": 0}, launches
    assert launches["segment_sum"] > 0, launches
    assert launches["soil_tail"] == days, launches
    assert runner.dtype == torch.float32 and runner.device.type == "cuda"
    names = sorted(os.listdir(out))
    assert {"dis.tss", "mbErrorMM.tss", "chanqend.map", "lzend.map",
            f"lz000000.0{days:02d}"} <= set(names), names

    # phase 8's step loop over the same days, the TSS sampled by each
    # series' GaugeSampler from its field; the end state
    tss = runner.outputs.tss_samplers
    keys = sorted({k for _, ts in tss.values() for k in output_var_fields(ts.output_var)
                   if k not in params})
    ref = {name: [] for name in tss}
    s = step.prepare_state(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in ctx["forcing"][:days]:
        s, d = step(s, f)
        host = to_host({k: d[k] for k in keys})
        for name, (sampler, ts) in tss.items():
            ref[name].append(sampler.sample(np.asarray(resolve_output(host, ts.output_var),
                                                       np.float64)))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    worst = []
    for name, writer in runner.outputs.tss_writers.items():
        rows, steps = read_tss(writer.path)[1:]
        assert list(steps) == list(range(1, days + 1)), (name, steps)
        worst.append((field_gate(name, torch.as_tensor(np.array(ref[name])),
                                 torch.as_tensor(rows), None), name))
    ref_state = step.natural_state(s)
    worst_state = max((field_gate(k, v, runner.state[k], ref_state), k)
                      for k, v in ref_state.items() if v.is_floating_point())
    print(f"  phase 8's step loop over the same {days} days with the TSS fields copied and "
          f"sampled: {loop_s / days * 1e3:.1f} ms per day, so the driver's own cost is "
          f"{(run_s - loop_s) / days * 1e3:.1f} ms a day; the driver's TSS against it, worst "
          f"{max(worst)[0]:.3e} ({max(worst)[1]}), end state worst {worst_state[0]:.3e} "
          f"({worst_state[1]}) of each field's max (tol 1e-5)", flush=True)
    assert max(worst)[0] <= 1e-5 and worst_state[0] <= 1e-5, (worst, worst_state)
    assert set(ref_state) == set(runner.state)
    # the TSS `total` operation: one host accuflux over the catchment
    graph = runner.outputs._graph
    t0 = time.perf_counter()
    graph.accuflux(np.ones(cfg.num_pixels) * runner.outputs._pixel_area)
    total_s = time.perf_counter() - t0
    print(f"  the TSS 'total' operation (host accuflux over {cfg.num_pixels} cells): "
          f"{total_s:.2f} s per TSS that takes it, per day", flush=True)
    del s, d, ref_state
    graph_run_pair(torch, card, "production", runner,
                   lambda o: load_settings(path, sys_args=["-v"],
                                           vars_to_set={"Precision": "single", "PathOut": o}),
                   out, days)
    del runner
    torch.cuda.empty_cache()

    # -l at 96x80, float64, on the card and on the CPU
    small = write_catchment(os.path.join(tmp, "small"), 96, 80, seed=0, n_steps=3,
                            nc_format="classic", outputs=True)
    runs = {}
    for device in ("cuda", "cpu"):
        d_out = os.path.join(tmp, f"small_{device}")
        os.makedirs(d_out)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            r = lisfloodexe(load_settings(small, sys_args=["-l"], vars_to_set={"PathOut": d_out}),
                            device=None if device == "cuda" else "cpu")
        runs[device] = (r, printed.getvalue().splitlines(), d_out, time.perf_counter() - t0)
    (gpu, gpu_lines, gpu_out, gpu_s), (cpu, cpu_lines, cpu_out, cpu_s) = runs["cuda"], runs["cpu"]
    assert gpu.dtype == cpu.dtype == torch.float64 and gpu.device.type == "cuda"
    assert gpu_lines == cpu_lines and len(gpu_lines) == 3, (gpu_lines, cpu_lines)
    files = sorted(os.listdir(gpu_out))
    assert files == sorted(os.listdir(cpu_out)) and "dis.tss" in files
    errs = [(field_gate(n, torch.as_tensor(read_tss(os.path.join(cpu_out, n))[1]),
                        torch.as_tensor(read_tss(os.path.join(gpu_out, n))[1]), None), n)
            for n in files if n.endswith(".tss")]
    errs += [(field_gate(k, v, gpu.state[k].cpu(), cpu.state), k) for k, v in cpu.state.items()
             if v.is_floating_point()]
    print(f"  -l at 96x80, float64: the card's {len(gpu_lines)} lines equal the CPU's "
          f"({gpu_lines[-1].strip()}); TSS and end state worst {max(errs)[0]:.3e} ({max(errs)[1]}) "
          f"of each field's max (tol 1e-10); {gpu_s:.1f} s on the card, {cpu_s:.1f} s on the "
          f"CPU", flush=True)
    assert max(errs)[0] <= 1e-10, errs
    del gpu, cpu, runs

    # MonteCarlo and EnKF through lisfloodexe
    total = torch.cuda.get_device_properties(0).total_memory
    spec, blocks = ctx["spec"], ctx["blocks"]
    ring_mib = lambda slots: slots * ring_slot_bytes(spec) / 2**20
    M = DRIVER_MEMBERS
    while M > 1 and (M * per_model + ring_mib(ensemble_ring_slots(spec, blocks, M)) * 2**20
                     > 0.9 * total):
        print(f"  {M} members do not fit: {M} x {per_model / 2**30:.2f} GiB + a ring of "
              f"{ring_mib(ensemble_ring_slots(spec, blocks, M)):.0f} MiB > 90% of "
              f"{total / 2**30:.1f} GiB", flush=True)
        M //= 2
    slots = ensemble_ring_slots(spec, blocks, M)
    print(f"  {M} members: reckoned ring {slots} slots, {ring_mib(slots):.0f} MiB (one model's "
          f"{ring_mib(ensemble_ring_slots(spec, blocks, 1)):.0f} MiB), models {M} x "
          f"{per_model / 2**30:.2f} GiB (the peak of the run above, phase 8's model on the "
          f"card too), card {total / 2**30:.1f} GiB", flush=True)
    ens_out = os.path.join(tmp, "ensemble")
    os.makedirs(ens_out)
    settings = load_settings(path, sys_args=["-v"], opts_to_set=["MonteCarlo", "EnKF"],
                             vars_to_set={"Precision": "single", "PathOut": ens_out,
                                          "EnsMembers": str(M),
                                          "FilterSteps": str(DRIVER_FILTER_STEP),
                                          "LZState": ""})
    assert settings.ens_members == M and settings.filter_steps == [DRIVER_FILTER_STEP]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    runner = lisfloodexe(settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ens = runner.ensemble
    ring = ks.kinwave_substep.last_plan["ring"]
    es = ens.seconds
    print(f"  MonteCarlo + EnKF, {M} members x {days} days at float32: {wall:.1f} s in all "
          f"(build_model {runner.seconds['build_model']:.1f}, the folded model built, moved "
          f"and perturbed {es['build']:.1f}, the days {es['days']:.2f}, the step's capture "
          f"{es['capture']:.2f}, EnKF {es['enkf']:.2f}, dumps {es['dumps']:.2f}); "
          f"{es['days'] / (days * M) * 1e3:.1f} ms per member-day; "
          f"ring {ring} slots, {ring_mib(ring):.0f} MiB; launches {launches} for {days} "
          f"ensemble days; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}", flush=True)
    assert routing_launches(launches) == {"kinwave_substep": days, "kinwave_sweep": days,
                                          "kinwave_sharded": 0}, launches
    assert launches["soil_tail"] == days, launches
    assert ens.n == M and ring > spec.window * M, (ens.n, ring, spec.window)
    top = sorted(os.listdir(ens_out))
    assert top == [str(m) for m in range(1, M + 1)] + ["stateVar"], top
    assert sorted(os.listdir(os.path.join(ens_out, "stateVar"))) == [
        f"stateVar_{m}_{DRIVER_FILTER_STEP}.npz" for m in range(1, M + 1)]
    expected = sorted(n for n in names if not n.startswith("lz0"))
    for m in range(1, M + 1):
        member = os.path.join(ens_out, str(m))
        assert sorted(os.listdir(member)) == expected, (m, sorted(os.listdir(member)))
        for n in expected:
            if n.endswith(".tss"):
                rows, steps = read_tss(os.path.join(member, n))[1:]
                assert np.isfinite(rows).all() and len(steps) == days, (m, n)
            else:
                mp = csf.read_map(os.path.join(member, n))
                assert np.isfinite(mp.data[~mp.mv_mask]).all(), (m, n)
    print(f"  every member's {len(expected)} files present and finite, {M} dumps at step "
          f"{DRIVER_FILTER_STEP}", flush=True)
    del runner, ens
    torch.cuda.empty_cache()


# days of phase 15's warm start: the cold run, the half run it is split
# into and the warm run from the half run's files; and of its geographic runs
WARM_DAYS, WARM_HALF = 6, 3
GEO_DAYS = 3
# the geographic catchment's meteo window: GEO_MARGIN cells wider than the
# mask on every side
GEO_MARGIN = 2
# the state of a warm start held to the cold run (tests/test_torch_warmstart.py):
# WARM_BITWISE bit for bit, the rest within the float32 gate of the CPU tests
WARM_KEYS = ("W1a", "W1b", "W2", "UZ", "LZ", "SnowCoverS", "FrostIndex", "ChanQKin",
             "ChanM3Kin", "ChanQ", "DSLR", "CumInterception", "CumInterSealed", "Chan2QKin",
             "Chan2M3Kin", "CrossSection2Area", "Sideflow1Chan", "LakeStorageM3CC",
             "LakeInflowOldCC", "LakeOutflowCC", "ReservoirStorageM3CC", "ReservoirFillCC",
             "OFM3Direct", "OFM3Other", "OFM3Forest")
WARM_BITWISE = ("SnowCoverS", "FrostIndex", "DSLR", "CumInterception", "CumInterSealed")


def operational_run(torch, card, what, path, out, days, **vars_to_set):
    """lisfloodexe of the settings `path` at float32 into `out`, with
    `vars_to_set`: the runner, its launches (one of the sub-step kernel, K5
    and K8 a day, K7 called) and its figures, printed."""
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.models.driver import lisfloodexe
    os.makedirs(out)
    settings = load_settings(path, sys_args=["-v"],
                             vars_to_set={"Precision": "single", "PathOut": out, **vars_to_set})
    reset_launches()
    t0 = time.perf_counter()
    runner = lisfloodexe(settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    sec = runner.seconds
    run_s = sum(v for k, v in sec.items() if k not in ("build_model", "to_device"))
    fig = {"days": days, "build_model_s": sec["build_model"], "run_s": run_s,
           "ms_per_day": run_s / days * 1e3, "launches": launches}
    print(f"  {what}: {days} days at float32, {wall:.1f} s in all; host seconds build_model "
          f"{sec['build_model']:.2f}, step built and state moved {sec['to_device']:.2f}, the "
          f"run {run_s:.2f} ({fig['ms_per_day']:.1f} ms per simulated day); launches "
          f"{launches}; card {card}", flush=True)
    assert routing_launches(launches) == {"kinwave_substep": days, "kinwave_sweep": days,
                                          "kinwave_sharded": 0}, (what, launches)
    assert launches["segment_sum"] > 0 and launches["soil_tail"] == days, (what, launches)
    assert runner.dtype == torch.float32 and runner.device.type == "cuda"
    assert len(runner.dates) == days
    return runner, fig


def same_outputs(a, b):
    """The output directories `a` and `b` hold the same files and every TSS
    (ids, steps, rows) and map the same bits; the files compared."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)), (names, sorted(os.listdir(b)))
    for name in names:
        same_file(os.path.join(a, name), os.path.join(b, name), name)
    return names


def same_file(fa, fb, name):
    """The TSS (ids, steps, rows) or map `name` of two runs, `fa` and `fb`,
    the same bits."""
    import numpy as np
    from lisflood_tpu_torch.io import csf
    from lisflood_tpu_torch.io.tss import read_tss
    if name.endswith(".tss"):
        (ia, ra, sa), (ib, rb, sb) = read_tss(fa), read_tss(fb)
        assert ia == ib and np.array_equal(sa, sb) and np.array_equal(ra, rb), name
    else:
        ma, mb = csf.read_map(fa), csf.read_map(fb)
        assert np.array_equal(ma.mv_mask, mb.mv_mask), name
        assert np.array_equal(ma.data, mb.data, equal_nan=True), name


def phase_operational(torch, card, path, tmp, shape=(1200, 1000)):
    """Phase 15: the operational run paths on the card; see the module
    docstring. `path` is phase 8's catchment, `tmp` a scratch directory,
    `shape` the geographic catchment's rows and columns."""
    import numpy as np
    from lisflood_tpu_torch.io.loadmap import MapsCache
    from lisflood_tpu_torch.io.tss import read_tss
    from lisflood_tpu_torch.models.synthetic import GEO_CELL, warm_start, write_catchment
    day = lambda n: f"{n:02d}/01/2000 00:00"       # phase 8's catchment starts on 01/01/2000

    # a warm start: WARM_DAYS cold against WARM_HALF days and a warm run from
    # the half run's PCRaster end maps, LZ from its stack's map of the last
    # day (lz000000.003), timestepInit that day
    out = {k: os.path.join(tmp, "warm_" + k) for k in ("cold", "half", "warm")}
    cold, cold_fig = operational_run(torch, card, "cold run", path, out["cold"], WARM_DAYS,
                                     StepEnd=day(WARM_DAYS))
    cold_state = {k: cold.state[k] for k in WARM_KEYS}
    del cold
    half, _ = operational_run(torch, card, "half run", path, out["half"], WARM_HALF,
                              StepEnd=day(WARM_HALF))
    del half
    warm, warm_fig = operational_run(
        torch, card, "warm run from the half run's end maps and LZ stack", path, out["warm"],
        WARM_DAYS - WARM_HALF, StepStart=day(WARM_HALF + 1), StepEnd=day(WARM_DAYS),
        timestepInit=day(WARM_HALF), **warm_start(out["half"], lz_step=WARM_HALF))
    gates = []
    for k in WARM_KEYS:
        if k in WARM_BITWISE:
            assert torch.equal(cold_state[k], warm.state[k]), k
        else:
            gates.append((field_gate(k, cold_state[k], warm.state[k], cold_state), k))
    worst = max(gates, key=lambda g: g[0] / (1e-2 if g[1] == "Sideflow1Chan" else 1.5e-4))
    (cold_rows, cold_steps), (warm_rows, warm_steps) = (
        read_tss(os.path.join(out[k], "dis.tss"))[1:] for k in ("cold", "warm"))
    sel = np.isin(cold_steps, warm_steps)
    assert list(warm_steps) == list(range(WARM_HALF + 1, WARM_DAYS + 1)), warm_steps
    # the rows as printed: equal on the CPU tests' 48x40, where the
    # reference's gate (array_equal) holds; here a last printed digit may
    # differ, and they are held to the float32 gate
    rows = torch.as_tensor(cold_rows[sel]), torch.as_tensor(warm_rows)
    rows_err = field_gate("dis.tss", *rows, None)
    print(f"  the warm run's days {WARM_HALF + 1}-{WARM_DAYS} against the cold run's: "
          f"{len(WARM_BITWISE)} state keys bit for bit, the other {len(gates)} worst "
          f"{worst[0]:.3e} ({worst[1]}) of each field's max (tol 1.5e-4, Sideflow1Chan 1e-2); "
          f"dis.tss rows {'equal' if torch.equal(*rows) else 'not equal'} as printed, "
          f"{int((rows[0] != rows[1]).sum())} of {rows[0].numel()} values differ, worst "
          f"{rows_err:.3e} of the largest (tol 1.5e-4); card {card}", flush=True)
    assert all(e <= (1e-2 if k == "Sideflow1Chan" else 1.5e-4) for e, k in gates), gates
    assert rows_err <= 1.5e-4, rows_err
    del warm, cold_state
    torch.cuda.empty_cache()

    # the geographic catchment, run twice through MapsCaching
    t0 = time.perf_counter()
    geo = write_catchment(os.path.join(tmp, "geographic"), *shape, seed=0, n_steps=GEO_DAYS,
                          grid="geographic", gauges="coords", meteo_format="netcdf",
                          nc_format="classic", meteo_margin=GEO_MARGIN, lat_ascending=True,
                          outputs=True)
    print(f"  the geographic catchment ({shape[0]}x{shape[1]} cells of {GEO_CELL} degrees, "
          f"user pixel maps, coordinate gauges, classic netCDF meteo {GEO_MARGIN} cells wider "
          f"on every side and latitude ascending) written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    MapsCache.clear()
    runs, cache = [], []
    for i in (1, 2):
        runner, fig = operational_run(torch, card, f"geographic run {i}, MapsCaching on", geo,
                                      os.path.join(tmp, f"geographic_{i}"), GEO_DAYS,
                                      MapsCaching="True")
        fig.update(entries=MapsCache.size(), hits=MapsCache.values_found())
        cache.append(fig)
        runs.append(runner)
    first, second = runs
    assert first.grid.cell == GEO_CELL and first.grid.num_pixels > 0
    length = first.params_np["PixelLength"]
    assert 0 < length.min() < length.max() and length.max() > 1e3 * GEO_CELL
    bad = [k for k, v in first.state.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    assert set(first.state) == set(second.state)
    assert all(torch.equal(v, second.state[k]) for k, v in first.state.items())
    names = same_outputs(os.path.join(tmp, "geographic_1"), os.path.join(tmp, "geographic_2"))
    assert "dis.tss" in names and "chanqend.map" in names
    ids = read_tss(os.path.join(tmp, "geographic_1", "dis.tss"))[0]
    assert list(ids) == [1, 2, 3], ids
    (a, b) = cache
    print(f"  MapsCaching: build_model {a['build_model_s']:.2f} s with the cache empty, "
          f"{b['build_model_s']:.2f} s from it; {a['entries']} entries after the first run, "
          f"{b['entries']} after the second, hits {a['hits']} then {b['hits']}; the second "
          f"run's state ({len(second.state)} entries) and its {len(names)} output files the "
          f"same bits as the first's; card {card}", flush=True)
    assert b["entries"] == a["entries"] > 20 and b["hits"] > a["hits"], cache
    MapsCache.clear()
    del runs, first, second, runner
    torch.cuda.empty_cache()
    return {"warm": {"cold": cold_fig, "warm": warm_fig}, "geographic": cache}


# days of phase 16's runs, from EVERY_START: the 30th and 31st of December
# and the 1st of January, so a month and a year end in the run
EVERY_DAYS = 3
EVERY_START = (1999, 12, 30)
# K7's calls a day on phase 15's runs: phase 16's must be more
PHASE15_K7_PER_DAY = 13


def sideflow_groups(ks):
    """Record, launch by launch, the optional sideflow operand groups
    (kinwave_substep.SIDEFLOW_GROUPS) of the sub-step kernel's launches
    through the CUDA wrapper `ks._launch`, and keep the last launch's
    operands: returns the list it fills, the dict that holds (spec, xs) of
    the last launch and a function that puts the wrapper back. The count
    stays the wrapper's."""
    seen, last, launch = [], {}, ks._launch

    def recording(spec, xs, blocks=None):
        seen.append(tuple(g[0] for g in ks.SIDEFLOW_GROUPS if g[0] in xs))
        last["operands"] = spec, xs
        return launch(spec, xs, blocks=blocks)

    ks._launch = recording
    return seen, last, lambda: setattr(ks, "_launch", launch)


def outputs_finite(out):
    """Every output file in `out` finite: each TSS row, and each map where
    it is not missing (the mask); the files, by name."""
    import numpy as np
    from lisflood_tpu_torch.io import csf
    from lisflood_tpu_torch.io.tss import read_tss
    names = sorted(os.listdir(out))
    for name in names:
        if name.endswith(".tss"):
            rows = read_tss(os.path.join(out, name))[1]
            assert np.isfinite(rows).all(), name
        else:
            m = csf.read_map(os.path.join(out, name))
            assert np.isfinite(m.data[~m.mv_mask]).all(), name
    return names


def phase_every_option(torch, card, ks, tmp, shape=(1200, 1000), small=(96, 80)):
    """Phase 16: every option read from maps through the production run; see
    the module docstring. `tmp` is a scratch directory, `shape` the
    catchment's rows and columns, `small` the card-against-CPU catchment's."""
    import datetime
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.io.tss import read_tss
    from lisflood_tpu_torch.models.driver import lisfloodexe
    from lisflood_tpu_torch.models.synthetic import (EVERY_OPTION, expected_outputs,
                                                     write_catchment)
    start = datetime.date(*EVERY_START)
    t0 = time.perf_counter()
    path = write_catchment(os.path.join(tmp, "every"), *shape, seed=0, n_steps=EVERY_DAYS,
                           nc_format="classic", outputs=True, options=EVERY_OPTION, start=start)
    write_s = time.perf_counter() - t0
    out = os.path.join(tmp, "every_out")
    os.makedirs(out)
    settings = load_settings(path, sys_args=["-v"],
                             vars_to_set={"Precision": "single", "PathOut": out})
    on = sorted(k for k, v in EVERY_OPTION.items() if v)
    print(f"  the catchment ({shape[0]}x{shape[1]}, {len(on)} options on: {', '.join(on)}) "
          f"written in {write_s:.1f} s", flush=True)
    seen, last, restore = sideflow_groups(ks)
    reset_launches()
    t0 = time.perf_counter()
    try:
        runner = lisfloodexe(settings)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    sec = runner.seconds
    run_s = sum(v for k, v in sec.items() if k not in ("build_model", "to_device"))
    cfg = runner.config
    fig = {"days": EVERY_DAYS, "build_model_s": sec["build_model"], "run_s": run_s,
           "ms_per_day": run_s / EVERY_DAYS * 1e3, "launches": launches,
           "sideflow": sorted(set(seen))}
    print(f"  lisfloodexe, {EVERY_DAYS} days from {start:%d/%m/%Y} at float32: {wall:.1f} s in "
          f"all; host seconds build_model {sec['build_model']:.2f}, step built and state moved "
          f"{sec['to_device']:.2f}, the run {run_s:.2f} (forcing {sec['forcing']:.2f}, step calls "
          f"{sec['steps']:.2f}, the step's capture {sec['capture']:.2f}, copies to the host "
          f"{sec['to_host']:.2f}, reports "
          f"{sec['report']:.2f}, close {sec['close']:.2f}): {fig['ms_per_day']:.1f} ms per "
          f"simulated day; {cfg.num_pixels} cells, {cfg.num_wregions - 1} water regions; "
          f"{len(runner.outputs.map_writers)} map outputs, {len(runner.outputs.tss_writers)} "
          f"TSS; card {card}", flush=True)
    print(f"  launches by kernel: {launches} for {EVERY_DAYS} days ("
          f"{launches['segment_sum'] / EVERY_DAYS:g} of K7 a day, phase 15's runs "
          f"{PHASE15_K7_PER_DAY}); the sub-step kernel's sideflow operands by launch: {seen}",
          flush=True)
    assert runner.device.type == "cuda" and runner.dtype == torch.float32
    assert routing_launches(launches) == {"kinwave_substep": EVERY_DAYS,
                                          "kinwave_sweep": EVERY_DAYS,
                                          "kinwave_sharded": 0}, launches
    assert launches["soil_tail"] == EVERY_DAYS, launches
    assert launches["segment_sum"] > PHASE15_K7_PER_DAY * EVERY_DAYS, launches
    # the run replays its captured step: the wrapper ran at the warm-up, the
    # first day's step, and at the capture, whose operands every replay takes
    seen = seen[:1] + seen[1:2] * (EVERY_DAYS - 1)
    assert len(seen) == EVERY_DAYS and all({"wuse", "qin_old", "uptrans"} <= set(g)
                                           for g in seen), seen
    bad = [k for k, v in runner.state.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    names = outputs_finite(out)
    expected = expected_outputs(settings)
    assert set(names) == expected, (sorted(set(names) - expected), sorted(expected - set(names)))
    trans = runner.state["TransCum"]
    print(f"  every state entry finite ({len(runner.state)} entries, TransCum max "
          f"{float(trans.max()):.4g} m3, PolderStorageM3 sum "
          f"{float(runner.state['PolderStorageM3'].double().sum()):.4g} m3); the {len(names)} "
          f"output files finite where the mask is and the registry rule's set "
          f"(expected_outputs)", flush=True)
    assert float(trans.max()) > 0
    graph_run_pair(torch, card, "every option", runner,
                   lambda o: load_settings(path, sys_args=["-v"],
                                           vars_to_set={"Precision": "single", "PathOut": o}),
                   out, EVERY_DAYS)
    del runner
    torch.cuda.empty_cache()

    # the last day's launch of the sub-step kernel, the sideflow terms on
    # (K4b) on the map-built schedule: its time, bound and plain version
    spec, xs = last.pop("operands")
    assert spec.chunk == 256 and spec.split and "lk_pos" in xs, spec
    ys, k4b = kernel_figures(torch, ks, spec, xs, "catchment launch with the sideflow terms")
    n = CATCHMENT_PREFIX
    # `trans`, the transmission loss, sums differences chanq - (chanq**tp2 -
    # tsub)**tp1 of near-equal operands (TransSub 1e-3 takes ~1e-4 of the
    # discharge): in float32 one ulp of pow moves it by ~1e-4 of its own max.
    # It is held on the scale of those operands, the volume the launch's
    # largest discharge passes in one routing sub-step, as the CPU tests
    # hold TransCum (tests/test_torch_options.py::_f32_scales); the lanes'
    # sideflow carries the loss, so every output is held to the CPU tests'
    # float32 gate of the all-options step after one step, 3e-5 of its max
    volume = float(ys["chanq"][:n].abs().max()) * spec.dt_routing
    rel, absd, plain_ms = held_on_prefix(torch, ks, spec, xs, ys, n, {"trans": volume})
    print(f"  that launch vs the plain version on its first {n} of {spec.n_chunks} chunks: max "
          f"rel err {rel:.3e} (tol 3e-05; trans on {volume:.4g} m3, a sub-step's volume of "
          f"the largest discharge), max abs err {absd:.3e}; plain version {plain_ms:.1f} ms "
          f"(one run); card {card}", flush=True)
    assert rel <= 3e-5, f"the sideflow launch disagrees with the plain version: {rel}"
    assert "trans" in ys and bool(torch.isfinite(ys["trans"]).all())
    fig["kinwave_substep"] = {
        **k4b, "launches": launches["kinwave_substep"], "plain_ms": plain_ms,
        "max_abs_err": absd,
        "plain_shape": f"first {n} of the {spec.n_chunks} chunks of this launch, float32"}
    del spec, xs, ys
    torch.cuda.empty_cache()

    # the card against the CPU: the same options at `small`, float64, -l
    tiny = write_catchment(os.path.join(tmp, "every_small"), *small, seed=0,
                           n_steps=EVERY_DAYS, nc_format="classic", outputs=True,
                           options=EVERY_OPTION, start=start)
    runs = {}
    for device in ("cuda", "cpu"):
        d_out = os.path.join(tmp, f"every_small_{device}")
        os.makedirs(d_out)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            r = lisfloodexe(load_settings(tiny, sys_args=["-l"], vars_to_set={"PathOut": d_out}),
                            device=None if device == "cuda" else "cpu")
        runs[device] = (r, printed.getvalue().splitlines(), d_out, time.perf_counter() - t0)
    (gpu, gpu_lines, gpu_out, gpu_s), (cpu, cpu_lines, cpu_out, cpu_s) = runs["cuda"], runs["cpu"]
    assert gpu.dtype == cpu.dtype == torch.float64 and gpu.device.type == "cuda"
    assert gpu_lines == cpu_lines and len(gpu_lines) == EVERY_DAYS, (gpu_lines, cpu_lines)
    files = sorted(os.listdir(gpu_out))
    assert files == sorted(os.listdir(cpu_out)) and set(files) == expected_outputs(gpu.settings)
    errs = [(field_gate(n, torch.as_tensor(read_tss(os.path.join(cpu_out, n))[1]),
                        torch.as_tensor(read_tss(os.path.join(gpu_out, n))[1]), None), n)
            for n in files if n.endswith(".tss")]
    errs += [(field_gate(k, v, gpu.state[k].cpu(), cpu.state), k) for k, v in cpu.state.items()
             if v.is_floating_point()]
    print(f"  -l at {small[0]}x{small[1]}, float64, every option: the card's {len(gpu_lines)} "
          f"lines equal the CPU's ({gpu_lines[-1].strip()}), the same {len(files)} files; "
          f"{len(errs)} TSS and state fields worst {max(errs)[0]:.3e} ({max(errs)[1]}) of each "
          f"field's max (tol 1e-10); {gpu_s:.1f} s on the card, {cpu_s:.1f} s on the CPU",
          flush=True)
    assert max(errs)[0] <= 1e-10, errs
    fig["small_worst"] = max(errs)[0]
    del gpu, cpu, runs
    torch.cuda.empty_cache()
    return fig


def every_option_check(torch):
    """`python3 chip_smoke.py --every-option`: phase 16 alone."""
    from lisflood_tpu_torch.ops import _build
    from lisflood_tpu_torch.ops import kinwave_substep as ks
    card = smi_line()
    print(f"card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"  built {list(_build.SOURCES)} in {_build.build():.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fig = phase_every_option(torch, card, ks, tmp)
    print(f"  phase 16 in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(fig), flush=True)
    print(smi_line())
    return 0


# logical shards of phase 10 (the JAX package's RoutingShards default)
SHARDS = 4
# days phase 10 runs the sharded step and lisfloodexe
SHARDED_DAYS = 3


def sharded_bound(ps, L, dtype, n_edges):
    """(bound_ms, bound_by) of one sweep of the sharded schedule `ps` with L
    lanes, counted over its num_pixels real positions as sweep_bound counts
    K5: `const` and `adx` read once, `q` written once and the graph at its
    least, one int32 downstream index per position, over the HBM rate,
    against the Newton solve of every lane-row and position (FLOPS_SWEEP in
    float32 at beta = 3/5, the q-space row and its `pow`s in float64) and one
    add per edge and lane over the peak of the type. The schedule's padding
    positions, its tables and the kernel's source table are not the
    function's inputs and are not counted; the padding's share of p_pad is
    printed as a property of the schedule."""
    name = str(dtype).replace("torch.", "")
    item = 4 if name == "float32" else 8
    P = ps.num_pixels
    nbytes = 3 * L * P * item + 4 * P
    if name == "float32":
        per_row = FLOPS_SWEEP
    else:
        plain, pows = QSPACE_ROW(QSPACE_ITERS[name])
        per_row = 1 + plain + pows * POW_FLOPS[name]
    flops = L * P * per_row + L * n_edges
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    print(f"  bound over {P} positions: {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms; "
          f"{flops / 1e9:.3f} GFLOP ({name}) -> {t_ops:.4f} ms; the schedule's padding "
          f"{1 - P / ps.p_pad:.3f} of its {ps.p_pad} positions", flush=True)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# tile caps at which phase 10 checks K6's bits and times it, besides its
# default (ops/wavefront.SWEEP_CAP)
SHARDED_CAPS = (256, 4096)


def sharded_plan_text(plan):
    return (f"{plan['tiles']} tiles of at most {plan['cap']} positions ({plan['ring_tiles']} "
            f"through the ring, {plan['ring_w']} wide, {plan['global_tiles']} in global memory), "
            f"{plan['pad_blocks']} padding blocks for {plan['n_pad']} positions, {plan['threads']} "
            f"threads and {plan['smem_bytes']} shared bytes a block")


def sharded_held(torch, kss, router, ops, beta, tol, what, caps=SHARDED_CAPS):
    """K6 on the operands `ops` of `router` (sharded, or the scan router's
    natural ones) at its default tile cap against its plain version (the
    tiles' `reference`: kinwave_sharded._sweep_sharded, or kinwave._sweep_scan,
    which _route_batched runs): within `tol` of each lane-row's max and
    bitwise equal, the same bits in two runs and at every cap of `caps`.
    Returns (max abs err, the plain version's milliseconds, the launch's
    plan)."""
    ps = router.ps
    tiles = router.sweep_tiles()
    q = kss.kinwave_sharded_sweep(*ops, tiles, beta)
    plan = dict(kss.kinwave_sharded_sweep.last_plan)
    twice = same_bits({"q": q}, {"q": kss.kinwave_sharded_sweep(*ops, tiles, beta)})
    by_cap = {}
    for cap in caps:
        again = kss.kinwave_sharded_sweep(*ops, router.sweep_tiles(cap), beta)
        ok = same_bits({"q": q}, {"q": again})
        by_cap[cap] = (ok, dict(kss.kinwave_sharded_sweep.last_plan))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = tiles.reference(*ops, beta)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diff = (q.double() - ref.double()).abs()
    rel = float((diff.amax(1) / ref.double().abs().amax(1).clamp_min(1e-300)).max())
    absd = float(diff.max())
    bitwise = same_bits({"q": q}, {"q": ref})
    print(f"  {what}: K6 vs plain max rel err {rel:.3e} of each lane's max (tol {tol:g}), max abs "
          f"{absd:.3e}, bitwise equal: {bitwise} ({int((q != ref).sum())} of {q.numel()} values "
          f"differ); the same bits in two runs: {twice}, at caps "
          + ", ".join(f"{c}: {ok}" for c, (ok, _) in by_cap.items())
          + f"; {sharded_plan_text(plan)}; at caps "
          + "; ".join(f"{c}: {sharded_plan_text(p)}" for c, (_, p) in by_cap.items())
          + f"; schedule {ps.n_chunks} chunks of {getattr(ps, 'n_shards', 1)} x {ps.chunk}; "
          f"plain version "
          f"{plain_ms:.1f} ms (one run)", flush=True)
    assert rel <= tol, f"K6 disagrees with its plain version: {rel}"
    assert bitwise and twice and all(ok for ok, _ in by_cap.values()), (bitwise, twice, by_cap)
    return absd, plain_ms, plan


def sharded_tile_range(tiles, a, b):
    """The ShardedTiles of tiles a..b-1 of `tiles` alone, without the
    padding (a diagnostic)."""
    import dataclasses
    tp = tiles.tile_ptr.cpu()
    R = tiles.ring.numel() // tiles.pos.numel()
    return dataclasses.replace(tile_range(tiles, a, b), width=tiles.width[a:b].contiguous(),
                               ring=tiles.ring[R * int(tp[a]):R * int(tp[b])].contiguous(),
                               pad=tiles.pad[:0], widths=tiles.widths[a:b],
                               levels=tiles.levels[a:b])


def sharded_where(torch, kss, ops, tiles, beta, what):
    """Where one launch of K6 spends its time, from its blocks' records
    (kinwave_sharded.sharded_trace): the launch's span on the global clock,
    the shallow tiles' and the padding blocks' time, and the tile with the
    most levels, in the launch and launched alone (its time by cuda_ms too):
    its cycles to its first level and a level, and the chain floor, its
    levels times its cycles a level at the clock the records give. Returns
    (the tile alone in ms, the chain floor in ms, cycles a level)."""
    import numpy as np

    def records(t):
        rec = kss.sharded_trace(*ops, t, beta)[1].astype(np.float64)
        return rec[:, 1], rec[:, 2], rec[:, 3], rec[:, 4]
    g0, g1, staged, cycles = records(tiles)
    span = g1.max() - g0.min()
    ghz = cycles.sum() / (g1 - g0).sum()
    n = tiles.n_tiles
    deep = int(np.argmax(tiles.levels))
    levels = int(tiles.levels[deep])
    one = sharded_tile_range(tiles, deep, deep + 1)
    a0, a1, a_staged, a_cycles = records(one)
    per_level = (a_cycles[0] - a_staged[0]) / levels
    floor_ms = float(levels * per_level / ghz / 1e6)
    alone_ms = cuda_ms(torch, lambda: kss.kinwave_sharded_sweep(*ops, one, beta), N_REP)
    others = np.arange(n) != deep
    print(f"  where K6's time goes ({what}, one traced launch at cap {tiles.cap}): span "
          f"{span / 1e3:.2f} us on the global clock at {ghz:.3f} GHz; {n} tile blocks, "
          f"{g1.size - n} padding blocks; the other tiles end "
          f"{((g1[:n][others].max() if others.any() else g0.min()) - g0.min()) / 1e3:.2f} us and "
          f"the padding {((g1[n:].max() if g1.size > n else g0.min()) - g0.min()) / 1e3:.2f} us "
          f"into the launch; the tile with the most levels ({levels} levels, widest "
          f"{int(tiles.widths[deep])}, {int(tiles.count[deep])} positions) takes "
          f"{(g1[deep] - g0[deep]) / 1e3:.2f} us in the launch and {(a1[0] - a0[0]) / 1e3:.2f} us "
          f"launched alone ({a_staged[0] / ghz / 1e3:.2f} us to its first level, {per_level:.0f} "
          f"cycles a level), {alone_ms:.4f} ms alone by CUDA events; chain floor {levels} levels "
          f"x {per_level:.0f} cycles = {floor_ms:.4f} ms", flush=True)
    return alone_ms, floor_ms, per_level


def schedule_text(ps):
    cuts = int((ps.cut_src != ps.n_shards * ps.chunk).sum())
    return (f"{ps.n_chunks} chunks of {ps.n_shards} x {ps.chunk}, window {ps.window}, K "
            f"{ps.cut_src.shape[1]}, {cuts} cut edges")


def phase_sharded(torch, ks, card, ctx, tmp):
    """Phase 10: RoutingKernel sharded on phase 8's catchment; see the module
    docstring. `ctx` is phase 8's context, `tmp` a scratch directory."""
    import dataclasses

    import numpy as np
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.driver import lisfloodexe
    from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
    from lisflood_tpu_torch.models.step import build_multi_step, build_step
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, write_catchment
    from lisflood_tpu_torch.ops import kinwave_sharded as kss
    from lisflood_tpu_torch.ops.routing_ops import overland_operands
    from lisflood_tpu_torch.parallel.partition import catchment_partition
    path, (cfg, params, state, aux) = ctx["path"], ctx["model"]
    forcing = ctx["forcing"]
    days = SHARDED_DAYS
    T = cfg.no_rout_steps
    cfg_s = dataclasses.replace(cfg, routing_kernel="sharded", num_shards=SHARDS)

    # the step (build_routers records the host seconds of its parts): one
    # warm-up day and one timed batch
    t0 = time.perf_counter()
    multi, p = build_multi_step(cfg_s, params, aux, output_keys=("ChanQAvg",) + RANK_REPORTS[1:],
                                dtype=torch.float32, device="cuda")
    s = multi.prepare_state(state)
    torch.cuda.synchronize()
    kin, tochan = multi.routers["kin"], multi.routers["tochan"]
    sec, stats = multi.routers["seconds"], multi.routers["partition_stats"]
    print(f"  sharded step built and moved to the card in {time.perf_counter() - t0:.1f} s; "
          f"pipeline {multi.step.pipeline}; host seconds: catchment_partition "
          f"{sec['partition']:.2f} ({len(stats['cut_edges'])} cut edges on the channel graph, "
          f"shard sizes {stats['shard_sizes'].tolist()}); "
          + "; ".join(f"{n}: schedule {sec['schedule_' + k]:.2f}, router {sec['router_' + k]:.2f} "
                      f"({schedule_text(r.ps)})"
                      for n, k, r in (("channel", "kin", kin), ("overland", "tochan", tochan))),
          flush=True)
    assert multi.step.pipeline == "substeps" and tochan.has_cuts and not tochan.no_edges
    reset_launches()
    s, _ = multi(s, stack_forcing(torch, forcing[:1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, outs = multi(s, stack_forcing(torch, forcing[1:1 + days]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / days * 1e3
    launches = launch_counts()
    print(f"  one warm-up step and a batch of {days}: {step_ms:.1f} ms/step = "
          f"{cfg.num_pixels / step_ms * 1e3:.4g} cells*steps/s on {card}; launches for "
          f"{days + 1} steps: {launches} (NoRoutSteps + 1 = {T + 1} of K6 a step)", flush=True)
    assert routing_launches(launches) == {"kinwave_substep": 0, "kinwave_sweep": 0,
                                          "kinwave_sharded": (days + 1) * (T + 1)}, launches
    assert launches["segment_sum"] > 0 and launches["soil_tail"] == days + 1, launches
    bad = [k for k, v in s.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    # the state and reports phase 14's ranks are held to, bit for bit
    ranks_reference = {k: v.cpu().numpy() for k, v in multi.natural_state(s).items()}
    ranks_reference.update({f"{k}@{i}": outs[k][i].cpu().numpy()
                            for k in RANK_REPORTS for i in range(days)})
    q = outs["ChanQAvg"]
    assert q.shape == (days, cfg.num_pixels) and bool(torch.isfinite(q).all())
    print(f"  every state entry finite ({len(s)} entries, natural); ChanQAvg mean "
          f"{float(q.mean()):.4g} m3/s", flush=True)
    busy = profile_step(torch, multi.step, s, forcing[0], step_ms)
    SYNCS["sharded"] = sync_count(torch, multi.step, s, forcing[0], "sharded")
    graph_figures(torch, card, "sharded", multi.stepper, multi.step, s, forcing, busy)
    SOIL_COUNTS["sharded"] = soil_tail_counts(torch, multi.step, s, forcing[0], "sharded")
    repeat_bitwise(torch, multi.step, multi.prepare_state(state), forcing, "sharded")
    position_catchments = p["kinp$Catchments"].cpu().numpy()

    # K6 on the land phase's overland operands and on one channel sub-step's
    beta = float(p["Beta"])
    pp = multi.step.step_params(forcing[0])
    d = multi.step.land_phase(s, forcing[0], pp)
    _, q0, lat, adx = overland_operands(cfg_s, pp, s, d)
    ops_o = tochan.sweep_operands(q0, lat, adx, beta)
    captured = []
    real = kss.kinwave_sharded_sweep

    def capture(*args):
        if not captured and args[0].shape[0] == 2:
            captured.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args[:2]))
        return real(*args)
    capture.launches, capture.last_plan = 0, None
    kss.kinwave_sharded_sweep = capture
    try:
        multi.step(s, forcing[0])
    finally:
        kss.kinwave_sharded_sweep = real
    ops_c = captured[0]
    for name, router in (("channel", kin), ("overland", tochan)):
        st = router.sweep_tiles().stats
        print(f"  K6 {name} tables at cap {router.sweep_tiles().cap}: {st['trees']} trees, the "
              f"largest {st['largest_tree']} cells, {st['levels']} levels at most in a tile; built "
              f"in {st['seconds']:.2f} s on the host with the step", flush=True)
    absd_o, plain_o, plan_o = sharded_held(torch, kss, tochan, ops_o, beta, 1e-5,
                                           "overland, 3 lanes, float32")
    absd_c, plain_c, plan_c = sharded_held(torch, kss, kin, ops_c, beta, 1e-5,
                                           "channel sub-step, 2 lanes, float32")
    ms, by_cap = {}, {}
    for name, router, ops in (("channel", kin, ops_c), ("overland", tochan, ops_o)):
        for cap in (router.sweep_tiles().cap, *SHARDED_CAPS):
            t = router.sweep_tiles(cap)
            by_cap[name, cap] = cuda_ms(torch, lambda: kss.kinwave_sharded_sweep(*ops, t, beta),
                                        N_REP)
        ms[name] = by_cap[name, router.sweep_tiles().cap]
    deep_ms, floor_ms, per_level = sharded_where(torch, kss, ops_c, kin.sweep_tiles(), beta,
                                                 "channel")
    deep_o, floor_o, _ = sharded_where(torch, kss, ops_o, tochan.sweep_tiles(), beta, "overland")
    edges = lambda r: int((r.ps.down_pos < r.ps.p_pad).sum())
    bound_c = sharded_bound(kin.ps, 2, torch.float32, edges(kin))
    bound_o = sharded_bound(tochan.ps, 3, torch.float32, edges(tochan))
    print(f"  K6 {ms['channel']:.4f} ms a channel launch, {ms['overland']:.4f} ms an overland "
          f"launch (mean of {N_REP}); by cap (channel, overland): "
          + ", ".join(f"{c}: {by_cap['channel', c]:.4f}, {by_cap['overland', c]:.4f}"
                      for c in (kin.sweep_tiles().cap, *SHARDED_CAPS))
          + f"; bounds {bound_c[0]:.4f} ms ({bound_c[1]}) and {bound_o[0]:.4f} ms ({bound_o[1]}); "
          f"chain floors {floor_ms:.4f} and {floor_o:.4f} ms; "
          f"{T * ms['channel'] + ms['overland']:.1f} ms of K6 a step in {T + 1} launches; card {card}",
          flush=True)
    del ops_o, ops_c, captured, d

    # the float32 sharded state after `days` days against phase 8's packed
    # step's after the same days from the same start (printed only)
    runs = {}
    for name, step in (("sharded", multi.step), ("packed", ctx["step"])):
        st = step.prepare_state(state)
        for f in forcing[:days]:
            st, _ = step(st, f)
        runs[name] = step.natural_state(st)
    diffs = sorted(((float((runs["sharded"][k].double() - v.double()).abs().max())
                     / max(float(v.double().abs().max()), 1e-30), k)
                    for k, v in runs["packed"].items() if v.is_floating_point()), reverse=True)
    print(f"  float32, {days} days from the same start, sharded against phase 8's packed "
          f"state, largest difference of each field's max: "
          + ", ".join(f"{k} {e:.3e}" for e, k in diffs[:5]), flush=True)
    single_step = multi.step
    del runs, multi, p, s
    torch.cuda.empty_cache()

    # lisfloodexe over the same days with RoutingKernel sharded
    out = os.path.join(tmp, "sharded")
    os.makedirs(out)
    settings = load_settings(path, sys_args=["-v"], vars_to_set={
        "Precision": "single", "PathOut": out, "RoutingKernel": "sharded",
        "RoutingShards": str(SHARDS), "StepEnd": f"{days:02d}/01/2000 00:00"})
    reset_launches()
    t0 = time.perf_counter()
    runner = lisfloodexe(settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_d = launch_counts()
    sec = runner.seconds
    run_s = sum(v for k, v in sec.items() if k not in ("build_model", "to_device"))
    print(f"  lisfloodexe with RoutingKernel sharded, {days} days at float32: {wall:.1f} s in all; "
          f"host seconds: build_model {sec['build_model']:.1f}, step built (partition, schedules, "
          f"routers) and state moved {sec['to_device']:.1f}; the run {run_s:.2f} (forcing "
          f"{sec['forcing']:.2f}, step calls {sec['steps']:.2f}, the step's capture "
          f"{sec['capture']:.2f}, copies to the host "
          f"{sec['to_host']:.2f}, reports {sec['report']:.2f}, close {sec['close']:.2f}); "
          f"{run_s / days * 1e3:.1f} ms per simulated day; launches {launches_d}", flush=True)
    assert runner.config.routing_kernel == "sharded" and runner.config.num_shards == SHARDS
    assert routing_launches(launches_d) == {"kinwave_substep": 0, "kinwave_sweep": 0,
                                            "kinwave_sharded": days * (T + 1)}, launches_d
    assert launches_d["soil_tail"] == days, launches_d
    assert all(bool(torch.isfinite(v).all()) for v in runner.state.values()
               if v.is_floating_point())
    assert "dis.tss" in os.listdir(out)
    del runner
    torch.cuda.empty_cache()

    # float64 at synthetic 240x200 (cut edges on the channel graph)
    mid = build_synthetic_model(240, 200)
    graph = mid[3]["graph_kin"]
    router = kss.ShardedRouter(graph, catchment_partition(graph, SHARDS)[0], device="cuda")
    rng = np.random.default_rng(0)
    lanes = [torch.as_tensor(rng.uniform(lo, hi, (2, graph.num_pixels)), device="cuda")
             for lo, hi in ((0, 100), (0, 5), (1e-3, 1e3))]
    ops64 = router.sweep_operands(*lanes, beta)
    print(f"  synthetic 240x200, float64: {schedule_text(router.ps)}", flush=True)
    assert router.has_cuts
    sharded_held(torch, kss, router, ops64, beta, 1e-12, "synthetic 240x200, 2 lanes, float64")
    del router, ops64, lanes

    # the float64 sharded step on the card against the CPU, 96x80 catchment
    small = load_settings(write_catchment(os.path.join(tmp, "sharded_small"), 96, 80, seed=0,
                                          n_steps=days, nc_format="classic"),
                          vars_to_set={"RoutingKernel": "sharded",
                                       "RoutingShards": str(SHARDS)})
    cfg_m, params_m, state_m, aux_m = build_model(small)
    f_m = meteo_forcing(small, cfg_m, aux_m)[:days]
    ends = {}
    for dev in ("cuda", "cpu"):
        step, _ = build_step(cfg_m, params_m, aux_m, dtype=torch.float64, device=dev)
        st = step.prepare_state(state_m)
        for f in f_m:
            st, _ = step(st, to_device(f, dev, torch.float64))
        ends[dev] = {k: v.cpu() for k, v in step.natural_state(st).items()}
    assert step.routers["tochan"].has_cuts
    worst = max((field_gate(k, v, ends["cuda"][k], ends["cpu"]), k)
                for k, v in ends["cpu"].items() if v.is_floating_point())
    print(f"  96x80 catchment, float64, {days} sharded steps on the card against the CPU: worst "
          f"{worst[0]:.3e} ({worst[1]}) of each field's max (tol 1e-10); overland "
          f"{schedule_text(step.routers['tochan'].ps)}", flush=True)
    assert worst[0] <= 1e-10, worst
    return {"ms": ms["channel"], "bound_ms": bound_c[0], "bound_by": bound_c[1],
            "launches": launches["kinwave_sharded"], "plain_ms": plain_c,
            "max_abs_err": max(absd_c, absd_o), "ms_overland": ms["overland"],
            "bound_ms_overland": bound_o[0], "plain_ms_overland": plain_o,
            "chain_floor_ms": floor_ms, "chain_floor_ms_overland": floor_o,
            "deep_tile_ms": deep_ms, "deep_tile_ms_overland": deep_o,
            "cycles_per_level": float(per_level), "tiles": plan_c["tiles"],
            "ring_tiles": plan_c["ring_tiles"], "tiles_overland": plan_o["tiles"],
            "step_ms": step_ms, "position_catchments": position_catchments,
            "single_step": single_step, "ranks_reference": ranks_reference,
            "k7_per_step": launches["segment_sum"] / (days + 1),
            "plain_shape": "1200x1000 catchment, one channel sub-step (and the overland sweep), "
                           "float32"}


# days phase 11 runs the scan step and lisfloodexe
SCAN_DAYS = 3
# the second tile cap at which phase 11 checks K6's bits on natural tables
SCAN_CAPS = (256,)


def phase_scan(torch, ks, card, ctx, tmp):
    """Phase 11: RoutingKernel scan on phase 8's catchment; see the module
    docstring. `ctx` is phase 8's context, `tmp` a scratch directory."""
    import dataclasses

    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.driver import lisfloodexe
    from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
    from lisflood_tpu_torch.models.step import build_multi_step, build_step
    from lisflood_tpu_torch.models.synthetic import write_catchment
    from lisflood_tpu_torch.ops import kinwave as kw
    from lisflood_tpu_torch.ops import kinwave_sharded as kss
    from lisflood_tpu_torch.ops.routing_ops import overland_operands
    path, (cfg, params, state, aux) = ctx["path"], ctx["model"]
    forcing = ctx["forcing"]
    days = SCAN_DAYS
    T = cfg.no_rout_steps
    cfg_s = dataclasses.replace(cfg, routing_kernel="scan", num_shards=1)

    t0 = time.perf_counter()
    multi, p = build_multi_step(cfg_s, params, aux, output_keys=("ChanQAvg",) + RANK_REPORTS[1:],
                                dtype=torch.float32, device="cuda")
    s = multi.prepare_state(state)
    torch.cuda.synchronize()
    kin, tochan = multi.routers["kin"], multi.routers["tochan"]
    sec = multi.routers["seconds"]
    print(f"  scan step built and moved to the card in {time.perf_counter() - t0:.1f} s; "
          f"pipeline {multi.step.pipeline}; host seconds of build_routers: channel "
          f"{sec['router_kin']:.2f}, overland {sec['router_tochan']:.2f} (each router with K6's "
          f"tables); segment orders {multi.step.order_seconds:.2f}", flush=True)
    assert multi.step.pipeline == "substeps" and isinstance(kin, kw.ScanRouter)
    assert not kin.no_edges and not tochan.no_edges
    for name, router in (("channel", kin), ("overland", tochan)):
        st = router.sweep_tiles().stats
        plan = kss.sharded_plan(router.sweep_tiles(), *kss._smem(0, 0), 2 if name == "channel"
                                else 3, 4)
        print(f"  K6 {name} tables on the natural graph at cap {router.sweep_tiles().cap}: "
              f"{st['trees']} trees, the largest {st['largest_tree']} cells, {st['levels']} levels "
              f"at most in a tile, {router.sweep_tiles().n_tiles} tiles, {plan['ring_tiles']} "
              f"through the ring, {plan['global_tiles']} in global memory; built in "
              f"{st['seconds']:.2f} s on the host with the step; {router.ps.n_chunks} chunks of "
              f"{router.ps.chunk} in the schedule", flush=True)
    reset_launches()
    s, _ = multi(s, stack_forcing(torch, forcing[:1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, outs = multi(s, stack_forcing(torch, forcing[1:1 + days]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / days * 1e3
    launches = launch_counts()
    print(f"  one warm-up step and a batch of {days}: {step_ms:.1f} ms/step = "
          f"{cfg.num_pixels / step_ms * 1e3:.4g} cells*steps/s on {card}; launches for "
          f"{days + 1} steps: {launches} (NoRoutSteps + 1 = {T + 1} of K6 a step)", flush=True)
    assert routing_launches(launches) == {"kinwave_substep": 0, "kinwave_sweep": 0,
                                          "kinwave_sharded": (days + 1) * (T + 1)}, launches
    assert launches["segment_sum"] > 0 and launches["soil_tail"] == days + 1, launches
    bad = [k for k, v in s.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    assert not any(k.startswith("pk$") for k in s)
    # the state and reports phase 14's scan ranks are held to, bit for bit
    ranks_reference = {k: v.cpu().numpy() for k, v in multi.natural_state(s).items()}
    ranks_reference.update({f"{k}@{i}": outs[k][i].cpu().numpy()
                            for k in RANK_REPORTS for i in range(days)})
    q = outs["ChanQAvg"]
    assert q.shape == (days, cfg.num_pixels) and bool(torch.isfinite(q).all())
    print(f"  every state entry finite ({len(s)} entries, natural); ChanQAvg mean "
          f"{float(q.mean()):.4g} m3/s", flush=True)
    busy = profile_step(torch, multi.step, s, forcing[0], step_ms)
    SYNCS["scan"] = sync_count(torch, multi.step, s, forcing[0], "scan")
    graph_figures(torch, card, "scan", multi.stepper, multi.step, s, forcing, busy)
    SOIL_COUNTS["scan"] = soil_tail_counts(torch, multi.step, s, forcing[0], "scan")
    repeat_bitwise(torch, multi.step, multi.prepare_state(state), forcing, "scan")

    # K6 on the natural tables: the land phase's overland operands and one
    # channel sub-step's
    beta = float(p["Beta"])
    pp = multi.step.step_params(forcing[0])
    d = multi.step.land_phase(s, forcing[0], pp)
    _, q0, lat, adx = overland_operands(cfg_s, pp, s, d)
    ops_o = tochan.sweep_operands(q0, lat, adx, beta)
    captured = []
    real = kss.kinwave_sharded_sweep

    def capture(*args):
        if not captured and args[0].shape[0] == 2:
            captured.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args[:2]))
        return real(*args)
    kw.kinwave_sharded_sweep = capture
    try:
        multi.step(s, forcing[0])
    finally:
        kw.kinwave_sharded_sweep = real
    ops_c = captured[0]
    absd_o, plain_o, plan_o = sharded_held(torch, kss, tochan, ops_o, beta, 1e-5,
                                           "scan, overland, 3 lanes, float32", caps=SCAN_CAPS)
    absd_c, plain_c, plan_c = sharded_held(torch, kss, kin, ops_c, beta, 1e-5,
                                           "scan, channel sub-step, 2 lanes, float32",
                                           caps=SCAN_CAPS)
    ms = {name: cuda_ms(torch, lambda: kss.kinwave_sharded_sweep(*ops, r.sweep_tiles(), beta),
                        N_REP)
          for name, r, ops in (("channel", kin, ops_c), ("overland", tochan, ops_o))}
    deep_ms, floor_ms, per_level = sharded_where(torch, kss, ops_c, kin.sweep_tiles(), beta,
                                                 "scan, channel")
    edges = lambda r: int((r.ps.down_pos < r.ps.num_pixels).sum())
    bound_c = sharded_bound(kin.ps, 2, torch.float32, edges(kin))
    bound_o = sharded_bound(tochan.ps, 3, torch.float32, edges(tochan))
    print(f"  K6 on the natural tables {ms['channel']:.4f} ms a channel launch, "
          f"{ms['overland']:.4f} ms an overland launch (mean of {N_REP}); bounds "
          f"{bound_c[0]:.4f} ms ({bound_c[1]}) and {bound_o[0]:.4f} ms ({bound_o[1]}); chain floor "
          f"{floor_ms:.4f} ms; {T * ms['channel'] + ms['overland']:.1f} ms of K6 a step in "
          f"{T + 1} launches; card {card}", flush=True)
    del ops_o, ops_c, captured, d

    # the float32 scan state after `days` days against phase 8's packed
    # step's after the same days from the same start (printed only)
    runs = {}
    for name, step in (("scan", multi.step), ("packed", ctx["step"])):
        st = step.prepare_state(state)
        for f in forcing[:days]:
            st, _ = step(st, f)
        runs[name] = step.natural_state(st)
    diffs = sorted(((float((runs["scan"][k].double() - v.double()).abs().max())
                     / max(float(v.double().abs().max()), 1e-30), k)
                    for k, v in runs["packed"].items() if v.is_floating_point()), reverse=True)
    print(f"  float32, {days} days from the same start, scan against phase 8's packed state, "
          f"largest difference of each field's max: "
          + ", ".join(f"{k} {e:.3e}" for e, k in diffs[:5]), flush=True)
    single_step = multi.step
    del runs, multi, p, s
    torch.cuda.empty_cache()

    # lisfloodexe over the same days with RoutingKernel scan
    out = os.path.join(tmp, "scan")
    os.makedirs(out)
    settings = load_settings(path, sys_args=["-v"], vars_to_set={
        "Precision": "single", "PathOut": out, "RoutingKernel": "scan",
        "StepEnd": f"{days:02d}/01/2000 00:00"})
    reset_launches()
    t0 = time.perf_counter()
    runner = lisfloodexe(settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_d = launch_counts()
    sec = runner.seconds
    run_s = sum(v for k, v in sec.items() if k not in ("build_model", "to_device"))
    print(f"  lisfloodexe with RoutingKernel scan, {days} days at float32: {wall:.1f} s in all; "
          f"host seconds: build_model {sec['build_model']:.1f}, step built (routers, tables) and "
          f"state moved {sec['to_device']:.1f}; the run {run_s:.2f} (forcing "
          f"{sec['forcing']:.2f}, step calls {sec['steps']:.2f}, the step's capture "
          f"{sec['capture']:.2f}, copies to the host "
          f"{sec['to_host']:.2f}, reports {sec['report']:.2f}, close {sec['close']:.2f}); "
          f"{run_s / days * 1e3:.1f} ms per simulated day; launches {launches_d}", flush=True)
    assert runner.config.routing_kernel == "scan"
    assert routing_launches(launches_d) == {"kinwave_substep": 0, "kinwave_sweep": 0,
                                            "kinwave_sharded": days * (T + 1)}, launches_d
    assert launches_d["soil_tail"] == days, launches_d
    assert all(bool(torch.isfinite(v).all()) for v in runner.state.values()
               if v.is_floating_point())
    assert "dis.tss" in os.listdir(out)
    del runner
    torch.cuda.empty_cache()

    # the float64 scan step on the card against the CPU, 96x80 catchment
    small = load_settings(write_catchment(os.path.join(tmp, "scan_small"), 96, 80, seed=0,
                                          n_steps=days, nc_format="classic"),
                          vars_to_set={"RoutingKernel": "scan"})
    cfg_m, params_m, state_m, aux_m = build_model(small)
    f_m = meteo_forcing(small, cfg_m, aux_m)[:days]
    ends = {}
    for dev in ("cuda", "cpu"):
        step, _ = build_step(cfg_m, params_m, aux_m, dtype=torch.float64, device=dev)
        st = step.prepare_state(state_m)
        for f in f_m:
            st, _ = step(st, to_device(f, dev, torch.float64))
        ends[dev] = {k: v.cpu() for k, v in step.natural_state(st).items()}
    assert isinstance(step.routers["kin"], kw.ScanRouter)
    worst = max((field_gate(k, v, ends["cuda"][k], ends["cpu"]), k)
                for k, v in ends["cpu"].items() if v.is_floating_point())
    print(f"  96x80 catchment, float64, {days} scan steps on the card against the CPU: worst "
          f"{worst[0]:.3e} ({worst[1]}) of each field's max (tol 1e-10)", flush=True)
    assert worst[0] <= 1e-10, worst
    return {"ms": ms["channel"], "bound_ms": bound_c[0], "bound_by": bound_c[1],
            "launches": launches["kinwave_sharded"], "plain_ms": plain_c,
            "max_abs_err": max(absd_c, absd_o), "ms_overland": ms["overland"],
            "bound_ms_overland": bound_o[0], "plain_ms_overland": plain_o,
            "chain_floor_ms": floor_ms, "deep_tile_ms": deep_ms,
            "cycles_per_level": float(per_level), "tiles": plan_c["tiles"],
            "ring_tiles": plan_c["ring_tiles"], "tiles_overland": plan_o["tiles"],
            "step_ms": step_ms, "single_step": single_step, "ranks_reference": ranks_reference,
            "k7_per_step": launches["segment_sum"] / (days + 1),
            "plain_shape": "1200x1000 catchment, natural tables, one channel sub-step (and the "
                           "overland sweep), float32"}


# members of phase 13's ensembles on the sharded and the scan router, the
# days their steps are timed, and the days and filter step of its
# MonteCarlo/EnKF run from the settings
ROUTER_MEMBERS = 4
ROUTER_DAYS = 3
ROUTER_FILTER_STEP = 2


def capture_k6(torch, step, s, f):
    """The operands (const, adx) of the first channel sub-step's K6 launch in
    one step of `step` (sharded or scan router), copied as they enter it."""
    from lisflood_tpu_torch.ops import kinwave as kw
    from lisflood_tpu_torch.ops import kinwave_sharded as kss
    captured = []
    real = kss.kinwave_sharded_sweep

    def capture(*args):
        if not captured and args[0].shape[0] == 2:
            captured.append(tuple(a.clone() for a in args[:2]))
        return real(*args)
    capture.launches, capture.last_plan = 0, None
    kss.kinwave_sharded_sweep = kw.kinwave_sharded_sweep = capture
    try:
        step(s, f)
    finally:
        kss.kinwave_sharded_sweep = kw.kinwave_sharded_sweep = real
    return captured[0]


def members_bitwise(torch, ens, single, forcing, n=2):
    """Each member of the ensemble `ens` after `n` steps from its state
    against the single model's `single` step from the same state: the
    state entries of every member that differ in any bit."""
    from lisflood_tpu_torch.models.ensemble import member_state, tile_forcing
    starts = ens.member_states()
    s_e = ens.fold(starts)
    for f in forcing[:n]:
        s_e, _ = ens.step(s_e, tile_forcing(f, ens.n, ens.pixels))
    differ = []
    for m, start in enumerate(starts):
        s1 = single.prepare_state(start)
        for f in forcing[:n]:
            s1, _ = single(s1, f)
        mine = member_state(s_e, m, ens.n, 0)
        differ += [(m, k) for k, v in s1.items() if not tensor_bits_equal(torch, mine[k], v)]
    torch.cuda.synchronize()
    return differ, len(s1)


def phase_ensemble_routers(torch, ks, card, ctx, tmp, singles):
    """Phase 13: the folded ensemble on RoutingKernel sharded and scan; see
    the module docstring. `ctx` is phase 8's context, `singles` phases 10 and
    11's single steps and K6 figures by router."""
    import dataclasses

    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.models import graph
    from lisflood_tpu_torch.models.driver import lisfloodexe
    from lisflood_tpu_torch.models.ensemble import EnsembleRunner, tile_forcing
    from lisflood_tpu_torch.ops import kinwave_sharded as kss
    from lisflood_tpu_torch.ops.routing_ops import overland_operands
    path, (cfg, params, state, aux) = ctx["path"], ctx["model"]
    forcing = ctx["forcing"]
    M, T, P, days = ROUTER_MEMBERS, cfg.no_rout_steps, cfg.num_pixels, ROUTER_DAYS
    figures = {}
    for router, fields in (("sharded", {"routing_kernel": "sharded", "num_shards": SHARDS}),
                           ("scan", {"routing_kernel": "scan", "num_shards": 1})):
        single, k6_single = singles[router]
        model_aux = aux
        if router == "sharded":
            # the single model's partition and schedules (phase 10's), replicated
            r = single.routers
            model_aux = {**aux, "sharded": {"kin": r["kin"].ps, "tochan": r["tochan"].ps,
                                            "shard_of": r["shard_of"],
                                            "partition_stats": r["partition_stats"],
                                            "seconds": {}}}
        t0 = time.perf_counter()
        ens = EnsembleRunner((dataclasses.replace(cfg, **fields), params, state, model_aux), M,
                             dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        kin, tochan = ens.step.routers["kin"], ens.step.routers["tochan"]
        sec = ens.step.routers["seconds"]
        print(f"  {router}, {M} members of {P} cells: the folded model built, moved and perturbed "
              f"in {build_s:.1f} s; host seconds: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sec.items())
              + f", segment orders {ens.step.order_seconds:.2f}; channel "
              + (schedule_text(kin.ps) if router == "sharded" else f"{kin.ps.n_chunks} chunks")
              + f"; K6 tables: channel {kin.sweep_tiles().n_tiles} tiles "
              f"({kin.sweep_tiles().stats['trees']} trees, the largest "
              f"{kin.sweep_tiles().stats['largest_tree']} cells, "
              f"{kin.sweep_tiles().stats['levels']} levels), overland "
              f"{tochan.sweep_tiles().n_tiles} tiles", flush=True)
        assert ens.step.pipeline == "substeps" and not tochan.no_edges
        if router == "sharded":
            assert kin.ps.n_shards == M * SHARDS and tochan.has_cuts
        stack = stack_forcing(torch, forcing[:1 + days])
        reset_launches()
        ens.advance({k: v[:1] for k, v in stack.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ens.advance({k: v[1:] for k, v in stack.items()})
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / days * 1e3
        launches = launch_counts()
        print(f"  one warm-up step and a batch of {days}: {step_ms:.1f} ms per ensemble step, "
              f"{step_ms / M:.1f} ms per member-step = {M * P / step_ms * 1e3:.4g} member "
              f"cells*steps/s on {card}; launches for {days + 1} steps: {launches}", flush=True)
        assert routing_launches(launches) == {"kinwave_substep": 0, "kinwave_sweep": 0,
                                              "kinwave_sharded": (days + 1) * (T + 1)}, launches
        assert launches["soil_tail"] == days + 1 and launches["segment_sum"] > 0, launches
        bad = [k for k, v in ens.state.items()
               if v.is_floating_point() and not bool(torch.isfinite(v).all())]
        assert not bad, f"non-finite state: {bad}"
        f0 = tile_forcing(forcing[0], M, P)
        busy = profile_step(torch, ens.step, ens.state, f0, step_ms)
        syncs = SYNCS[f"{router} ensemble"] = sync_count(torch, ens.step, ens.state, f0,
                                                          f"{router} ensemble")
        graph_figures(torch, card, f"{router} ensemble", ens.stepper,
                      lambda s, f: ens.step(s, tile_forcing(f, M, P)), ens.state, forcing,
                      busy)
        # the graph's pool back to the card for the checks below
        ens.stepper = graph.stepper(ens.step, ens.stepper.prepare)
        torch.cuda.empty_cache()
        SOIL_COUNTS[f"{router} ensemble"] = soil_tail_counts(torch, ens.step, ens.state, f0,
                                                             f"{router} ensemble")
        differ, n_keys = members_bitwise(torch, ens, single, forcing)
        print(f"  each of the {M} members against phase {10 if router == 'sharded' else 11}'s "
              f"single step from the same state, 2 steps: {n_keys} state entries bitwise equal: "
              f"{not differ}{'' if not differ else f' (differ: {differ[:8]})'}", flush=True)
        assert not differ, differ
        repeat_bitwise(torch, ens.step, ens.fold(ens.member_states()),
                       [tile_forcing(f, M, P) for f in forcing[:REPEAT_STEPS]],
                       f"{router} ensemble")

        # K6 on the folded tables: one channel sub-step's operands and the
        # overland operands of the land phase
        beta = float(ens.params["Beta"])
        ops_c = capture_k6(torch, ens.step, ens.state, f0)
        absd, plain_ms, plan_c = sharded_held(torch, kss, kin, ops_c, beta, 1e-5,
                                              f"{router} ensemble, channel sub-step, 2 lanes, "
                                              f"{M} members, float32", caps=())
        pp = ens.step.step_params(f0)
        d = ens.step.land_phase(ens.state, f0, pp)
        _, q0, lat, adx = overland_operands(ens.cfg, pp, ens.state, d)
        ops_o = tochan.sweep_operands(q0, lat, adx, beta)
        q_o = kss.kinwave_sharded_sweep(*ops_o, tochan.sweep_tiles(), beta)
        twice_o = same_bits({"q": q_o},
                            {"q": kss.kinwave_sharded_sweep(*ops_o, tochan.sweep_tiles(), beta)})
        assert twice_o
        ms = {name: cuda_ms(torch, lambda: kss.kinwave_sharded_sweep(*ops, r.sweep_tiles(), beta),
                            N_REP)
              for name, r, ops in (("channel", kin, ops_c), ("overland", tochan, ops_o))}
        deep_ms, floor_ms, per_level = sharded_where(torch, kss, ops_c, kin.sweep_tiles(), beta,
                                                     f"{router} ensemble, channel")
        edges = lambda r: int((r.ps.down_pos < r.ps.p_pad).sum())
        bound_c = sharded_bound(kin.ps, 2, torch.float32, edges(kin))
        print(f"  K6 on the folded tables: {ms['channel']:.4f} ms a channel launch for {M} "
              f"members ({k6_single['ms']:.4f} for one model in phase "
              f"{10 if router == 'sharded' else 11}; {ms['channel'] / M:.4f} per member), "
              f"{ms['overland']:.4f} ms an overland launch ({k6_single['ms_overland']:.4f}), the "
              f"overland bits the same in two runs; chain floor {floor_ms:.4f} ms, the deepest "
              f"tile alone {deep_ms:.4f} ms; bound {bound_c[0]:.4f} ms ({bound_c[1]}) over "
              f"{kin.ps.num_pixels} positions; {T * ms['channel'] + ms['overland']:.1f} ms of K6 an "
              f"ensemble step in {T + 1} launches; card {card}", flush=True)
        figures[router] = {"ms": ms["channel"], "ms_overland": ms["overland"],
                           "bound_ms": bound_c[0], "bound_by": bound_c[1],
                           "plain_ms": plain_ms, "max_abs_err": absd,
                           "launches": launches["kinwave_sharded"], "chain_floor_ms": floor_ms,
                           "deep_tile_ms": deep_ms, "cycles_per_level": float(per_level),
                           "tiles": plan_c["tiles"], "ring_tiles": plan_c["ring_tiles"],
                           "step_ms": step_ms, "member_step_ms": step_ms / M,
                           "syncs": syncs, "members": M}
        del ens, ops_c, ops_o, q_o, d
        torch.cuda.empty_cache()

    # MonteCarlo and EnKF from the settings with RoutingKernel sharded
    out = os.path.join(tmp, "ensemble_sharded")
    os.makedirs(out)
    settings = load_settings(path, sys_args=["-v"], opts_to_set=["MonteCarlo", "EnKF"],
                             vars_to_set={"Precision": "single", "PathOut": out,
                                          "EnsMembers": str(M),
                                          "FilterSteps": str(ROUTER_FILTER_STEP),
                                          "LZState": "", "RoutingKernel": "sharded",
                                          "RoutingShards": str(SHARDS),
                                          "StepEnd": f"{days:02d}/01/2000 00:00"})
    assert settings.ens_members == M and settings.filter_steps == [ROUTER_FILTER_STEP]
    reset_launches()
    t0 = time.perf_counter()
    runner = lisfloodexe(settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ens = runner.ensemble
    es = ens.seconds
    print(f"  MonteCarlo + EnKF, RoutingKernel sharded, {M} members x {days} days at float32: "
          f"{wall:.1f} s in all (build_model {runner.seconds['build_model']:.1f}, the folded "
          f"model built, moved and perturbed {es['build']:.1f}, the days {es['days']:.2f}, the "
          f"step's capture {es['capture']:.2f}, one "
          f"EnKF analysis {es['enkf']:.2f}, dumps {es['dumps']:.2f}); "
          f"{es['days'] / (days * M) * 1e3:.1f} ms per member-day; launches {launches}; card "
          f"{card}", flush=True)
    assert ens.cfg.routing_kernel == "sharded" and ens.n == M
    assert routing_launches(launches) == {"kinwave_substep": 0, "kinwave_sweep": 0,
                                          "kinwave_sharded": days * (T + 1)}, launches
    assert launches["soil_tail"] == days, launches
    assert sorted(os.listdir(out)) == [str(m) for m in range(1, M + 1)] + ["stateVar"]
    assert all(bool(torch.isfinite(v).all()) for v in ens.state.values() if v.is_floating_point())
    figures["sharded"]["member_day_ms"] = es["days"] / (days * M) * 1e3
    figures["sharded"]["enkf_s"] = es["enkf"]
    del runner, ens
    torch.cuda.empty_cache()
    return figures


def phase_segment_sums(torch, card, ctx, position_catchments):
    """Phase 12: K7 on phase 8's catchment's segments; see the module
    docstring. `position_catchments` is phase 10's kinp$Catchments."""
    import numpy as np
    cfg, params = ctx["model"][:2]
    P = cfg.num_pixels
    # the water-use regions write_catchment writes with the wateruse option:
    # the grid's west and east halves
    cols = np.asarray(params["landIdx"], np.int64) % cfg.grid_cols
    regions = (cols >= cfg.grid_cols // 2).astype(np.int64)
    print(f"  {ctx['sums_per_step']:g} calls of K7 a step on phase 8's path", flush=True)
    was = lambda name: PREVIOUS_MS["segment_sum"]["catchment " + name]
    return {
        "Catchments": k7_figures(torch, card, "the catchment's Catchments", params["Catchments"],
                                 cfg.num_catchments, previous=was("Catchments")),
        "kinp$Catchments": k7_figures(torch, card, "the sharded loop's kinp$Catchments",
                                      position_catchments, cfg.num_catchments + 1,
                                      previous=was("kinp$Catchments")),
        "WUseRegionC": k7_figures(torch, card, "WUseRegionC (west and east halves)", regions, 2,
                                  previous=was("WUseRegionC")),
        "downEva": k7_figures(torch, card, "the catchment's downEva", params["downEva"], P + 1,
                              count=P, previous=was("downEva"))}


# steps of each path that repeat_bitwise runs twice
REPEAT_STEPS = 3


def tensor_bits_equal(torch, a, b):
    """Whether two tensors hold the same bits (NaNs included)."""
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in bits and b.dtype == a.dtype:
        return torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))
    return torch.equal(a, b)


def repeat_bitwise(torch, step, state, forcing, what, n=REPEAT_STEPS):
    """Two runs of `n` steps of `step` from the same prepared `state` on the
    same forcing, with no deterministic mode: every state entry and every
    report (the step's diagnostics) of each step must have the same bits."""
    first = []
    s = dict(state)
    for f in forcing[:n]:
        s, d = step(s, f)
        first.append((s, d))
    s = dict(state)
    differ, counted = [], (0, 0)
    for i, f in enumerate(forcing[:n]):
        s, d = step(s, f)
        s0, d0 = first[i]
        pairs = [(k, v, s[k]) for k, v in s0.items() if torch.is_tensor(v)]
        reports = [(k, v, d[k]) for k, v in d0.items() if torch.is_tensor(v) and k not in s0]
        differ += [(i + 1, k) for k, a, b in pairs + reports if not tensor_bits_equal(torch, a, b)]
        counted = (len(pairs), len(reports))
    del first
    print(f"  {what}: two runs of {n} steps from the same state, no deterministic mode: "
          f"{counted[0]} state entries and {counted[1]} reports a step bitwise equal: "
          f"{not differ}{'' if not differ else f' (differ: {differ[:8]})'}", flush=True)
    assert not differ, differ


# K7's figures of each segment set in the kernels line
K7_KEYS = ("ms", "kernels_per_call", "bound_ms", "library_ms", "segments",
           "largest")


def k7_figures(torch, card, what, seg, n, count=None, order=None, seed=0, previous=None):
    """K7 (csrc/segment_sum.cu) on the segment array `seg` (n segments; the
    totals of those below `count`, or spread back to the members where
    every segment is summed) with float32 values drawn from `seed`, through
    the order `order` (built here on the card if None): its segments,
    members, largest segment, pieces and the kernel's warp items; the same
    bits in two runs, through a second order of the same segments built
    apart (its own tables, tickets and scratch) between calls of the first,
    and against its plain version (segment_sum.segment_sum) on the card; the
    kernels a call launches (one, two for a spread over a segment of more
    than one piece); its time (CUDA events, mean of N_REP) beside
    `previous`, the time recorded before K7's redesign (printed, not
    returned), its bound by bytes (the
    values and the permutation read, the totals and the spread written, at
    PEAK_BYTES) and the library time of index_add_ plus the gather, atomic
    and under torch.use_deterministic_algorithms. Returns the figures."""
    import numpy as np
    from lisflood_tpu_torch.ops import segment_sum as ss
    seg = np.asarray(seg, np.int64)
    order = order or ss.SegmentOrder.build(seg, n, count, "cuda")
    spread = order.count == order.num_segments
    fn = ss.segment_spread if spread else ss.segment_total
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.lognormal(0, 2, order.size).astype(np.float32), device="cuda")
    a, b = fn(v, order), fn(v, order)
    kernels = ss.segment_total.last_kernels
    other = ss.SegmentOrder.build(seg, order.num_segments, order.count, "cuda")
    apart = [fn(v, other), fn(v, order), fn(v, other)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ss.segment_sum(v, order)
    plain = plain[order.segments.long()] if spread else plain
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    twice, bitwise = tensor_bits_equal(torch, a, b), tensor_bits_equal(torch, a, plain)
    orders = all(tensor_bits_equal(torch, a, x) for x in apart)
    ms = cuda_ms(torch, lambda: fn(v, order), N_REP)
    seg_t = torch.as_tensor(seg, device="cuda")

    def library():
        totals = v.new_zeros(n).index_add_(0, seg_t, v)
        return totals[seg_t] if spread else totals[:order.count]
    lib_ms = cuda_ms(torch, library, N_REP)
    torch.use_deterministic_algorithms(True)
    try:
        lib_det_ms = cuda_ms(torch, library, N_REP)
    finally:
        torch.use_deterministic_algorithms(False)
    lib_rel = float((library() - a).abs().max() / a.abs().max().clamp_min(1e-30))
    nbytes = 4 * (order.size + order.perm.numel() + order.count + (order.size if spread else 0))
    bound_ms = nbytes / PEAK_BYTES * 1e3
    adds_ms = order.perm.numel() / PEAK_FLOPS["float32"] * 1e3
    st = order.stats
    want = 2 if spread and order.n_multi_items else 1
    was = "" if previous is None else f" (recorded before the redesign: {previous:.4f} ms)"
    print(f"  K7 on {what}: {st['segments']} segments, {st['members']} members, the largest "
          f"{st['largest']}, {st['pieces']} pieces, {st['warp_items']} warp items, "
          f"{st['multi_segments']} segments of several pieces, order built in "
          f"{order.stats['seconds']:.2f} s on the host; {'spread' if spread else 'totals'}: "
          f"{kernels} kernel launches a call; the same bits in two runs: {twice}, through a "
          f"second order between calls of the first: {orders}, bitwise equal to the plain "
          f"version: {bitwise}; K7 {ms:.4f} ms a call (mean of {N_REP}){was}, bound "
          f"{bound_ms:.4f} ms (bytes: {nbytes / 1e6:.1f} MB; {order.perm.numel()} adds "
          f"{adds_ms:.5f} ms); index_add_ and gather {lib_ms:.4f} ms atomic, {lib_det_ms:.4f} ms "
          f"deterministic (rel diff {lib_rel:.2e}); plain version {plain_ms:.1f} ms; card {card}",
          flush=True)
    assert twice and bitwise and orders, (twice, bitwise, orders)
    assert kernels == want, (kernels, want)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "library_deterministic_ms": lib_det_ms, "plain_ms": plain_ms,
            "max_abs_err": float((a - plain).abs().max()), "kernels_per_call": kernels,
            "segments": st["segments"], "largest": st["largest"],
            "order_build_s": st["seconds"]}


def soil_tail_operands(torch, step, s, f, p=None):
    """The operands the land phase of `step` (with the parameters `p`, the
    step's by default) gives the soil tail (K8) from state `s` and forcing
    `f`, copied as they enter it, and the land phase's diagnostics."""
    from lisflood_tpu_torch.ops import physics
    from lisflood_tpu_torch.ops.soil_tail import SOIL_KEYS
    captured = []
    real = physics.soil_tail

    def capture(aw, seep, no_subs, dt_sub, q):
        captured.append((tuple(x.clone() for x in aw), tuple(x.clone() for x in seep),
                         no_subs.clone(), dt_sub.clone(), {k: q[k] for k in SOIL_KEYS}))
        return real(aw, seep, no_subs, dt_sub, q)
    physics.soil_tail = capture
    try:
        d = step.land_phase(s, f, p)
    finally:
        physics.soil_tail = real
    assert len(captured) == 1, len(captured)
    return captured[0], d


def soil_tail_bound(ops):
    """(bound_ms, bound_by) of K8 on `ops`, counted from what this run's data
    needs: every lane's count read (4 bytes), and a lane that sub-steps its
    operands read and its sums written (SOIL_VALUES values and its masks), at
    PEAK_BYTES, against FLOPS_SOIL_SUBSTEP for each of its no_subs - 1
    sub-steps (a pow as POW_FLOPS) over the non-tensor peak of the type."""
    aw, seep, no_subs, dt_sub, q = ops
    name = str(dt_sub.dtype).replace("torch.", "")
    multi = int((no_subs > 1).sum())
    substeps = int((no_subs.long() - 1).clamp_min(0).sum())
    nbytes = 4 * no_subs.numel() + multi * (SOIL_VALUES * dt_sub.element_size() + SOIL_MASK_BYTES)
    plain, pows = FLOPS_SOIL_SUBSTEP
    flops = substeps * (plain + pows * POW_FLOPS[name])
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[name] * 1e3
    print(f"  K8 bound: {nbytes / 1e6:.2f} MB -> {t_bytes:.5f} ms; {substeps} lane sub-steps, "
          f"{flops / 1e9:.4f} GFLOP ({name}) -> {t_ops:.5f} ms", flush=True)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def soil_tail_figures(torch, card, ops, tol, what, previous=None):
    """K8 (csrc/soil_tail.cu) on the operands `ops` (soil_tail_operands)
    against its plain version (soil_tail_reference) on the card: within
    `tol` of each sum's max and, in float32, bitwise equal (float64 may
    differ in the last bit of CUDA's double pow), the same bits in two runs;
    the lanes that sub-step, the largest count and the lane sub-steps; its
    time (CUDA events, mean of N_REP) beside `previous`, the time recorded
    before K8's redesign (printed, not returned); the chain floor, the lane with the largest
    count launched alone (its sums the same bits as in the whole launch);
    the plain version's time (one run) and its bound. Returns the
    figures."""
    from lisflood_tpu_torch.ops import soil_tail as st
    aw, seep, no_subs, dt_sub, q = ops
    names = ("seep_a", "seep_b", "seep_gw")
    run = lambda fn: dict(zip(names, fn(aw, tuple(x.clone() for x in seep), no_subs, dt_sub, q)))
    a, b = run(st.soil_tail), run(st.soil_tail)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = run(st.soil_tail_reference)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    twice, bitwise = same_bits(a, b), same_bits(a, ref)
    rel, absd = max_rel_err(a, ref)
    scratch = tuple(x.clone() for x in seep)
    ms = cuda_ms(torch, lambda: st.soil_tail(aw, scratch, no_subs, dt_sub, q), N_REP)
    bound_ms, bound_by = soil_tail_bound(ops)
    multi, largest = int((no_subs > 1).sum()), int(no_subs.max())
    differ = sum(int((a[i] != ref[i]).sum()) for i in a)
    # the chain floor: the lane with the largest count, launched alone
    lane = int(no_subs.reshape(-1).argmax())
    one = lambda x: x.expand(no_subs.shape).reshape(-1)[lane:lane + 1].clone()
    aw1, no1, dt1 = tuple(one(x) for x in aw), one(no_subs), one(dt_sub)
    q1 = {k: one(v) for k, v in q.items()}
    alone = st.soil_tail(aw1, tuple(one(x) for x in seep), no1, dt1, q1)
    same_alone = all(tensor_bits_equal(torch, x, one(a[k])) for x, k in zip(alone, names))
    scratch1 = tuple(one(x) for x in seep)
    floor_ms = cuda_ms(torch, lambda: st.soil_tail(aw1, scratch1, no1, dt1, q1), N_REP)
    was = "" if previous is None else f" (recorded before the redesign: {previous:.4f} ms)"
    print(f"  K8 ({what}): {multi} of {no_subs.numel()} lanes sub-step, the largest count "
          f"{largest}; K8 vs plain max rel err {rel:.3e} of each sum's max (tol {tol:g}), max abs "
          f"{absd:.3e}, bitwise equal: {bitwise} ({differ} values differ); the same bits in two "
          f"runs: {twice}; K8 {ms:.4f} ms a launch (mean of {N_REP}){was}, bound "
          f"{bound_ms:.5f} ms ({bound_by}), chain floor {floor_ms:.4f} ms (the lane of count "
          f"{largest} alone, its sums the same bits as in the whole launch: {same_alone}), "
          f"plain version {plain_ms:.1f} ms (one run); card {card}", flush=True)
    assert rel <= tol and twice and same_alone, (rel, twice, same_alone)
    assert bitwise or dt_sub.dtype != torch.float32, f"float32 K8 differs in {differ} values"
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_floor_ms": floor_ms, "plain_ms": plain_ms, "max_abs_err": absd,
            "bitwise": bitwise, "multi_lanes": multi, "largest_no_subs": largest,
            "lanes": no_subs.numel()}


def soil_tail_counts(torch, step, s, f, what):
    """The lanes that sub-step in the soil tail (K8) and the largest count,
    from one land phase of `step` on state `s` and forcing `f`."""
    ops, _ = soil_tail_operands(torch, step, s, f)
    no_subs = ops[2]
    multi, largest = int((no_subs > 1).sum()), int(no_subs.max())
    print(f"  K8 on the {what} path: {multi} of {no_subs.numel()} lanes sub-step, the largest "
          f"count {largest}", flush=True)
    return {"multi_lanes": multi, "largest_no_subs": largest, "lanes": no_subs.numel()}


def forced_wet_operands(torch, step, s, f):
    """The soil tail's operands where the soil's Courant cap binds: the land
    phase of `step` with KSat1a, KSat1b and KSat2 scaled up by 10 at a time
    until the largest count reaches cfg.max_soil_substeps,
    SoilCourantCapHit set. Returns them and the scale."""
    cap = step.cfg.max_soil_substeps
    scale = 1.0
    while True:
        scale *= 10.0
        p = dict(step.params)
        for k in ("KSat1a", "KSat1b", "KSat2"):
            p[k] = step.params[k] * scale
        ops, d = soil_tail_operands(torch, step, s, f, p)
        if int(ops[2].max()) >= cap or scale >= 1e8:
            break
    hit = bool(d["SoilCourantCapHit"])
    print(f"  forced wet: KSat x {scale:g}, the largest count {int(ops[2].max())} (the cap "
          f"{cap}), SoilCourantCapHit {hit}", flush=True)
    assert int(ops[2].max()) == cap and hit
    return ops, scale


def forced_wet_figures(torch, card, step, s, f, tol, previous=None):
    """K8 where the soil's Courant cap binds (forced_wet_operands), held to
    its plain version on those operands (soil_tail_figures)."""
    ops, scale = forced_wet_operands(torch, step, s, f)
    return soil_tail_figures(torch, card, ops, tol, f"forced wet, KSat x {scale:g}", previous)


def sync_count(torch, step, s, f, what):
    """The host synchronisations of one step of `step` on the card (state
    `s`, forcing `f`), from torch.cuda.set_sync_debug_mode("warn"): their
    count and the lines that make them. Returns the count."""
    import collections
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(s, f)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    here = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter(f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in syncs)
    print(f"  host synchronisations in one {what} step (set_sync_debug_mode warn): {len(syncs)}"
          + (f" at {dict(sites.most_common(8))}" if syncs else ""), flush=True)
    return len(syncs)


def profile_step(torch, step, s, f, step_ms):
    """One step under torch.profiler: the device's busy time by kernel rows,
    against the unprofiled steady step time `step_ms` (the profiled step's
    own wall time holds the profiler's cost). The idle share is printed as
    it comes out, below 0 if the profiled kernels ran longer than that
    step. A profiler that records no device time is said so on a line of
    its own and is no failure: a machine may refuse the tracing. Returns the
    device's busy milliseconds, kernels and idle share, or None."""
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
        return None
    rows.sort(key=device_us, reverse=True)
    top = "; ".join(f"{e.key[:40]} {device_us(e) / 1e3:.1f} ms x{e.count}" for e in rows[:4])
    print(f"  one step under torch.profiler: device busy {busy_ms:.1f} ms in "
          f"{sum(e.count for e in rows)} kernels, {(1 - busy_ms / step_ms) * 100:.1f}% idle "
          f"of the unprofiled {step_ms:.1f} ms step; largest: {top}", flush=True)
    return {"busy_ms": busy_ms, "kernels": sum(e.count for e in rows),
            "idle": 1 - busy_ms / step_ms}


# phase 18: the step replayed as a captured CUDA graph (models/graph.py):
# the steps held bitwise, replay against eager step, and the steps timed
# each way, per path
GRAPH_STEPS = 3
GRAPH_TIMED = 3
# figures by path, filled where each phase has its step (graph_figures) and
# its lisfloodexe run (graph_run_pair), printed by phase 18
GRAPHS = {}
# the paths phase 18 requires, and the kernels that must run inside a graph;
# `--graphs` also holds the MonteCarlo/EnKF run to its eager run (the whole
# script runs it on the graph in phase 9, and the folded steps' replays are
# held bitwise in phases 7 and 13)
GRAPH_PATHS = ("main", "all-options", "prerun", "ensemble", "catchment", "sharded", "scan",
               "sharded ensemble", "scan ensemble", "lisfloodexe production",
               "lisfloodexe every option")
GRAPH_KERNELS = ("kinwave_substep", "kinwave_sweep", "kinwave_sharded", "segment_sum",
                 "soil_tail")


def graph_figures(torch, card, what, stepper, eager, state, forcing, eager_profile=None):
    """A path's captured step (`stepper`, the GraphedStep its entry point
    replays) against its eager step `eager(state, forcing)`, from the
    prepared `state` on the days `forcing` (the single model's for a folded
    ensemble, whose stepper tiles it inside the graph): the capture's
    seconds and pool bytes; GRAPH_STEPS replays bitwise equal to as many
    eager steps, every state entry and every diagnostic; ms/step eager and
    replayed, a batch of GRAPH_TIMED steps each after one untimed step of
    each;
    one profiled replay and one eager step (device busy and idle; the
    eager step's busy time from `eager_profile`, the phase's profile_step of
    it, where given);
    the kernel launches of a replay, from the counts its capture recorded,
    equal to an eager step's; the host synchronisations of a replay (none).
    Into GRAPHS[what]."""
    from lisflood_tpu_torch.models.graph import GraphedStep
    assert isinstance(stepper, GraphedStep) and stepper.device.type == "cuda", what
    t_start = time.perf_counter()
    if stepper.graph is None:
        stepper(state, forcing[0], keys=())
    torch.cuda.synchronize()
    s_e, s_g, differ, counted = dict(state), state, [], (0, 0)
    for i, f in enumerate(forcing[:GRAPH_STEPS]):
        s_e, d_e = eager(s_e, f)
        s_g, d_g = stepper.run(s_g, f)
        pairs = [(k, v, s_g[k]) for k, v in s_e.items()]
        reports = [(k, v, d_g[k]) for k, v in d_e.items() if torch.is_tensor(v)]
        differ += [(i + 1, k) for k, a, b in pairs + reports if not tensor_bits_equal(torch, a, b)]
        counted = (len(pairs), len(reports))
        del d_e, d_g

    def timed(fn):
        s = dict(s_e)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in forcing[:GRAPH_TIMED]:
            s = fn(s, f)[0]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / GRAPH_TIMED * 1e3

    replay = lambda s, f: stepper(s, f, keys=())
    # one untimed step of each: the capture emptied the allocator's cache
    eager(s_e, forcing[0])
    replay(s_e, forcing[0])
    eager_ms, graph_ms = timed(eager), timed(replay)
    reset_launches()
    replay(s_e, forcing[0])
    per_replay = launch_counts()
    reset_launches()
    eager(s_e, forcing[0])
    per_step = launch_counts()
    print(f"  graph of the {what} step: captured in {stepper.capture_seconds:.2f} s, pool "
          f"{stepper.pool_bytes / 2**20:.1f} MiB; {GRAPH_STEPS} replays against {GRAPH_STEPS} "
          f"eager steps from the same state: {counted[0]} state entries and {counted[1]} "
          f"diagnostics a step bitwise equal: {not differ}"
          f"{'' if not differ else f' (differ: {differ[:8]})'}; ms/step eager {eager_ms:.2f}, "
          f"replayed {graph_ms:.2f}; launches a replay "
          f"{per_replay} (an eager step's {per_step}); card {card}", flush=True)
    assert not differ, (what, differ)
    assert per_replay == per_step == stepper.captured, (what, per_replay, per_step)
    prof_e = eager_profile or profile_step(torch, eager, s_e, forcing[0], eager_ms)
    prof_g = profile_step(torch, replay, s_e, forcing[0], graph_ms)
    syncs = sync_count(torch, replay, s_e, forcing[0], f"{what} replay")
    assert syncs == 0, (what, syncs)
    GRAPHS[what] = {"capture_s": stepper.capture_seconds, "pool_bytes": stepper.pool_bytes,
                    "bitwise_steps": GRAPH_STEPS, "eager_ms": eager_ms, "graph_ms": graph_ms,
                    "eager_idle": prof_e and 1 - prof_e["busy_ms"] / eager_ms,
                    "graph_idle": prof_g and prof_g["idle"],
                    "busy_ms": prof_g and prof_g["busy_ms"],
                    "kernels": prof_g and prof_g["kernels"], "launches": per_replay,
                    "syncs": syncs, "seconds": time.perf_counter() - t_start}


@contextlib.contextmanager
def eager_entry_points():
    """The entry points on the eager step (models/graph.EagerStep) inside the
    block: the runs a graphed run is held to."""
    from lisflood_tpu_torch.models import graph
    stepper = graph.stepper
    graph.stepper = graph.EagerStep
    try:
        yield
    finally:
        graph.stepper = stepper


def same_tree(a, b):
    """Two runs' output directories hold the same files with the same bits:
    every TSS and map as same_outputs compares them, an ensemble member's
    directory likewise and the stateVar dumps array by array. Returns the
    files compared."""
    import numpy as np
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)), (a, names, sorted(os.listdir(b)))
    files = []
    for name in names:
        fa, fb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(fa):
            files += [f"{name}/{n}" for n in same_tree(fa, fb)]
        elif name.endswith(".npz"):
            with np.load(fa) as x, np.load(fb) as y:
                assert sorted(x.files) == sorted(y.files), name
                assert all(np.array_equal(x[k], y[k], equal_nan=True) for k in x.files), name
            files.append(name)
        else:
            same_file(fa, fb, name)
            files.append(name)
    return files


def run_figures(runner, days):
    """A lisfloodexe run's host seconds by part and ms per simulated day (of
    its ensemble's days where it ran one)."""
    ens = getattr(runner, "ensemble", None)
    parts = dict(ens.seconds if ens is not None else runner.seconds)
    run_s = (parts["days"] + parts["capture"] if ens is not None
             else sum(v for k, v in parts.items() if k not in ("build_model", "to_device")))
    return {"ms_per_day": run_s / days * 1e3, "parts": parts}


def graph_run_pair(torch, card, what, runner, settings_for, out, days):
    """The phase's lisfloodexe run on the captured step (`runner`, its
    outputs in `out`) against the same run on the eager step
    (`settings_for(path_out)`, into `out` + "_eager"): every output file
    and the end state the same bits; ms per simulated day of each with the
    host seconds by part. Into GRAPHS["lisfloodexe " + what]."""
    from lisflood_tpu_torch.models.driver import lisfloodexe
    eager_out = out + "_eager"
    os.makedirs(eager_out)
    t0 = time.perf_counter()
    with eager_entry_points():
        eager = lisfloodexe(settings_for(eager_out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    files = same_tree(out, eager_out)
    state = lambda r: (r.ensemble if getattr(r, "ensemble", None) is not None else r).state
    differ = [k for k, v in state(runner).items()
              if not tensor_bits_equal(torch, v, state(eager)[k])]
    fig = {"graph": run_figures(runner, days), "eager": run_figures(eager, days),
           "files": len(files), "state_bitwise": not differ,
           "seconds": time.perf_counter() - t0}
    part = lambda f: ", ".join(f"{k} {v:.2f}" for k, v in f["parts"].items())
    print(f"  lisfloodexe, {what}, on the captured step against the same run on the eager step "
          f"({wall:.1f} s): {len(files)} output files and {len(state(eager))} state entries "
          f"the same bits: {not differ}; ms per simulated day graphed "
          f"{fig['graph']['ms_per_day']:.1f} ({part(fig['graph'])}), eager "
          f"{fig['eager']['ms_per_day']:.1f} ({part(fig['eager'])}); card {card}", flush=True)
    assert not differ, (what, differ)
    GRAPHS["lisfloodexe " + what] = fig
    del eager
    torch.cuda.empty_cache()


def phase_graphs(card, paths=GRAPH_PATHS):
    """Phase 18: the figures of every path's captured step (GRAPHS), as a
    table; every path of `paths` there, and every kernel launched inside a
    graph on one of them."""
    missing = [p for p in paths if p not in GRAPHS]
    assert not missing, missing
    print(f"  the step as a captured CUDA graph against the eager step, card {card}:", flush=True)
    pct = lambda x: "not measured" if x is None else f"{x * 100:.1f}%"
    inside = set()
    for what, g in GRAPHS.items():
        if what.startswith("lisfloodexe"):
            print(f"  {what}: ms per simulated day eager {g['eager']['ms_per_day']:.1f}, "
                  f"graphed {g['graph']['ms_per_day']:.1f}; {g['files']} files and the end "
                  f"state bitwise equal", flush=True)
            continue
        inside |= {k for k, n in g["launches"].items() if n}
        print(f"  {what}: ms/step eager {g['eager_ms']:.2f}, graphed {g['graph_ms']:.2f}; "
              f"device idle eager {pct(g['eager_idle'])}, graphed {pct(g['graph_idle'])} "
              f"(busy {g['busy_ms'] or 0:.2f} ms); capture {g['capture_s']:.2f} s, pool "
              f"{g['pool_bytes'] / 2**20:.1f} MiB; {g['bitwise_steps']} replays bitwise; launches "
              f"a replay {g['launches']}; host syncs {g['syncs']}", flush=True)
    print(f"  kernels launched inside a graph: {sorted(inside)}; the graph checks took "
          f"{sum(g['seconds'] for g in GRAPHS.values()):.1f} s in all", flush=True)
    assert inside == set(GRAPH_KERNELS), inside
    print("graphs: " + json.dumps(GRAPHS), flush=True)


def graphs_check(torch):
    """`python3 chip_smoke.py --graphs`: phase 18 alone, on models of its
    own: the continental main path, all options, the prerun and the
    8-member ensemble; the 1200x1000 catchment on RoutingKernel packed,
    sharded and scan, and the 4-member folded ensembles of the last two;
    lisfloodexe's production and MonteCarlo/EnKF runs on the catchment and
    the every-option run on a catchment of its own, each against the same
    run on the eager step."""
    import dataclasses
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.driver import lisfloodexe
    from lisflood_tpu_torch.models.ensemble import EnsembleRunner, tile_forcing
    from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
    from lisflood_tpu_torch.models.step import build_multi_step
    from lisflood_tpu_torch.models.synthetic import (EVERY_OPTION, build_synthetic_model,
                                                     synthetic_forcing, with_options,
                                                     write_catchment)
    from lisflood_tpu_torch.ops import _build
    card = smi_line()
    print(f"graphs alone: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"kernels built in {_build.build():.1f} s", flush=True)
    dev = lambda fs: [to_device(f, "cuda", torch.float32) for f in fs]

    def path(what, cfg, params, state, aux, forcing):
        multi, _ = build_multi_step(cfg, params, aux, dtype=torch.float32, device="cuda")
        graph_figures(torch, card, what, multi.stepper, multi.step, multi.prepare_state(state),
                      forcing)
        del multi
        torch.cuda.empty_cache()

    def folded(what, model, M, forcing):
        ens = EnsembleRunner(model, M, seed=0, dtype=torch.float32, device="cuda")
        P = model[0].num_pixels
        graph_figures(torch, card, what, ens.stepper,
                      lambda s, f: ens.step(s, tile_forcing(f, M, P)), ens.state, forcing)
        del ens
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = build_synthetic_model(1200, 1000, no_rout_steps=24, chunk_size=512)
    cfg = model[0]
    print(f"  continental model built on the host in {time.perf_counter() - t0:.1f} s", flush=True)
    days = lambda extra: dev([{**synthetic_forcing(cfg.num_pixels, seed=i), **extra}
                              for i in range(GRAPH_TIMED)])
    path("main", *model, days({}))
    options = with_options(model)
    path("all-options", *options, days(options[3]["forcing_options"]))
    del options
    path("prerun", dataclasses.replace(cfg, init_lisflood=True), *model[1:], days({}))
    folded("ensemble", model, 8, days({}))
    del model

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        catchment = write_catchment(os.path.join(tmp, "catchment"), 1200, 1000, seed=0,
                                    n_steps=STEPS_RUN, nc_format="classic", outputs=True,
                                    user={"EnsMembers": 1, "FilterSteps": ""})
        settings = load_settings(catchment)
        cfg, params, state, aux = build_model(settings)
        forcing = dev(meteo_forcing(settings, cfg, aux))
        print(f"  the 1200x1000 catchment written and built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        path("catchment", cfg, params, state, aux, forcing)
        for router, fields in (("sharded", {"routing_kernel": "sharded", "num_shards": SHARDS}),
                               ("scan", {"routing_kernel": "scan"})):
            cfg_r = dataclasses.replace(cfg, **fields)
            path(router, cfg_r, params, state, aux, forcing)
            folded(f"{router} ensemble", (cfg_r, params, state, aux), ROUTER_MEMBERS, forcing)
        del forcing, params, aux

        def pair(what, settings_for, name, days):
            out = os.path.join(tmp, name)
            os.makedirs(out)
            runner = lisfloodexe(settings_for(out))
            torch.cuda.synchronize()
            graph_run_pair(torch, card, what, runner, settings_for, out, days)

        single = {"Precision": "single"}
        pair("production", lambda o: load_settings(catchment, sys_args=["-v"],
                                                   vars_to_set={**single, "PathOut": o}),
             "production", STEPS_RUN)
        pair("MonteCarlo/EnKF",
             lambda o: load_settings(catchment, sys_args=["-v"], opts_to_set=["MonteCarlo", "EnKF"],
                                     vars_to_set={**single, "PathOut": o,
                                                  "EnsMembers": str(DRIVER_MEMBERS),
                                                  "FilterSteps": str(DRIVER_FILTER_STEP),
                                                  "LZState": ""}),
             "ensemble", STEPS_RUN)
        import datetime
        every = write_catchment(os.path.join(tmp, "every"), 1200, 1000, seed=0,
                                n_steps=EVERY_DAYS, nc_format="classic", outputs=True,
                                options=EVERY_OPTION, start=datetime.date(*EVERY_START))
        pair("every option", lambda o: load_settings(every, sys_args=["-v"],
                                                     vars_to_set={**single, "PathOut": o}),
             "every_out", EVERY_DAYS)
    phase_graphs(card, GRAPH_PATHS + ("lisfloodexe MonteCarlo/EnKF",))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


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
    src, n = re.subn(r"side \? (substep_kernel<\w+, \w+), true> : substep_kernel<\w+, \w+, false>",
                     r"\1>", src)
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
            ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), 20)
            outs[name] = ks.kinwave_substep(spec, xs)
            print(f"main-path launch, {spec.n_chunks} chunks, "
                  f"{ks.kinwave_substep.last_plan['blocks']} blocks, {name}: {ms:.3f} ms "
                  f"(mean of 20)", flush=True)
        torch.cuda.synchronize()
    assert same_bits(outs["flag"], outs["no flag"])
    print("outputs of the two builds bitwise equal", flush=True)
    return 0


def k7_k8_check(torch):
    """K8 and K7 alone, built from the checkout, at the continental grid's
    shapes (the main-path model, 3 steps in): K8 held to its plain version
    on the main path's and the forced-wet operands (soil_tail_figures), K7
    on the grid's Catchments, downstruct and downEva (k7_figures)."""
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.step import build_multi_step
    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, synthetic_forcing
    from lisflood_tpu_torch.ops import _build
    card = smi_line()
    print(f"K7 and K8 alone; card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    secs = _build.build(["soil_tail", "segment_sum"])
    print(f"  built soil_tail and segment_sum in {secs:.1f} s", flush=True)
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}", flush=True)
    cfg, params, state, aux = build_synthetic_model(1200, 1000, no_rout_steps=24, chunk_size=512)
    multi, _ = build_multi_step(cfg, params, aux, dtype=torch.float32, device="cuda")
    s = multi.prepare_state(state)
    for i in range(3):
        f = to_device(synthetic_forcing(cfg.num_pixels, seed=i), "cuda", torch.float32)
        s, _ = multi.step(s, f)
    was = PREVIOUS_MS["soil_tail"]
    soil_tail_figures(torch, card, soil_tail_operands(torch, multi.step, s, f)[0], 1e-5,
                      "continental main path, float32", was["main"])
    forced_wet_figures(torch, card, multi.step, s, f, 1e-5, was["forced wet"])
    was = PREVIOUS_MS["segment_sum"]
    k7_figures(torch, card, "Catchments", params["Catchments"], cfg.num_catchments,
               previous=was["Catchments"])
    k7_figures(torch, card, "downstruct", params["downstruct"], cfg.num_pixels + 1,
               count=cfg.num_pixels, previous=was["downstruct"])
    k7_figures(torch, card, "downEva", params["downEva"], cfg.num_pixels + 1,
               count=cfg.num_pixels, previous=was["downEva"])
    print(card, flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 14: the multi-process step


# ranks of phase 14 on phase 8's catchment (SHARDS shards, float32) and on
# the synthetic 240x200 model (SYNTHETIC_SHARDS shards, float64, which has
# channel edges between its ranks), its steps there, and each rank
# process's timeout in seconds
CATCHMENT_RANKS = 2
SYNTHETIC_RANKS, SYNTHETIC_SHARDS, SYNTHETIC_STEPS = 4, 8, 3
RANK_TIMEOUT = {"catchment": 600, "synthetic": 300}
# the per-pixel reports each rank gathers beside the state
RANK_REPORTS = ("ChanQAvg", "MBError", "MBErrorSplitRoutingM3")


def rank_bound(n_real, L, dtype, n_edges):
    """(bound_ms, bound_by) of one K6 launch over `n_real` real positions
    with `n_edges` edges and L lanes, counted as sharded_bound counts the
    whole schedule's."""
    name = str(dtype).replace("torch.", "")
    item = 4 if name == "float32" else 8
    nbytes = 3 * L * n_real * item + 4 * n_real
    if name == "float32":
        per_row = FLOPS_SWEEP
    else:
        plain, pows = QSPACE_ROW(QSPACE_ITERS[name])
        per_row = 1 + plain + pows * POW_FLOPS[name]
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (L * n_real * per_row + L * n_edges) / PEAK_FLOPS[name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_rank_k6(torch, step, s, f, module):
    """The local operands (const, adx) of the first channel sub-step's and
    of the overland K6 launch in one step of a rank step, as they enter
    the kernel (halo included), through the name `module` (the router's:
    ops/kinwave_sharded, ops/kinwave for scan) calls the sweep by. Every
    rank calls it: the step exchanges."""
    captured = {}
    real = module.kinwave_sharded_sweep

    def capture(*args):
        key = "channel" if args[0].shape[0] == 2 else "overland"
        if key not in captured:
            captured[key] = (tuple(a.clone() for a in args[:2]), args[2])
        return real(*args)
    # the launcher counts through ops/kinwave_sharded's name: the wrapper's
    capture.launches, capture.last_plan = 0, None
    module.kinwave_sharded_sweep = capture
    try:
        step(s, f)
    finally:
        module.kinwave_sharded_sweep = real
    return captured


def rank_k6_figures(torch, kss, captured, beta, dtype):
    """K6 on one rank's tables (own positions plus halo) for each captured
    launch: bitwise against its plain version (RankTiles.reference, the
    one-process `_sweep_sharded` over the whole schedule with only the
    rank's operands set; RankScanTiles.reference, `_sweep_scan` on the
    schedule's chunks cut to the rank's pixels), its time, bound and chain
    floor."""
    out = {}
    for name, (ops, tiles) in captured.items():
        q = kss.kinwave_sharded_sweep(*ops, tiles, beta)
        plan = dict(kss.kinwave_sharded_sweep.last_plan)
        twice = same_bits({"q": q}, {"q": kss.kinwave_sharded_sweep(*ops, tiles, beta)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = tiles.reference(*ops, beta)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bitwise = same_bits({"q": q}, {"q": ref})
        absd = float((q.double() - ref.double()).abs().max())
        ms = cuda_ms(torch, lambda: kss.kinwave_sharded_sweep(*ops, tiles, beta), N_REP)
        deep_ms, floor_ms, per_level = sharded_where(torch, kss, ops, tiles, beta,
                                                     f"{name}, rank 0's tables")
        real = int(tiles.count.sum())
        n_edges = int((tiles.ups >= 0).sum())
        bound_ms, bound_by = rank_bound(real, ops[0].shape[0], dtype, n_edges)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": absd, "bitwise": bitwise,
                     "twice": twice, "bound_ms": bound_ms, "bound_by": bound_by,
                     "chain_floor_ms": floor_ms, "deep_tile_ms": deep_ms,
                     "cycles_per_level": float(per_level), "positions": int(tiles.p_pad),
                     "real": real, "edges": n_edges, "plan": sharded_plan_text(plan)}
    return out


def capture_packed(torch, step, s, f):
    """The operands of the sub-step kernel's launch (spec, xs) and of the
    overland sweep's (const, adx, tiles, beta) in one step of a packed
    `step` (a rank's: every rank calls it, the step exchanges), as they
    enter the kernels."""
    from lisflood_tpu_torch.ops import kinwave_packed as kp
    from lisflood_tpu_torch.ops import routing_ops
    captured = {}
    real_sub, real_sweep = routing_ops.kinwave_substep, kp.kinwave_sweep

    def sub(spec, xs):
        captured["substep"] = (spec, {k: v.clone() for k, v in xs.items()})
        return real_sub(spec, xs)

    def sweep(const, adx, tiles, beta):
        captured["sweep"] = ((const.clone(), adx.clone()), tiles, beta)
        return real_sweep(const, adx, tiles, beta)
    # the sweep's launcher counts through its module's name: the wrapper's
    sweep.launches, sweep.last_plan = 0, None
    routing_ops.kinwave_substep, kp.kinwave_sweep = sub, sweep
    try:
        step(s, f)
    finally:
        routing_ops.kinwave_substep, kp.kinwave_sweep = real_sub, real_sweep
    return captured


def packed_rank_figures(torch, step, captured, group, out_path):
    """The packed rank step's kernels on its own tables, from the operands
    `captured` in one of its steps (every rank calls it): the sub-step
    kernel's launch on the rank's kept chunks, the same bits twice, held to
    its plain version on its first CATCHMENT_PREFIX kept chunks, and its
    time (the ranks one after the other, the others waiting) and bound; on
    rank 0 K5 on its tables against its plain version `_sweep`, bitwise,
    twice, its time and bound. The outputs at the rank's own positions (and
    of its own structures), and rank 0's overland discharge at its own
    pixels, go to `out_path` for the whole launch to be compared with."""
    import numpy as np
    from lisflood_tpu_torch.ops import kinwave_packed as kp
    from lisflood_tpu_torch.ops import kinwave_substep as ks
    from lisflood_tpu_torch.parallel import collectives
    layout, rank = step.layout, step.layout.rank
    spec, xs = captured["substep"]
    ys = ks.kinwave_substep(spec, xs)
    plan = dict(ks.kinwave_substep.last_plan)
    twice = same_bits(ys, ks.kinwave_substep(spec, xs))
    n = min(CATCHMENT_PREFIX, spec.n_chunks)
    tol = 1e-5 if xs["dx"].dtype == torch.float32 else 1e-12
    with contextlib.redirect_stdout(io.StringIO()):
        rel, absd, plain_ms = held_on_prefix(torch, ks, spec, xs, ys, n)
    # the function the rank needs: its own and halo lanes; the other lanes
    # of its kept chunks are padding of this design
    part, loc_of = layout.part("kin"), layout.loc_of["kin"]
    n_real = int(part["lanes"].size)
    with contextlib.redirect_stdout(io.StringIO()):
        bound_ms, bound_by = bound(xs, ys, spec, n_real)
    ms = float("nan")
    for r in range(layout.nranks + 1):
        collectives.barrier(group)
        if r == rank:
            ms = cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), N_REP)
    loc = torch.as_tensor(loc_of[part["own"]], device=xs["dx"].device)
    own = {"pos": part["own"]}
    for k, v in ys.items():
        if v.dim() == 2:
            own[k] = v.reshape(-1).index_select(0, loc).cpu().numpy()
    for prefix, (mine, _, _) in step.routers["kin"].struct_src.items():
        own[prefix + "$rows"] = layout.struct_rows[prefix][mine]
        for k, v in ys.items():
            if k.startswith(prefix + "_"):
                own[k] = v[torch.as_tensor(mine, device=v.device)].cpu().numpy()
    fig = {"ms": ms, "plain_ms": plain_ms, "rel_err": rel, "max_abs_err": absd,
           "tol": tol, "twice": twice, "bound_ms": bound_ms, "bound_by": bound_by,
           "chunks": spec.n_chunks, "prefix": n, "blocks": plan["blocks"], "lanes": n_real,
           "padding": 1 - n_real / (spec.n_chunks * spec.chunk)}
    assert rel <= tol and twice, ("rank sub-step launch", rank, fig)
    k5 = {}
    if rank == 0 and "sweep" in captured:
        (const, adx), tiles, beta = captured["sweep"]
        q = kp.kinwave_sweep(const, adx, tiles, beta)
        k5_twice = same_bits({"q": q}, {"q": kp.kinwave_sweep(const, adx, tiles, beta)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = kp._sweep(const, adx, tiles.ups.long(), beta)
        torch.cuda.synchronize()
        k5_plain_ms = (time.perf_counter() - t0) * 1e3
        bitwise = same_bits({"q": q}, {"q": ref})
        tochan = step.routers["tochan"]
        n_edges = int((tochan.ps.down_pos < tochan.ps.p_pad).sum())
        k5_real = int(layout.part("tochan")["lanes"].size)
        with contextlib.redirect_stdout(io.StringIO()):
            k5_bound, k5_by = sweep_bound((const, adx), q, n_edges, k5_real)
        k5 = {"ms": cuda_ms(torch, lambda: kp.kinwave_sweep(const, adx, tiles, beta), N_REP),
              "plain_ms": k5_plain_ms, "bitwise": bitwise, "twice": k5_twice,
              "max_abs_err": float((q.double() - ref.double()).abs().max()),
              "bound_ms": k5_bound, "bound_by": k5_by, "tiles": tiles.n_tiles,
              "positions": int(tochan.ps.p_pad), "chunks": tochan.ps.n_chunks,
              "padding": 1 - k5_real / int(tochan.ps.p_pad)}
        assert bitwise and k5_twice, ("rank 0's K5", k5)
        L = q.shape[1]
        own["k5$q"] = tochan.unpack(q.transpose(0, 1).reshape(L, -1)).cpu().numpy()
        own["k5$pixels"] = layout.pixels
    collectives.barrier(group)
    np.savez(out_path, **own)
    return fig, k5


def rank_run(torch, spec, rank, group, model, forcing, dev, router):
    """One router's run of a rank process: its rank step on the card, one
    warm-up step and spec["days"] timed steps with the kernel launches,
    collectives, bytes and host synchronisations of those steps counted, one
    more step under set_sync_debug_mode, the kernels on the rank's own
    tables (K6's figures on rank 0 for sharded and scan,
    packed_rank_figures for packed), then the gathered state and reports.
    Returns (figures, the gathered arrays)."""
    import dataclasses
    import warnings

    import numpy as np
    from lisflood_tpu_torch.ops import kinwave as kw
    from lisflood_tpu_torch.ops import kinwave_sharded as kss
    from lisflood_tpu_torch.parallel import collectives, multihost
    from lisflood_tpu_torch.parallel.shard_model import rank_layout
    N, S, days = spec["nranks"], spec["shards"], spec["days"]
    dtype = getattr(torch, spec["dtype"])
    cfg, params, state, aux = model
    cfg = dataclasses.replace(cfg, routing_kernel=router, num_shards=S)
    t0 = time.perf_counter()
    layout = rank_layout(cfg, params, aux, rank, N)
    step = multihost.multihost_step((cfg, params, aux), layout, group, dtype, dev)
    s = step.prepare_state(state)
    fs = [step.shard_forcing(f) for f in forcing]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    t_step = time.perf_counter() - t0
    s, _ = step(s, fs[0])
    collectives.barrier(group)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    collectives.reset_stats()
    t0 = time.perf_counter()
    reports = []
    for f in fs[1:]:
        s, d = step(s, f)
        reports.append({k: d[k] for k in RANK_REPORTS if k in d})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    collectives.barrier(group)
    step_ms = (time.perf_counter() - t0) / days * 1e3
    launches = launch_counts()
    stats = dict(collectives.STATS)
    stats["collectives"] -= 1          # the closing barrier
    # one more step under set_sync_debug_mode: the host synchronisations
    # torch sees (the collectives' copies to the host among them)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            step(s, fs[1])
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    kernels = {}
    if router in ("sharded", "scan"):
        captured = capture_rank_k6(torch, step, s, fs[1], kss if router == "sharded" else kw)
        collectives.barrier(group)
        if rank == 0 and spec.get("k6_figures"):
            kernels["k6"] = rank_k6_figures(torch, kss, captured, float(step.params["Beta"]),
                                            dtype)
        per_step = {"kinwave_sharded": cfg.no_rout_steps + (not step.routers["tochan"].no_edges)}
    else:
        captured = capture_packed(torch, step, s, fs[1])
        kernels["substep"], kernels["k5"] = packed_rank_figures(
            torch, step, captured, group, spec["own"] % (router, rank))
        per_step = {"kinwave_substep": 1, "kinwave_sweep": int(not step.routers["tochan"].no_edges)}
    del captured
    collectives.barrier(group)
    gathered = multihost.gather_state(step, s)
    for i, r in enumerate(reports):
        gathered.update({f"{k}@{i}": v.cpu().numpy() for k, v in step.gather(r, r).items()})
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = {"rank": rank, "router": router, "pixels": int(layout.pixels.size),
              "graphs": layout.figures(), "launches": launches, "stats": stats,
              "syncs_debug": syncs, "step_ms": step_ms, "peak_bytes": peak,
              "seconds": {"step": t_step, **step.seconds}, "per_step": per_step, **kernels}
    del step, s, fs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return result, gathered


def rank_child(spec_path, rank):
    """One rank process of phase 14 (`python3 chip_smoke.py --rank-child
    SPEC RANK`): builds the model on the host once, joins the process group
    once, then runs each router of spec["routers"] in turn (rank_run); rank
    0 saves each router's gathered arrays. Writes its figures by router to
    spec["result"] % rank."""
    import numpy as np
    import torch
    from lisflood_tpu_torch.parallel import collectives, multihost
    from lisflood_tpu_torch.parallel.shard_model import rank_device

    with open(spec_path) as fh:
        spec = json.load(fh)
    t_start = time.perf_counter()
    N, days = spec["nranks"], spec["days"]
    dev = rank_device(spec["device"], rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if spec["case"] == "catchment":
        from lisflood_tpu_torch.config import load_settings
        from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
        settings = load_settings(spec["path"])
        model = build_model(settings)
        forcing = meteo_forcing(settings, model[0], model[3])[:1 + days]
    else:
        from lisflood_tpu_torch.models.synthetic import build_synthetic_model, synthetic_forcing
        model = build_synthetic_model(*spec["size"])
        forcing = [synthetic_forcing(model[0].num_pixels)] * (1 + days)
    t_model = time.perf_counter() - t_start
    group = multihost.initialize(spec["init"], N, rank)
    results = {}
    try:
        for router in spec["routers"]:
            res, gathered = rank_run(torch, spec, rank, group, model, forcing, dev, router)
            res["seconds"]["model"] = t_model
            results[router] = res
            if rank == 0:
                np.savez(spec["out"] % router, **gathered)
            del gathered
    finally:
        collectives.destroy_group()
    results["seconds"] = time.perf_counter() - t_start
    with open(spec["result"] % rank, "w") as fh:
        json.dump(results, fh)
    print(f"rank {rank} of {N} done in {time.perf_counter() - t_start:.1f} s", flush=True)
    return 0


def launch_ranks(spec, tmp):
    """Runs the N rank processes of `spec` at once, each with its timeout;
    one that dies or hangs fails the phase (the others are killed). Returns
    (each rank's figures by router, rank 0's gathered arrays by router, the
    path pattern of the ranks' own-position outputs, % (router, rank))."""
    import numpy as np
    tag = f"{spec['case']}{spec['nranks']}"
    spec = dict(spec, init=f"file://{os.path.join(tmp, 'pg_' + tag)}",
                out=os.path.join(tmp, f"ranks_{tag}_%s.npz"),
                own=os.path.join(tmp, f"own_{tag}_%s_%d.npz"),
                result=os.path.join(tmp, f"rank_{tag}_%d.json"))
    spec_path = os.path.join(tmp, f"spec_{tag}.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    logs = [open(os.path.join(tmp, f"rank_{tag}_{r}.log"), "w+") for r in range(spec["nranks"])]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-child",
                               spec_path, str(r)], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(spec["nranks"])]
    deadline = time.perf_counter() + RANK_TIMEOUT[spec["case"]]
    failed = []
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((r, rc))
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for fh in logs:
        fh.seek(0)
        texts.append(fh.read())
        fh.close()
    assert not failed, (f"rank process {failed[0][0]} of {tag} ended {failed[0][1]}:\n"
                        + "\n".join(f"--- rank {r}:\n{t[-3000:]}" for r, t in enumerate(texts)))
    results = []
    for r in range(spec["nranks"]):
        with open(spec["result"] % r) as fh:
            results.append(json.load(fh))
    return (results, {k: dict(np.load(spec["out"] % k)) for k in spec["routers"]},
            spec["own"])


def ranks_bitwise(got, ref, what):
    """Every array of `ref` against `got`, bit for bit (NaNs included)."""
    import numpy as np
    missing = sorted(set(ref) - set(got))
    assert not missing, f"{what}: not gathered: {missing}"
    bad = [k for k, v in ref.items()
           if (v.shape, v.dtype) != (got[k].shape, got[k].dtype) or v.tobytes() != got[k].tobytes()]
    print(f"  {what}: {len(ref)} arrays gathered from the ranks, bitwise equal to one process: "
          f"{not bad}" + (f" (differ: {bad[:8]})" if bad else ""), flush=True)
    assert not bad, f"{what}: {bad}"


def rank_lines(results, router, days, k7_per_step, card, whole_ms=None):
    """Per rank of `router`'s run, under the card's name and power limit:
    its pixels, each graph's own and halo positions (and, packed, its kept
    chunks of all), what a step exchanges, its host synchronisations,
    ms/step, peak memory and its host seconds; packed, its sub-step
    launch's ms beside the whole schedule's (`whole_ms`, the one-process
    launch in this run) and rank 0's K5 ms. Each rank launches per step
    what its `per_step` says (sharded: K6 NoRoutSteps + 1 where the overland
    graph has edges; packed: the sub-step kernel once and K5 once where the
    overland graph has edges), K8 once and K7 as often as one process
    (`k7_per_step`)."""
    print(f"  {router} ranks on card {card}:", flush=True)
    for res in (r[router] for r in results):
        st, g = res["stats"], res["graphs"]
        per = lambda k: st[k] / days
        lc = res["launches"]
        graphs = "; ".join(
            f"{name} graph {g[k]['own']} own positions, halo {g[k]['halo']}, sends {g[k]['send']}"
            + (f", {g[k]['chunks']} of {g[k]['of_chunks']} chunks kept" if "chunks" in g[k] else "")
            + f" (exchange {'on' if g[k]['exchange'] else 'off'})"
            for name, k in (("channel", "kin"), ("overland", "tochan")))
        kernels = ""
        if router == "packed":
            sub, k5 = res["substep"], res["k5"]
            kernels = (f"; sub-step launch on its {sub['chunks']} kept chunks {sub['ms']:.3f} ms "
                       f"(mean of {N_REP}) against {whole_ms:.3f} ms for the whole schedule's "
                       f"launch, bound {sub['bound_ms']:.4f} ms ({sub['bound_by']}) over its "
                       f"{sub['lanes']} own and halo lanes (padding {sub['padding']:.3f} of the "
                       f"kept chunks' lanes), the same "
                       f"bits twice: {sub['twice']}, plain version on its first {sub['prefix']} "
                       f"chunks {sub['plain_ms']:.0f} ms, max rel err {sub['rel_err']:.2e} "
                       f"(tol {sub['tol']:g})")
            if k5:
                kernels += (f"; K5 on its {k5['chunks']} kept overland chunks ({k5['tiles']} "
                            f"tiles) {k5['ms']:.4f} ms, bound {k5['bound_ms']:.4f} ms "
                            f"({k5['bound_by']}; padding {k5['padding']:.3f}), plain {k5['plain_ms']:.0f} ms, bitwise equal "
                            f"to it: {k5['bitwise']}, twice: {k5['twice']}")
        print(f"  rank {res['rank']}: {res['pixels']} pixels; {graphs}{kernels}"
              f"; a step: {per('collectives'):g} collectives, {per('bytes_sent') / 1e6:.3f} MB "
              f"sent and {per('bytes_received') / 1e6:.3f} MB received through the host, "
              f"{per('syncs'):g} host syncs for them ({res['syncs_debug']} synchronising calls "
              f"in one step by set_sync_debug_mode); launches a step: "
              + ", ".join(f"{k} {v / days:g}" for k, v in lc.items())
              + f"; {res['step_ms']:.1f} ms/step; peak device memory "
              f"{res['peak_bytes'] / 2**30:.2f} GiB; host seconds: "
              + ", ".join(f"{k} {v:.1f}" for k, v in res["seconds"].items()), flush=True)
        want = {"kinwave_substep": 0, "kinwave_sweep": 0, "kinwave_sharded": 0}
        want.update({k: days * v for k, v in res["per_step"].items()})
        assert routing_launches(lc) == want, (lc, want)
        assert lc["soil_tail"] == days and lc["segment_sum"] == days * k7_per_step, lc


def one_process_reference(torch, cfg, params, aux, state, forcing, days, dtype, step=None):
    """The one-process step (`step`, or built here) on the card over one
    warm-up step and `days` steps: the natural state and the reports, as
    NumPy arrays, and K7's launches a step. For the packed router also the
    whole schedule's kernels on the operands of the step the ranks capture
    (from the state after those days, with the first timed day's forcing),
    under "whole": the sub-step launch's outputs (flat) and its ms, and the
    overland sweep's discharge at the natural pixels."""
    from lisflood_tpu_torch.device import to_device
    from lisflood_tpu_torch.models.step import build_step
    from lisflood_tpu_torch.ops import kinwave_packed as kp
    from lisflood_tpu_torch.ops import kinwave_substep as ks
    if step is None:
        step, _ = build_step(cfg, params, aux, dtype=dtype, device="cuda")
    s = step.prepare_state(state)
    fs = [f if torch.is_tensor(next(iter(f.values()))) else to_device(f, "cuda", dtype)
          for f in forcing]
    s, _ = step(s, fs[0])
    out = {}
    reset_launches()
    for i, f in enumerate(fs[1:1 + days]):
        s, d = step(s, f)
        out.update({f"{k}@{i}": d[k].cpu().numpy() for k in RANK_REPORTS if k in d})
    k7_per_step = launch_counts()["segment_sum"] / days
    out.update({k: v.cpu().numpy() for k, v in step.natural_state(s).items()})
    whole = None
    if cfg.routing_kernel == "packed":
        captured = capture_packed(torch, step, s, fs[1])
        spec, xs = captured["substep"]
        ys = ks.kinwave_substep(spec, xs)
        whole = {"ms": cuda_ms(torch, lambda: ks.kinwave_substep(spec, xs), N_REP),
                 "ys": {k: (v.reshape(-1) if v.dim() == 2 else v).cpu().numpy()
                        for k, v in ys.items()}}
        if "sweep" in captured:
            (const, adx), tiles, beta = captured["sweep"]
            q = kp.kinwave_sweep(const, adx, tiles, beta)
            L = q.shape[1]
            whole["q"] = step.routers["tochan"].unpack(
                q.transpose(0, 1).reshape(L, -1)).cpu().numpy()
            whole["k5_ms"] = cuda_ms(torch, lambda: kp.kinwave_sweep(const, adx, tiles, beta),
                                     N_REP)
        del captured, xs, ys
    return out, k7_per_step, whole


def packed_own_bitwise(whole, own_path, nranks, what):
    """Each rank's sub-step launch on its kept chunks against the whole
    schedule's launch on the same step's operands, at the rank's own
    positions and its own structures, bit for bit; rank 0's K5 at its own
    pixels against the whole sweep."""
    import numpy as np
    bad, n_pos, k5 = [], 0, None
    for r in range(nranks):
        own = dict(np.load(own_path % ("packed", r)))
        pos = own.pop("pos")
        n_pos += pos.size
        if "k5$q" in own:
            q, pixels = own.pop("k5$q"), own.pop("k5$pixels")
            k5 = q.tobytes() == whole["q"][:, pixels].tobytes()
            if not k5:
                bad.append((r, "K5"))
        rows = {k[:2]: own.pop(k) for k in list(own) if k.endswith("$rows")}
        for k, v in own.items():
            want = whole["ys"][k][rows[k[:2]]] if k[:2] in rows else whole["ys"][k][pos]
            if v.tobytes() != want.tobytes():
                bad.append((r, k))
    print(f"  {what}: each rank's sub-step launch on its kept chunks bitwise equal to the whole "
          f"schedule's launch on the same step's operands at its own positions ({n_pos} in all) "
          f"and structures: {not bad}; rank 0's K5 on its tables equal to the whole sweep at its "
          f"own pixels: {k5}", flush=True)
    assert not bad and k5 is not False, bad


def rank_k6_lines(k6, single, tables, phase, card):
    """The K6 figures of rank 0's launches on its `tables` (rank_k6_figures)
    beside `phase`'s launch on the whole tables (`single`), under the card's
    name and power limit; each must be bitwise equal to its plain version and
    give the same bits twice."""
    for name, fig in k6.items():
        was = single["ms" if name == "channel" else "ms_overland"]
        print(f"  K6 on rank 0's {tables}{name} tables ({fig['positions']} positions, "
              f"{fig['real']} real, {fig['edges']} edges): {fig['ms']:.4f} ms a launch (mean of "
              f"{N_REP}) against {was:.4f} ms on {phase}'s whole tables; bound "
              f"{fig['bound_ms']:.4f} ms ({fig['bound_by']}); chain floor "
              f"{fig['chain_floor_ms']:.4f} ms, the deepest tile alone {fig['deep_tile_ms']:.4f} "
              f"ms; plain version {fig['plain_ms']:.1f} ms (one run); bitwise equal to it: "
              f"{fig['bitwise']}, max abs {fig['max_abs_err']:.3e}; the same bits in two runs: "
              f"{fig['twice']}; {fig['plan']}; card {card}", flush=True)
        assert fig["bitwise"] and fig["twice"], (name, fig)


def rank_k6_entry(results, router, k6, single, phase, days):
    """The kernels line's figures of K6 on rank 0's tables of `router`'s
    ranks: a channel sub-step's launch (the overland launch in *_overland),
    its launches in rank 0's timed days, `phase`'s launch on the whole
    tables in this run, ms/step of the ranks (the slower) and of one
    process, and each rank's bytes each way a step."""
    ch, ov = k6["channel"], k6["overland"]
    return {"ms": ch["ms"], "plain_ms": ch["plain_ms"], "bound_ms": ch["bound_ms"],
            "bound_by": ch["bound_by"], "max_abs_err": max(ch["max_abs_err"], ov["max_abs_err"]),
            "launches": results[0][router]["launches"]["kinwave_sharded"],
            "ms_overland": ov["ms"], "plain_ms_overland": ov["plain_ms"],
            "bound_ms_overland": ov["bound_ms"], "chain_floor_ms": ch["chain_floor_ms"],
            "chain_floor_ms_overland": ov["chain_floor_ms"], f"ms_{phase}": single["ms"],
            f"ms_overland_{phase}": single["ms_overland"],
            "step_ms_ranks": max(r[router]["step_ms"] for r in results),
            "step_ms_one_process": single["step_ms"],
            "exchange_mb_per_step": [(r[router]["stats"]["bytes_sent"]
                                      + r[router]["stats"]["bytes_received"]) / days / 1e6
                                     for r in results]}


def phase_ranks(torch, card, path, tmp, refs, singles):
    """Phase 14: the multi-process step (parallel/shard_model.py,
    parallel/multihost.py); see the module docstring. `path` is phase 8's
    settings; `refs` by router the one-process state and reports after one
    warm-up day and SHARDED_DAYS days, and K7's launches a step (phase 10's
    sharded step, phase 8's packed step, with its whole kernels under
    "whole", phase 11's scan step), `singles` phase 10's and 11's figures
    by router."""
    import dataclasses

    from lisflood_tpu_torch.models.synthetic import build_synthetic_model, synthetic_forcing
    days = SHARDED_DAYS
    single = singles["sharded"]
    t0 = time.perf_counter()
    spec = {"case": "catchment", "path": path, "nranks": CATCHMENT_RANKS, "shards": SHARDS,
            "days": days, "dtype": "float32", "device": "cuda", "k6_figures": True,
            "routers": ["sharded", "packed", "scan"]}
    results, got, own_path = launch_ranks(spec, tmp)
    wall = time.perf_counter() - t0
    print(f"  {CATCHMENT_RANKS} rank processes on the one card over gloo (a file:// store), "
          f"phase 8's catchment, {SHARDS} shards, float32, one warm-up day and {days} days, "
          f"RoutingKernel sharded, packed then scan in the same processes: {wall:.1f} s in all",
          flush=True)
    rank_lines(results, "sharded", days, single["k7_per_step"], card)
    ranks_bitwise(got["sharded"], refs["sharded"][0],
                  f"{CATCHMENT_RANKS} sharded ranks against phase 10's one-process step")
    k6 = results[0]["sharded"]["k6"]
    rank_k6_lines(k6, single, "", "phase 10", card)
    ms_two = max(r["sharded"]["step_ms"] for r in results)
    print(f"  ms/step: one process {single['step_ms']:.1f} (phase 10), {CATCHMENT_RANKS} ranks "
          f"{ms_two:.1f} (the slower rank; two processes time-slice one card, so no speed-up "
          f"is expected or claimed); card {card}", flush=True)
    pref, k7_packed, whole = refs["packed"]
    rank_lines(results, "packed", days, k7_packed, card, whole["ms"])
    ranks_bitwise(got["packed"], pref,
                  f"{CATCHMENT_RANKS} packed ranks against phase 8's one-process packed step")
    packed_own_bitwise(whole, own_path, CATCHMENT_RANKS, "catchment, packed")
    packed_two = max(r["packed"]["step_ms"] for r in results)
    print(f"  packed ms/step: {CATCHMENT_RANKS} ranks {packed_two:.1f} (the slower rank; no "
          f"speed-up claimed); the whole schedule's sub-step launch {whole['ms']:.3f} ms and K5 "
          f"{whole['k5_ms']:.4f} ms in this run; card {card}", flush=True)
    scan_ref, k7_scan, _ = refs["scan"]
    rank_lines(results, "scan", days, k7_scan, card)
    ranks_bitwise(got["scan"], scan_ref,
                  f"{CATCHMENT_RANKS} scan ranks against phase 11's one-process scan step")
    k6_scan = results[0]["scan"]["k6"]
    rank_k6_lines(k6_scan, singles["scan"], "natural ", "phase 11", card)
    scan_two = max(r["scan"]["step_ms"] for r in results)
    print(f"  scan ms/step: one process {singles['scan']['step_ms']:.1f} (phase 11), "
          f"{CATCHMENT_RANKS} ranks {scan_two:.1f} (the slower rank; no speed-up claimed); "
          f"card {card}", flush=True)

    # four ranks of the synthetic 240x200 model, float64: channel edges
    # between ranks, the channel halo exchanged each sub-step (sharded) and
    # before each launch (packed: K4a, the q-space solve)
    t0 = time.perf_counter()
    size = (240, 200)
    cfg, params, state, aux = build_synthetic_model(*size)
    forcing = [synthetic_forcing(cfg.num_pixels)] * (1 + SYNTHETIC_STEPS)
    refs2 = {}
    for router in ("sharded", "packed", "scan"):
        cfg_r = dataclasses.replace(cfg, routing_kernel=router, num_shards=SYNTHETIC_SHARDS)
        refs2[router] = one_process_reference(torch, cfg_r, params, aux, state, forcing,
                                              SYNTHETIC_STEPS, torch.float64)
        torch.cuda.empty_cache()
    spec2 = {"case": "synthetic", "size": size, "nranks": SYNTHETIC_RANKS,
             "shards": SYNTHETIC_SHARDS, "days": SYNTHETIC_STEPS, "dtype": "float64",
             "device": "cuda", "routers": ["sharded", "packed", "scan"]}
    results2, got2, own2 = launch_ranks(spec2, tmp)
    print(f"  {SYNTHETIC_RANKS} rank processes, synthetic {size[0]}x{size[1]}, "
          f"{SYNTHETIC_SHARDS} shards, float64, one warm-up step and {SYNTHETIC_STEPS}, sharded, "
          f"packed then scan: {time.perf_counter() - t0:.1f} s in all (the one-process "
          f"references included)", flush=True)
    rank_lines(results2, "sharded", SYNTHETIC_STEPS, refs2["sharded"][1], card)
    assert any(r["sharded"]["graphs"]["kin"]["halo"] for r in results2), "no channel halo"
    ranks_bitwise(got2["sharded"], refs2["sharded"][0],
                  f"{SYNTHETIC_RANKS} sharded ranks against the one-process step")
    rank_lines(results2, "packed", SYNTHETIC_STEPS, refs2["packed"][1], card,
               refs2["packed"][2]["ms"])
    assert any(r["packed"]["graphs"]["kin"]["halo"] for r in results2), "no packed channel halo"
    ranks_bitwise(got2["packed"], refs2["packed"][0],
                  f"{SYNTHETIC_RANKS} packed ranks against the one-process packed step")
    packed_own_bitwise(refs2["packed"][2], own2, SYNTHETIC_RANKS, "synthetic, packed, float64")
    rank_lines(results2, "scan", SYNTHETIC_STEPS, refs2["scan"][1], card)
    assert any(r["scan"]["graphs"]["kin"]["halo"] for r in results2), "no scan channel halo"
    ranks_bitwise(got2["scan"], refs2["scan"][0],
                  f"{SYNTHETIC_RANKS} scan ranks against the one-process scan step")
    sub0, k5 = results[0]["packed"]["substep"], results[0]["packed"]["k5"]
    packed = {
        "kinwave_substep_rank": {
            "ms": sub0["ms"], "plain_ms": sub0["plain_ms"], "bound_ms": sub0["bound_ms"],
            "bound_by": sub0["bound_by"], "max_abs_err": sub0["max_abs_err"],
            "launches": results[0]["packed"]["launches"]["kinwave_substep"],
            "ms_whole": whole["ms"], "chunks": sub0["chunks"], "padding": sub0["padding"],
            "plain_shape": f"first {sub0['prefix']} of rank 0's {sub0['chunks']} kept chunks, "
                           f"1200x1000 catchment, {CATCHMENT_RANKS} ranks, float32"},
        "kinwave_sweep_rank": {
            "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
            "bound_by": k5["bound_by"], "max_abs_err": k5["max_abs_err"],
            "launches": results[0]["packed"]["launches"]["kinwave_sweep"],
            "ms_whole": whole["k5_ms"], "chunks": k5["chunks"], "padding": k5["padding"],
            "plain_shape": f"rank 0's {k5['chunks']} kept overland chunks, 1200x1000 "
                           f"catchment, {CATCHMENT_RANKS} ranks, float32"}}
    scan = {**rank_k6_entry(results, "scan", k6_scan, singles["scan"], "phase11", days),
            "halo": [{k: r["scan"]["graphs"][k]["halo"] for k in ("kin", "tochan")}
                     for r in results],
            "plain_shape": f"1200x1000 catchment, rank 0 of {CATCHMENT_RANKS}, its own and halo "
                           f"pixels (natural tables), one channel sub-step (and the overland "
                           f"sweep), float32"}
    return {**rank_k6_entry(results, "sharded", k6, single, "phase10", days),
            "step_ms_packed_ranks": packed_two,
            "plain_shape": f"1200x1000 catchment, rank 0 of {CATCHMENT_RANKS}, its own and halo "
                           f"positions, one channel sub-step (and the overland sweep), float32",
            "packed": packed, "scan": scan}


def multi_process_check(torch):
    """`python3 chip_smoke.py --multi-process`: phase 14 alone, on its own
    1200x1000 catchment, with the one-process sharded, packed and scan steps
    over the same days as its references."""
    import dataclasses

    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
    from lisflood_tpu_torch.models.synthetic import write_catchment
    from lisflood_tpu_torch.ops import _build
    card = smi_line()
    print(f"card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"  built {list(_build.SOURCES)} in {_build.build():.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_catchment(os.path.join(tmp, "catchment"), 1200, 1000, seed=0,
                               n_steps=1 + SHARDED_DAYS, nc_format="classic")
        settings = load_settings(path)
        cfg, params, state, aux = build_model(settings)
        forcing = meteo_forcing(settings, cfg, aux)
        t0 = time.perf_counter()
        refs = {}
        for router in ("sharded", "packed", "scan"):
            cfg_r = dataclasses.replace(cfg, routing_kernel=router, num_shards=SHARDS)
            refs[router] = one_process_reference(torch, cfg_r, params, aux, state, forcing,
                                                 SHARDED_DAYS, torch.float32)
            torch.cuda.empty_cache()
        print(f"  the one-process references in {time.perf_counter() - t0:.1f} s", flush=True)
        del params, aux, forcing
        torch.cuda.empty_cache()
        nan = {"ms": float("nan"), "ms_overland": float("nan"), "step_ms": float("nan")}
        fig = phase_ranks(torch, card, path, tmp, refs,
                          {"sharded": {**nan, "k7_per_step": refs["sharded"][1]}, "scan": nan})
    print(json.dumps({k: v for k, v in fig.items() if k != "plain_shape"}), flush=True)
    print(smi_line())
    return 0


def operational_check(torch):
    """`python3 chip_smoke.py --operational`: phase 15 alone, on its own copy
    of phase 8's catchment."""
    from lisflood_tpu_torch.models.synthetic import write_catchment
    from lisflood_tpu_torch.ops import _build
    card = smi_line()
    print(f"card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"  built {list(_build.SOURCES)} in {_build.build():.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = write_catchment(os.path.join(tmp, "catchment"), 1200, 1000, seed=0,
                               n_steps=STEPS_RUN, nc_format="classic", outputs=True)
        fig = phase_operational(torch, card, path, tmp)
    print(f"  phase 15 in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(fig), flush=True)
    print(smi_line())
    return 0


# the start of each phase on the host clock, by phase
STAMPS = {}
# host synchronisations in one step of each path (sync_count), by path
SYNCS = {}
# the soil tail's lanes that sub-step and largest count on each path
SOIL_COUNTS = {}


def stamp(n):
    STAMPS[n] = time.perf_counter()


def phase_seconds():
    """The seconds each phase took, from the stamps to now."""
    ends = sorted(STAMPS.items())[1:] + [(None, time.perf_counter())]
    return {n: round(t1 - t0, 1) for (n, t0), (_, t1) in zip(sorted(STAMPS.items()), ends)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--side-flag-ab"]:
        return side_flag_ab(torch)
    if sys.argv[1:] == ["--k7-k8"]:
        return k7_k8_check(torch)
    if sys.argv[1:2] == ["--rank-child"]:
        return rank_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:] == ["--multi-process"]:
        return multi_process_check(torch)
    if sys.argv[1:] == ["--operational"]:
        return operational_check(torch)
    if sys.argv[1:] == ["--every-option"]:
        return every_option_check(torch)
    if sys.argv[1:] == ["--graphs"]:
        return graphs_check(torch)
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
    stamp(1)
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    secs = _build.build()
    print(f"  built {list(_build.SOURCES)} in {secs:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}", flush=True)

    assert count_pow_ops() == POW_FLOPS, "POW_FLOPS is not what this nvcc emits for pow"

    stamp(2)
    print("phase 2: kernel vs plain version, 240x200, T=24, C=512", flush=True)
    mid = phase_mid(torch, ks, card)

    stamp(3)
    print("phase 3: main path, continental 1200x1000, T=24, C=512, float32", flush=True)
    torch.cuda.reset_peak_memory_stats()
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
    s, outs, step_ms, launches = timed_steps(torch, ks, multi, s, forcing, card, sums=False)
    launches, launches_k8 = launches["kinwave_substep"], launches["soil_tail"]
    per_model_bytes = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {per_model_bytes / 2**30:.2f} GiB", flush=True)
    bad = [k for k, v in s.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite state: {bad}"
    q = outs["ChanQAvg"]
    assert q.shape == (5, cfg.num_pixels) and bool(torch.isfinite(q).all()) and bool((q >= 0).all())
    print(f"  every state entry finite ({len(s)} entries); ChanQAvg {tuple(q.shape)}, "
          f"mean {float(q.mean()):.4g} m3/s", flush=True)
    busy = profile_step(torch, multi.step, s, forcing[0], step_ms)
    SYNCS["main"] = sync_count(torch, multi.step, s, forcing[0], "main")
    assert SYNCS["main"] == 0, "the main-path step synchronises the host"
    graph_figures(torch, card, "main", multi.stepper, multi.step, s, forcing, busy)

    stamp(4)
    print("phase 4: kernel timing at the main-path shape", flush=True)
    d = multi.step.land_phase(s, forcing[0])
    spec, xs = kernel_operands(cfg, p, s, d, multi.routers)
    ys, main = kernel_figures(torch, ks, spec, xs, "main-path launch")
    kernel_ms, bound_ms, bound_by = main["ms"], main["bound_ms"], main["bound_by"]
    land_ms = cuda_ms(torch, lambda: multi.step.land_phase(s, forcing[0]), N_REP)
    print(f"  parts of the {step_ms:.1f} ms step, each timed alone (they overlap in the step: "
          f"the host enqueues the next land phase while the routing kernel runs): land phase "
          f"+ surface routing {land_ms:.1f} ms, routing kernel {kernel_ms:.1f} ms", flush=True)
    # the plain version at the main-path shape, after the timed phases: the
    # comparison that holds the kernel to it, and its time from that run
    main_job = plain_later(spec, xs, ys, 1e-5, f"main-path launch ({spec.n_chunks} chunks)")
    print(f"  kernel {kernel_ms:.3f} ms/launch (mean of {N_REP}); bound {bound_ms:.4f} ms "
          f"({bound_by}), at the main-path shape ({spec.n_chunks} chunks); card {card}",
          flush=True)
    ops8, _ = soil_tail_operands(torch, multi.step, s, forcing[0])
    was = PREVIOUS_MS["soil_tail"]
    k8_main = {**soil_tail_figures(torch, card, ops8, 1e-5, "continental main path, float32",
                                   was["main"]),
               "launches": launches_k8}
    k8_wet = forced_wet_figures(torch, card, multi.step, s, forcing[0], 1e-5, was["forced wet"])
    del ops8
    f64 = mid["float64"]
    print(f"  the float64 q-space kernel at 240x200: {f64['ms']:.3f} ms with {f64['blocks']} "
          f"blocks ({f64['ms_one_block']:.3f} ms with one), bound "
          f"{f64['bound_ms']:.4f} ms "
          f"({f64['bound_by']})", flush=True)

    stamp(5)
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
    s5, outs5, step5_ms, counts5 = timed_steps(torch, ks, multi5, s5, forcing5, card, sums=True)
    launches5 = counts5["kinwave_substep"]
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
    busy = profile_step(torch, multi5.step, s5, forcing5[0], step5_ms)
    SYNCS["all-options"] = sync_count(torch, multi5.step, s5, forcing5[0], "all-options")
    graph_figures(torch, card, "all-options", multi5.stepper, multi5.step, s5, forcing5, busy)
    SOIL_COUNTS["all-options"] = soil_tail_counts(torch, multi5.step, s5, forcing5[0],
                                                  "all-options")
    repeat_bitwise(torch, multi5.step, multi5.prepare_state(state5), forcing5, "all-options")
    # the operands the kernel is held to the plain version on (every sum in
    # the step adds in a fixed order, so every run has the same numbers)
    spec5, xs5 = kernel_operands(cfg5, p5, s5, multi5.step.land_phase(s5, forcing5[0]),
                                 multi5.routers)
    assert all(k in xs5 for k in ("wuse", "qin_old", "qdelta", "uptrans", "tp1", "tp2", "tsub"))
    ys5, opts = kernel_figures(torch, ks, spec5, xs5, "launch with the sideflow terms")
    kernel5_ms, bound5_ms, bound5_by = opts["ms"], opts["bound_ms"], opts["bound_by"]
    land5_ms = cuda_ms(torch, lambda: multi5.step.land_phase(s5, forcing5[0]), N_REP)
    print(f"  parts of the {step5_ms:.1f} ms step, each timed alone: land phase incl. water "
          f"abstraction + surface routing {land5_ms:.1f} ms, routing kernel {kernel5_ms:.1f} ms; "
          f"operand build, post-routing and the mass balance's catchment totals are the rest",
          flush=True)
    assert "trans" in ys5 and bool(torch.isfinite(ys5["trans"]).all())
    opts_job = plain_later(spec5, xs5, ys5, 1e-5,
                           f"launch with the sideflow terms ({spec5.n_chunks} chunks)")
    side = mid["float32"]
    print(f"  kernel with the sideflow terms {kernel5_ms:.3f} ms/launch (mean of {N_REP}); bound "
          f"{bound5_ms:.4f} ms ({bound5_by}), at this path's shape ({spec5.n_chunks} chunks, "
          f"window {spec5.window}); at 240x200 (phase 2) kernel {side['ms']:.3f} ms; card "
          f"{card}", flush=True)
    del xs5, ys5
    print(f"  K7, the segment sums, on this grid's segments, float32 ("
          f"{counts5['segment_sum'] / STEPS_RUN:g} calls a step):", flush=True)
    was = PREVIOUS_MS["segment_sum"]
    k7 = {name: k7_figures(torch, card, name, params5[name], int(p5["seg$" + name].num_segments),
                           order=p5["seg$" + name], previous=was[name])
          for name in ("Catchments", "WUseRegionC", "downstruct")}
    k7["downEva"] = k7_figures(torch, card, "downEva", params5["downEva"], cfg5.num_pixels + 1,
                               count=cfg5.num_pixels, previous=was["downEva"])
    k7_main = {**k7["Catchments"], "launches": counts5["segment_sum"],
               "plain_shape": "1200x1000, all options, Catchments, float32",
               "continental": {k: {f: v[f] for f in K7_KEYS} for k, v in k7.items()}}
    del multi5, p5, s5
    torch.cuda.empty_cache()

    stamp(6)
    print("phase 6: InitLisflood prerun, continental 1200x1000, T=24, C=512, float32", flush=True)
    prerun = phase_prerun(torch, ks, model, card)
    torch.cuda.empty_cache()

    stamp(7)
    print("phase 7: ensemble of the main path, continental 1200x1000, T=24, C=512, float32",
          flush=True)
    ensemble = phase_ensemble(torch, ks, model, multi.step, per_model_bytes, card)
    del multi, p, s, model, d, xs, ys
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        stamp(8)
        print("phase 8: a catchment read from maps, 1200x1000, T=24, C=256, float32", flush=True)
        sweep, catchment, context = phase_catchment(torch, ks, card,
                                                    os.path.join(tmp, "catchment"))
        torch.cuda.empty_cache()
        stamp(9)
        print("phase 9: the settings-driven run (lisfloodexe) on phase 8's catchment", flush=True)
        phase_driver(torch, ks, card, context, tmp)
        stamp(10)
        print(f"phase 10: RoutingKernel sharded on phase 8's catchment, {SHARDS} shards, C=256, "
              "float32", flush=True)
        sharded = phase_sharded(torch, ks, card, context, tmp)
        torch.cuda.empty_cache()
        stamp(11)
        print("phase 11: RoutingKernel scan on phase 8's catchment, C=256, float32", flush=True)
        scan = phase_scan(torch, ks, card, context, tmp)
        torch.cuda.empty_cache()
        stamp(12)
        print("phase 12: K7, the segment sums, on phase 8's catchment's segments, float32",
              flush=True)
        sums = phase_segment_sums(torch, card, context, sharded.pop("position_catchments"))
        stamp(13)
        print(f"phase 13: the folded ensemble, {ROUTER_MEMBERS} members, on RoutingKernel "
              f"sharded ({SHARDS} shards) and scan, phase 8's catchment, float32", flush=True)
        folded = phase_ensemble_routers(
            torch, ks, card, context, tmp,
            {"sharded": (sharded.pop("single_step"), sharded),
             "scan": (scan.pop("single_step"), scan)})
        k8_catchment = context["soil_tail"]
        path = context["path"]
        # phase 14's packed ranks are held to phase 8's one-process packed
        # step over the same days
        cfg8, params8, state8, aux8 = context["model"]
        packed_ref = one_process_reference(torch, cfg8, params8, aux8, state8,
                                           context["forcing"], SHARDED_DAYS, torch.float32,
                                           step=context["step"])
        del context, params8, aux8
        torch.cuda.empty_cache()
        stamp(14)
        print(f"phase 14: the multi-process step, {CATCHMENT_RANKS} ranks on phase 8's catchment "
              f"and {SYNTHETIC_RANKS} on synthetic 240x200, float32 and float64", flush=True)
        ranks = phase_ranks(torch, card, path, tmp,
                            {"sharded": (sharded.pop("ranks_reference"), None, None),
                             "packed": packed_ref,
                             "scan": (scan.pop("ranks_reference"), scan.pop("k7_per_step"),
                                      None)},
                            {"sharded": sharded, "scan": scan})
        sharded.pop("k7_per_step")
        del packed_ref
        torch.cuda.empty_cache()
        stamp(15)
        print("phase 15: the operational run paths: a warm start on phase 8's catchment, and a "
              "geographic catchment run twice through MapsCaching, float32", flush=True)
        operational = phase_operational(torch, card, path, tmp)
        stamp(16)
        print("phase 16: every option read from maps through the production run, 1200x1000, "
              "float32, and at 96x80 in float64 on the card against the CPU", flush=True)
        every = phase_every_option(torch, card, ks, tmp)
        torch.cuda.empty_cache()

    source = "lisflood_tpu_torch/csrc/kinwave_substep.cu"
    replaces = "lisflood_tpu/ops/kinwave_pallas.py:654"
    # the plain versions, now that every device time is taken: every job
    # checked, its time (PLAIN_WORKERS side by side) and the kernel's largest
    # difference from it into the figures
    stamp(17)
    print("phase 17: the sub-step kernel's plain versions on the operands of phases 2 and 4-7",
          flush=True)
    plain = run_plain_jobs()
    stamp(18)
    print("phase 18: the step as one captured CUDA graph, every path against its eager step",
          flush=True)
    phase_graphs(card)
    main.update(launches=launches, plain_job=main_job, plain_shape="1200x1000, float32")
    opts.update(launches=launches5, plain_job=opts_job,
                plain_shape="1200x1000, all options, float32")
    for fig in (main, opts, prerun):
        _, fig["max_abs_err"], fig["plain_ms"] = plain[fig.pop("plain_job")]
        fig["plain_side_by_side"] = PLAIN_WORKERS
    # the sub-step kernel on the five paths and the overland sweep: ms,
    # launches and bound at each path's full-width shape, plain_ms and
    # max_abs_err at plain_shape
    figures = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "library_ms": None, **{k: v for k, v in fig.items() if k != "step_ms"}}
        for name, fig in (("kinwave_substep", main), ("kinwave_substep_sideflow", opts),
                          ("kinwave_substep_prerun", prerun),
                          ("kinwave_substep_ensemble", ensemble),
                          ("kinwave_substep_catchment", catchment))]}
    # no PyTorch call computes the sweep (a dependent chain of Newton solves)
    figures["kernels"].append(
        {"name": "kinwave_sweep", "route": "cuda",
         "source": "lisflood_tpu_torch/csrc/kinwave_sweep.cu",
         "replaces": "lisflood_tpu/ops/kinwave_packed.py:211", "library_ms": None, **sweep})
    # the sub-step kernel in its sideflow instantiation on phase 16's
    # map-built catchment with every option: the last day's launch
    figures["kernels"].append(
        {"name": "kinwave_substep_catchment_sideflow", "route": "cuda", "source": source,
         "replaces": replaces, "library_ms": None, **every["kinwave_substep"]})
    # K6: ms, bound and plain_ms of a channel sub-step's launch (and of the
    # overland launch, *_overland); launches of both in phase 10's run; no
    # PyTorch call computes it either
    figures["kernels"].append(
        {"name": "kinwave_sharded", "route": "cuda",
         "source": "lisflood_tpu_torch/csrc/kinwave_sharded.cu",
         "replaces": "lisflood_tpu/ops/kinwave_sharded.py:164", "library_ms": None,
         **{k: v for k, v in sharded.items() if k != "step_ms"}})
    # K6 on the scan router's natural tables (phase 11): ms, bound and
    # plain_ms of a channel sub-step's launch (overland in *_overland)
    figures["kernels"].append(
        {"name": "kinwave_sharded_scan", "route": "cuda",
         "source": "lisflood_tpu_torch/csrc/kinwave_sharded.cu",
         "replaces": "lisflood_tpu/ops/kinwave.py:80", "library_ms": None,
         **{k: v for k, v in scan.items() if k != "step_ms"}})
    # K7: the all-options path's Catchments spread (phase 5), its launches in
    # that path's timed run; library_ms is index_add_ and the gather
    figures["kernels"].append(
        {"name": "segment_sum", "route": "cuda", "source": "lisflood_tpu_torch/csrc/segment_sum.cu",
         "replaces": "lisflood_tpu/ops/physics.py:22", **k7_main,
         "catchment": {k: {f: v[f] for f in K7_KEYS} for k, v in sums.items()}})
    # K8: the continental main path's operands and launches; the catchment's,
    # the forced-wet case's and float64's beside them; no PyTorch call
    # computes it (a per-lane loop of data-dependent length)
    figures["kernels"].append(
        {"name": "soil_tail", "route": "cuda", "source": "lisflood_tpu_torch/csrc/soil_tail.cu",
         "replaces": "lisflood_tpu/ops/physics.py:300", "library_ms": None,
         **{k: v for k, v in k8_main.items() if k != "bitwise"},
         "plain_shape": "1200x1000 continental main path, float32",
         "catchment": k8_catchment, "forced_wet": k8_wet,
         "float64": mid["soil_tail_float64"], "float64_wet": mid["soil_tail_float64_wet"]})
    # K6 on the folded ensembles' tables (phase 13): a channel sub-step's
    # launch for all members, its launches in the ensemble's timed run
    for router, fig in folded.items():
        figures["kernels"].append(
            {"name": f"kinwave_sharded_ensemble_{router}", "route": "cuda",
             "source": "lisflood_tpu_torch/csrc/kinwave_sharded.cu",
             "replaces": ("lisflood_tpu/ops/kinwave_sharded.py:164" if router == "sharded"
                          else "lisflood_tpu/ops/kinwave.py:80"), "library_ms": None,
             **{k: v for k, v in fig.items() if k not in ("step_ms", "syncs")},
             "plain_shape": f"1200x1000 catchment, {ROUTER_MEMBERS} members, one channel "
                            f"sub-step, float32"})
    # K6 on one rank's own and halo tables (phase 14): a channel sub-step's
    # launch on rank 0 of the catchment's two ranks, its launches in that
    # rank's timed days; no PyTorch call computes it
    packed_ranks, scan_ranks = ranks.pop("packed"), ranks.pop("scan")
    figures["kernels"].append(
        {"name": "kinwave_sharded_rank", "route": "cuda",
         "source": "lisflood_tpu_torch/csrc/kinwave_sharded.cu",
         "replaces": "lisflood_tpu/ops/kinwave_sharded.py:164", "library_ms": None, **ranks})
    # the sub-step kernel on rank 0's kept chunks and K5 on its overland
    # tables (phase 14, packed ranks): ms beside the whole schedule's launch
    # in this run (ms_whole), launches in rank 0's timed days; no PyTorch call
    # computes either
    figures["kernels"].append(
        {"name": "kinwave_substep_rank", "route": "cuda", "source": source,
         "replaces": replaces, "library_ms": None, **packed_ranks["kinwave_substep_rank"]})
    figures["kernels"].append(
        {"name": "kinwave_sweep_rank", "route": "cuda",
         "source": "lisflood_tpu_torch/csrc/kinwave_sweep.cu",
         "replaces": "lisflood_tpu/ops/kinwave_packed.py:211", "library_ms": None,
         **packed_ranks["kinwave_sweep_rank"]})
    # K6 on rank 0's natural tables of the catchment's two scan ranks (phase
    # 14): a channel sub-step's launch beside phase 11's on the whole
    # natural tables (ms_phase11), its launches in that rank's timed days
    figures["kernels"].append(
        {"name": "kinwave_sharded_scan_rank", "route": "cuda",
         "source": "lisflood_tpu_torch/csrc/kinwave_sharded.cu",
         "replaces": "lisflood_tpu/ops/kinwave.py:80", "library_ms": None, **scan_ranks})
    # the launches of phase 15's warm run and geographic runs, by kernel,
    # beside the entries of the kernels its step runs
    runs15 = {"warm": operational["warm"]["warm"]["launches"],
              **{f"geographic_{i}": fig["launches"]
                 for i, fig in enumerate(operational["geographic"], 1)}}
    for entry in figures["kernels"]:
        kernel = {"kinwave_substep_catchment": "kinwave_substep"}.get(entry["name"],
                                                                      entry["name"])
        if entry["name"] in ("kinwave_substep_catchment", "kinwave_sweep", "segment_sum",
                             "soil_tail"):
            entry["launches_phase15"] = {run: counts[kernel] for run, counts in runs15.items()}
            # phase 16's production run with every option, the sub-step
            # kernel in its sideflow instantiation
            entry["launches_phase16"] = every["launches"][kernel]
    every.pop("kinwave_substep")
    print(f"host synchronisations in one step, by path: {SYNCS}", flush=True)
    SOIL_COUNTS.update({"main": k8_main, "catchment": k8_catchment})
    print("K8 lanes that sub-step / the largest count, by path: "
          + "; ".join(f"{k} {v['multi_lanes']} of {v['lanes']} / {v['largest_no_subs']}"
                      for k, v in SOIL_COUNTS.items()), flush=True)
    print(f"seconds by phase: {phase_seconds()}", flush=True)
    print(json.dumps(figures))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
