"""The multi-process step — the port of lisflood_tpu/parallel/multihost.py.

The JAX package brings up `jax.distributed`, makes a global mesh over every
process's devices and lets GSPMD shard the pixel axis. Here N processes
(ranks) join one torch.distributed process group (gloo,
parallel/collectives.py), and each steps the part of the grid it owns
(parallel/shard_model.py: whole logical shards; RoutingKernel packed runs
the sub-step kernel and K5 on the rank's kept chunks of the whole packed
schedules, sharded K6 on its own positions, scan K6 on its own natural
pixels, each with its upstream halo).
The gathered state is the one-process state bit for bit.

- `initialize(...)`: the process group;
- `global_mesh()`: the world group;
- `make_global(...)` / `shard_tree_global(...)`: a rank's part of host
  arrays replicated on every process;
- `multihost_step(model, layout, group)`: the rank's model step;
- `gather_state(step, state)`: the whole natural state on every rank (the
  counterpart of `process_allgather`);
- a command line, `python -m lisflood_tpu_torch.parallel.multihost --rank i
  --nprocs N [--steps K --out state.npz --kernel packed|sharded|scan
  --shards S --device cuda|cpu --init-method file:///path]`, which runs the
  synthetic 16x16 model in float64 for K steps and saves the gathered state
  on rank 0 (tests/test_torch_multihost.py,
  tests/test_torch_multihost_packed.py and
  tests/test_torch_multihost_scan.py hold N = 1, 2 and 4 bitwise equal).

One process runs any router, as the one-process step does; more than one
runs RoutingKernel packed, sharded and scan, every option but folded
ensembles (which the JAX package does not run across devices either). With
`--device cuda` (the default) rank r takes card r modulo the card count, so
N ranks may share one card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import to_device
from ..models.step import build_step
from ..models.synthetic import build_synthetic_model, synthetic_forcing
from . import collectives
from .shard_model import check_ranks, rank_device, rank_layout, rank_step, shard_tree


def initialize(init_method, world_size, rank, backend="gloo"):
    """Bring up the process group of `world_size` processes (nothing for
    one); returns the group (None for one process)."""
    if world_size <= 1:
        return None
    return collectives.init_group(init_method, world_size, rank, backend)


def global_mesh():
    """The group of every process (the world)."""
    import torch.distributed as dist
    return dist.group.WORLD if dist.is_initialized() else None


def make_global(layout, arr, num_pixels=None):
    """The rank's part of a host array replicated on every process: its
    pixels where the trailing axis is the pixel axis, else the whole."""
    return shard_tree(layout, {"a": arr}, num_pixels)["a"]


def shard_tree_global(layout, tree, num_pixels=None):
    return shard_tree(layout, tree, num_pixels)


def multihost_step(model, layout, group, dtype=torch.float64, device=None):
    """The rank's step of the host model (cfg, params, aux) laid out by
    `layout` (shard_model.rank_layout: a RankLayout for RoutingKernel
    sharded, a PackedRankLayout for packed, a ScanRankLayout for scan) over
    `group`: a shard_model.RankStep."""
    cfg, params, aux = model
    return rank_step(cfg, params, aux, layout, group, dtype, device)


def gather_state(step, state):
    """The whole natural state as NumPy arrays on every rank: the rank
    steps' parts gathered (a collective), a one-process step's state as it
    is."""
    if hasattr(step, "gather"):
        state = step.gather(step.natural_state(state))
    else:
        state = step.natural_state(state)
    return {k: v.cpu().numpy() for k, v in state.items()}


def run_demo(rank, nprocs, steps=3, out=None, device=None, init_method=None,
             routing_kernel="sharded", num_shards=4):
    """The synthetic 16x16 model in float64 over `nprocs` processes for
    `steps` steps; returns the gathered state, which rank 0 saves to `out`."""
    dev = rank_device(device, rank)
    cfg, params, state, aux = build_synthetic_model(16, 16)
    # the packed and the scan router's layouts take num_shards as their
    # logical shard count
    cfg = dataclasses.replace(cfg, routing_kernel=routing_kernel, num_shards=num_shards)
    check_ranks(cfg, nprocs)
    group = initialize(init_method or "tcp://localhost:29500", nprocs, rank)
    try:
        forcing = synthetic_forcing(cfg.num_pixels)
        if nprocs > 1:
            layout = rank_layout(cfg, params, aux, rank, nprocs)
            step = multihost_step((cfg, params, aux), layout, group, torch.float64, dev)
            s, f = step.prepare_state(state), step.shard_forcing(forcing)
        else:
            step, _ = build_step(cfg, params, aux, dtype=torch.float64, device=dev)
            s, f = step.prepare_state(state), to_device(forcing, dev, torch.float64)
        for _ in range(steps):
            s, _ = step(s, f)
        gathered = gather_state(step, s)
    finally:
        collectives.destroy_group()
    if out and rank == 0:
        np.savez(out, **gathered)
    return gathered


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--init-method", type=str, default="tcp://localhost:29500",
                    help="the process group's rendezvous: tcp://localhost:<port> or "
                         "file:///path (a file no other group uses)")
    ap.add_argument("--kernel", choices=("packed", "sharded", "scan"), default="sharded")
    ap.add_argument("--shards", type=int, default=4)
    a = ap.parse_args(argv)
    run_demo(a.rank, a.nprocs, a.steps, a.out, a.device, a.init_method, a.kernel, a.shards)
    print(f"multihost rank {a.rank}/{a.nprocs} done", flush=True)


if __name__ == "__main__":
    main()
