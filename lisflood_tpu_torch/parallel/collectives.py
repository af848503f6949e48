"""The collectives of the multi-process step, over torch.distributed — the
port's counterpart of the collectives XLA inserts for the JAX package's
GSPMD-sharded step (lisflood_tpu/parallel/shard_model.py, multihost.py).

Three operations, each on fixed-size buffers so that every rank calls it
with the same shapes and the placement of the result is fixed:

- `all_gather(x)`: every rank's `x` stacked on a new leading axis, in rank
  order (the callers pad their parts to one size);
- `all_reduce_max(x)`: the elementwise maximum over the ranks (a flag's
  global OR);
- `barrier()`.

The backend is gloo: the card's machine has one H100, and NCCL refuses two
ranks on one device. Gloo's collectives take host tensors, so a CUDA buffer
is staged through pinned host memory: copied to the host (the host waits for
the device: one synchronisation), gathered or reduced there, and copied back
to the device (asynchronously, from pinned memory). `STATS` counts the
calls, the host synchronisations and the bytes each rank sends and receives,
so that a caller can print them per step; nothing here hides a
synchronisation.

Nothing is brought up at import: `init_group` starts the process group.
"""
from __future__ import annotations

import datetime

import torch

# the calls of this process: collectives, host synchronisations (a CUDA
# buffer's copy to the host), bytes sent and received through the host
STATS = {"collectives": 0, "syncs": 0, "bytes_sent": 0, "bytes_received": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def init_group(init_method, world_size, rank, backend="gloo", timeout_s=600):
    """Bring up the default process group: `init_method` is a "file://" path
    (the tests: parallel workers cannot collide on a port) or a
    "tcp://localhost:<port>" address. Returns the group (the world)."""
    import torch.distributed as dist
    if backend != "gloo":
        raise NotImplementedError(
            f"backend {backend!r}: the multi-process step stages its buffers for gloo; NCCL "
            "with one card per rank waits for a machine with several cards (ROADMAP.md)")
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def destroy_group():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def world(group=None):
    """(rank, world size) of this process in `group` (1 process without a
    group)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _to_host(x):
    """`x` as a contiguous host tensor: a CUDA tensor is copied into pinned
    memory, and the host waits for the copy (counted)."""
    if x.device.type == "cpu":
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    STATS["syncs"] += 1
    return host


def _to_device(host, device):
    return host if device.type == "cpu" else host.to(device, non_blocking=True)


def all_gather(x, group=None):
    """(world, *x.shape): every rank's `x`, in rank order, on x's device.
    Every rank passes a tensor of the same shape and dtype."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    host = _to_host(x)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                      pin_memory=x.device.type == "cuda")
    dist.all_gather(list(out.unbind(0)), host, group=group)
    STATS["collectives"] += 1
    nbytes = host.numel() * host.element_size()
    STATS["bytes_sent"] += nbytes
    STATS["bytes_received"] += (n - 1) * nbytes
    return _to_device(out, x.device)


def all_reduce_max(x, group=None):
    """The elementwise maximum of `x` over the ranks (a bool tensor: the
    global OR), on x's device."""
    import torch.distributed as dist
    kind = x.dtype
    host = _to_host(x.to(torch.int32) if kind == torch.bool else x).clone()
    dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group)
    STATS["collectives"] += 1
    nbytes = host.numel() * host.element_size()
    STATS["bytes_sent"] += nbytes
    STATS["bytes_received"] += nbytes
    out = _to_device(host, x.device)
    return out.to(torch.bool) if kind == torch.bool else out


def barrier(group=None):
    import torch.distributed as dist
    dist.barrier(group=group)
    STATS["collectives"] += 1
