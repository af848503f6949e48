"""RoutingKernel sharded in the port (lisflood_tpu_torch) against the JAX
package, below the step: the subcatchment partition, the sharded schedule,
the router with its sweep (the plain version of K6 on the CPU) and the
configuration. The same NumPy inputs, made from a seed, go through both
packages; tests/test_torch_sharded_step.py holds the step and the run.

Gates: the partition and the schedule bit for bit; the router as the JAX
package holds its own (tests/test_kinwave.py:273-276, 298)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.models.config import ModelConfig as JaxConfig
from lisflood_tpu.models.synthetic import build_synthetic_model as jax_synthetic_model
from lisflood_tpu.ops.kinwave_sharded import ShardedRouter as JaxShardedRouter
from lisflood_tpu.ops.kinwave_sharded import build_sharded_schedule as jax_schedule
from lisflood_tpu.parallel.partition import catchment_partition as jax_partition
from lisflood_tpu.parallel.partition import subtree_pixels as jax_subtree_pixels
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.graph.ldd import build_schedule
from lisflood_tpu_torch.models.config import ModelConfig
from lisflood_tpu_torch.models.convert import config_from_reference, from_reference
from lisflood_tpu_torch.models.ensemble import ensemble_model
from lisflood_tpu_torch.models.initial import build_model
from lisflood_tpu_torch.models.step import build_step
from lisflood_tpu_torch.models.synthetic import build_synthetic_model, write_catchment
from lisflood_tpu_torch.ops.kinwave_packed import PackedRouter
from lisflood_tpu_torch.ops.kinwave_sharded import (ShardedRouter, build_sharded_schedule,
                                                    kinwave_sharded_sweep)
from lisflood_tpu_torch.parallel.partition import catchment_partition, subtree_pixels

SHARDS = (1, 2, 4, 8)
SCHEDULE_FIELDS = ("perm", "inv_perm", "down_local", "down_pos", "cut_src", "cut_dst")
SCALARS = ("n_chunks", "n_shards", "chunk", "window", "num_pixels")
GRIDS = ("16x16", "64x64", "240x200", "64x64 pre-cut")


@pytest.fixture(scope="module")
def graphs():
    """The synthetic models' channel graphs (structure-cut and pre-cut)."""
    out = {}
    for rows, cols in ((16, 16), (64, 64), (240, 200)):
        aux = jax_synthetic_model(rows, cols)[3]
        out[f"{rows}x{cols}"] = aux["graph_kin"]
        out[f"{rows}x{cols} pre-cut"] = aux["graph"]
    return out


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    return write_catchment(tmp_path_factory.mktemp("sharded"), 48, 40, seed=0, n_steps=1)


@pytest.fixture(scope="module")
def catchment_graphs(catchment):
    """The channel and overland graphs of the 48x40 catchment."""
    aux = build_model(load_settings(catchment))[3]
    return {k: aux[k] for k in ("graph_kin", "graph_tochan")}


def _same_schedule(ref, got):
    for f in SCHEDULE_FIELDS:
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in SCALARS:
        assert getattr(ref, f) == getattr(got, f), f


def _same_partition(graph, n_shards, chunk):
    """catchment_partition and build_sharded_schedule of both packages on
    `graph`: the same arrays. Returns the partition's cut edges."""
    ref, ref_stats = jax_partition(graph, n_shards)
    got, got_stats = catchment_partition(graph, n_shards)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for k in ("cut_edges", "shard_sizes"):
        assert np.array_equal(got_stats[k], ref_stats[k]), k
    _same_schedule(jax_schedule(graph, ref, chunk), build_sharded_schedule(graph, got, chunk))
    return len(got_stats["cut_edges"])


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("grid", GRIDS)
def test_partition_and_schedule_match_jax(graphs, grid, n_shards):
    """Synthetic channel graphs at S = 1, 2, 4, 8 (chunk 64): shard_of, the
    cut edges and shard sizes, and every array of the schedule, bit for
    bit. One shard cuts no edge, eight cut some (the 240x200 graph 48 at
    S=4)."""
    cuts = _same_partition(graphs[grid], n_shards, 64)
    if n_shards in (1, 8):
        assert (cuts > 0) == (n_shards == 8)


@pytest.mark.parametrize("name", ["graph_kin", "graph_tochan"])
def test_partition_and_schedule_match_jax_catchment(catchment_graphs, name):
    """The catchment's channel partition at S = 1, 2, 4, 8 (whole
    catchments pack, no cut edge on the channel graph) and the schedules of
    its channel and overland graphs on it (chunk 256 and 64): bit for bit;
    the overland graph carries cut edges."""
    graph_kin = catchment_graphs["graph_kin"]
    for S in SHARDS:
        ref, _ = jax_partition(graph_kin, S)
        got, stats = catchment_partition(graph_kin, S)
        assert np.array_equal(got, ref) and len(stats["cut_edges"]) == 0
        for chunk in (256, 64):
            ps = build_sharded_schedule(catchment_graphs[name], got, chunk)
            _same_schedule(jax_schedule(catchment_graphs[name], ref, chunk), ps)
    cut = (ps.cut_src != ps.n_shards * ps.chunk).any()
    assert cut == (name == "graph_tochan")


def test_subtree_pixels(graphs):
    """subtree_pixels: the JAX package's pixels in its order."""
    graph = graphs["64x64 pre-cut"]
    for root in (0, 100, int(np.argmax(graph.accuflux(np.ones(graph.num_pixels))))):
        assert np.array_equal(subtree_pixels(graph, root), jax_subtree_pixels(graph, root))


def _router_inputs(P, L=3, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 100, (L, P)), rng.uniform(0, 5, (L, P)),
            rng.uniform(1e-3, 1e3, (L, P)))


def test_router_matches_jax_and_packed(graphs):
    """The sharded router's plain sweep, three lanes, float64, on the
    pre-cut 64x64 graph split into 4 shards (cut edges): against the JAX
    ShardedRouter within rtol 1e-10, atol 1e-12 (measured 4e-16 of the
    max), and against the port's PackedRouter within rtol 1e-9, atol
    1e-11."""
    graph = graphs["64x64 pre-cut"]
    q0, lat, adx = _router_inputs(graph.num_pixels)
    shard_of, _ = catchment_partition(graph, 4)
    router = ShardedRouter(graph, shard_of, chunk_size=64, device="cpu")
    assert router.has_cuts and not router.no_edges
    t = lambda x: torch.as_tensor(x)
    got = router.route_batched(t(q0), t(lat), t(adx), 0.6).numpy()
    ref = np.asarray(JaxShardedRouter(graph, shard_of, chunk_size=64).route_batched(
        jnp.asarray(q0), jnp.asarray(lat), jnp.asarray(adx), 0.6))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    packed = PackedRouter(build_schedule(graph, 64), "cpu").route_batched(
        t(q0), t(lat), t(adx), 0.6).numpy()
    np.testing.assert_allclose(got, packed, rtol=1e-9, atol=1e-11)
    one = router.route(t(q0[0]), t(lat[0]), t(adx[0]), 0.6).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_sweep_bits_do_not_depend_on_shards(graphs, dt):
    """Each pixel sums its sources in ascending natural pixel order, so the
    sweep gives the same bits for every shard count and chunk size."""
    graph = graphs["64x64 pre-cut"]
    q0, lat, adx = (torch.as_tensor(x, dtype=dt) for x in _router_inputs(graph.num_pixels))
    outs = [ShardedRouter(graph, catchment_partition(graph, S)[0], C, device="cpu")
            .route_batched(q0, lat, adx, 0.6) for S in SHARDS for C in (16, 64)]
    for q in outs[1:]:
        assert torch.equal(q, outs[0])


def test_sweep_wrapper_checks_and_devices(graphs):
    """The wrapper takes the router's tile tables, counts no launch on the
    CPU, refuses operands of the wrong shape or type, and raises on a device
    with no kernel."""
    graph = graphs["16x16"]
    router = ShardedRouter(graph, catchment_partition(graph, 4)[0], 64, device="cpu")
    ps = router.ps
    c, a = router.sweep_operands(*(torch.as_tensor(x) for x in _router_inputs(ps.num_pixels)), 0.6)
    tiles = router.sweep_tiles()
    assert (tiles.n_chunks, tiles.n_shards, tiles.chunk) == (ps.n_chunks, ps.n_shards, ps.chunk)
    before = kinwave_sharded_sweep.launches
    q = kinwave_sharded_sweep(c, a, tiles, 0.6)
    assert q.shape == c.shape and kinwave_sharded_sweep.launches == before
    with pytest.raises(ValueError):
        kinwave_sharded_sweep(c[:, :-1], a, tiles, 0.6)
    with pytest.raises(TypeError):
        kinwave_sharded_sweep(c, a, dataclasses.replace(tiles, ups=tiles.ups.long()), 0.6)
    meta = dataclasses.replace(tiles, **{f.name: getattr(tiles, f.name).to("meta")
                                         for f in dataclasses.fields(tiles)
                                         if torch.is_tensor(getattr(tiles, f.name))})
    with pytest.raises(RuntimeError):
        kinwave_sharded_sweep(c.to("meta"), a.to("meta"), meta, 0.6)


# ---------------------------------------------------------------------------
# configuration


def test_config_keeps_num_shards_and_refuses_scan(catchment):
    """config_from_reference carries num_shards; from_settings reads
    RoutingShards for the sharded kernel (4 by default) and 1 otherwise;
    RoutingKernel scan builds (since the scan router was ported) and a
    router name that no package has is refused when the step is built; the
    folded ensemble takes the sharded router (the single model's 2 shards
    replicated, 2 per member) and the scan router (natural schedules
    replicated)."""
    assert config_from_reference(JaxConfig(routing_kernel="sharded", num_shards=8)).num_shards == 8
    assert ModelConfig.from_settings(load_settings(catchment)).num_shards == 1
    sharded = load_settings(catchment, vars_to_set={"RoutingKernel": "sharded"})
    assert ModelConfig.from_settings(sharded).num_shards == 4
    scan = ModelConfig.from_settings(load_settings(catchment, vars_to_set={"RoutingKernel": "scan"}))
    assert scan.routing_kernel == "scan" and scan.num_shards == 1
    cfg, params, state, aux = build_synthetic_model(16, 16, chunk_size=16)
    step, _ = build_step(dataclasses.replace(cfg, routing_kernel="scan"), params, aux,
                         device="cpu")
    assert step.pipeline == "substeps"
    with pytest.raises(ValueError, match="routing_kernel"):
        build_step(dataclasses.replace(cfg, routing_kernel="lockstep"), params, aux, device="cpu")
    for kernel in ("sharded", "scan"):
        cfg_e, _, aux_e = ensemble_model(dataclasses.replace(cfg, routing_kernel=kernel,
                                                             num_shards=2), params, aux, 2)
        assert cfg_e.members == 2 and cfg_e.num_pixels == 2 * cfg.num_pixels
        assert ("sharded" in aux_e) == (kernel == "sharded")
        if kernel == "sharded":
            assert aux_e["sharded"]["kin"].n_shards == 4


def test_from_reference_carries_the_graphs():
    """from_reference on a JAX model with RoutingKernel sharded: the port's
    routers partition the JAX model's channel graph as the JAX package does
    and keep the state natural."""
    cfg, params, state, aux = jax_synthetic_model(16, 16, chunk_size=16)
    cfg = dataclasses.replace(cfg, routing_kernel="sharded", num_shards=4)
    cfg_t, _, s, routers = from_reference(cfg, params, state, aux, device="cpu")
    assert cfg_t.num_shards == 4 and isinstance(routers["kin"], ShardedRouter)
    ref, _ = jax_partition(aux["graph_kin"], 4)
    assert np.array_equal(routers["shard_of"], ref) and routers["kin"].has_cuts
    assert "ChanQKin" in s and not any(k.startswith("pk$") for k in s)
    assert set(routers["seconds"]) == {"partition", "schedule_kin", "router_kin",
                                       "schedule_tochan", "router_tochan"}
