"""The port's cluster plumbing is the JAX package's, byte for byte.

Wire frames, encoded rings, tile payloads, tile layouts, halo assembly,
protocol constants, seeded crash and network-chaos schedules, and the
config's cluster keys: the same inputs give equal bytes or equal values in
both packages.  Also the config refusals by name.
"""

import socket

import numpy as np
import pytest

from akka_game_of_life_tpu.runtime import protocol as JP
from akka_game_of_life_tpu.runtime import tiles as jtiles
from akka_game_of_life_tpu.runtime import wire as jwire
from akka_game_of_life_tpu.runtime.boundary import BoundaryStore as JStore
from akka_game_of_life_tpu.runtime.chaos import CrashInjector as JInjector
from akka_game_of_life_tpu.runtime.config import FaultInjectionConfig as JFI
from akka_game_of_life_tpu.runtime.config import NetworkChaosConfig as JNC
from akka_game_of_life_tpu.runtime.config import load_config as jload
from akka_game_of_life_tpu.runtime.netchaos import NetworkChaos as JChaos
from akka_game_of_life_tpu.runtime.rebalance import Rebalancer as JRebalancer
from akka_game_of_life_tpu_torch.runtime import protocol as TP
from akka_game_of_life_tpu_torch.runtime import tiles as ttiles
from akka_game_of_life_tpu_torch.runtime import wire as twire
from akka_game_of_life_tpu_torch.runtime.boundary import BoundaryStore as TStore
from akka_game_of_life_tpu_torch.runtime.chaos import CrashInjector as TInjector
from akka_game_of_life_tpu_torch.runtime.config import FaultInjectionConfig as TFI
from akka_game_of_life_tpu_torch.runtime.config import NetworkChaosConfig as TNC
from akka_game_of_life_tpu_torch.runtime.config import load_config as tload
from akka_game_of_life_tpu_torch.runtime.netchaos import NetworkChaos as TChaos
from akka_game_of_life_tpu_torch.runtime.rebalance import Rebalancer as TRebalancer

RNG = np.random.default_rng(5)
TILE = RNG.integers(0, 2, size=(24, 40), dtype=np.uint8)
TILE3 = RNG.integers(0, 3, size=(24, 40), dtype=np.uint8)


def _frame(channel_cls, msg) -> bytes:
    a, b = socket.socketpair()
    try:
        channel_cls(a).send(msg)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        a.close()
        b.close()


def _messages(mod, tiles_mod):
    ring = tiles_mod.Ring.of(TILE, 3)
    return [
        {"type": "register", "name": "w0", "peer_port": 4242, "engine": "torch", "pallas": "auto"},
        {"type": "deploy", "tiles": [{"id": [0, 1], "epoch": 10, "origin": [0, 40], "state": mod.pack_tile(TILE)}],
         "rule": "B3/S23", "target": 120, "final_epoch": 120, "render_strides": [1, 2]},
        {"type": "peer_ring_batch", "rings": [{"tile": [0, 1], "epoch": 7, "ring": mod.encode_ring(ring, True)},
                                              {"tile": [1, 1], "epoch": 7, "ring": mod.encode_ring(ring, False)}]},
        {"type": "progress", "tile": [1, 0], "epoch": 30, "digest": [123, 456]},
        {"type": "tile_state", "tile": [0, 0], "epoch": 30, "reasons": ["checkpoint"],
         "state": mod.pack_tile(TILE3), "population": np.int64(17), "sample": TILE[::4, ::4]},
    ]


@pytest.mark.parametrize("i", range(5))
def test_frames_are_byte_equal(i):
    jmsg = _messages(jwire, jtiles)[i]
    tmsg = _messages(twire, ttiles)[i]
    assert _frame(twire.Channel, tmsg) == _frame(jwire.Channel, jmsg)


def test_frames_cross_decode():
    for msg in _messages(twire, ttiles):
        a, b = socket.socketpair()
        try:
            twire.Channel(a).send(msg)
            got = jwire.Channel(b).recv()
        finally:
            a.close()
            b.close()
        assert got["type"] == msg["type"]
    a, b = socket.socketpair()
    jwire.Channel(a).send(_messages(jwire, jtiles)[1])
    got = twire.Channel(b).recv()
    a.close()
    b.close()
    np.testing.assert_array_equal(twire.unpack_tile(got["tiles"][0]["state"]), TILE)


@pytest.mark.parametrize("pack,width", [(True, 1), (True, 5), (False, 1), (False, 5)])
def test_rings_encode_equal_and_round_trip(pack, width):
    board = TILE if pack else TILE3
    jr, tr = jtiles.Ring.of(board, width), ttiles.Ring.of(board, width)
    je, te = jwire.encode_ring(jr, pack), twire.encode_ring(tr, pack)
    assert {k: v for k, v in je.items() if k != "data"} == {k: v for k, v in te.items() if k != "data"}
    assert je["data"].tobytes() == te["data"].tobytes()
    back = twire.decode_ring(je)
    np.testing.assert_array_equal(back.top, jr.top)
    np.testing.assert_array_equal(back.corners["se"], jr.corners["se"])
    assert twire.ring_entry_nbytes(te) == jwire.ring_entry_nbytes(je)


@pytest.mark.parametrize("arr", [TILE, TILE3], ids=["binary", "multistate"])
def test_tile_payloads_equal(arr):
    j, t = jwire.pack_tile(arr), twire.pack_tile(arr)
    assert (j["enc"], j["shape"]) == (t["enc"], t["shape"])
    assert j["data"].tobytes() == t["data"].tobytes()
    np.testing.assert_array_equal(twire.unpack_tile(j), arr)


@pytest.mark.parametrize("shape,workers", [((64, 64), 2), ((48, 96), 4), ((96, 64), 6), ((16384, 16384), 2)])
def test_layouts_equal(shape, workers):
    jl, tl = jtiles.layout_for_workers(shape, workers), ttiles.layout_for_workers(shape, workers)
    assert (jl.grid, jl.tile_shape, jl.tile_ids) == (tl.grid, tl.tile_shape, tl.tile_ids)
    for t in tl.tile_ids:
        assert jl.origin(t) == tl.origin(t)
        assert jl.neighbors(t) == tl.neighbors(t)


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_2d_equal(n):
    from akka_game_of_life_tpu.parallel.mesh import factor_2d

    assert ttiles.factor_2d(n) == factor_2d(n)


def test_halo_assembly_equal():
    board = RNG.integers(0, 2, size=(32, 48), dtype=np.uint8)
    jl, tl = jtiles.layout_for_workers(board.shape, 4), ttiles.layout_for_workers(board.shape, 4)
    js, ts = JStore(jl, 2), TStore(tl, 2)
    for t in tl.tile_ids:
        js.push_ring(t, 0, jtiles.Ring.of(jl.extract(board, t), 2))
        ts.push_ring(t, 0, ttiles.Ring.of(tl.extract(board, t), 2))
    for t in tl.tile_ids:
        jh, th = js.pull_halo_now(t, 0, lambda h: None), ts.pull_halo_now(t, 0, lambda h: None)
        np.testing.assert_array_equal(th.pad(tl.extract(board, t)), jh.pad(jl.extract(board, t)))


def test_protocol_constants_equal():
    names = [n for n in dir(JP) if n.isupper() and isinstance(getattr(JP, n), str)]
    assert len(names) > 30
    assert {n: getattr(TP, n) for n in names} == {n: getattr(JP, n) for n in names}


def test_crash_schedules_equal():
    kw = dict(enabled=True, first_after_s=0.5, every_s=0.25, max_crashes=4, seed=9)
    j, t = JInjector(JFI(**kw), start_time=0.0), TInjector(TFI(**kw), start_time=0.0)
    times = [i * 0.1 for i in range(30)]
    assert [t.should_crash(x) for x in times] == [j.should_crash(x) for x in times]
    assert [t.rng.random() for _ in range(5)] == [j.rng.random() for _ in range(5)]
    kw = dict(enabled=True, first_after_epochs=10, every_epochs=20, max_crashes=3)
    j, t = JInjector(JFI(**kw), start_time=0.0), TInjector(TFI(**kw), start_time=0.0)
    assert [t.should_crash_at_epoch(e) for e in range(100)] == [j.should_crash_at_epoch(e) for e in range(100)]


def test_network_chaos_schedules_equal():
    kw = dict(enabled=True, seed=3, drop_p=0.2, delay_p=0.3, delay_s=0.05,
              duplicate_p=0.1, reorder_p=0.1, partition_after_s=1.0,
              partition_every_s=2.0, partition_heal_s=0.5, max_partitions=2)
    j, t = JChaos(JNC(**kw), start_time=0.0), TChaos(TNC(**kw), start_time=0.0)
    for chaos in (j, t):
        for n in ("frontend", "w0", "w1", "w2"):
            chaos.register_node(n)
    trail = []
    for chaos in (j, t):
        out = []
        for i in range(200):
            now = i * 0.03
            d = chaos.on_send(f"w{i % 3}", f"w{(i + 1) % 3}", now)
            out.append((d.blocked, d.drop, round(d.delay_s, 12), d.duplicate, d.reorder, chaos.partitioned()))
        trail.append((out, chaos.partitions))
    assert trail[1] == trail[0]
    assert trail[0][1] == 2


def test_rebalance_plans_equal():
    from akka_game_of_life_tpu.runtime.config import SimulationConfig as JCfg
    from akka_game_of_life_tpu.runtime.membership import Member as JMember
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig as TCfg
    from akka_game_of_life_tpu_torch.runtime.membership import Member as TMember
    from akka_game_of_life_tpu_torch.runtime.rebalance import rendezvous_pick
    from akka_game_of_life_tpu.serve.sessions import rendezvous_pick as jpick

    kw = dict(rebalance_enabled=True, rebalance_interval_s=0.1)
    plans = []
    for cfg, member, reb in ((JCfg(**kw), JMember, JRebalancer), (TCfg(**kw), TMember, TRebalancer)):
        members = [member(name=f"w{i}", channel=None, last_seen=0.0) for i in range(3)]
        members[0].tiles = [(0, c) for c in range(5)]
        members[1].tiles = [(1, 0)]
        epochs = {t: 4 for m in members for t in m.tiles}
        plans.append(reb(cfg).plan(members, epochs, 100, 10.0))
    assert plans[0] == plans[1] and plans[0]
    names = [f"n{i}" for i in range(7)]
    assert [rendezvous_pick(f"k{i}", names) for i in range(20)] == [jpick(f"k{i}", names) for i in range(20)]


def test_cluster_keys_load_like_jax(tmp_path):
    path = tmp_path / "cluster.toml"
    path.write_text(
        'height = 256\nwidth = 256\nmax_epochs = 120\nexchange_width = 10\n'
        'metrics_every = 30\ncheckpoint_every = 30\nobs_digest = true\n'
        'failure_timeout_s = "10s"\ntick_s = "200ms"\nring_batch = false\n'
        '[fault_injection]\nenabled = true\nmode = "node"\nfirst_after_epochs = 10\nevery_epochs = 20\n'
        '[net_chaos]\nenabled = true\ndrop_p = 0.1\nscope = "all"\n'
    )
    j, t = jload(str(path)), tload(str(path))
    for name in ("height", "exchange_width", "failure_timeout_s", "tick_s", "ring_batch",
                 "metrics_every", "checkpoint_every", "obs_digest", "max_epochs"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.fault_injection.__dict__ == j.fault_injection.__dict__
    assert t.net_chaos.__dict__ == j.net_chaos.__dict__


@pytest.mark.parametrize(
    "key,value",
    [
        ("serve_cluster", True), ("serve_max_sessions", 4), ("frontend_seeds", "a:1"),
        ("coordinator_address", "h:1"), ("num_processes", 2), ("distributed", True),
        ("process_id", 1), ("serve_memo", True), ("backend", "actor"),
        ("pallas_vmem_limit_mb", 8),
    ],
)
def test_unported_keys_refused_by_name(key, value):
    if key in ("coordinator_address", "num_processes", "distributed", "process_id",
               "serve_max_sessions", "serve_memo", "backend", "serve_cluster",
               "frontend_seeds"):
        # The multi-process run, the serving plane (single-process,
        # cluster and federation) and the actor engines are ported: the
        # key loads as the JAX package loads it.
        assert getattr(tload(None, {key: value}), key) == getattr(jload(None, {key: value}), key)
        return
    with pytest.raises(ValueError, match=key):
        tload(None, {key: value})


def test_orbax_and_bad_cadence_refused(tmp_path):
    # orbax is the standalone run's store; the cluster frontend refuses it
    # (the JAX package's text), and an unknown format is refused by name.
    assert tload(None, {"checkpoint_format": "orbax"}).checkpoint_format == "orbax"
    from akka_game_of_life_tpu_torch.runtime.checkpoint import make_store
    from akka_game_of_life_tpu_torch.runtime.frontend import Frontend

    with pytest.raises(ValueError, match="checkpoint_format='npz'.*orbax"):
        Frontend(tload(None, {"checkpoint_format": "orbax", "max_epochs": 4,
                              "checkpoint_dir": str(tmp_path / "fe")}))
    with pytest.raises(ValueError, match="pickle"):
        make_store(str(tmp_path / "x"), "pickle")
    with pytest.raises(ValueError, match="multiple of exchange_width"):
        tload(None, {"exchange_width": 4, "metrics_every": 6})
