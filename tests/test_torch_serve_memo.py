"""The port's memo plane (``serve/memo.py`` over ``ops/macroblock.py``)
against the JAX package's.

The macro-block codec must give the same bytes and keys as the JAX
package's; memoized trajectories must give the same digests as the JAX
memo router, as the memo-off router and as the numpy oracle, and the
sampled certification must catch a poisoned cache entry.
"""

import io
import json

import numpy as np
import pytest

import akka_game_of_life_tpu.ops.macroblock as j_mblock
import akka_game_of_life_tpu_torch.ops.macroblock as t_mblock
from akka_game_of_life_tpu_torch.obs.events import EventLog
from _torch_serve_pkgs import PKGS, both, cfg, oracle, oracle_digest, random_grid


def _memo_cfg(pkg, **kw):
    kw.setdefault("serve_memo", True)
    kw.setdefault("serve_memo_block", 32)
    return cfg(pkg, **kw)


@pytest.mark.parametrize("states", [2, 3, 5])
def test_codec_bytes_and_keys_match_jax(states):
    rng = np.random.default_rng(states)
    blocks = rng.integers(0, states, size=(9, 16, 16), dtype=np.uint8)
    blocks[3] = 0
    blocks[4] = blocks[5]
    got = t_mblock.encode_blocks(blocks, states)
    assert got == j_mblock.encode_blocks(blocks, states)
    assert [t_mblock.block_key(p) for p in got] == [j_mblock.block_key(p) for p in got]
    for i, p in enumerate(got):
        np.testing.assert_array_equal(t_mblock.decode_block(p, 16, states), blocks[i])


def test_plan_geometry_matches_jax():
    board = np.random.default_rng(3).integers(0, 2, size=(32, 48), dtype=np.uint8)
    tp, jp = t_mblock.plan(32, 48, 32), j_mblock.plan(32, 48, 32)
    assert (tp.tile, tp.steps, tp.n_tiles) == (jp.tile, jp.steps, jp.n_tiles)
    ctx = t_mblock.extract_contexts(board, tp)
    np.testing.assert_array_equal(ctx, j_mblock.extract_contexts(board, jp))
    s = tp.steps
    np.testing.assert_array_equal(tp.assemble(ctx[:, s : s + tp.tile, s : s + tp.tile]), board)
    for args in ((33, 48, 32), (32, 48, 8), (32, 48, 24)):
        assert t_mblock.plan(*args) is None and j_mblock.plan(*args) is None
    assert t_mblock.MIN_BLOCK == j_mblock.MIN_BLOCK


@pytest.mark.parametrize("rule,steps", [("conway", 100), ("highlife", 64), ("brians-brain", 50)])
def test_memoized_trajectory_matches_jax_memo_off_and_oracle(rule, steps):
    board0 = random_grid((64, 64), density=0.5, seed=9)

    def script(pkg):
        registry = pkg.registry()
        with pkg.Router(_memo_cfg(pkg, serve_memo_certify_every=4), registry=registry) as router:
            sid = router.create(tenant="t1", rule=rule, height=64, width=64, seed=9)["id"]
            got = router.step(sid, steps=steps)
            np.testing.assert_array_equal(router.get(sid)["board"], oracle(rule, board0, steps))
            assert registry.value("gol_serve_memo_epochs_total", tenant="t1") > 0
            assert registry.value("gol_memo_certify_total") > 0
            assert registry.value("gol_memo_certify_mismatches_total") == 0
            return got

    got = both(script)
    assert got == (steps, oracle_digest(rule, board0, steps))
    pkg = PKGS["torch"]
    with pkg.Router(cfg(pkg), registry=pkg.registry()) as plain:
        sid = plain.create(tenant="t1", rule=rule, height=64, width=64, seed=9)["id"]
        assert plain.step(sid, steps=steps) == got


def test_cross_tenant_sharing_second_tenant_all_hits():
    def script(pkg):
        registry = pkg.registry()
        with pkg.Router(_memo_cfg(pkg), registry=registry) as router:
            a = router.create(tenant="alice", height=64, width=64, seed=21)["id"]
            first = router.step(a, steps=64)
            assert registry.value("gol_serve_memo_misses_total", tenant="alice") > 0
            b = router.create(tenant="bob", height=64, width=64, seed=21)["id"]
            second = router.step(b, steps=64)
            assert registry.value("gol_serve_memo_hits_total", tenant="bob") > 0
            assert registry.value("gol_serve_memo_misses_total", tenant="bob") == 0
            return first, second, registry.value("gol_serve_memo_hit_rate")

    first, second, rate = both(script)
    assert first[1] == second[1] and rate > 0.4


def _seed_board(router, sid, board, digest):
    with router._lock:
        sess = router._sessions[sid]
        sess.board = board
        sess.lanes = digest.digest_dense_np(board)
        sess.population = int((board == 1).sum())


def test_certification_catches_corrupted_cache_entry():
    """Poison every cache entry after a clean round: the sampled
    certification pages and the direct board wins the commit."""
    pkg = PKGS["torch"]
    registry = pkg.registry()
    events = io.StringIO()
    with pkg.Router(_memo_cfg(pkg, serve_memo_certify_every=1), registry=registry,
                    events=EventLog(stream=events)) as router:
        board = np.zeros((32, 32), dtype=np.uint8)
        board[8:10, 8:10] = 1  # a still life: every round re-probes
        sid = router.create(tenant="t1", height=32, width=32, seed=0, density=0.0)["id"]
        _seed_board(router, sid, board, pkg.digest)
        router.step(sid, steps=8)
        assert registry.value("gol_memo_certify_mismatches_total") == 0
        router._memo.board_cache._entries.clear()
        router._memo.board_cache.bytes = 0
        assert len(router._memo.cache) > 0
        for e in router._memo.cache._entries.values():
            bad = e.center.copy()
            bad[0, 0] ^= 1
            bad.setflags(write=False)
            e.center = bad
            e.center_payload = t_mblock.encode_blocks(bad[None], 2)[0]
            e.pop = int((bad == 1).sum())
        epoch, digest = router.step(sid, steps=8)
        assert registry.value("gol_memo_certify_mismatches_total") >= 1
        assert (epoch, digest) == (16, oracle_digest("conway", board, 16))
        np.testing.assert_array_equal(router.get(sid)["board"], oracle("conway", board, 16))
        assert router._sessions[sid].memo.disabled
        names = [json.loads(line)["event"] for line in events.getvalue().splitlines()]
        assert "memo_certify_mismatch" in names


def test_board_chain_level_carries_periodic_orbits():
    board = np.zeros((32, 32), dtype=np.uint8)
    board[4:6, 4:6] = 1
    board[20, 10:13] = 1  # blinker, period 2 (divides S = 8)

    def script(pkg):
        with pkg.Router(_memo_cfg(pkg), registry=pkg.registry()) as router:
            sid = router.create(tenant="t1", height=32, width=32, seed=0, density=0.0)["id"]
            _seed_board(router, sid, board, pkg.digest)
            got = router.step(sid, steps=80)
            bc = router._memo.board_cache
            assert bc.hits >= 8 and bc.stats()["board_entries"] >= 1
            return got

    assert both(script) == (80, oracle_digest("conway", board, 80))


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_imported_session_arrives_memo_cold_and_rewarms(src, dst):
    a, b = PKGS[src], PKGS[dst]
    reg_b = b.registry()
    with a.Router(_memo_cfg(a), registry=a.registry()) as ra, b.Router(_memo_cfg(b), registry=reg_b) as rb:
        sid = ra.create(tenant="t1", height=64, width=64, seed=55)["id"]
        ra.step(sid, steps=32)
        rb.import_sessions(ra.export_sessions([sid]))
        assert rb._sessions[sid].memo is None
        got = rb.step(sid, steps=32)
        assert got == (64, oracle_digest("conway", random_grid((64, 64), density=0.5, seed=55), 64))
        assert rb._sessions[sid].memo is not None
        assert reg_b.value("gol_serve_memo_epochs_total", tenant="t1") > 0
