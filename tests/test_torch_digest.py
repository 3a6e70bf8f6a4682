"""The port's board digests against the JAX package's, bit for bit.

The 64-bit digest is what certifies the port against the JAX package, so the
torch versions (int64 with 32-bit masking, row-blocked) must give exactly the
JAX uint32 lanes, at non-zero origins and global widths too.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from akka_game_of_life_tpu.ops import digest as jdig
from akka_game_of_life_tpu_torch.ops import bitpack as tbp
from akka_game_of_life_tpu_torch.ops import digest as tdig
import torch


def _words(h, nw, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(h, nw), dtype=np.uint32)
    w[0, :] |= np.uint32(1 << 31)
    return w


def _lanes(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize(
    "h,nw,width,row0,wordcol0",
    [(1, 1, 32, 0, 0), (7, 3, 96, 0, 0), (9, 2, 65536, 5, 3), (16, 4, 4096, 100, 17)],
)
def test_digest_packed_matches(h, nw, width, row0, wordcol0):
    w = _words(h, nw, seed=h * nw)
    want = np.asarray(jdig.digest_packed(jnp.asarray(w), width, row0, wordcol0))
    got = tdig.digest_packed(tbp.words_from_numpy(w), width, row0, wordcol0)
    np.testing.assert_array_equal(_lanes(got), want)
    if row0 == wordcol0 == 0 and width == nw * 32:
        np.testing.assert_array_equal(tdig.digest_packed_np(w, width), want)
        np.testing.assert_array_equal(jdig.digest_packed_np(w, width), want)


@pytest.mark.parametrize("states", [2, 4])
@pytest.mark.parametrize("row0,col0,width", [(0, 0, None), (3, 11, 1000)])
def test_digest_dense_matches(states, row0, col0, width):
    rng = np.random.default_rng(states)
    board = rng.integers(0, states, size=(13, 37), dtype=np.uint8)
    want = np.asarray(jdig.digest_dense(jnp.asarray(board), row0, col0, width))
    got = tdig.digest_dense(torch.from_numpy(board), row0, col0, width)
    np.testing.assert_array_equal(_lanes(got), want)
    np.testing.assert_array_equal(
        tdig.digest_dense_np(board, (row0, col0), width),
        jdig.digest_dense_np(board, (row0, col0), width),
    )


@pytest.mark.parametrize(
    "shape,states,origin,width",
    [((1, 1), 2, (0, 0), 1), ((13, 37), 4, (3, 11), 1000), ((64, 64), 2, (4032, 4032), 4096),
     ((40, 24), 256, (65500, 65000), 65536)],
)
def test_keyed_digest_matches(shape, states, origin, width):
    """A tile's digest as its cell-free key table times its cells equals
    the JAX package's host digest of the tile, at any origin and width."""
    rng = np.random.default_rng(states + shape[0])
    tile = rng.integers(0, states, size=shape, dtype=np.uint8)
    keys = tdig.key_lanes_np(shape, origin, width)
    assert keys.shape == (2, shape[0] * shape[1]) and keys.dtype == np.uint32
    got = tdig.digest_keyed_np(keys, tile)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jdig.digest_dense_np(tile, origin, width))


def test_packed_equals_dense_of_unpacked():
    w = _words(6, 2, seed=4)
    packed = tdig.digest_packed(tbp.words_from_numpy(w), 64)
    dense = tdig.digest_dense(torch.from_numpy(tbp.unpack_np(w)))
    np.testing.assert_array_equal(_lanes(packed), _lanes(dense))


def test_row_blocks_and_empty_skips(monkeypatch):
    """Small row blocks (many partial sums) and all-zero blocks (skipped)
    leave the lanes unchanged."""
    w = _words(40, 3, seed=8)
    w[8:24] = 0
    want = np.asarray(jdig.digest_packed(jnp.asarray(w), 96))
    monkeypatch.setattr(tdig, "_BLOCK_ELEMS", 3 * 4)
    got = tdig.digest_packed(tbp.words_from_numpy(w), 96)
    np.testing.assert_array_equal(_lanes(got), want)


def test_value_merge_and_format_match():
    parts = [np.array([0xFFFFFFFF, 1], np.uint32), np.array([2, 0xFFFFFFFF], np.uint32)]
    np.testing.assert_array_equal(tdig.merge_lanes(parts), jdig.merge_lanes(parts))
    lanes = np.array([0x89ABCDEF, 0x01234567], np.uint32)
    assert tdig.value(lanes) == jdig.value(lanes) == 0x0123456789ABCDEF
    assert tdig.value(torch.tensor([0x89ABCDEF, 0x01234567])) == 0x0123456789ABCDEF
    assert tdig.format_digest(255) == jdig.format_digest(255) == "00000000000000ff"
