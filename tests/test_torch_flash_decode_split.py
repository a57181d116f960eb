"""The order of work of the split f32/bf16-cache decode kernel
(raydp_tpu_torch/csrc/flash_decode.cu), emulated in torch ops.

The kernel keeps the bits of the sequential per-row update over 32-key
tiles by splitting it into: (1) each tile's scores and max, (2) the row max
before and at each tile as a max over the earlier tiles' maxima, (3) each
tile's p, sum of p and p @ v against that max, independently of every other
tile, and (4) the merges in tile order, rescaling where the max moved and
adding where it did not. The emulation below runs those steps apart, in
that order, with the same torch ops as a sequential tile-by-tile online
update; the two agree bit for bit. It is held within 1e-5 of the JAX
package's ``flash_decode`` in interpret mode (f32, different k-tile
partitions), on inputs made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raydp_tpu.ops.flash_attention import flash_decode as jax_flash_decode
from raydp_tpu_torch.ops import flash_attention as fa

TILE = fa.BLOCK_K


def _tiles(q, k, v, lens, bi, r):
    """Sequence bi's query row r over its tiles: a list of (scores [H, 1,
    TILE] masked to NEG_INF, V tile [H, TILE, D]) in tile order, with the
    cache rows at or past the valid length read as zeros."""
    tq, d = q.shape[2], q.shape[3]
    tk = k.shape[2]
    length = int(lens[bi])
    valid = min(length, tk)
    q_pos = length - tq + r
    out = []
    for k0 in range(0, valid, TILE):
        if q_pos < k0:  # the tile lies in the row's future
            break
        keys = torch.arange(k0, k0 + TILE)
        ok = keys < valid
        rows = torch.clamp(keys, max=tk - 1)
        kt = torch.where(ok[:, None], k[bi][:, rows], torch.zeros(()))
        vt = torch.where(ok[:, None], v[bi][:, rows], torch.zeros(()))
        s = (q[bi][:, r:r + 1] @ kt.transpose(-1, -2)) * d**-0.5
        live = ok & (keys <= q_pos)
        out.append((torch.where(live, s, torch.full_like(s, fa.NEG_INF)), vt))
    return out


def _probs(s, m):
    p = torch.exp(s - m)
    return torch.where(s > fa.NEG_INF / 2, p, torch.zeros_like(p))


def _sequential(q, k, v, lens):
    """The tile-by-tile online update (the prefill's row_update order)."""
    b, h, tq, d = q.shape
    out = torch.zeros((b, h, tq, d))
    for bi in range(b):
        for r in range(tq):
            m = torch.full((h, 1, 1), fa.NEG_INF)
            l = torch.zeros((h, 1, 1))  # noqa: E741
            o = torch.zeros((h, 1, d))
            for s, vt in _tiles(q, k, v, lens, bi, r):
                tile_max = s.amax(dim=-1, keepdim=True)
                m_new = torch.maximum(m, tile_max)
                p = _probs(s, m_new)
                p_sum = p.sum(dim=-1, keepdim=True)
                pv = p @ vt
                moved = tile_max > m
                alpha = torch.exp(m - m_new)
                l = torch.where(moved, alpha * l + p_sum, l + p_sum)  # noqa: E741
                o = torch.where(moved, alpha * o + pv, o + pv)
                m = m_new
            out[bi, :, r:r + 1] = o / torch.clamp(l, min=1e-30)
    return out


def _split(q, k, v, lens):
    """The kernel's order: every tile's scores and max first; the row max
    before each tile as one max over the earlier maxima; each tile's
    partials alone; then the merges in tile order."""
    b, h, tq, d = q.shape
    out = torch.zeros((b, h, tq, d))
    for bi in range(b):
        for r in range(tq):
            tiles = _tiles(q, k, v, lens, bi, r)  # step 1
            maxima = [s.amax(dim=-1, keepdim=True) for s, _ in tiles]
            floor = torch.full((h, 1, 1), fa.NEG_INF)
            parts = []
            # steps 2-3, each tile independent of the others given its maxima
            for t in reversed(range(len(tiles))):
                s, vt = tiles[t]
                m_prev = torch.stack([floor, *maxima[:t]]).amax(dim=0)
                m_new = torch.maximum(m_prev, maxima[t])
                p = _probs(s, m_new)
                moved = maxima[t] > m_prev
                alpha = torch.where(moved, torch.exp(m_prev - m_new),
                                    torch.full_like(m_prev, -1.0))
                parts.append((alpha, p.sum(dim=-1, keepdim=True), p @ vt))
            l = torch.zeros((h, 1, 1))  # noqa: E741
            o = torch.zeros((h, 1, d))
            for alpha, p_sum, pv in reversed(parts):  # step 4, in tile order
                moved = alpha >= 0
                l = torch.where(moved, alpha * l + p_sum, l + p_sum)  # noqa: E741
                o = torch.where(moved, alpha * o + pv, o + pv)
            out[bi, :, r:r + 1] = o / torch.clamp(l, min=1e-30)
    return out


CAPACITY = 256


@pytest.mark.parametrize("lengths, tq", [
    ([1, 31, 32, 33], 1),          # one key, and the tile boundary -1, 0, +1
    ([128, 129, CAPACITY, 0], 1),  # a block boundary, capacity, no live key
    ([2, 33, 129, CAPACITY], 3),   # causal inside the new rows; row 0 of
                                   # the first sequence has no live key
    ([CAPACITY + 40, 31, 32, 200], 3),  # past capacity (clipped)
])
@pytest.mark.parametrize("d", [32, 64])
def test_split_decode_order_keeps_the_sequential_bits(lengths, tq, d):
    b, h = len(lengths), 2
    rng = np.random.default_rng(31)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, CAPACITY, d)).astype(np.float32)
    v = rng.standard_normal((b, h, CAPACITY, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    tq_, tk_, tv_ = (torch.tensor(x) for x in (q, k, v))
    # stale rows past each sequence's length never reach the sums
    tk_[0, :, lengths[0]:] = float("nan")
    tv_[0, :, lengths[0]:] = float("inf")

    got = _split(tq_, tk_, tv_, lens)
    assert torch.equal(got, _sequential(tq_, tk_, tv_, lens))

    no_key = lens[:, None] - tq + np.arange(tq)[None, :] < 0
    no_key |= (lens == 0)[:, None]
    for bi, r in zip(*np.nonzero(no_key)):
        assert torch.equal(got[bi, :, r], torch.zeros((h, d)))

    ref = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), fa.flash_decode(tq_, tk_, tv_, torch.from_numpy(lens)).numpy(),
        rtol=0, atol=1e-6)
