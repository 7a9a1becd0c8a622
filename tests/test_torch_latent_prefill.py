"""K5 at MLA's 640-lane latent row (``flash_prefill_latent_kernel``): its
tiles, walk and block order (``ops/flash_prefill.py``) against the JAX
package, on the CPU.

A cluster of two blocks owns a tile of 128 (position, head) rows of one KV
head, position-major: ``hb = min(G, 128)`` heads by ``128 // hb`` positions
(rows past ``hb * bq`` idle, a group past 128 heads split over tiles). It
walks K/V tiles of 32 keys from key 0 to the tile's last position; each
64-row warpgroup computes the prefix of the walk up to its own last
position, and every score is masked by the length and the diagonal. The
Python twins are ``latent_geometry``, ``latent_rows``, ``latent_walk``,
``latent_takes``, ``latent_tile_order`` and ``latent_clusters``. Here:

- at G 2, 4, 6, 16 and 128 (DeepSeek-V2's full model: more heads than one
  tile holds), over ragged lengths and offsets that are not multiples of the
  tile, the clusters' tiles, walks and masks compute every (sequence, head,
  row, key) that JAX's causal / length mask keeps exactly once, and none it
  drops. The mask is read from JAX's ``flash_prefill`` in interpret mode:
  with q = 0 every kept score is equal, so a one-hot V row a key gives each
  kept key the weight 1 / (kept keys) and each dropped key 0;
- the clusters cover each (sequence, KV head, position tile, head group)
  once and start sequence 0's longest walks first;
- the tiles hold the fewest idle rows a group allows, and the shared memory
  fits the H100's 227 KB.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest

from starflashattention_tpu.ops.flash_prefill import flash_prefill as j_flash_prefill
from starflashattention_tpu_torch.ops import flash_prefill as fp

SMEM_LIMIT = 232_448  # bytes of shared memory a block can take on the H100
D = 640

# B, Hkv, Sq, Skv, q_offsets, lengths (Skv <= D: the one-hot V reads one key a lane)
CASES = {
    "chunks": (2, 1, 48, 96, (0, 48), (48, 96)),  # phase 2's two chunks, cut to size
    "ragged": (2, 2, 37, 300, (5, 200), (42, 237)),  # lengths and offsets off the tile
    "short_lengths": (2, 1, 40, 200, (150, 0), (120, 33)),  # rows past the length, a shorter chunk
    "one_row": (1, 1, 1, 90, (70,), (71,)),  # one position: a decode-sized chunk
}
GROUPS = (2, 4, 6, 16, 128)


def _jax_mask(c):
    """(B, Sq, Skv) bool: the (row, key) pairs JAX's flash_prefill keeps."""
    b, _, sq, skv, q_off, lengths = c
    q = jnp.zeros((b, 1, sq, D), jnp.float32)
    k = jnp.asarray(np.random.default_rng(0).standard_normal((b, 1, skv, D)), jnp.float32)
    v = jnp.asarray(np.broadcast_to(np.eye(skv, D, dtype=np.float32), (b, 1, skv, D)))
    out = np.asarray(j_flash_prefill(q, k, v, jnp.asarray(lengths, jnp.int32), causal=True,
                                     q_offsets=jnp.asarray(q_off, jnp.int32)))
    return out[:, 0, :, :skv] > 0


_MASKS = {}


def _mask(name):
    if name not in _MASKS:
        _MASKS[name] = _jax_mask(CASES[name])
    return _MASKS[name]


def _walked(c, g):
    """Counter of (sequence, query head, row, key) the twins compute."""
    b, hkv, sq, skv, q_off, lengths = c
    walked = collections.Counter()
    for bi, kvh, qt, hg in fp.latent_clusters(b, hkv, sq, skv, g, lengths, q_off):
        _, bq, _, _ = fp.latent_geometry(g)
        length = min(lengths[bi], skv)
        n = fp.latent_walk(qt, bq=bq, sq=sq, length=length, q_offset=q_off[bi])
        rows = fp.latent_rows(g, sq, qt, hg)
        takes = fp.latent_takes(rows, q_off[bi], n)
        for r, row in enumerate(rows):
            if row is None:
                continue
            head, i = row
            for tile in range(takes[r // fp.LATENT_GROUP_ROWS]):
                for key in range(tile * fp.LATENT_KEYS, (tile + 1) * fp.LATENT_KEYS):
                    if key < length and key <= q_off[bi] + i:  # the kernel's mask
                        walked[(bi, kvh * g + head, i, key)] += 1
    return walked


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("name", list(CASES))
def test_latent_walk_covers_jax_mask_once(name, g):
    c = CASES[name]
    b, hkv, sq = c[:3]
    mask = _mask(name)
    want = {(bi, h, i, key) for bi, i, key in zip(*np.nonzero(mask)) for h in range(hkv * g)}
    walked = _walked(c, g)
    assert set(walked) == want, sorted(set(walked) ^ want)[:8]
    assert all(n == 1 for n in walked.values())


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("name", list(CASES))
def test_latent_clusters_cover_each_tile_once_longest_first(name, g):
    b, hkv, sq, skv, q_off, lengths = CASES[name]
    hb, bq, nhg, _ = fp.latent_geometry(g)
    clusters = fp.latent_clusters(b, hkv, sq, skv, g, lengths, q_off)
    n_qt = -(-sq // bq)
    assert sorted(clusters) == sorted((bi, kvh, qt, hg) for bi in range(b) for kvh in range(hkv)
                                      for qt in range(n_qt) for hg in range(nhg))
    walks = [fp.latent_walk(qt, bq=bq, sq=sq, length=min(lengths[0], skv), q_offset=q_off[0])
             for bi, _, qt, _ in clusters if bi == 0]
    assert walks == sorted(walks, reverse=True)
    # the causal end of a tile is its last position's: no tile past it, none short of it
    for bi, _, qt, hg in clusters:
        last = min(qt * bq + bq, sq) - 1
        end = min(lengths[bi], skv, q_off[bi] + last + 1)
        assert fp.latent_walk(qt, bq=bq, sq=sq, length=min(lengths[bi], skv), q_offset=q_off[bi]) == (
            -(-end // fp.LATENT_KEYS) if end > 0 else 0)


@pytest.mark.parametrize("g", (1, 2, 3, 4, 6, 16, 24, 64, 128, 160, 256))
def test_latent_tiles_fill_the_rows(g):
    hb, bq, nhg, smem = fp.latent_geometry(g)
    assert smem <= SMEM_LIMIT
    assert hb * bq <= fp.LATENT_ROWS < hb * (bq + 1)  # the fewest idle rows the group allows
    assert hb * nhg >= g > hb * (nhg - 1)  # the group's heads over its tiles
    rows = fp.latent_rows(g, 10 * bq, 3, nhg - 1)
    live = [r for r in rows if r is not None]
    assert len(live) == min(hb, g - (nhg - 1) * hb) * bq  # the last head group's live rows
    assert all(r[1] // bq == 3 for r in live)  # every row of position tile 3
    assert rows[:len(live)] == live  # idle rows at the end, position-major before them
