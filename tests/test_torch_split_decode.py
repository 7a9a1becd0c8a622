"""The chunk grid of the split-KV decode kernel against the JAX package, on
the CPU: its walks, its sizing, and the plain split-and-merge on fp32 caches
(``tests/split_decode_cases.py``; the int8 / fp8 caches are in
``tests/test_torch_split_decode_quant.py``).

Here:

- the walks cover every row some query token attends exactly once, the
  sinks in chunk 0 only, nothing below token 0's band that is not a sink,
  every tile a 32-row tile of its own chunk;
- the grid depends on S, B, Hkv and D alone: 8 blocks an SM up to D 256 (the
  same grid at D 64, 128 and 256), one at MLA's D 640;
- the plain split-and-merge equals JAX's ``flash_decode(num_splits=1)``,
  ``flash_verify`` and ``paged_flash_decode`` at head_dim 64, 128 and 256
  on the edge cases, and at MLA's latent row (D 640, 16 query heads on one
  KV head, sm_scale 192 ** -0.5) on the D 640 grid's chunks, with lengths on
  each side of every chunk edge.

Tolerance: fp32 on both sides, 1e-5 absolute (see the helper module).
"""

import pytest
import torch

from split_decode_cases import CASES, S, check_against_jax
from starflashattention_tpu_torch.ops import flash_decode as t_fd

torch.set_num_threads(1)

TILE = t_fd.TILE
SMS = 132  # an H100's SMs
LATENT_S = 512  # D 640: 4 chunks of 128 rows at B 4
# name: lengths of token 0 (B 4), each beside an edge of the D 640 grid's 128-row chunks
LATENT_CASES = {
    "latent-edges-low": (0, 1, 127, 128),
    "latent-edges-high": (129, 255, 385, 512),
}


def _attended(length, t, window, sinks, s=S):
    """Rows some query token attends: token j sees [len + j - window,
    len + j) below the table's end, plus the sinks below its length."""
    rows = set()
    for j in range(t):
        n = min(length + j, s)
        lo = 0 if window is None else n - window
        rows |= {p for p in range(n) if p >= lo or p < sinks}
    return rows


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunk_walks_read_each_attended_row_once(name):
    lengths, window, sinks, _, chunk, t = CASES[name]
    for length in lengths:
        walks = t_fd.split_chunk_walk(length, s=S, chunk=chunk, qspan=t, window=window, sinks=sinks)
        assert len(walks) == -(-S // chunk)
        read = []
        for c, tiles in enumerate(walks):
            for j0, rows in tiles:
                assert j0 % TILE == 0 and c * chunk <= j0 < (c + 1) * chunk
                assert all(j0 <= p < j0 + TILE and p < (c + 1) * chunk for p in rows)
                read += rows
        assert len(read) == len(set(read)), "a row read twice"
        assert set(read) == _attended(length, t, window, sinks)
        lo = 0 if window is None else max(length - window, 0)
        assert all(p >= lo or p < sinks for p in read), "a row below the band that is not a sink"
        sink_rows = {p for p in read if p < sinks and p < lo}
        assert all(p < chunk for p in sink_rows), "a sink outside chunk 0"


@pytest.mark.parametrize("s,b,hkv", [(8192, 8, 8), (8192, 8, 16), (1024, 16, 8), (512, 4, 2), (100, 1, 1)])
def test_chunking_fills_the_card(s, b, hkv):
    """C is a multiple of the tile and at least SPLIT_MIN_CHUNK rows; N =
    ceil(S / C) gives at least 2 blocks an SM of 132 unless the minimum
    chunk caps it (Gemma-2-9B's decode, B 8, Hkv 8, S 8192: 576 blocks). D
    64, 128 and 256 share one grid, 8 blocks an SM."""
    c, n = t_fd.split_chunking(s, b, hkv, SMS, 128)
    assert c % TILE == 0 and c >= t_fd.SPLIT_MIN_CHUNK and n == -(-s // c)
    assert b * hkv * n >= min(2 * SMS, b * hkv * -(-s // t_fd.SPLIT_MIN_CHUNK))
    target = -(-t_fd.SPLIT_BLOCKS_PER_SM * SMS // (b * hkv))
    want = max(t_fd.SPLIT_MIN_CHUNK, -(-(-(-s // target)) // TILE) * TILE)
    assert all(t_fd.split_chunking(s, b, hkv, SMS, d) == (want, -(-s // want)) for d in t_fd.KERNEL_HEAD_DIMS)


@pytest.mark.parametrize("s,b,want", [(4096, 4, (128, 32)), (4096, 1, (128, 32)), (4096, 16, (480, 9)),
                                      (8192, 4, (256, 32)), (256, 4, (128, 2))])
def test_latent_chunking_holds_one_block_an_sm(s, b, want):
    """At D 640 a block takes one SM (229,888 bytes of shared memory), so
    the grid aims at one block an SM: DeepSeek-V2-Lite's decode (B 4, one
    latent KV head, S 4096) walks 32 chunks of 128 rows, 128 blocks on 132
    SMs, at most 4 tiles a block."""
    c, n = t_fd.split_chunking(s, b, 1, SMS, t_fd.LATENT_HEAD_DIM)
    assert (c, n) == want and c % TILE == 0 and (n - 1) * c < s <= n * c
    assert b * n <= SMS or c == t_fd.SPLIT_MIN_CHUNK or b * (n - 1) < SMS


@pytest.mark.parametrize("min_chunk", [64, 128, 256, 512])
def test_chunking_depends_on_the_table_alone(monkeypatch, min_chunk):
    """A coarser grid (a larger minimum chunk) still tiles S in 32-row
    multiples, and the grid of a verify
    call and of the decodes at its tokens' lengths is one grid: it reads S,
    B, Hkv and D only."""
    monkeypatch.setattr(t_fd, "SPLIT_MIN_CHUNK", min_chunk)
    for s, b, hkv in [(1024, 16, 8), (1024, 8, 8), (8192, 8, 8), (256, 4, 2)]:
        for d in (*t_fd.KERNEL_HEAD_DIMS, t_fd.LATENT_HEAD_DIM):
            c, n = t_fd.split_chunking(s, b, hkv, SMS, d)
            assert c % TILE == 0 and c >= min_chunk and (n - 1) * c < s <= n * c
            assert (c, n) == t_fd.split_chunking(s, b, hkv, SMS, d)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_matches_jax(rng, name, d):
    """fp32 caches at every head_dim of the kernel."""
    check_against_jax(rng, CASES[name], d, "fp32")


@pytest.mark.parametrize("name", sorted(LATENT_CASES))
def test_latent_split_merge_matches_jax(rng, name):
    """MLA's latent row on the D 640 grid (B 4, one KV head: 4 chunks of 128
    rows at S 512), decode and 16-row pages, against JAX's decode and paged
    decode at DeepSeek-V2-Lite's sm_scale."""
    lengths = LATENT_CASES[name]
    d = t_fd.LATENT_HEAD_DIM
    chunk, n = t_fd.split_chunking(LATENT_S, len(lengths), 1, SMS, d)
    assert (chunk, n) == (128, 4)
    check_against_jax(rng, (lengths, None, 0, None, chunk, 1), d, "fp32", hq=16, hkv=1, s=LATENT_S,
                      sm=192.0**-0.5)
