"""The dq kernel's walk and tiles (``ops/flash_bwd.py``) against the JAX
package, on the CPU.

The CUDA dq kernel (``csrc/flash_bwd.cu``) gives each block the q tile of
every query head of one KV head, keeps their Q and dO rows in shared memory
and walks K/V tiles of 64 keys past them. Its arithmetic has Python twins:
``dq_geometry`` (the tiles and the shared memory), ``dq_walk`` (the KV tiles
a q tile walks, in order) and ``dq_tile_order`` (the blocks' q tiles). Here:

- at the built kernel's tiles for head_dim 64, 128 and 256 and G 1 / 4 / 8,
  for causal and not, ragged lengths, q offsets, a window with and without
  sinks (one and two sink tiles), and ring chunks (``kv_offset``) wholly in
  the rows' future or past the length: every (q tile, KV tile) pair that
  JAX's ``flash_bwd._in_band`` keeps is walked exactly once, sinks first and
  then in order, and no pair it drops is walked;
- the blocks cover each (q tile, KV head, sequence) once, and sequence 0's
  walks start longest first (under a window, to within one tile);
- the shared memory fits the H100's 227 KB at every head_dim and group, and
  the blocks fill its 132 SMs at the training shapes the port runs;
- the port's plain dS, summed tile by tile in the walk's order in fp32, and
  ``flash_bwd_dq`` itself (its plain twin on CPU tensors) give dq within
  ``tests/test_torch_train.py``'s backward tolerance (2e-5 of the peak) of
  JAX's ``flash_prefill_bwd`` (Pallas in interpret mode).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.ops.flash_bwd import _in_band as j_in_band
from starflashattention_tpu.ops.flash_bwd import flash_prefill_bwd as j_flash_prefill_bwd
from starflashattention_tpu.ops.flash_prefill import flash_prefill as j_flash_prefill
from starflashattention_tpu_torch.ops import flash_bwd as t_fb

torch.set_num_threads(1)

BWD_RTOL = 2e-5  # tests/test_torch_train.py's
SMEM_LIMIT = 232_448  # bytes of shared memory a block can take on the H100
SMS = 132

# B, Sq, Skv, causal, window, sinks, kv_offset, q_offsets, lengths: several
# 64-key tiles and several q tiles of 8-128 rows
CASES = {
    "causal": (2, 384, 384, True, None, 0, 0, (0, 0), (384, 290)),
    "non_causal": (2, 200, 500, False, None, 0, 0, (0, 0), (500, 170)),
    "window": (2, 640, 640, True, 150, 0, 0, (0, 0), (640, 500)),
    "window_sinks": (2, 640, 640, True, 150, 3, 0, (0, 0), (640, 611)),
    "two_sink_tiles": (1, 640, 640, True, 100, 70, 0, (0,), (640,)),
    "q_offsets": (2, 240, 640, True, None, 0, 0, (100, 400), (340, 640)),
    # ring steps: a KV chunk at global position 640 wholly in sequence 0's
    # future (q_offsets < 0), a band past it for sequence 1
    "kv_offset_future": (2, 320, 320, True, 200, 4, 640, (-320, 160), (320, 320)),
    # a chunk past sequence 0's length (clipped to 0), sinks moved out of it
    "kv_offset_past_length": (2, 320, 480, True, 240, 4, 320, (400, 80), (0, 400)),
}
GEOMETRIES = [(d, g) for d in (64, 128, 256) for g in (1, 4, 8)]


def _case(name):
    b, sq, skv, causal, window, sinks, kv_offset, q_off, lengths = CASES[name]
    return dict(b=b, sq=sq, skv=skv, causal=causal, window=window, sinks=sinks, kv_offset=kv_offset,
                q_off=q_off, lengths=tuple(min(n, skv) for n in lengths))


def _walk(c, b, qt, bq, bk):
    return t_fb.dq_walk(qt, bq=bq, bk=bk, length=c["lengths"][b], q_offset=c["q_off"][b],
                        causal=c["causal"], window=c["window"], sinks=max(c["sinks"] - c["kv_offset"], 0))


@pytest.mark.parametrize("d,g", GEOMETRIES)
@pytest.mark.parametrize("name", list(CASES))
def test_dq_walk_covers_jax_band_once(name, d, g):
    c = _case(name)
    bq, bk, _ = t_fb.dq_geometry(d, g)
    nqt, nkt = -(-c["sq"] // bq), -(-c["skv"] // bk)
    for b in range(c["b"]):
        q_row0 = c["q_off"][b] + bq * np.arange(nqt)[:, None]
        kv_start = bk * np.arange(nkt)[None, :]
        band = np.asarray(j_in_band(jnp.asarray(q_row0), jnp.asarray(kv_start), bq, bk, c["lengths"][b],
                                    c["causal"], c["window"], c["sinks"], c["kv_offset"]))
        band = np.broadcast_to(band, (nqt, nkt))
        walked = collections.Counter()
        for qt in range(nqt):
            walk = _walk(c, b, qt, bq, bk)
            assert walk == sorted(set(walk))  # the sink tiles, then the band, each once
            walked.update((qt, kt) for kt in walk)
        want = set(zip(*np.nonzero(band)))
        assert set(walked) == want, (b, sorted(set(walked) ^ want)[:8])
        assert all(n == 1 for n in walked.values())


@pytest.mark.parametrize("d,g", GEOMETRIES)
@pytest.mark.parametrize("name", list(CASES))
def test_dq_grid_covers_each_tile_once_longest_first(name, d, g):
    """The kernel's blocks: x over (KV head, sequence), y over the q tiles
    in ``dq_tile_order``. Sequence 0's walks run longest first; under a
    window, whose walks differ by the band's alignment to the tiles, each
    is at most one tile shorter than any after it."""
    c = _case(name)
    bq, bk, _ = t_fb.dq_geometry(d, g)
    hkv, nqt = 2, -(-c["sq"] // bq)
    order = t_fb.dq_tile_order(nqt, lambda qt: len(_walk(c, 0, qt, bq, bk)))
    blocks = [(order[y], x % hkv, x // hkv) for y in range(nqt) for x in range(hkv * c["b"])]
    assert sorted(blocks) == [(qt, h, b) for qt in range(nqt) for h in range(hkv) for b in range(c["b"])]
    lens = [len(_walk(c, 0, qt, bq, bk)) for qt in order]
    slack = 0 if c["window"] is None else 1
    assert all(n >= max(lens[i:]) - slack for i, n in enumerate(lens)), lens


# (B, Hkv, G, S, D): phase 9's step, a TP x DP rank's shard of it (phase
# 14e), Mistral-7B's and Gemma-2-9B's training (phase 11a / 11b), Gemma-7B's (11c)
TRAIN_SHAPES = {"phase9": (2, 8, 4, 2048, 128), "tp_shard": (1, 4, 4, 2048, 128),
                "mistral": (1, 8, 4, 8192, 128), "gemma2": (1, 8, 2, 6144, 256), "gemma": (1, 16, 1, 4608, 256)}


@pytest.mark.parametrize("d", [64, 128, 256])
def test_dq_tiles_fit_the_card(d):
    for g in range(1, 9):
        bq, bk, smem = t_fb.dq_geometry(d, g)
        assert smem <= SMEM_LIMIT and bk == t_fb.DQ_KEYS
        assert g * bq <= (64 if d == 256 else 128) < g * (bq + 1)  # the rows a block holds, fewest idle
    with pytest.raises(ValueError):
        t_fb.dq_geometry(d, 9)


@pytest.mark.parametrize("shape", list(TRAIN_SHAPES))
def test_dq_blocks_fill_the_card(shape):
    b, hkv, g, s, d = TRAIN_SHAPES[shape]
    bq = t_fb.dq_geometry(d, g)[0]
    assert b * hkv * -(-s // bq) >= SMS


SUM_CASES = {  # B, G, Sq, Skv, causal, window, sinks, kv_offset, q_offsets, lengths
    "causal": (2, 2, 40, 40, True, None, 0, 0, (0, 0), (40, 29)),
    "non_causal": (2, 1, 33, 50, False, None, 0, 0, (0, 0), (50, 17)),
    "window_sinks": (2, 2, 64, 64, True, 12, 3, 0, (0, 0), (64, 61)),
    "q_offsets": (2, 4, 24, 64, True, None, 0, 0, (10, 40), (34, 64)),
    "kv_offset_future": (2, 2, 32, 32, True, 20, 4, 64, (-32, 16), (32, 32)),
    "kv_offset_past_length": (2, 1, 32, 48, True, 24, 4, 32, (40, 8), (0, 40)),
}


@pytest.mark.parametrize("name", list(SUM_CASES))
def test_dq_walk_sums_match_jax_bwd(rng, name):
    """JAX's tiles (8 q rows, 16 keys) for the walk, so that Pallas in
    interpret mode stays quick: the walk's sums in fp32 and the CPU entry."""
    b, g, sq, skv, causal, window, sinks, kv_offset, q_off, lengths = SUM_CASES[name]
    bq, bk, d, hkv = 8, 16, 16, 2
    hq = g * hkv
    q, do = (rng.standard_normal((b, hq, sq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, skv, d), dtype=np.float32) for _ in range(2))
    lengths = np.minimum(np.array(lengths, np.int32), skv)
    q_off = np.array(q_off, np.int32)
    opts = dict(causal=causal, window=window, sinks=sinks, kv_offset=kv_offset)
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    jo, jlse = j_flash_prefill(*args, q_offsets=jnp.asarray(q_off), block_q=bq, block_k=bk,
                               return_lse=True, **opts)
    jdq = np.asarray(j_flash_prefill_bwd(*args[:3], jo, jlse, jnp.asarray(do), args[3], jnp.asarray(q_off),
                                         block_q=bq, block_k=bk, **opts)[0])

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse))
    delta = t_fb.bwd_delta(o, tdo)
    bound = max(sinks - kv_offset, 0)
    _, ds = t_fb._p_ds_plain(tq, tk, tv, lse, tdo, delta, torch.from_numpy(lengths), torch.from_numpy(q_off),
                             causal, None, window, bound, None)
    dq = torch.zeros_like(tq)
    for bi in range(b):
        for qt in range(-(-sq // bq)):
            rows = slice(qt * bq, min(qt * bq + bq, sq))
            for kt in t_fb.dq_walk(qt, bq=bq, bk=bk, length=int(lengths[bi]), q_offset=int(q_off[bi]),
                                   causal=causal, window=window, sinks=bound):
                keys = slice(kt * bk, min(kt * bk + bk, skv))
                for h in range(hq):  # every head of the block's KV head, h // g
                    dq[bi, h, rows] += ds[bi, h, rows, keys] @ tk[bi, h // g, keys]
    entry = t_fb.flash_bwd_dq(tq, tk, tv, lse, tdo, delta, torch.from_numpy(lengths), torch.from_numpy(q_off),
                              **opts)
    for what, got in (("walk", dq / d**0.5), ("flash_bwd_dq", entry)):
        err = np.abs(got.numpy() - jdq).max() / (np.abs(jdq).max() + 1e-9)
        assert err < BWD_RTOL, (what, err)
