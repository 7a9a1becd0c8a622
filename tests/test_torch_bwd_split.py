"""The dk/dv kernel's split walk (``ops/flash_bwd.py``) against the JAX
package, on the CPU.

The CUDA dk/dv kernel (``csrc/flash_bwd.cu``) cuts each KV tile's walk of
(head, q tile) steps into pieces of ``chunk`` steps, one block each, and a
second pass adds the pieces' fp32 sums in piece order. Its arithmetic has a
Python twin: ``dkdv_walk`` (the q tiles in band of one KV tile),
``dkdv_walk_splits`` / ``dkdv_split_steps`` (the pieces) and
``dkdv_split_plan`` (the chunk from the static shapes). Here, at tiny tile
grids (16 KV rows, 8 q rows a tile), for causal and not, a window with and
without sinks, ragged lengths, q offsets, ring chunks wholly in the rows'
future or past the length, and G 1 / 2 / 4:

- every (head, q tile, KV tile) triple that JAX's ``flash_bwd._in_band``
  puts in band is walked by exactly one piece, and no piece walks one out
  of band;
- the port's plain P and dS, summed piece by piece in fp32 in the twin's
  order, give dk and dv within ``tests/test_torch_train.py``'s backward
  tolerance (2e-5 of each gradient's peak) of JAX's ``flash_prefill_bwd``
  (Pallas in interpret mode).
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
BKV, BQ = 16, 8  # tiny tiles: several q and KV tiles at these lengths

# B, G, Sq, Skv, causal, window, sinks, kv_offset, q_offsets, lengths
CASES = {
    "causal": (2, 2, 40, 40, True, None, 0, 0, (0, 0), (40, 29)),
    "non_causal": (2, 1, 33, 50, False, None, 0, 0, (0, 0), (50, 17)),
    "window": (2, 4, 64, 64, True, 12, 0, 0, (0, 0), (64, 50)),
    "window_sinks": (2, 2, 64, 64, True, 12, 3, 0, (0, 0), (64, 61)),
    "q_offsets": (2, 4, 24, 64, True, None, 0, 0, (10, 40), (34, 64)),
    # ring steps: a KV chunk at global position 64 wholly in sequence 0's
    # future (q_offsets < 0), a band past it for sequence 1
    "kv_offset_future": (2, 2, 32, 32, True, 20, 4, 64, (-32, 16), (32, 32)),
    # a chunk past sequence 0's length (clipped to 0), sinks moved out of it
    "kv_offset_past_length": (2, 1, 32, 48, True, 24, 4, 32, (40, 8), (0, 40)),
}
CHUNKS = [1, 3, 7, None]  # None: the whole walk in one piece


def _case(name):
    b, g, sq, skv, causal, window, sinks, kv_offset, q_off, lengths = CASES[name]
    return dict(b=b, g=g, sq=sq, skv=skv, causal=causal, window=window, sinks=sinks,
                kv_offset=kv_offset, q_off=q_off, lengths=tuple(min(n, skv) for n in lengths))


def _walks(c, chunk, g=None):
    """{(b, kt): (qt0, nq, pieces)}: each KV tile's walk and its pieces'
    steps (absolute q tiles) in the twin's order."""
    g = c["g"] if g is None else g
    sinks = max(c["sinks"] - c["kv_offset"], 0)  # the kernel's sink bound
    out = {}
    for b in range(c["b"]):
        for kt in range(-(-c["skv"] // BKV)):
            qt0, nq = t_fb.dkdv_walk(kt, bkv=BKV, bq=BQ, sq=c["sq"], length=c["lengths"][b],
                                     q_offset=c["q_off"][b], causal=c["causal"], window=c["window"],
                                     sinks=sinks)
            ch = chunk or max(g * -(-c["sq"] // BQ), 1)
            n = t_fb.dkdv_walk_splits(g * nq, ch)
            pieces = [[(h, qt0 + dq) for h, dq in t_fb.dkdv_split_steps(nq, g, ch, s)] for s in range(n)]
            assert t_fb.dkdv_split_steps(nq, g, ch, n) == []  # nothing past the tile's pieces
            out[b, kt] = (qt0, nq, pieces)
    return out


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(CASES))
def test_split_walk_covers_jax_band_once(name, chunk):
    c = _case(name)
    nqt, nkt = -(-c["sq"] // BQ), -(-c["skv"] // BKV)
    walks = _walks(c, chunk)
    for b in range(c["b"]):
        q_row0 = c["q_off"][b] + BQ * np.arange(nqt)[:, None]
        kv_start = BKV * np.arange(nkt)[None, :]
        band = np.asarray(j_in_band(jnp.asarray(q_row0), jnp.asarray(kv_start), BQ, BKV, c["lengths"][b],
                                    c["causal"], c["window"], c["sinks"], c["kv_offset"]))
        band = np.broadcast_to(band, (nqt, nkt))
        walked = collections.Counter()
        for kt in range(nkt):
            for piece in walks[b, kt][2]:
                walked.update((h, qt, kt) for h, qt in piece)
        want = {(h, qt, kt) for h in range(c["g"]) for qt, kt in zip(*np.nonzero(band))}
        assert set(walked) == want, (b, sorted(set(walked) ^ want)[:8])
        assert all(n == 1 for n in walked.values())


@pytest.mark.parametrize("name", ["causal", "window_sinks", "q_offsets", "kv_offset_future",
                                  "kv_offset_past_length"])
def test_split_sums_match_jax_bwd(rng, name):
    c = _case(name)
    b, g, sq, skv, d, hkv = c["b"], c["g"], c["sq"], c["skv"], 16, 2
    hq = g * hkv
    q, do = (rng.standard_normal((b, hq, sq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, skv, d), dtype=np.float32) for _ in range(2))
    lengths, q_off = np.array(c["lengths"], np.int32), np.array(c["q_off"], np.int32)
    opts = dict(causal=c["causal"], window=c["window"], sinks=c["sinks"], kv_offset=c["kv_offset"])
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    jo, jlse = j_flash_prefill(*args, q_offsets=jnp.asarray(q_off), block_q=8, block_k=16,
                               return_lse=True, **opts)
    _, jdk, jdv = j_flash_prefill_bwd(*args[:3], jo, jlse, jnp.asarray(do), args[3], jnp.asarray(q_off),
                                      block_q=8, block_k=16, **opts)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse))
    p, ds = t_fb._p_ds_plain(tq, tk, tv, lse, tdo, t_fb.bwd_delta(o, tdo), torch.from_numpy(lengths),
                             torch.from_numpy(q_off), c["causal"], None, c["window"],
                             max(c["sinks"] - c["kv_offset"], 0), None)
    scale = 1.0 / d**0.5
    for chunk in CHUNKS:
        dk, dv = torch.zeros_like(tk), torch.zeros_like(tv)
        for (bi, kt), (_, _, pieces) in _walks(c, chunk).items():
            rows = slice(kt * BKV, min(kt * BKV + BKV, skv))
            for kvh in range(hkv):
                for piece in pieces:  # each piece's fp32 sums, then the pieces in order
                    part_k = torch.zeros((rows.stop - rows.start, d))
                    part_v = torch.zeros_like(part_k)
                    for h, qt in piece:
                        hh, qr = kvh * g + h, slice(qt * BQ, min(qt * BQ + BQ, sq))
                        part_k += ds[bi, hh, qr, rows].T @ tq[bi, hh, qr]
                        part_v += p[bi, hh, qr, rows].T @ tdo[bi, hh, qr]
                    dk[bi, kvh, rows] += part_k
                    dv[bi, kvh, rows] += part_v
        for what, got, want in (("dk", scale * dk, jdk), ("dv", dv, jdv)):
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-9)
            assert err < BWD_RTOL, (what, chunk, err)


@pytest.mark.parametrize("shape,split", [
    ((2, 8, 4, 2048, 2048, True, None, 0, 128, 64), False),   # phase 9's step: the tiles balance unsplit
    ((1, 16, 1, 4608, 4608, True, None, 0, 64, 64), False),   # Gemma-7B's, D 256
    ((1, 8, 4, 8192, 8192, True, 4096, 0, 128, 64), False),   # Mistral's ring step and training
    ((1, 1, 8, 8192, 8192, True, None, 0, 128, 64), True),    # one KV head: a few long walks
    ((1, 2, 4, 4096, 4096, False, None, 0, 128, 64), True),
    ((1, 4, 4, 2048, 2048, True, None, 0, 128, 64), True),    # a TP x DP rank's shard of phase 9's
])
def test_split_plan_from_static_shapes(shape, split):
    """The plan splits only where the longest walk of the static estimate
    exceeds a block slot's average (132 SMs, one block each), and its
    pieces cover the longest walk any data can give. The tiles are the
    built kernel's (``dkdv_geometry``: 128 KV rows, 64 at D 256; 64 q rows)."""
    b, hkv, g, sq, skv, causal, window, sinks, bkv, bq = shape
    chunk, splits = t_fb.dkdv_split_plan(b, hkv, g, sq, skv, causal, window, sinks, 132, bkv, bq)
    full = g * -(-sq // bq)
    assert (splits > 1) == split
    assert chunk * splits >= full and (splits == 1 or chunk >= t_fb.DKDV_MIN_CHUNK)
    assert t_fb.dkdv_walk_splits(full, chunk) == splits
