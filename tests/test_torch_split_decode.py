"""The chunk grid of the split-KV decode kernel against the JAX package, on
the CPU.

``csrc/flash_decode_split.cu`` (head_dim 64, 128 and 256) splits each
(sequence, KV head)'s walk into chunks of C rows, one block each, and merges
the blocks' (o, m, l) in one pass. ``ops/flash_decode.split_chunk_walk``
gives each chunk's tiles and the rows each tile reads, as the kernel
computes them. Here:

- the walks cover every row some query token attends exactly once, the
  sinks in chunk 0 only, nothing below token 0's band that is not a sink,
  every tile a 32-row tile of its own chunk;
- a plain split-and-merge decode built on those walks (each chunk's
  partial over the rows its tiles read that the query row attends, merged
  in chunk order with the l == 0 -> 1 guard, as the kernel does) equals
  JAX's ``flash_decode(num_splits=1)``, ``flash_verify`` and
  ``paged_flash_decode`` at head_dim 64, 128 and 256 (JAX's Pallas kernels
  in interpret mode), on fp32 and on int8 / fp8 caches with their (Hkv,)
  ``k_scales`` / ``v_scales``. On a quantized cache the plain version
  applies the scales in the kernel's order: ``sm_scale * k_scale[h]``
  folded into q in fp32 and rounded to q's dtype, the scores scaled by 1,
  ``v_scale[h]`` on the merged output (rounded to q's dtype first on the
  contiguous forms, once on the paged one).

Tolerance: fp32 on both sides (q fp32, K and V upcast to fp32 on both),
differing only in the order of the sums, 1e-5 absolute at magnitudes of a
few units. A row of length 0 gives 0 in the port (JAX's decode gives a mean
of V rows there; ROADMAP Queue 3), so that row is held to 0.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu_torch.core.reference import NEG_INF
from starflashattention_tpu_torch.ops import flash_decode as t_fd

j_fd = importlib.import_module("starflashattention_tpu.ops.flash_decode")
j_pdec = importlib.import_module("starflashattention_tpu.ops.paged_decode")

torch.set_num_threads(1)

ATOL = 1e-5
S = 256
TILE = t_fd.TILE
PAGE = 16  # the paged form's page size: 16 pages a sequence

# name: (lengths of token 0, window, sinks, softcap, chunk rows, query tokens T)
CASES = {
    "length-0-and-below-a-tile": ((0, 17, 200, 256), None, 0, None, 64, 1),
    "window-below-a-tile": ((5, 17, 150, 256), 20, 0, None, 64, 1),
    "sinks-past-the-band-start": ((60, 100, 200, 256), 40, 70, None, 128, 1),
    "band-across-chunks": ((150, 200, 256, 90), 100, 4, None, 64, 1),
    "softcap-and-band": ((33, 129, 222, 256), 48, 0, 50.0, 64, 1),
    "verify-T5": ((1, 17, 150, 252), 48, 4, 50.0, 64, 5),
    "verify-T5-no-window": ((0, 31, 96, 252), None, 0, None, 128, 5),
}
# the quantized caches' edge cases: a band across chunks with sinks, the
# softcap on a band, a verify span (a row of length 0 in each)
QUANT_CASES = ("band-across-chunks", "softcap-and-band", "verify-T5-no-window")
QMAX = {"int8": 127.0, "fp8": 448.0}


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
    chunk caps it (Gemma-2-9B's decode, B 8, Hkv 8, S 8192: 576 blocks)."""
    c, n = t_fd.split_chunking(s, b, hkv, 132)
    assert c % TILE == 0 and c >= t_fd.SPLIT_MIN_CHUNK and n == -(-s // c)
    assert b * hkv * n >= min(2 * 132, b * hkv * -(-s // t_fd.SPLIT_MIN_CHUNK))


@pytest.mark.parametrize("min_chunk", [64, 128, 256, 512])
def test_chunking_depends_on_the_table_alone(monkeypatch, min_chunk):
    """A coarser grid (a larger minimum chunk, as phase 2 of chip_smoke.py
    times one) still tiles S in 32-row multiples, and the grid of a verify
    call and of the decodes at its tokens' lengths is one grid: it reads S,
    B and Hkv only."""
    monkeypatch.setattr(t_fd, "SPLIT_MIN_CHUNK", min_chunk)
    for s, b, hkv in [(1024, 16, 8), (1024, 8, 8), (8192, 8, 8), (256, 4, 2)]:
        c, n = t_fd.split_chunking(s, b, hkv, 132)
        assert c % TILE == 0 and c >= min_chunk and (n - 1) * c < s <= n * c
        assert (c, n) == t_fd.split_chunking(s, b, hkv, 132)


def _split_merge(q, k, v, lengths, *, chunk, window, sinks, softcap, sm_scale, scales=None,
                 paged=False):
    """Plain split-and-merge on the chunk walks in the kernel's order: q
    (B, Hq, T, D) fp32, k / v (B, Hkv, S, D) fp32 (a quantized cache's
    values, with ``scales`` = (k_scales, v_scales) (Hkv,) fp32) ->
    (B, Hq, T, D). q is folded (times sm_scale * k_scale[h]) on the paged
    form and on a quantized cache, else the scores are scaled by sm_scale.
    Each chunk's partial (o, m, l) covers the rows its tiles read that the
    query row attends (below its own length and the chunk's end, in its
    band or a sink); the partials merge in chunk order; v_scale multiplies
    the merged output."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    sm = torch.tensor(sm_scale, dtype=torch.float32)
    fold = paged or scales is not None
    q_scale = sm * scales[0] if scales is not None else sm.expand(hkv)  # fp32 products, per KV head
    out = torch.zeros_like(q)
    for bi in range(b):
        length = int(lengths[bi])
        walks = t_fd.split_chunk_walk(length, s=s, chunk=chunk, qspan=t, window=window, sinks=sinks)
        for h in range(hq):
            kh, vh = k[bi, h // g], v[bi, h // g]
            qh = q[bi, h] * q_scale[h // g] if fold else q[bi, h]
            for j in range(t):
                n = min(length + j, s)
                lo = -s if window is None else n - window
                ms, ls, os_ = [], [], []
                for tiles in walks:
                    rows = [p for _, read in tiles for p in read if p < n and (p >= lo or p < sinks)]
                    if not rows:
                        ms.append(torch.tensor(NEG_INF))
                        ls.append(torch.tensor(0.0))
                        os_.append(torch.zeros(d))
                        continue
                    idx = torch.tensor(rows)
                    sc = kh[idx] @ qh[j]
                    if not fold:
                        sc = sc * sm
                    if softcap is not None:
                        sc = softcap * torch.tanh(sc / softcap)
                    m = sc.max()
                    p = torch.exp(sc - m)
                    ms.append(m)
                    ls.append(p.sum())
                    os_.append(p @ vh[idx])
                mg = torch.stack(ms).max()
                alpha = torch.exp(torch.stack(ms) - mg)
                lg = (alpha * torch.stack(ls)).sum()
                o = (alpha[:, None] * torch.stack(os_)).sum(0)
                o = o / (1.0 if lg == 0 else lg)
                out[bi, h, j] = o if scales is None else o * scales[1][h // g]
    return out


def _inputs(rng, t, lengths, d, kv):
    """fp32 q, K and V, and for a quantized ``kv`` the K / V caches
    quantized against (Hkv,) scales: (q, k, v, lengths, JAX's k / v caches,
    scales or None)."""
    q = rng.standard_normal((len(lengths), 4, t, d), dtype=np.float32)
    k = rng.standard_normal((len(lengths), 2, S, d), dtype=np.float32)
    v = rng.standard_normal((len(lengths), 2, S, d), dtype=np.float32)
    lens = np.array(lengths, np.int32)
    if kv == "fp32":
        return q, k, v, lens, jnp.asarray(k), jnp.asarray(v), None
    scales = np.array([5.0, 6.0], np.float32) / np.float32(QMAX[kv])
    jcaches = []
    for x in (k, v):
        scaled = x / scales[None, :, None, None]
        if kv == "int8":
            jcaches.append(jnp.asarray(np.clip(np.round(scaled), -127, 127).astype(np.int8)))
        else:
            jcaches.append(jnp.asarray(scaled).astype(jnp.float8_e4m3fn))
    k, v = (np.array(x.astype(jnp.float32)) for x in jcaches)  # the caches' values
    return q, k, v, lens, jcaches[0], jcaches[1], scales


def _pools(jk, jv, rng):
    """The (B, Hkv, S, D) caches in PAGE-row pages under a shuffled page
    table: (Hkv, 1 + B * S / PAGE, PAGE, D) pools (page 0 the null page)."""
    b, hkv, s, d = jk.shape
    pps = s // PAGE
    table = (rng.permutation(b * pps) + 1).reshape(b, pps).astype(np.int32)
    pools = []
    for x in (jk, jv):
        pool = jnp.zeros((hkv, 1 + b * pps, PAGE, d), x.dtype)
        pool = pool.at[:, table.reshape(-1)].set(
            x.reshape(b, hkv, pps, PAGE, d).transpose(1, 0, 2, 3, 4).reshape(hkv, b * pps, PAGE, d))
        pools.append(pool)
    return pools[0], pools[1], jnp.asarray(table)


def _check_against_jax(rng, name, d, kv):
    """Decode cases against JAX's single-split decode and paged decode;
    verify cases against JAX's ``flash_verify`` (one 256-row block, so that
    its walk covers every row) and each token against JAX's decode at
    ``lengths + j``."""
    lengths, window, sinks, softcap, chunk, t = CASES[name]
    q, k, v, lens, jk, jv, scales = _inputs(rng, t, lengths, d, kv)
    opts = dict(window=window, sinks=sinks, softcap=softcap)
    qs = {} if scales is None else dict(k_scales=jnp.asarray(scales), v_scales=jnp.asarray(scales))
    sm = d**-0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tscales = None if scales is None else (torch.from_numpy(scales),) * 2
    got = _split_merge(tq, tk, tv, lens, chunk=chunk, sm_scale=sm, scales=tscales, **opts).numpy()
    jq = jnp.asarray(q)
    ver = None if t == 1 else np.asarray(j_fd.flash_verify(jq, jk, jv, jnp.asarray(lens), block_k=S, **qs,
                                                           **opts))
    for j in range(t):
        live = lens + j > 0
        assert np.all(got[~live, :, j] == 0)
        dec = np.asarray(j_fd.flash_decode(jq[:, :, j], jk, jv, jnp.asarray(lens + j), num_splits=1,
                                           block_k=64, **qs, **opts))
        np.testing.assert_allclose(got[live, :, j], dec[live], atol=ATOL, rtol=0)
        if ver is not None:
            np.testing.assert_allclose(got[live, :, j], ver[live, :, j], atol=ATOL, rtol=0)
    if t == 1:  # the paged form on the same rows, on the same chunk grid
        kp, vp, table = _pools(jk, jv, rng)
        paged = _split_merge(tq, tk, tv, lens, chunk=chunk, sm_scale=sm, scales=tscales, paged=True,
                             **opts).numpy()[:, :, 0]
        want = np.asarray(j_pdec.paged_flash_decode(jq[:, :, 0], kp, vp, table, jnp.asarray(lens),
                                                    pages_per_compute_block=2, **qs, **opts))
        np.testing.assert_allclose(paged, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_matches_jax(rng, name, d):
    """fp32 caches at every head_dim of the kernel."""
    _check_against_jax(rng, name, d, "fp32")


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("name", QUANT_CASES)
def test_split_merge_on_quantized_kv_matches_jax(rng, name, d, kv):
    """int8 / fp8 caches with their scales applied in the kernel's order."""
    _check_against_jax(rng, name, d, kv)
