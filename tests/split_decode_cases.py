"""The plain split-and-merge decode on the split-KV kernel's chunk walks,
and its comparison with the JAX package, shared by
``tests/test_torch_split_decode.py`` (fp32 caches, every head_dim) and
``tests/test_torch_split_decode_quant.py`` (int8 / fp8 caches).

``csrc/flash_decode_split.cu`` splits each (sequence, KV head)'s walk into
chunks of C rows, one block each, and merges the blocks' (o, m, l) in one
pass. ``ops/flash_decode.split_chunk_walk`` gives each chunk's tiles and
the rows each tile reads, as the kernel computes them. A plain
split-and-merge decode built on those walks (each chunk's partial over the
rows its tiles read that the query row attends, merged in chunk order with
the l == 0 -> 1 guard, as the kernel does) is held to JAX's
``flash_decode(num_splits=1)``, ``flash_verify`` and ``paged_flash_decode``
(JAX's Pallas kernels in interpret mode). On a quantized cache the plain
version applies the scales in the kernel's order: ``sm_scale * k_scale[h]``
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
import torch

from starflashattention_tpu_torch.core.reference import NEG_INF
from starflashattention_tpu_torch.ops import flash_decode as t_fd

j_fd = importlib.import_module("starflashattention_tpu.ops.flash_decode")
j_pdec = importlib.import_module("starflashattention_tpu.ops.paged_decode")

ATOL = 1e-5
S = 256
PAGE = 16  # the paged form's page size: 16 pages a sequence at S 256

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


def split_merge(q, k, v, lengths, *, chunk, window, sinks, softcap, sm_scale, scales=None,
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


def _inputs(rng, t, lengths, d, kv, hq=4, hkv=2, s=S):
    """fp32 q, K and V, and for a quantized ``kv`` the K / V caches
    quantized against (Hkv,) scales: (q, k, v, lengths, JAX's k / v caches,
    scales or None)."""
    q = rng.standard_normal((len(lengths), hq, t, d), dtype=np.float32)
    k = rng.standard_normal((len(lengths), hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((len(lengths), hkv, s, d), dtype=np.float32)
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


def check_against_jax(rng, case, d, kv, hq=4, hkv=2, s=S, sm=None):
    """Decode cases against JAX's single-split decode and paged decode;
    verify cases against JAX's ``flash_verify`` (one block of the whole
    table, so that its walk covers every row) and each token against JAX's
    decode at ``lengths + j``. ``case`` = (lengths of token 0, window, sinks,
    softcap, chunk rows, query tokens T); ``sm`` defaults to D ** -0.5."""
    lengths, window, sinks, softcap, chunk, t = case
    q, k, v, lens, jk, jv, scales = _inputs(rng, t, lengths, d, kv, hq, hkv, s)
    opts = dict(window=window, sinks=sinks, softcap=softcap)
    qs = {} if scales is None else dict(k_scales=jnp.asarray(scales), v_scales=jnp.asarray(scales))
    if sm is None:
        sm = d**-0.5  # JAX's default
    else:
        qs["sm_scale"] = sm
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tscales = None if scales is None else (torch.from_numpy(scales),) * 2
    got = split_merge(tq, tk, tv, lens, chunk=chunk, sm_scale=sm, scales=tscales, **opts).numpy()
    jq = jnp.asarray(q)
    ver = None if t == 1 else np.asarray(j_fd.flash_verify(jq, jk, jv, jnp.asarray(lens), block_k=s, **qs,
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
        paged = split_merge(tq, tk, tv, lens, chunk=chunk, sm_scale=sm, scales=tscales, paged=True,
                            **opts).numpy()[:, :, 0]
        want = np.asarray(j_pdec.paged_flash_decode(jq[:, :, 0], kp, vp, table, jnp.asarray(lens),
                                                    pages_per_compute_block=2, **qs, **opts))
        np.testing.assert_allclose(paged, want, atol=ATOL, rtol=0)
