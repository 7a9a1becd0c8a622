"""The chunk grid of the head_dim-256 decode kernel against the JAX package,
on the CPU.

``csrc/flash_decode_d256.cu`` splits each (sequence, KV head)'s walk into
chunks of C rows, one block each, and merges the blocks' (o, m, l) in one
pass. ``ops/flash_decode.d256_chunk_walk`` gives each chunk's tiles and the
rows each tile reads, as the kernel computes them. Here:

- the walks cover every row some query token attends exactly once, the
  sinks in chunk 0 only, nothing below token 0's band that is not a sink,
  every tile a 32-row tile of its own chunk;
- a plain split-and-merge decode built on those walks (each chunk's
  partial over the rows its tiles read that the query row attends, merged
  in chunk order with the l == 0 -> 1 guard, as the kernel does) equals
  JAX's ``flash_decode(num_splits=1)`` and ``flash_verify`` at head_dim 256
  (JAX's Pallas kernels in interpret mode).

Tolerance: fp32 on both sides, differing only in the order of the sums,
1e-5 absolute at magnitudes of a few units. A row of length 0 gives 0 in
the port (JAX's decode gives a mean of V rows there; ROADMAP Queue 3), so
that row is held to 0.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu_torch.core.reference import NEG_INF
from starflashattention_tpu_torch.ops import flash_decode as t_fd

j_fd = importlib.import_module("starflashattention_tpu.ops.flash_decode")

torch.set_num_threads(1)

ATOL = 1e-5
S, D = 256, 256
TILE = t_fd.TILE

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
        walks = t_fd.d256_chunk_walk(length, s=S, chunk=chunk, qspan=t, window=window, sinks=sinks)
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
    """C is a multiple of the tile and at least D256_MIN_CHUNK rows; N =
    ceil(S / C) gives at least 2 blocks an SM of 132 unless the minimum
    chunk caps it (Gemma-2-9B's decode, B 8, Hkv 8, S 8192: 576 blocks)."""
    c, n = t_fd.d256_chunking(s, b, hkv, 132)
    assert c % TILE == 0 and c >= t_fd.D256_MIN_CHUNK and n == -(-s // c)
    assert b * hkv * n >= min(2 * 132, b * hkv * -(-s // t_fd.D256_MIN_CHUNK))


def _split_merge(q, k, v, lengths, *, chunk, window, sinks, softcap, sm_scale):
    """Plain split-and-merge on the chunk walks: q (B, Hq, T, D), k / v
    (B, Hkv, S, D) fp32 -> (B, Hq, T, D). Each chunk's partial (o, m, l)
    covers the rows its tiles read that the query row attends (below its
    own length and the chunk's end, in its band or a sink); the partials
    merge in chunk order."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.zeros_like(q)
    for bi in range(b):
        length = int(lengths[bi])
        walks = t_fd.d256_chunk_walk(length, s=s, chunk=chunk, qspan=t, window=window, sinks=sinks)
        for h in range(hq):
            kh, vh = k[bi, h // (hq // hkv)], v[bi, h // (hq // hkv)]
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
                    sc = (kh[idx] @ q[bi, h, j]) * sm_scale
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
                out[bi, h, j] = o / (1.0 if lg == 0 else lg)
    return out


def _inputs(rng, t, lengths):
    q = rng.standard_normal((len(lengths), 4, t, D), dtype=np.float32)
    k = rng.standard_normal((len(lengths), 2, S, D), dtype=np.float32)
    v = rng.standard_normal((len(lengths), 2, S, D), dtype=np.float32)
    return q, k, v, np.array(lengths, np.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_matches_jax(rng, name):
    """Decode cases against JAX's single-split decode; verify cases against
    JAX's ``flash_verify`` (one 256-row block, so that its walk covers every
    row) and each token against JAX's decode at ``lengths + j``."""
    lengths, window, sinks, softcap, chunk, t = CASES[name]
    q, k, v, lens = _inputs(rng, t, lengths)
    opts = dict(window=window, sinks=sinks, softcap=softcap)
    sm = D**-0.5
    got = _split_merge(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lens,
                       chunk=chunk, sm_scale=sm, **opts).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ver = None if t == 1 else np.asarray(j_fd.flash_verify(jq, jk, jv, jnp.asarray(lens), block_k=S, **opts))
    for j in range(t):
        live = lens + j > 0
        assert np.all(got[~live, :, j] == 0)
        dec = np.asarray(j_fd.flash_decode(jq[:, :, j], jk, jv, jnp.asarray(lens + j), num_splits=1,
                                           block_k=64, **opts))
        np.testing.assert_allclose(got[live, :, j], dec[live], atol=ATOL, rtol=0)
        if ver is not None:
            np.testing.assert_allclose(got[live, :, j], ver[live, :, j], atol=ATOL, rtol=0)
