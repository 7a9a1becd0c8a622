"""The decode step's row append folded into the decode launch, on the CPU.

``ops/flash_decode.flash_decode_append`` and
``ops/paged_decode.paged_flash_decode_append`` write the new K/V row of each
sequence (at ``min(pos, S - 1)``) and attend, in one launch of
``csrc/flash_decode_split.cu`` on the card. On CPU tensors they run their
plain twins (the plain append, then the plain decode), which are held here
to JAX's ``append_rows_kv`` + ``flash_decode`` and ``append_rows_paged_kv``
+ ``paged_flash_decode`` (the Pallas kernels in interpret mode) on the same
numpy draws.

Here:

- the two entries against JAX, num_splits 1 and 4 and paged, on fp32,
  bf16, int8 and fp8 caches, with a row of its first token, an inactive
  row (0 attended rows, a write at its stale position), a row clamped at
  ``S - 1``, a length-0 row; a window + sinks layer whose write lands in
  the sink tile; MLA's D 640 (16 query heads on one KV head);
- a model of the kernel's owner rule on ``split_chunking``,
  ``_split_geometry`` and ``split_chunk_walk``: at write positions on each
  side of every chunk edge exactly one chunk owns the row and no other
  chunk's walk reads it, and a per-chunk emulation that stages the row
  from the new rows and every other row from the un-appended table equals
  append-then-decode bit for bit;
- the refusals: a verify span, new rows of the wrong shape or dtype, or
  not contiguous.

Tolerances: outputs, fp32 on both sides, 1e-5 absolute; bf16 q, 4 bf16 ulps
of the peak (JAX's kernel rounds P to bf16 for P @ V where the port keeps
fp32, as in ``tests/test_torch_ops.py``). The tables and pools are compared
bit for bit, every dtype. A row of length 0 gives 0 in the port (JAX's
decode gives a mean of V there), so such a row's output is held to 0.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_decode_cases import split_merge
from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu_torch.core.reference import NEG_INF
from starflashattention_tpu_torch.ops import flash_decode as t_fd
from starflashattention_tpu_torch.ops import paged_decode as t_pdec
from starflashattention_tpu_torch.utils.bridge import tensor_from_numpy, tensor_to_numpy

j_append, j_fd, j_pdec = (importlib.import_module(f"starflashattention_tpu.ops.{name}")
                          for name in ("cache_append", "flash_decode", "paged_decode"))

torch.set_num_threads(1)

ATOL = 1e-5
S, PAGE, LAYER = 128, 16, 1
# (write position, attended rows): its first token, inactive (a stale write,
# 0 rows), clamped to S - 1, an ordinary row, a length-0 row at slot 0
ROWS = ((0, 1), (37, 0), (S + 5, S), (100, 101), (0, 0))
QMAX = {"int8": 127.0, "fp8": 448.0}


def _bits(x):
    """Raw bits of a torch tensor or a JAX / numpy array, as numpy integers."""
    if isinstance(x, torch.Tensor):
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
        return x.contiguous().view(ints[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32}[x.itemsize])


def _draws(rng, kv, b, hq, hkv, d, s=S, layers=2):
    """q, the tables, the new rows and the scales as numpy arrays in the
    kernel's dtypes: q fp32 (bf16 on a bf16 cache), K / V quantized by JAX
    against (Hkv,) scales on an int8 / fp8 cache."""
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k, v = (rng.standard_normal((layers, b, hkv, s, d), dtype=np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((b, hkv, d), dtype=np.float32) for _ in range(2))
    if kv == "bfloat16":
        q, k, v, kn, vn = (x.astype(jnp.bfloat16) for x in (q, k, v, kn, vn))
    if kv not in QMAX:
        return q, k, v, kn, vn, None
    ks = (5.0 / QMAX[kv] * (1.0 + 0.1 * np.arange(hkv))).astype(np.float32)
    vs = (5.0 / QMAX[kv] * (1.0 - 0.05 * np.arange(hkv))).astype(np.float32)
    quant = [np.asarray(j_quant.quantize_value(jnp.asarray(x), jnp.asarray(sc), kv, head_axis=axis))
             for x, sc, axis in ((k, ks, 2), (v, vs, 2), (kn, ks, 1), (vn, vs, 1))]
    return (q, *quant, (ks, vs))


def _check_out(out, ref, lengths, q_dtype):
    out = tensor_to_numpy(out)
    ref = np.asarray(ref).astype(np.float32)
    live = np.asarray(lengths) > 0
    assert np.all(out[~live] == 0)
    tol = ATOL if q_dtype == np.float32 else 4 * 2.0**-8 * np.abs(ref[live]).max()
    np.testing.assert_allclose(out[live], ref[live], atol=tol, rtol=0)


# every cache dtype, each split mode on fp32 and on a 1-byte cache (JAX's
# interpret mode compiles each case anew: about 3 s a case)
@pytest.mark.parametrize("kv,num_splits", [("float32", 1), ("float32", 4), ("bfloat16", 1), ("int8", 4),
                                           ("fp8", 1)])
def test_flash_decode_append_matches_jax(rng, kv, num_splits):
    b, hq, hkv, d = len(ROWS), 4, 2, 16
    q, k, v, kn, vn, scales = _draws(rng, kv, b, hq, hkv, d)
    pos = np.array([p for p, _ in ROWS], np.int32)
    lengths = np.array([n for _, n in ROWS], np.int32)
    kw = dict(layer=LAYER, num_splits=num_splits, block_k=32)
    if scales is not None:
        kw.update(k_scales=scales[0], v_scales=scales[1])
    jk, jv = j_append.append_rows_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                                     LAYER, jnp.asarray(np.minimum(pos, S - 1)))
    ref = j_fd.flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(lengths),
                            **{n: jnp.asarray(x) if n.endswith("scales") else x for n, x in kw.items()})
    tk, tv = tensor_from_numpy(k), tensor_from_numpy(v)
    out = t_fd.flash_decode_append(
        tensor_from_numpy(q), tk, tv, tensor_from_numpy(kn), tensor_from_numpy(vn), torch.from_numpy(pos),
        torch.from_numpy(lengths), **{n: torch.from_numpy(x) if n.endswith("scales") else x
                                      for n, x in kw.items()})
    np.testing.assert_array_equal(_bits(tk), _bits(jk))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    _check_out(out, ref, lengths, q.dtype)


def _paged(rng, k, v, inactive):
    """(L, B, Hkv, S, D) tables laid out in PAGE-row pages under a shuffled
    table (page 0 the null page); the ``inactive`` rows' table rows point at
    page 0, as the engines leave them."""
    layers, b, hkv, s, d = k.shape
    pps = s // PAGE
    table = (rng.permutation(b * pps) + 1).reshape(b, pps).astype(np.int32)
    pools = []
    for x in (k, v):
        pool = np.zeros((layers, hkv, 1 + b * pps, PAGE, d), x.dtype)
        pool[:, :, table.reshape(-1)] = x.reshape(layers, b, hkv, pps, PAGE, d).transpose(
            0, 2, 1, 3, 4, 5).reshape(layers, hkv, b * pps, PAGE, d)
        pools.append(pool)
    table[list(inactive)] = 0
    return pools[0], pools[1], table


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_flash_decode_append_matches_jax(rng, kv):
    """K8 folded into K7 on a shuffled table; the inactive row writes into
    the null page 0, as K8 does (one row only: JAX's kernel rewrites a whole
    16-row window of the page, so two null-page writes in one window race
    there), the length-0 row into its own first page."""
    b, hq, hkv, d = len(ROWS), 4, 2, 16
    q, k, v, kn, vn, scales = _draws(rng, kv, b, hq, hkv, d)
    pos = np.array([p for p, _ in ROWS], np.int32)
    lengths = np.array([n for _, n in ROWS], np.int32)
    kp, vp, table = _paged(rng, k, v, inactive=(1,))
    kw = dict(layer=LAYER)
    if scales is not None:
        kw.update(k_scales=scales[0], v_scales=scales[1])
    jk, jv = j_append.append_rows_paged_kv(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn),
                                           jnp.asarray(vn), LAYER, jnp.asarray(table),
                                           jnp.asarray(np.minimum(pos, S - 1)))
    ref = j_pdec.paged_flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                                    pages_per_compute_block=2,
                                    **{n: jnp.asarray(x) if n.endswith("scales") else x for n, x in kw.items()})
    tk, tv = tensor_from_numpy(kp), tensor_from_numpy(vp)
    out = t_pdec.paged_flash_decode_append(
        tensor_from_numpy(q), tk, tv, torch.from_numpy(table), tensor_from_numpy(kn), tensor_from_numpy(vn),
        torch.from_numpy(pos), torch.from_numpy(lengths),
        **{n: torch.from_numpy(x) if n.endswith("scales") else x for n, x in kw.items()})
    np.testing.assert_array_equal(_bits(tk), _bits(jk))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    _check_out(out, ref, lengths, q.dtype)


def test_append_into_the_sink_tile_matches_jax(rng):
    """Mistral's window + sinks (window 8, 4 sinks) with a softcap: row 0
    writes at 20, inside the tile that holds the sinks and its band; row 1
    is inactive with a stale write at 2, inside the sinks; row 2's band is
    far past the sink tile."""
    b, hq, hkv, d = 3, 4, 2, 16
    q, k, v, kn, vn, _ = _draws(rng, "float32", b, hq, hkv, d)
    pos = np.array([20, 2, 90], np.int32)
    lengths = np.array([21, 0, 91], np.int32)
    kw = dict(layer=LAYER, num_splits=1, block_k=32, window=8, sinks=4, softcap=30.0)
    jk, jv = j_append.append_rows_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                                     LAYER, jnp.asarray(pos))
    ref = j_fd.flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(lengths), **kw)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    out = t_fd.flash_decode_append(torch.from_numpy(q), tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                                   torch.from_numpy(pos), torch.from_numpy(lengths), **kw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _check_out(out, ref, lengths, np.float32)


def test_latent_row_append_matches_jax():
    """MLA's D 640 (16 query heads on one latent KV head, sm_scale 192 **
    -0.5) at 4 splits: the K row and the V row differ (the model's V row
    is the latent part with its rope lanes zeroed), so neither is taken
    for the other."""
    rng = np.random.default_rng(7)
    b, hq, hkv, d, sm = 3, 16, 1, t_fd.LATENT_HEAD_DIM, 192.0**-0.5
    q, k, v, kn, vn, _ = _draws(rng, "float32", b, hq, hkv, d)
    vn[..., 512:] = 0
    pos = np.array([37, 5, 127], np.int32)
    lengths = np.array([38, 0, 128], np.int32)
    kw = dict(layer=LAYER, sm_scale=sm, num_splits=4, block_k=32)
    jk, jv = j_append.append_rows_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                                     LAYER, jnp.asarray(pos))
    ref = j_fd.flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(lengths), **kw)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    out = t_fd.flash_decode_append(torch.from_numpy(q), tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                                   torch.from_numpy(pos), torch.from_numpy(lengths), **kw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _check_out(out, ref, lengths, np.float32)


# ----------------------------------------------------------------- the owner rule


def _grids():
    """(name, S, chunk rows, chunks) of the grids the kernel runs: the
    merging grid of a few decode shapes on an H100's 132 SMs, and the
    partials mode's split geometry."""
    grids = []
    for s, b, hkv, d in ((1024, 16, 8, 128), (4096, 4, 1, t_fd.LATENT_HEAD_DIM), (300, 1, 1, 64)):
        c, n = t_fd.split_chunking(s, b, hkv, 132, d)
        grids.append((f"merging S={s} B={b} Hkv={hkv} D={d}", s, c, n))
    for s, splits, bk in ((1024, 4, 256), (128, 4, 32), (8192, 8, 256)):
        n, _, _ = t_fd._split_geometry(s, splits, bk)
        grids.append((f"partials S={s} splits={splits}", s, s // n, n))
    return grids


def _edge_positions(s, chunk):
    """Write positions on each side of every chunk edge, clamped to the
    table, plus one past the table (clamped to S - 1)."""
    raw = {p for e in range(0, s + chunk, chunk) for p in (e - 1, e)} | {s + 3}
    return sorted({min(p, s - 1) for p in raw if p >= 0})


@pytest.mark.parametrize("grid", _grids(), ids=lambda g: g[0])
def test_every_write_position_has_one_owner_and_no_other_reader(grid):
    _, s, chunk, n = grid
    assert n * chunk >= s
    for p in _edge_positions(s, chunk):
        owners = [c for c in range(n) if c * chunk <= p < (c + 1) * chunk]
        assert len(owners) == 1
        # active (the row is the last attended), inactive (0 rows), and a
        # window + sinks band at both
        for length, window, sinks in ((p + 1, None, 0), (0, None, 0), (p + 1, 64, 4), (0, 64, 4)):
            walks = t_fd.split_chunk_walk(length, s=s, chunk=chunk, window=window, sinks=sinks)
            readers = [c for c, tiles in enumerate(walks) if any(p in rows for _, rows in tiles)]
            assert readers == (owners if length else [])


def _emulated(q, k_old, v_old, k_new, v_new, wpos, lengths, chunk, sm):
    """The kernel's per-chunk work with the fold, in the plain
    split-and-merge's arithmetic: chunk c stages row wpos[b] from the new
    rows when c owns it, every other row from the un-appended table, and
    writes the row to its own copy of the table; the partials merge in
    chunk order. -> (output (B, Hq, D), the appended tables)."""
    b, hq, d = q.shape
    hkv, s = k_old.shape[1], k_old.shape[2]
    g = hq // hkv
    k_out, v_out = k_old.clone(), v_old.clone()
    out = torch.zeros_like(q)
    for bi in range(b):
        wp, length = min(int(wpos[bi]), s - 1), int(lengths[bi])
        walks = t_fd.split_chunk_walk(length, s=s, chunk=chunk)
        owner = wp // chunk
        k_out[bi, :, wp], v_out[bi, :, wp] = k_new[bi], v_new[bi]  # the owner's write
        for h in range(hq):
            ms, ls, os_ = [], [], []
            for c, tiles in enumerate(walks):
                rows = [p for _, read in tiles for p in read if p < length]
                if not rows:
                    ms.append(torch.tensor(NEG_INF))
                    ls.append(torch.tensor(0.0))
                    os_.append(torch.zeros(d))
                    continue
                kh, vh = k_old[bi, h // g].clone(), v_old[bi, h // g].clone()
                if c == owner:  # stage(): row wp from the new rows
                    kh[wp], vh[wp] = k_new[bi, h // g], v_new[bi, h // g]
                idx = torch.tensor(rows)
                sc = (kh[idx] @ q[bi, h]) * torch.tensor(sm, dtype=torch.float32)
                m = sc.max()
                p_ = torch.exp(sc - m)
                ms.append(m)
                ls.append(p_.sum())
                os_.append(p_ @ vh[idx])
            mg = torch.stack(ms).max()
            alpha = torch.exp(torch.stack(ms) - mg)
            lg = (alpha * torch.stack(ls)).sum()
            out[bi, h] = (alpha[:, None] * torch.stack(os_)).sum(0) / (1.0 if lg == 0 else lg)
    return out, k_out, v_out


@pytest.mark.parametrize("chunk", [64, 128])
def test_per_chunk_emulation_equals_append_then_decode(rng, chunk):
    """Write positions on each side of the chunk edges (and clamped past the
    table), active and inactive: the emulated fold gives the same bits as
    the plain append followed by the plain split-and-merge on the chunk
    walks."""
    s, hq, hkv, d, sm = 256, 4, 2, 16, 0.25
    wpos = torch.tensor([63, 64, 127, 128, 255, 300, 191, 0], dtype=torch.int32)
    lengths = torch.minimum(wpos + 1, torch.tensor(s))
    lengths[6] = 0  # inactive: its stale write still lands
    b = wpos.shape[0]
    q = torch.from_numpy(rng.standard_normal((b, hq, d), dtype=np.float32))
    k_old, v_old = (torch.from_numpy(rng.standard_normal((b, hkv, s, d), dtype=np.float32)) for _ in range(2))
    k_new, v_new = (torch.from_numpy(rng.standard_normal((b, hkv, d), dtype=np.float32)) for _ in range(2))
    got, k_out, v_out = _emulated(q, k_old, v_old, k_new, v_new, wpos, lengths, chunk, sm)
    k_app, v_app = k_old[None].clone(), v_old[None].clone()
    t_fd.append_rows_kv_plain(k_app, v_app, k_new, v_new, 0, torch.clamp(wpos, max=s - 1))
    want = split_merge(q[:, :, None], k_app[0], v_app[0], lengths, chunk=chunk, window=None, sinks=0,
                       softcap=None, sm_scale=sm)[:, :, 0]
    assert torch.equal(k_out, k_app[0]) and torch.equal(v_out, v_app[0])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ----------------------------------------------------------------- refusals


def test_refusals():
    b, hq, hkv, s, d = 2, 4, 2, 64, 16
    q = torch.zeros((b, hq, d))
    k, v = torch.zeros((1, b, hkv, s, d)), torch.zeros((1, b, hkv, s, d))
    kn, vn = torch.zeros((b, hkv, d)), torch.zeros((b, hkv, d))
    pos = lengths = torch.zeros((b,), dtype=torch.int32)
    run = lambda *a, **kw: t_fd.flash_decode_append(*a, layer=0, num_splits=1, **kw)  # noqa: E731
    run(q, k, v, kn, vn, pos, lengths)
    with pytest.raises(ValueError, match="verify span"):
        run(torch.zeros((b, hq, 3, d)), k, v, kn, vn, pos, lengths)
    with pytest.raises(ValueError, match="does not match"):
        run(q, k, v, torch.zeros((b, hkv, d + 1)), vn, pos, lengths)
    with pytest.raises(ValueError, match="does not match"):
        run(q, k, v, kn, vn.to(torch.bfloat16), pos, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        run(q, k, v, kn, torch.zeros((b, d, hkv)).transpose(1, 2), pos, lengths)
    with pytest.raises(ValueError, match="pos"):
        run(q, k, v, kn, vn, torch.zeros((b + 1,), dtype=torch.int32), lengths)
    table = torch.zeros((b, 4), dtype=torch.int32)
    pools = torch.zeros((1, hkv, 5, 16, d)), torch.zeros((1, hkv, 5, 16, d))
    paged = lambda q_, kn_: t_pdec.paged_flash_decode_append(q_, *pools, table, kn_, vn, pos,  # noqa: E731
                                                             lengths, layer=0)
    paged(q, kn)
    with pytest.raises(ValueError, match="verify span"):
        paged(torch.zeros((b, hq, 3, d)), kn)
    with pytest.raises(ValueError, match="does not match"):
        paged(q, torch.zeros((b, hkv + 1, d)))
    with pytest.raises(ValueError, match="does not match"):
        paged(q, kn.to(torch.int8))
