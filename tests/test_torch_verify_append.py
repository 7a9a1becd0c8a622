"""The verify step's block append folded into the verify launch, on the CPU.

``ops/flash_decode.flash_verify_append`` writes the first ``n_valid[b]`` of
each sequence's T new K/V rows at ``min(pos[b], S - T)`` and attends the T
query tokens, in one launch of ``csrc/flash_decode_split.cu`` on the card.
On CPU tensors it runs its plain twin (the plain block append, then the
plain verify), which is held here to JAX's ``append_block_kv`` +
``flash_verify`` (the Pallas kernels in interpret mode) on the same numpy
draws.

Here:

- the entry against JAX on fp32, bf16 and int8 caches, and on fp32 with a
  window, sinks and a softcap: spans across a 32-row tile edge and a
  128-row chunk edge, a span at the table's start, clamped spans (``pos >
  S - T`` and ``pos = S``), a partial span and an inactive row (``n_valid``
  0); with the variants, the clamped spans (whose later tokens attend past
  S) against JAX's ``core/reference`` instead, token by token;
- a model of the kernel's owner rule on ``split_chunking`` (a verify
  launch merges; it takes no partials mode) and ``split_chunk_walk``: for
  spans on each side of every chunk edge every written row has exactly
  one owner chunk and no other chunk's walk reads it, and a per-chunk
  emulation that stages the span's rows from the new rows and every other
  row from the un-appended table equals the block append then the verify,
  bit for bit;
- the refusals;
- ``models/llama._verify_core`` goes through the fused entry, once a layer,
  and never through ``append_block_kv`` or ``flash_verify``.

Tolerances: outputs, fp32 on both sides, 1e-5 absolute; bf16 q, 4 bf16 ulps
of the peak (JAX's kernel rounds P to bf16 for P @ V where the port keeps
fp32, as in ``tests/test_torch_spec.py``). The tables are compared bit for
bit, every dtype.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_decode_cases import split_merge
from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu.core import reference as j_ref
from starflashattention_tpu_torch.core.reference import NEG_INF
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.ops import cache_append as t_append
from starflashattention_tpu_torch.ops import flash_decode as t_fd
from starflashattention_tpu_torch.runtime.params import ModelConfig
from starflashattention_tpu_torch.utils.bridge import tensor_from_numpy, tensor_to_numpy

j_append, j_fd = (importlib.import_module(f"starflashattention_tpu.ops.{name}")
                  for name in ("cache_append", "flash_decode"))

torch.set_num_threads(1)

ATOL = 1e-5
S, T, LAYER = 256, 5, 1
# (first write position, rows to write): across the 32-row tile edge at 32,
# across the 128-row chunk edge at 128, at the table's start, clamped to
# S - T from S - 2 and from S, a partial span, an inactive row
ROWS = ((30, T), (126, T), (0, T), (S - 2, T), (S, T), (60, 3), (40, 0))
# the rows whose last token attends at most S rows, JAX's contract for a
# windowed verify (past S its interpret-mode walk steps beyond the table's
# last block; the verify step's clamp keeps the engines' rows inside it),
# with a span that ends at the table's last row
IN_TABLE = tuple(r for r in ROWS if r[0] + T <= S) + ((S - T, T),)
# the spans whose later tokens attend past S, held to JAX's reference
PAST_S = tuple(r for r in ROWS if r not in IN_TABLE)
QMAX = {"int8": 127.0, "fp8": 448.0}


def _bits(x):
    """Raw bits of a torch tensor or a JAX / numpy array, as numpy integers."""
    if isinstance(x, torch.Tensor):
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
        return x.contiguous().view(ints[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32}[x.itemsize])


def _draws(rng, kv, b, hq, hkv, d, layers=2):
    """q (B, Hq, T, D), the tables, the new (B, Hkv, T, D) rows and the
    scales as numpy arrays in the kernel's dtypes: q fp32 (bf16 on a bf16
    or int8 cache), K / V quantized by JAX against (Hkv,) scales on int8."""
    q = rng.standard_normal((b, hq, T, d), dtype=np.float32)
    k, v = (rng.standard_normal((layers, b, hkv, S, d), dtype=np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((b, hkv, T, d), dtype=np.float32) for _ in range(2))
    if kv != "float32":
        q = q.astype(jnp.bfloat16)
    if kv == "bfloat16":
        k, v, kn, vn = (x.astype(jnp.bfloat16) for x in (k, v, kn, vn))
    if kv not in QMAX:
        return q, k, v, kn, vn, {}
    ks = (5.0 / QMAX[kv] * (1.0 + 0.1 * np.arange(hkv))).astype(np.float32)
    vs = (5.0 / QMAX[kv] * (1.0 - 0.05 * np.arange(hkv))).astype(np.float32)
    quant = [np.asarray(j_quant.quantize_value(jnp.asarray(x), jnp.asarray(sc), kv, head_axis=axis))
             for x, sc, axis in ((k, ks, 2), (v, vs, 2), (kn, ks, 1), (vn, vs, 1))]
    return (q, *quant, dict(k_scales=ks, v_scales=vs))


@pytest.mark.parametrize("kv,variants", [("float32", False), ("bfloat16", False), ("int8", False),
                                         ("float32", True)])
def test_flash_verify_append_matches_jax(rng, kv, variants):
    """The entry's output and whole tables against JAX's block append at
    ``min(pos, S - T)`` (the verify step's clamp) then its verify over
    ``pos + 1`` rows, as ``_verify_core`` calls them; with ``variants`` a
    window of 40, 4 sinks and a softcap of 30 on the rows inside JAX's
    contract (``IN_TABLE``)."""
    rows = IN_TABLE if variants else ROWS
    b, hq, hkv, d = len(rows), 4, 2, 16
    q, k, v, kn, vn, scales = _draws(rng, kv, b, hq, hkv, d)
    pos = np.array([p for p, _ in rows], np.int32)
    n_valid = np.array([n for _, n in rows], np.int32)
    lengths = pos + 1
    opts = dict(window=40, sinks=4, softcap=30.0) if variants else {}
    jk, jv = j_append.append_block_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                                      LAYER, jnp.asarray(np.minimum(pos, S - T)), jnp.asarray(n_valid))
    ref = j_fd.flash_verify(jnp.asarray(q), jk, jv, jnp.asarray(lengths), layer=LAYER, block_k=64,
                            **{n: jnp.asarray(x) for n, x in scales.items()}, **opts)
    tk, tv = tensor_from_numpy(k), tensor_from_numpy(v)
    out = t_fd.flash_verify_append(tensor_from_numpy(q), tk, tv, tensor_from_numpy(kn), tensor_from_numpy(vn),
                                   torch.from_numpy(pos), torch.from_numpy(n_valid), torch.from_numpy(lengths),
                                   layer=LAYER, block_k=64, **{n: torch.from_numpy(x) for n, x in scales.items()},
                                   **opts)
    np.testing.assert_array_equal(_bits(tk), _bits(jk))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    ref = np.asarray(ref).astype(np.float32)
    tol = ATOL if kv == "float32" else 4 * 2.0**-8 * np.abs(ref).max()
    assert out.shape == q.shape
    np.testing.assert_allclose(tensor_to_numpy(out), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_windowed_verify_past_the_table_matches_jax_reference(rng, kv):
    """Spans clamped past S (``PAST_S``: token j attends ``pos + 1 + j``
    rows, up to S + T - 1) with a window of 40, 4 sinks and a softcap of 30:
    each token against JAX's ``core/reference.decode_reference`` at ``pos +
    1 + j`` on the table JAX's block append wrote, so its rows stop at S and
    its band starts at the unclamped ``pos + 1 + j - 40``. JAX's
    interpret-mode verify is no oracle there: its banded walk fetches a block
    past the table."""
    b, hq, hkv, d = len(PAST_S), 4, 2, 16
    q, k, v, kn, vn, _ = _draws(rng, kv, b, hq, hkv, d)
    pos = np.array([p for p, _ in PAST_S], np.int32)
    n_valid = np.array([n for _, n in PAST_S], np.int32)
    lengths = pos + 1
    assert (lengths + T - 1 > S).all()
    jk, jv = j_append.append_block_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                                      LAYER, jnp.asarray(np.minimum(pos, S - T)), jnp.asarray(n_valid))
    out = t_fd.flash_verify_append(tensor_from_numpy(q), tensor_from_numpy(k), tensor_from_numpy(v),
                                   tensor_from_numpy(kn), tensor_from_numpy(vn), torch.from_numpy(pos),
                                   torch.from_numpy(n_valid), torch.from_numpy(lengths), layer=LAYER,
                                   window=40, sinks=4, softcap=30.0)
    out = tensor_to_numpy(out)
    kl, vl = (jnp.asarray(np.asarray(x[LAYER]).astype(np.float32)) for x in (jk, jv))
    for j in range(T):
        ref = np.asarray(j_ref.decode_reference(jnp.asarray(np.asarray(q[:, :, j]).astype(np.float32)), kl, vl,
                                                jnp.asarray(lengths + j), sliding_window=40, attention_sinks=4,
                                                softcap=30.0))
        tol = ATOL if kv == "float32" else 4 * 2.0**-8 * np.abs(ref).max()
        np.testing.assert_allclose(out[:, :, j], ref, atol=tol, rtol=0)


# ----------------------------------------------------------------- the owner rule


def _span(pos, n_valid, s, t):
    """(wp, [w0, w1)) of one sequence as the kernel computes them: the first
    write position clamped to S - T, and the rows it writes inside the
    table (None: all T rows)."""
    wp = min(int(pos), s - t)
    nv = t if n_valid is None else min(max(int(n_valid), 0), t)
    return wp, max(wp, 0), min(wp + nv, s)


def _grids():
    """(name, S, chunk rows, chunks) of the grids a verify launch runs: the
    merging grid of the verify shapes on an H100's 132 SMs (the partials
    mode takes no span)."""
    grids = []
    for s, b, hkv, d in ((1024, 8, 8, 128), (8192, 8, 8, 256), (300, 1, 1, 64), (256, 2, 2, 16)):
        c, n = t_fd.split_chunking(s, b, hkv, 132, d)
        grids.append((f"merging S={s} B={b} Hkv={hkv} D={d}", s, c, n))
    return grids


@pytest.mark.parametrize("grid", _grids(), ids=lambda g: g[0])
def test_every_span_row_has_one_owner_and_no_other_reader(grid):
    """Spans of T = 5 starting on each side of every chunk and tile edge,
    clamped past the table, full, partial and inactive: each written row
    has exactly one owner chunk, the span touches at most two 32-row tiles,
    and no chunk's walk (plain, and with a window and sinks) reads a row
    that another chunk writes."""
    _, s, chunk, n = grid
    assert n * chunk >= s
    starts = sorted({min(max(e + o, 0), s + 3) for e in range(0, s + chunk, chunk) for o in (-4, -2, 0, 1)}
                    | {s - 2, s, 29, 30})
    for start in starts:
        for nv in (T, 2, 0):
            wp, w0, w1 = _span(start, nv, s, T)
            rows = range(w0, w1)
            assert len({p // t_fd.TILE for p in rows}) <= 2
            owners = {p: [c for c in range(n) if c * chunk <= p < (c + 1) * chunk] for p in rows}
            assert all(len(o) == 1 for o in owners.values())
            for window, sinks in ((None, 0), (64, 4)):
                walks = t_fd.split_chunk_walk(start + 1, s=s, chunk=chunk, qspan=T, window=window, sinks=sinks)
                for p in rows:
                    readers = [c for c, tiles in enumerate(walks) if any(p in read for _, read in tiles)]
                    assert set(readers) <= set(owners[p])


def _emulated(q, k_old, v_old, k_new, v_new, pos, n_valid, lengths, chunk, sm):
    """The kernel's per-chunk work with the fold, in the plain
    split-and-merge's arithmetic (``split_merge``): chunk c stages the rows
    of the span that it owns from the new rows, every other row from the
    un-appended table, and writes its rows to its own copy of the table;
    the partials merge in chunk order. -> (output (B, Hq, T, D), the
    appended tables)."""
    b, hq, t, d = q.shape
    hkv, s = k_old.shape[1], k_old.shape[2]
    g = hq // hkv
    k_out, v_out = k_old.clone(), v_old.clone()
    out = torch.zeros_like(q)
    for bi in range(b):
        wp, w0, w1 = _span(pos[bi], n_valid[bi], s, t)
        length = int(lengths[bi])
        walks = t_fd.split_chunk_walk(length, s=s, chunk=chunk, qspan=t)
        owned = [[p for p in range(w0, w1) if c * chunk <= p < (c + 1) * chunk] for c in range(len(walks))]
        for rows in owned:  # each owner's writes
            for p in rows:
                k_out[bi, :, p], v_out[bi, :, p] = k_new[bi, :, p - wp], v_new[bi, :, p - wp]
        for h in range(hq):
            staged = []
            for rows in owned:  # stage(): the owner's rows of the span from the new rows
                kh, vh = k_old[bi, h // g].clone(), v_old[bi, h // g].clone()
                for p in rows:
                    kh[p], vh[p] = k_new[bi, h // g, p - wp], v_new[bi, h // g, p - wp]
                staged.append((kh, vh))
            for j in range(t):
                n_j = min(length + j, s)
                ms, ls, os_ = [], [], []
                for (kh, vh), tiles in zip(staged, walks):
                    rows = [p for _, read in tiles for p in read if p < n_j]
                    if not rows:
                        ms.append(torch.tensor(NEG_INF))
                        ls.append(torch.tensor(0.0))
                        os_.append(torch.zeros(d))
                        continue
                    idx = torch.tensor(rows)
                    sc = (kh[idx] @ q[bi, h, j]) * torch.tensor(sm, dtype=torch.float32)
                    m = sc.max()
                    p_ = torch.exp(sc - m)
                    ms.append(m)
                    ls.append(p_.sum())
                    os_.append(p_ @ vh[idx])
                mg = torch.stack(ms).max()
                alpha = torch.exp(torch.stack(ms) - mg)
                lg = (alpha * torch.stack(ls)).sum()
                out[bi, h, j] = (alpha[:, None] * torch.stack(os_)).sum(0) / (1.0 if lg == 0 else lg)
    return out, k_out, v_out


@pytest.mark.parametrize("chunk", [64, 128])
def test_per_chunk_emulation_equals_append_then_verify(rng, chunk):
    """Spans on each side of the chunk edges and across a tile edge,
    clamped past the table, partial and inactive: the emulated fold gives
    the same bits as the plain block append followed by the plain
    split-and-merge verify on the chunk walks."""
    s, hq, hkv, d, sm = 256, 4, 2, 16, 0.25
    pos = torch.tensor([62, 125, 127, 30, 254, 300, 191, 0], dtype=torch.int32)
    n_valid = torch.tensor([T, T, 3, T, T, T, 0, T], dtype=torch.int32)
    lengths = torch.minimum(pos + 1, torch.tensor(s))
    b = pos.shape[0]
    q = torch.from_numpy(rng.standard_normal((b, hq, T, d), dtype=np.float32))
    k_old, v_old = (torch.from_numpy(rng.standard_normal((b, hkv, s, d), dtype=np.float32)) for _ in range(2))
    k_new, v_new = (torch.from_numpy(rng.standard_normal((b, hkv, T, d), dtype=np.float32)) for _ in range(2))
    got, k_out, v_out = _emulated(q, k_old, v_old, k_new, v_new, pos, n_valid, lengths, chunk, sm)
    k_app, v_app = k_old[None].clone(), v_old[None].clone()
    t_append.append_block_kv_plain(k_app, v_app, k_new, v_new, 0, torch.clamp(pos, max=s - T), n_valid)
    want = split_merge(q, k_app[0], v_app[0], lengths, chunk=chunk, window=None, sinks=0, softcap=None,
                       sm_scale=sm)
    assert torch.equal(k_out, k_app[0]) and torch.equal(v_out, v_app[0])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ----------------------------------------------------------------- refusals


def test_refusals():
    b, hq, hkv, d = 2, 4, 2, 16
    q = torch.zeros((b, hq, T, d))
    k, v = torch.zeros((1, b, hkv, S, d)), torch.zeros((1, b, hkv, S, d))
    kn, vn = torch.zeros((b, hkv, T, d)), torch.zeros((b, hkv, T, d))
    pos = lengths = torch.zeros((b,), dtype=torch.int32)
    n_valid = torch.full((b,), T, dtype=torch.int32)
    run = lambda *a, **kw: t_fd.flash_verify_append(*a, layer=0, **kw)  # noqa: E731
    run(q, k, v, kn, vn, pos, n_valid, lengths)
    run(q, k, v, kn, vn, pos, None, lengths)
    with pytest.raises(ValueError, match=r"\(B, Hq, T, D\)"):
        run(q[:, :, 0], k, v, kn, vn, pos, n_valid, lengths)
    with pytest.raises(ValueError, match="does not match"):
        run(q, k, v, kn[:, :, :2].contiguous(), vn, pos, n_valid, lengths)
    with pytest.raises(ValueError, match="does not match"):
        run(q, k, v, kn, vn.to(torch.bfloat16), pos, n_valid, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        run(q, k, v, kn, torch.zeros((b, hkv, d, T)).transpose(2, 3), pos, n_valid, lengths)
    with pytest.raises(ValueError, match="n_valid"):
        run(q, k, v, kn, vn, pos, torch.zeros((b + 1,), dtype=torch.int32), lengths)
    with pytest.raises(ValueError, match="n_valid"):
        run(q, k, v, kn, vn, pos, n_valid.float(), lengths)
    with pytest.raises(ValueError, match="pos"):
        run(q, k, v, kn, vn, torch.zeros((b, 1), dtype=torch.int32), n_valid, lengths)
    with pytest.raises(ValueError, match="sinks"):
        run(q, k, v, kn, vn, pos, n_valid, lengths, sinks=4)


# ----------------------------------------------------------------- the verify step's route


def test_verify_core_goes_through_the_fused_entry(monkeypatch):
    """A prompt-lookup round on a tiny model: each layer's verify step makes
    one ``flash_verify_append`` call (the write position unclamped, the
    inactive row's n_valid 0) and none to the standalone block append or
    verify, and the cache gains the same rows as the block append then the
    verify would give it."""
    cfg = ModelConfig.tiny(dtype="float32", num_splits=1, max_seq_len=64)
    params = t_llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    fused = t_fd.flash_verify_append

    def counted(*args, **kw):
        calls.append((args[5].clone(), None if args[6] is None else args[6].clone()))
        return fused(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("the verify step launched a standalone kernel")

    monkeypatch.setattr(t_llama, "flash_verify_append", counted)
    monkeypatch.setattr(t_append, "append_block_kv", refused)
    monkeypatch.setattr(t_fd, "flash_verify", refused)
    assert not hasattr(t_llama, "append_block_kv") and not hasattr(t_llama, "flash_verify")
    from starflashattention_tpu_torch.cache import contiguous

    b = 3
    hkv, d = cfg.kv_cache_dims()
    cache = contiguous.init_cache(cfg.num_layers, b, hkv, cfg.max_seq_len, d,
                                  dtype=torch.float32, device="cpu")
    cache.lengths.copy_(torch.tensor([10, 61, 30], dtype=torch.int32))  # row 1 clamped: 61 > 64 - 5
    cos, sin = t_llama.rope_tables(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (b, T), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    active = torch.tensor([True, True, False])
    t_llama._verify_core(params, cache, tokens, cos, sin, cfg, active=active)
    assert len(calls) == cfg.num_layers
    for pos, n_valid in calls:
        assert pos.tolist() == [10, 61, 30] and n_valid.tolist() == [T, T, 0]
    assert cache.lengths.tolist() == [10 + T, 61 + T, 30]
    assert torch.all(cache.k[:, 2] == 0) and torch.all(cache.k[:, 1, :, 64 - T:] != 0)
