"""The port's paged serving (pools and allocators, the K7 paged decode and
the K8 paged append, the paged serving prefill / decode and ``PagedEngine``)
against the JAX package's, on the CPU at ``ModelConfig.tiny`` in float32.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain twins of its kernels. Every kernel check uses a shuffled page table
(physical page != logical page) and a row of length 0.

Held exactly: K8 (a copy), the prompt-chunk scatter and prefix gather
(copies), greedy token streams, ``EngineStats`` counters and the host page
tables after each decode round. Held within 1e-5: K7 in float32 (both
sides fold sm_scale into q and run an fp32 softmax; they differ in
summation order only) and logprobs; logits within 1e-4 as in
tests/test_torch_llama.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import paged as j_paged
from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.ops import cache_append as j_append
from starflashattention_tpu.ops import paged_decode as j_pdec
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu.serving import PagedEngine as JPagedEngine
from starflashattention_tpu.serving import Request as JRequest
from starflashattention_tpu.utils import sanitize as j_sanitize
from starflashattention_tpu_torch.cache import paged as t_paged
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.ops import cache_append as t_append
from starflashattention_tpu_torch.ops import paged_decode as t_pdec
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.serving import Engine, PagedEngine, Request, SamplingParams
from starflashattention_tpu_torch.utils import bridge, native
from starflashattention_tpu_torch.utils import sanitize as t_sanitize

torch.set_num_threads(1)

PAGE = 16  # tiny: max_seq_len 128 -> 8 pages a sequence
ATOL_F32 = 1e-5
LOGIT_ATOL = 1e-4
STATS = ("finished", "decode_rounds", "prefill_rounds", "preemptions", "prefix_hits",
         "prefix_tokens_reused", "decode_tokens")


def _cfgs():
    return (j_params.ModelConfig.tiny(dtype="float32", pages_per_compute_block=2),
            t_params.ModelConfig.tiny(dtype="float32", pages_per_compute_block=2))


@functools.lru_cache(maxsize=None)
def _models():
    jc, _ = _cfgs()
    params = j_llama.quantize_model_weights(
        j_llama.init_params(jc, jax.random.PRNGKey(0)), "int8", lm_head=True)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


def _prompts(lengths, seed=1, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + [int(t) for t in rng.integers(0, 256, n)] for n in lengths]


def _pools(rng, layers=2, hkv=2, num_pages=29, ps=PAGE, d=16):
    shape = (layers, hkv, num_pages, ps, d)
    return rng.standard_normal(shape, dtype=np.float32), rng.standard_normal(shape, dtype=np.float32)


def _shuffled_table(rng, b, pages_per_seq, num_pages):
    """Distinct non-null pages in a random order, so a wrong lookup shows."""
    return (rng.permutation(num_pages - 1)[: b * pages_per_seq] + 1).reshape(b, pages_per_seq).astype(
        np.int32)


# ----------------------------------------------------------------- kernels


@pytest.mark.parametrize("layer", [0, 1])
def test_paged_decode_plain_matches_jax(layer):
    """K7: lengths 0 (gives exactly 0 on both sides), a full table, ragged."""
    rng = np.random.default_rng(0)
    k, v = _pools(rng)
    table = _shuffled_table(rng, 4, 6, 29)
    lengths = np.array([0, 6 * PAGE, 17, 40], np.int32)
    q = rng.standard_normal((4, 4, 16), dtype=np.float32)
    ref = j_pdec.paged_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(table), jnp.asarray(lengths), layer=layer,
                                    pages_per_compute_block=2)
    out = t_pdec.paged_flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(table), torch.from_numpy(lengths), layer=layer,
                                    pages_per_compute_block=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_F32, rtol=0)
    assert np.all(out.numpy()[0] == 0) and np.all(np.asarray(ref)[0] == 0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_quantized_matches_jax(mode, dtype):
    """K7 on int8 / fp8 pools: sm_scale * k_scale folded into q (one
    rounding to q's dtype), fp32 output times v_scale, one cast (JAX
    paged_decode.py:341-346, :404-406). In bf16 the JAX kernel rounds P to
    bf16 for the PV product where the port keeps fp32: 4 bf16 ulps of the
    peak."""
    rng = np.random.default_rng(1)
    k, v = _pools(rng)
    qmax = 127.0 if mode == "int8" else 448.0
    ks = np.array([5.0 / qmax, 6.0 / qmax], np.float32)
    vs = np.array([4.0 / qmax, 5.0 / qmax], np.float32)
    kq = np.asarray(j_quant.quantize_value(jnp.asarray(k), jnp.asarray(ks), mode, head_axis=1))
    vq = np.asarray(j_quant.quantize_value(jnp.asarray(v), jnp.asarray(vs), mode, head_axis=1))
    table = _shuffled_table(rng, 4, 6, 29)
    lengths = np.array([0, 6 * PAGE, 17, 40], np.int32)
    q = rng.standard_normal((4, 4, 16), dtype=np.float32).astype(jnp.dtype(dtype))
    ref = j_pdec.paged_flash_decode(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                                    jnp.asarray(table), jnp.asarray(lengths), layer=1,
                                    pages_per_compute_block=2, k_scales=jnp.asarray(ks),
                                    v_scales=jnp.asarray(vs))
    out = t_pdec.paged_flash_decode(bridge.tensor_from_numpy(q), bridge.tensor_from_numpy(kq),
                                    bridge.tensor_from_numpy(vq), torch.from_numpy(table),
                                    torch.from_numpy(lengths), layer=1, pages_per_compute_block=2,
                                    k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    ref = np.asarray(ref).astype(np.float32)
    tol = ATOL_F32 if dtype == "float32" else 4 * 2.0**-8 * np.abs(ref).max()
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(bridge.tensor_to_numpy(out), ref, atol=tol, rtol=0)
    assert np.all(bridge.tensor_to_numpy(out)[0] == 0)


def test_paged_decode_equals_contiguous_decode_on_the_same_rows():
    """The pages of a shuffled table hold the rows of a contiguous table:
    K7's plain version gives K1's plain result (sm_scale a power of two, so
    folding it into q rounds nothing)."""
    from starflashattention_tpu_torch.ops.flash_decode import flash_decode_plain

    rng = np.random.default_rng(1)
    b, hkv, pps, d = 3, 2, 8, 16
    dense_k = rng.standard_normal((b, hkv, pps * PAGE, d), dtype=np.float32)
    dense_v = rng.standard_normal((b, hkv, pps * PAGE, d), dtype=np.float32)
    table = _shuffled_table(rng, b, pps, b * pps + 1)
    pools = []
    for dense in (dense_k, dense_v):
        pool = np.zeros((1, hkv, b * pps + 1, PAGE, d), np.float32)
        pool[0][:, table.reshape(-1)] = dense.reshape(b, hkv, pps, PAGE, d).transpose(1, 0, 2, 3, 4).reshape(
            hkv, b * pps, PAGE, d)
        pools.append(torch.from_numpy(pool))
    q = torch.from_numpy(rng.standard_normal((b, 4, d), dtype=np.float32))
    lengths = torch.tensor([5, 128, 0], dtype=torch.int32)
    cache = t_paged.PagedKVCache(*pools, page_table=torch.from_numpy(table), lengths=lengths)
    dense = t_paged.gather_layer(cache, 0)
    np.testing.assert_array_equal(dense[0].numpy(), dense_k)
    np.testing.assert_array_equal(dense[1].numpy(), dense_v)
    out = t_pdec.paged_flash_decode(q, *pools, torch.from_numpy(table), lengths, layer=0, sm_scale=0.25)
    ref = flash_decode_plain(q, torch.from_numpy(dense_k), torch.from_numpy(dense_v), lengths,
                             sm_scale=0.25, num_splits=1, block_k=128)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL_F32, rtol=0)


def test_paged_append_plain_matches_jax():
    """K8, whole pools compared exactly; a null-page row writes page 0."""
    rng = np.random.default_rng(2)
    k, v = _pools(rng)
    table = _shuffled_table(rng, 4, 6, 29)
    table[3] = 0  # an inactive slot: every entry is the null page
    pos = np.array([0, 6 * PAGE - 1, 21, 7], np.int32)
    kn = rng.standard_normal((4, 2, 16), dtype=np.float32)
    vn = rng.standard_normal((4, 2, 16), dtype=np.float32)
    jk, jv = j_append.append_rows_paged_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn),
                                           jnp.asarray(vn), 1, jnp.asarray(table), jnp.asarray(pos))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    out = t_append.append_rows_paged_kv(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), 1,
                                        torch.from_numpy(table), torch.from_numpy(pos))
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_scatter_and_gather_match_jax():
    """The prompt-chunk scatter (rows with new_lengths 0 write nothing) and
    the prefix gather, exactly."""
    rng = np.random.default_rng(3)
    k, _ = _pools(rng)
    table = _shuffled_table(rng, 3, 6, 29)
    vals = rng.standard_normal((3, 2, 24, 16), dtype=np.float32)
    start = np.array([0, 13, 50], np.int32)
    new_lengths = np.array([24, 9, 0], np.int32)
    ref = j_paged.scatter_prefill_chunk(jnp.asarray(k), 1, jnp.asarray(vals), jnp.asarray(table),
                                        jnp.asarray(start), jnp.asarray(new_lengths))
    pool = torch.from_numpy(k.copy())
    t_paged.scatter_prefill_chunk(pool, 1, torch.from_numpy(vals), torch.from_numpy(table),
                                  torch.from_numpy(start), torch.from_numpy(new_lengths))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(ref))
    for n in (1, 30, 6 * PAGE):
        got = t_paged.gather_prefix(pool, 1, torch.from_numpy(table), n)
        want = j_paged.gather_prefix(ref, 1, jnp.asarray(table), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bridge_round_trips_a_jax_paged_cache():
    jcache = j_paged.init_paged_cache(2, 3, 2, 16, num_pages=9, page_size=PAGE, pages_per_seq=4)
    arrays = {name: np.asarray(getattr(jcache, name))
              for name in ("k_pages", "v_pages", "page_table", "lengths")}
    arrays["page_table"] = _shuffled_table(np.random.default_rng(4), 2, 4, 9).repeat(2, 0)[:3]
    tcache = bridge.paged_cache_from_numpy(**arrays)
    assert isinstance(tcache, t_paged.PagedKVCache) and tcache.page_table.dtype == torch.int32
    assert (tcache.num_pages, tcache.page_size, tcache.pages_per_seq, tcache.batch_size) == (9, PAGE, 4, 3)
    back = bridge.paged_cache_to_numpy(tcache)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(back[name], arr)


# ----------------------------------------------------------------- allocators


@pytest.mark.parametrize("pool_kind", ["python", "native"])
def test_page_pools_allocate_like_jax(pool_kind):
    """The same sequence of pool calls hands out the same page ids as the
    JAX package's Python pool; page 0 is never handed out."""
    if pool_kind == "native" and native.load() is None:
        pytest.skip("no C++ compiler to build the native page pool")
    pool = t_paged.SeqPagePool(7) if pool_kind == "python" else native.NativePagePool(7)
    ref = j_paged.SeqPagePool(7)
    log = {}
    for name, p in (("port", pool), ("jax", ref)):
        a, b = p.seq_new(), p.seq_new()
        p.seq_extend(a, 20, 8)
        p.seq_extend(b, 9, 8)
        head = p.seq_release_prefix(a, 2)
        p.seq_free(b)
        p.seq_extend(a, 30, 8)
        with pytest.raises(MemoryError):
            p.seq_extend(a, 200, 8)
        p.free_raw(head)
        log[name] = (head, p.seq_pages(a), p.free_pages)
    assert log["port"] == log["jax"]
    assert 0 not in log["port"][0] + log["port"][1]


def test_init_paged_cache_refuses_quantized_pages():
    """int8 / fp8 pages are ported; a quant mode the pools do not know, or
    a 1-byte dtype without one, is refused."""
    with pytest.raises(ValueError, match="quant mode"):
        t_paged.init_paged_cache(1, 1, 1, 16, num_pages=3, page_size=PAGE, pages_per_seq=2,
                                 quant_mode="int4", device="cpu")
    with pytest.raises(ValueError, match="bf16 or fp32"):
        t_paged.init_paged_cache(1, 1, 1, 16, num_pages=3, page_size=PAGE, pages_per_seq=2,
                                 dtype=torch.int8, device="cpu")


def test_page_table_sanitizer_matches_jax():
    table = np.array([[1, 2, 0], [2, 3, 0], [4, 0, 0]], np.int32)
    lengths = np.array([20, 20, 20], np.int64)
    msgs = []
    for mod in (j_sanitize, t_sanitize):
        with pytest.raises(mod.PageTableRace) as err:
            mod.check_page_table(table, lengths, PAGE, 8)
        msgs.append(str(err.value))
        # a refcounted prefix-cache page may sit in several live tables
        mod.check_page_table(table[:2, :2], lengths[:2], PAGE, 8, shared_ok={2})
        with pytest.raises(mod.PageTableRace):
            mod.check_append_window(np.array([120]), 9, 128)
        mod.check_append_window(np.array([119]), 9, 128)
    assert msgs[0] == msgs[1]
    assert "aliased" in msgs[1] and "null page" in msgs[1]
    with pytest.raises(t_sanitize.NumericFault):
        t_sanitize.check_finite({"x": torch.tensor([1.0, float("nan")])})


# ----------------------------------------------------------------- model entry points


def _jax_and_port_cache(rng, b=3, pps=8, num_pages=26):
    jc, _ = _cfgs()
    k, v = _pools(rng, layers=jc.num_layers, hkv=jc.num_kv_heads, num_pages=num_pages, d=jc.head_dim)
    table = _shuffled_table(rng, b, pps, num_pages)
    return k, v, table


def test_prefill_serving_paged_matches_jax():
    """Two admission calls on the same pools: whole prompts into reset rows
    (prefix_len 0), then a continuation chunk over a gathered prefix
    (prefix_len > 0) with one row inactive."""
    jc, tc = _cfgs()
    jp, tp = _models()
    rng = np.random.default_rng(5)
    k, v, table = _jax_and_port_cache(rng)
    lengths = np.array([3, 40, 11], np.int32)
    jcache = j_paged.PagedKVCache(k_pages=jnp.asarray(k), v_pages=jnp.asarray(v),
                                  page_table=jnp.asarray(table), lengths=jnp.asarray(lengths))
    tcache = bridge.paged_cache_from_numpy(k, v, table, lengths)
    cos, sin = j_llama.rope_tables(jc)
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    calls = [  # tokens, new_lengths, active, reset, prefix_len
        (rng.integers(0, 256, (3, 16)), [16, 5, 9], [True, False, True], [True, False, True], 0),
        (rng.integers(0, 256, (3, 8)), [8, 0, 3], [True, False, True], [False, False, False], 16),
    ]
    for toks, new, act, reset, prefix_len in calls:
        args = [np.asarray(a, dtype) for a, dtype in
                ((toks, np.int32), (new, np.int32), (act, bool), (reset, bool))]
        ref, jcache = j_llama.prefill_serving_paged(jp, jcache, *map(jnp.asarray, args), cos, sin, jc,
                                                    prefix_len=prefix_len)
        out, _ = t_llama.prefill_serving_paged(tp, tcache, *map(torch.from_numpy, args), tcos, tsin, tc,
                                               prefix_len=prefix_len)
        active = args[2]
        np.testing.assert_allclose(out.numpy()[active], np.asarray(ref)[active], atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
        np.testing.assert_allclose(tcache.k_pages.numpy(), np.asarray(jcache.k_pages), atol=ATOL_F32,
                                   rtol=0)
    np.testing.assert_array_equal(tcache.lengths.numpy(), [24, 40, 12])


def test_decode_multi_paged_matches_jax():
    jc, tc = _cfgs()
    jp, tp = _models()
    rng = np.random.default_rng(6)
    k, v, table = _jax_and_port_cache(rng)
    table[2] = 0  # inactive slot on the null page
    lengths = np.array([9, 57, 4], np.int32)
    tok = np.array([5, 6, 7], np.int32)
    active = np.array([True, True, False])
    jcache = j_paged.PagedKVCache(k_pages=jnp.asarray(k), v_pages=jnp.asarray(v),
                                  page_table=jnp.asarray(table), lengths=jnp.asarray(lengths))
    tcache = bridge.paged_cache_from_numpy(k, v, table, lengths)
    cos, sin = j_llama.rope_tables(jc)
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    jt, jpend, jcache, jlp = j_llama.decode_multi_paged(
        jp, jcache, jnp.asarray(tok), cos, sin, jnp.asarray(active), jc, 3, with_logprobs=True)
    tt, tpend, tcache, tlp = t_llama.decode_multi_paged(
        tp, tcache, torch.from_numpy(tok), tcos, tsin, torch.from_numpy(active), tc, 3,
        with_logprobs=True)
    np.testing.assert_array_equal(tt.numpy()[active], np.asarray(jt)[active])
    np.testing.assert_array_equal(tpend.numpy()[active], np.asarray(jpend)[active])
    np.testing.assert_array_equal(tcache.lengths.numpy(), [12, 60, 4])
    np.testing.assert_allclose(tlp.numpy()[active], np.asarray(jlp)[active], atol=ATOL_F32, rtol=0)
    live = np.ones(tcache.k_pages.shape[2], bool)
    live[0] = False  # page 0 holds the inactive slot's junk on both sides
    np.testing.assert_allclose(tcache.k_pages.numpy()[:, :, live], np.asarray(jcache.k_pages)[:, :, live],
                               atol=ATOL_F32, rtol=0)


# ----------------------------------------------------------------- the engine


_SCENARIOS = {
    # more requests than slots, with logprobs
    "interleaved": (dict(num_slots=2, steps_per_round=3, return_logprobs=True),
                    _prompts((3, 7, 5, 12, 2)), 6),
    # a pool of 3 usable pages: the younger request is preempted and resumes
    "preempt": (dict(num_slots=2, steps_per_round=3, num_pages=4), _prompts((9, 9), 2), 12),
    # chunked prefill over prompts up to 3 chunks wide
    "chunked": (dict(num_slots=2, steps_per_round=2, prefill_chunk=8), _prompts((3, 9, 17, 5), 3), 4),
    # a shared 2-page prefix: later admissions hit the prefix cache
    "prefix": (dict(num_slots=2, steps_per_round=3, prefix_cache=True),
               _prompts((3, 9, 5, 14), 4, prefix=_prompts((2 * PAGE,), 5)[0]), 5),
}


def _record_tables(eng):
    tables = []
    decode_round = eng._decode_round

    def recorded():
        decode_round()
        tables.append(eng._host_table.copy())

    eng._decode_round = recorded
    return tables


def _run(engine_cls, request_cls, params, cfg, kind, **extra):
    kw, prompts, n_new = _SCENARIOS[kind]
    eng = engine_cls(params, cfg, page_size=PAGE, native=False, **kw, **extra)
    tables = _record_tables(eng)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    stats = {k: getattr(eng.stats, k) for k in STATS}
    return eng, reqs, stats, tables


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    jc, _ = _cfgs()
    jp, _ = _models()
    _, reqs, stats, tables = _run(JPagedEngine, JRequest, jp, jc, kind)
    return reqs, stats, tables


@pytest.mark.parametrize("kind", sorted(_SCENARIOS))
def test_paged_engine_matches_jax(kind):
    """Streams, counters and the host page table after every decode round."""
    ref, ref_stats, ref_tables = _jax_run(kind)
    _, tc = _cfgs()
    _, tp = _models()
    eng, reqs, stats, tables = _run(PagedEngine, Request, tp, tc, kind, device="cpu")
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert stats == ref_stats
    assert len(tables) == len(ref_tables)
    for got, want in zip(tables, ref_tables):
        np.testing.assert_array_equal(got, want)
    assert eng.pool.free_pages + (eng._prefix.resident_pages if eng._prefix else 0) == eng.num_pages - 1
    eng._sync_table()  # retirements zeroed rows since the last round's sync
    np.testing.assert_array_equal(eng.cache.page_table.numpy(), eng._host_table)
    assert not eng._host_table.any()
    if kind == "preempt":
        assert stats["preemptions"] > 0
    if kind == "prefix":
        assert stats["prefix_hits"] > 0
    if kind == "interleaved":
        for r, j in zip(reqs, ref):
            np.testing.assert_allclose(r.logprobs, j.logprobs, atol=ATOL_F32, rtol=0)


@functools.lru_cache(maxsize=None)
def _int4_models():
    jc, _ = _cfgs()
    params = j_llama.quantize_model_weights(
        j_llama.init_params(jc, jax.random.PRNGKey(0)), "int4", lm_head=True)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("kind", ["preempt", "prefix"])
def test_paged_engine_int8_pages_int4_weights_matches_jax(kind):
    """A quantized deployment through the paged engine: int8 pages (chunk
    quantized before the scatter, prefixes dequantized after the gather),
    int4 weights. Streams, counters and the page table after every round
    equal the JAX engine's."""
    jc, tc = (dataclasses.replace(c, quant_mode="int8") for c in _cfgs())
    jp, tp = _int4_models()
    _, ref, ref_stats, ref_tables = _run(JPagedEngine, JRequest, jp, jc, kind)
    eng, reqs, stats, tables = _run(PagedEngine, Request, tp, tc, kind, device="cpu")
    assert eng.cache.k_pages.dtype == torch.int8 and eng.cache.k_scales is not None
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert stats == ref_stats
    assert len(tables) == len(ref_tables)
    for got, want in zip(tables, ref_tables):
        np.testing.assert_array_equal(got, want)
    assert stats["preemptions" if kind == "preempt" else "prefix_hits"] > 0


def test_paged_engine_equals_contiguous_engine():
    """Both port engines give the JAX streams of the interleaved scenario."""
    ref, _, _ = _jax_run("interleaved")
    _, tc = _cfgs()
    _, tp = _models()
    kw, prompts, n_new = _SCENARIOS["interleaved"]
    out = Engine(tp, tc, device="cpu", **kw).generate(prompts, n_new)
    assert out == [r.output for r in ref]


def test_paged_engine_native_pool_matches_python_pool():
    if native.load() is None:
        pytest.skip("no C++ compiler to build the native page pool")
    ref, _, ref_tables = _jax_run("preempt")
    _, tc = _cfgs()
    _, tp = _models()
    kw, prompts, n_new = _SCENARIOS["preempt"]
    eng = PagedEngine(tp, tc, page_size=PAGE, device="cpu", **kw)  # native=None: the C++ pool loads
    assert isinstance(eng.pool, native.NativePagePool)
    tables = _record_tables(eng)
    assert eng.generate(prompts, n_new) == [r.output for r in ref]
    for got, want in zip(tables, ref_tables):
        np.testing.assert_array_equal(got, want)
    assert eng.pool.free_pages == eng.num_pages - 1


def test_paged_engine_debug_validate_and_pool_limits():
    _, tc = _cfgs()
    _, tp = _models()
    kw, prompts, n_new = _SCENARIOS["prefix"]
    eng = PagedEngine(tp, tc, page_size=PAGE, native=False, device="cpu", debug_validate=True, **kw)
    ref, _, _ = _jax_run("prefix")
    assert eng.generate(prompts, n_new) == [r.output for r in ref]
    small = PagedEngine(tp, tc, num_slots=1, page_size=PAGE, num_pages=2, native=False, device="cpu")
    with pytest.raises(MemoryError):
        small.generate([[1, 2, 3]], max_new_tokens=PAGE + 4)


def test_sampled_stream_survives_preemption():
    """A sampled request that is preempted and resumed draws the same tokens
    as without preemption: each draw is keyed on (seed, position)."""
    _, tc = _cfgs()
    _, tp = _models()
    kw, prompts, n_new = _SCENARIOS["preempt"]
    samp = [SamplingParams(temperature=1.0, top_p=0.9, seed=7 + i) for i in range(len(prompts))]
    roomy = PagedEngine(tp, tc, page_size=PAGE, native=False, device="cpu", enable_sampling=True,
                        **{**kw, "num_pages": None})
    tight = PagedEngine(tp, tc, page_size=PAGE, native=False, device="cpu", enable_sampling=True, **kw)
    a = roomy.generate(prompts, n_new, sampling=samp)
    b = tight.generate(prompts, n_new, sampling=samp)
    assert roomy.stats.preemptions == 0 and tight.stats.preemptions > 0
    assert a == b
