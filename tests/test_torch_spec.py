"""The port's speculative decoding against the JAX package's, on the CPU.

Covered: prompt-lookup drafting (``core/drafting``), the verify attention
(``flash_verify``, kernel K1's verify mode, through its plain twin), the
block append (``append_block_kv``, kernel K9, through its plain twin), the
speculative rounds ``spec_decode_multi`` / ``spec_decode_multi_draft`` and
``Engine(spec_decode=, draft_model=)``. The JAX side runs its Pallas
kernels in interpret mode; the models are built by the JAX package and
reach the port through the numpy bridge.

Held exactly: drafts and histories, appended bytes, token streams, emitted
counts, pending tokens, cache lengths, ``EngineStats`` counters, and a
verify token against the one-split decode at ``lengths + j`` (the plain
twin computes each token as that decode). Held within 1e-5: fp32 attention
outputs and cache rows (fp32 on both sides, sums in another order). bf16
attention: 4 bf16 ulps of the peak (the JAX kernel rounds P to bf16 for
the PV product, the port keeps it fp32; ROADMAP Queue 3).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_cache
from starflashattention_tpu.core import drafting as j_drafting
from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu.serving import Engine as JEngine
from starflashattention_tpu_torch.core import drafting as t_drafting
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.ops import cache_append as t_append
from starflashattention_tpu_torch.ops import flash_decode as t_fd
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.serving import Engine
from starflashattention_tpu_torch.utils import bridge
from starflashattention_tpu_torch.utils.bridge import tensor_from_numpy, tensor_to_numpy

# the JAX package's ops/__init__ re-exports functions under the module names
j_append, j_fd = (importlib.import_module(f"starflashattention_tpu.ops.{name}")
                  for name in ("cache_append", "flash_decode"))

torch.set_num_threads(1)

ATOL = 1e-5
BF16_ULP = 2.0**-8


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- drafting


def _history(seq, s_hist=32):
    hist = np.zeros((1, s_hist), np.int32)
    hist[0, : len(seq)] = seq
    return hist


_DRAFT_CASES = {
    # key (5, 6) recurs: the draft is its continuation
    "repeat": (_history([1, 5, 6, 7, 8, 9, 2, 3, 5, 6]), [9], [6], 3, 2),
    # nothing recurs: the draft repeats pending
    "no_match": (_history([1, 2, 3, 4]), [3], [4], 2, 2),
    # the 3-gram (5, 6, 7) recurs once, the 2-gram (6, 7) later: the longer wins
    "backoff_longest": (_history([5, 6, 7, 9, 4, 2, 6, 7, 1, 3, 8, 5, 6, 7], 64), [13], [7], 2, 3),
    # only the 2-gram recurs: the key shortens to it
    "backoff_shorter": (_history([4, 6, 7, 1, 3, 8, 2, 6, 7], 64), [8], [7], 2, 3),
    # the match's continuation runs past the history: indices clamp to its last slot
    "clamp_edge": (_history([3, 1, 2, 9, 9, 9, 1, 2, 5, 5, 1, 2, 7, 7, 1, 2], 16), [15], [2], 4, 2),
}


@pytest.mark.parametrize("case", sorted(_DRAFT_CASES))
def test_propose_drafts_equal_jax(case):
    hist, length, pending, k, n = _DRAFT_CASES[case]
    ref = j_drafting.propose_drafts(jnp.asarray(hist), jnp.asarray(length, jnp.int32),
                                    jnp.asarray(pending, jnp.int32), num_draft=k, ngram=n)
    out = t_drafting.propose_drafts(_t(hist), torch.tensor(length, dtype=torch.int32),
                                    torch.tensor(pending, dtype=torch.int32), num_draft=k, ngram=n)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for m in range(1, n + 1):
        np.testing.assert_array_equal(
            t_drafting._match_pos(_t(hist), torch.tensor(length, dtype=torch.int32), m).numpy(),
            np.asarray(j_drafting._match_pos(jnp.asarray(hist), jnp.asarray(length, jnp.int32), m)))


def test_drafting_equals_jax_on_random_histories():
    """Small vocabularies (many matches), every length up to the edge."""
    rng = np.random.default_rng(7)
    hist = rng.integers(0, 4, (6, 24)).astype(np.int32)
    lengths = np.array([0, 3, 11, 22, 23, 17], np.int32)
    pending = rng.integers(0, 4, 6).astype(np.int32)
    for ngram in (1, 3, 4):
        ref = j_drafting.propose_drafts(jnp.asarray(hist), jnp.asarray(lengths), jnp.asarray(pending),
                                        num_draft=5, ngram=ngram)
        out = t_drafting.propose_drafts(_t(hist), _t(lengths), _t(pending), num_draft=5, ngram=ngram)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    pos = np.array([0, 5, 23, 40, -3, 22], np.int32)  # past the edge and below 0: clamped
    toks = rng.integers(10, 20, (6, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        t_drafting.write_token(_t(hist), _t(pos), _t(toks[:, 0])).numpy(),
        np.asarray(j_drafting.write_token(jnp.asarray(hist), jnp.asarray(pos), jnp.asarray(toks[:, 0]))))
    np.testing.assert_array_equal(
        t_drafting.write_block(_t(hist), _t(pos), _t(toks)).numpy(),
        np.asarray(j_drafting.write_block(jnp.asarray(hist), jnp.asarray(pos), jnp.asarray(toks))))
    before = hist.copy()
    t_drafting.write_block(_t(hist), _t(pos), _t(toks))
    np.testing.assert_array_equal(hist, before)  # functional, as in JAX


# ---------------------------------------------------------------- K1 verify, K9


def _verify_inputs(rng, t, b=4, hq=8, hkv=2, s=128, d=16, n_layers=2):
    q = rng.standard_normal((b, hq, t, d), dtype=np.float32)
    k = rng.standard_normal((n_layers, b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((n_layers, b, hkv, s, d), dtype=np.float32)
    # ragged; the last token of the last row attends the whole table
    lengths = np.array([1, 37, 100, s - t + 1][:b], np.int32)
    return q, k, v, lengths


def _kv_scales(hkv, mode):
    qmax = 127.0 if mode == "int8" else 448.0
    ks = (5.0 / qmax * (1.0 + 0.1 * np.arange(hkv))).astype(np.float32)
    vs = (5.0 / qmax * (1.0 - 0.05 * np.arange(hkv))).astype(np.float32)
    return ks, vs


def _kv(k, v, kv):
    """(k, v, {k_scales, v_scales}) as numpy, quantized by the JAX package."""
    if kv == "none":
        return k, v, {}
    ks, vs = _kv_scales(k.shape[2], kv)
    kq = np.asarray(j_quant.quantize_value(jnp.asarray(k), jnp.asarray(ks), kv, head_axis=2))
    vq = np.asarray(j_quant.quantize_value(jnp.asarray(v), jnp.asarray(vs), kv, head_axis=2))
    return kq, vq, {"k_scales": ks, "v_scales": vs}


@pytest.mark.parametrize("t", [2, 5])
@pytest.mark.parametrize("kv", ["none", "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_verify_matches_jax(rng, t, kv, dtype):
    q, k, v, lengths = _verify_inputs(rng, t)
    q = q.astype(jnp.dtype(dtype))
    if kv == "none":
        k, v = k.astype(jnp.dtype(dtype)), v.astype(jnp.dtype(dtype))
    k, v, scales = _kv(k, v, kv)
    ref = j_fd.flash_verify(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                            layer=1, **{n: jnp.asarray(s) for n, s in scales.items()})
    out = t_fd.flash_verify(tensor_from_numpy(q), tensor_from_numpy(k), tensor_from_numpy(v),
                            _t(lengths), layer=1, **{n: _t(s) for n, s in scales.items()})
    ref = np.asarray(ref).astype(np.float32)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    tol = ATOL if dtype == "float32" else 4 * BF16_ULP * np.abs(ref).max()
    np.testing.assert_allclose(tensor_to_numpy(out), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_verify_token_j_is_decode_at_lengths_plus_j(rng, kv):
    q, k, v, lengths = _verify_inputs(rng, 5)
    k, v, scales = _kv(k, v, kv)
    args = [tensor_from_numpy(x) for x in (q, k, v)]
    kw = dict(layer=1, **{n: _t(s) for n, s in scales.items()})
    out = t_fd.flash_verify_plain(*args, _t(lengths), **kw)
    for j in range(5):
        dec = t_fd.flash_decode_plain(args[0][:, :, j], *args[1:], _t(lengths + j), num_splits=1, **kw)
        assert torch.equal(out[:, :, j], dec)


def test_flash_verify_refuses_what_is_not_ported(rng):
    """Sinks need a window (as in JAX); the span needs a (B, Hq, T, D) q."""
    q, k, v, lengths = _verify_inputs(rng, 2)
    for kw in (dict(sinks=4), dict(window=0)):
        with pytest.raises(ValueError):
            t_fd.flash_verify(_t(q), _t(k), _t(v), _t(lengths), layer=0, **kw)
    with pytest.raises(ValueError, match=r"\(B, Hq, T, D\)"):
        t_fd.flash_verify(_t(q[:, :, 0]), _t(k), _t(v), _t(lengths), layer=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "float8_e4m3fn"])
def test_append_block_kv_matches_jax(rng, dtype):
    """Partial, zero and full rows; one block crosses a 32-row boundary and
    one ends at the last slot: the whole tables are equal byte for byte."""
    n_layers, b, hkv, s, d, t = 2, 4, 2, 64, 16, 5
    shape = (n_layers, b, hkv, s, d)
    k, v = (rng.standard_normal(shape, dtype=np.float32) * 4 for _ in range(2))
    kn, vn = (rng.standard_normal((b, hkv, t, d), dtype=np.float32) * 4 for _ in range(2))
    k, v, kn, vn = (x.astype(jnp.dtype(dtype)) for x in (k, v, kn, vn))
    pos = np.array([0, 30, 59, 12], np.int32)
    n_valid = np.array([t, 4, 3, 0], np.int32)
    jk, jv = j_append.append_block_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                                      1, jnp.asarray(pos), jnp.asarray(n_valid))
    tk, tv = tensor_from_numpy(k), tensor_from_numpy(v)
    out_k, out_v = t_append.append_block_kv(tk, tv, tensor_from_numpy(kn), tensor_from_numpy(vn), 1,
                                            _t(pos), _t(n_valid))
    assert out_k is tk and out_v is tv  # in place
    for got, ref in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(tensor_to_numpy(got, exact=True).view(np.uint8),
                                      np.asarray(ref).view(np.uint8))
    assert not np.array_equal(tensor_to_numpy(tk), tensor_to_numpy(tensor_from_numpy(k)))
    # n_valid None writes all T rows, as in JAX
    jk2, _ = j_append.append_block_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                                      0, jnp.asarray(pos))
    tk2 = tensor_from_numpy(k)
    t_append.append_block_kv(tk2, tensor_from_numpy(v), tensor_from_numpy(kn), tensor_from_numpy(vn), 0,
                             _t(pos))
    np.testing.assert_array_equal(tensor_to_numpy(tk2, exact=True).view(np.uint8),
                                  np.asarray(jk2).view(np.uint8))


# ---------------------------------------------------------------- spec rounds


def _cfgs(**kw):
    base = dict(dtype="float32", num_splits=1, **kw)
    return j_params.ModelConfig.tiny(**base), t_params.ModelConfig.tiny(**base)


@functools.lru_cache(maxsize=None)
def _models(seed, weights="none", num_layers=None, lm_head=False):
    """Quantized weights keep a dense lm_head unless ``lm_head``: the JAX
    verify step hands its (B, T, H) rows to the 2-D-only ``quant_matmul``
    for a quantized lm_head and raises (ROADMAP Queue 3)."""
    jc, _ = _cfgs(**({} if num_layers is None else {"num_layers": num_layers}))
    params = j_llama.init_params(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if weights != "none":
        params = j_llama.quantize_model_weights(params, weights, lm_head=lm_head)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


_PROMPTS = np.array([[7, 8, 9, 7, 8, 9], [3, 4, 3, 4, 3, 4], [5, 6, 5, 6, 1, 2]], np.int32)


def _prefilled(jc, tc, jp, tp):
    """Both packages' caches after a prefill of _PROMPTS, and the first tokens."""
    b = _PROMPTS.shape[0]
    plens = np.full((b,), _PROMPTS.shape[1], np.int32)
    jcache = j_cache.init_cache(jc.num_layers, b, jc.num_kv_heads, jc.max_seq_len, jc.head_dim,
                                dtype=jnp.float32, quant_mode=jc.quant_mode,
                                calibration_scale=jc.kv_calibration_scale)
    cos, sin = j_llama.rope_tables(jc)
    logits, jcache = j_llama.prefill(jp, jcache, jnp.asarray(_PROMPTS), jnp.asarray(plens), cos, sin, jc)
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    tcache = bridge.cache_from_numpy(*(np.asarray(getattr(jcache, n)) if getattr(jcache, n) is not None
                                       else None for n in bridge.CACHE_FIELDS))
    return jcache, tcache, tok, (cos, sin), t_llama.rope_tables(tc, device="cpu")


def _assert_cache_rows_equal(tcache, jcache, rows):
    """Lengths equal; every row's first ``lengths`` positions agree (fp32:
    1e-5; int8: byte for byte)."""
    lengths = np.asarray(jcache.lengths)
    np.testing.assert_array_equal(tcache.lengths.numpy(), lengths)
    for name in ("k", "v"):
        got, ref = tensor_to_numpy(getattr(tcache, name)), np.asarray(getattr(jcache, name))
        for r in rows:
            n = lengths[r]
            if ref.dtype == np.int8:
                np.testing.assert_array_equal(got[:, r, :, :n], ref[:, r, :, :n])
            else:
                np.testing.assert_allclose(got[:, r, :, :n], ref[:, r, :, :n], atol=ATOL, rtol=0)


_ROUNDS = [("none", "none"), ("int8", "none"), ("none", "int8")]  # (KV cache, weights)


@pytest.mark.parametrize("kv,weights", _ROUNDS, ids=["fp32", "int8_kv", "int8_weights"])
def test_spec_decode_multi_matches_jax(kv, weights):
    """Row 2 is inactive: its cache, length, history and pending token stay
    exactly as they were, and it emits nothing."""
    jc, tc = _cfgs(quant_mode=kv)
    jp, tp = _models(0, weights)
    jcache, tcache, tok, (cos, sin), (tcos, tsin) = _prefilled(jc, tc, jp, tp)
    b, plen = _PROMPTS.shape
    history = np.zeros((b, jc.max_seq_len), np.int32)
    history[:, :plen] = _PROMPTS
    active = np.array([True, True, False])
    k_before = tcache.k.clone()
    kw = dict(n_steps=6, num_draft=3, ngram=2)
    jt, jn, jpend, jcache, jhist = j_llama.spec_decode_multi(
        jp, jcache, jnp.asarray(history), jnp.asarray(tok), cos, sin, jnp.asarray(active), jc, **kw)
    tt, tn, tpend, same, thist = t_llama.spec_decode_multi(
        tp, tcache, _t(history), _t(tok), tcos, tsin, _t(active), tc, **kw)
    assert same is tcache and tt.shape == (b, 6, 4) and tn.shape == (b, 6)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy()[active], np.asarray(jt)[active])
    np.testing.assert_array_equal(tpend.numpy(), np.asarray(jpend))
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    _assert_cache_rows_equal(tcache, jcache, rows=(0, 1))
    assert (tn.numpy()[2] == 0).all() and int(tcache.lengths[2]) == plen
    assert int(tpend[2]) == tok[2]
    np.testing.assert_array_equal(thist.numpy()[2], history[2])
    assert torch.equal(tcache.k[:, 2], k_before[:, 2])
    assert tn.numpy()[:2].max() > 1  # the repetitive prompts accept drafts


def test_spec_decode_multi_draft_matches_jax():
    jc, tc = _cfgs()
    jdc, tdc = _cfgs(num_layers=1)
    jp, tp = _models(2)
    jdp, tdp = _models(9, num_layers=1)
    jcache, tcache, tok, (cos, sin), (tcos, tsin) = _prefilled(jc, tc, jp, tp)
    jdcache, tdcache, _, (dcos, dsin), (tdcos, tdsin) = _prefilled(jdc, tdc, jdp, tdp)
    active = np.array([True, False, True])
    kw = dict(n_steps=5, num_draft=3)
    jt, jn, jpend, jcache, jdcache = j_llama.spec_decode_multi_draft(
        jp, jcache, jdp, jdcache, jnp.asarray(tok), cos, sin, dcos, dsin, jnp.asarray(active),
        jc, jdc, **kw)
    tt, tn, tpend, _, _ = t_llama.spec_decode_multi_draft(
        tp, tcache, tdp, tdcache, _t(tok), tcos, tsin, tdcos, tdsin, _t(active), tc, tdc, **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy()[active], np.asarray(jt)[active])
    np.testing.assert_array_equal(tpend.numpy(), np.asarray(jpend))
    _assert_cache_rows_equal(tcache, jcache, rows=(0, 2))
    _assert_cache_rows_equal(tdcache, jdcache, rows=(0, 2))
    np.testing.assert_array_equal(tdcache.lengths.numpy(), tcache.lengths.numpy())  # lockstep


# ---------------------------------------------------------------- engines


_ENGINE_PROMPTS = [[7, 8, 9, 7, 8, 9], [3, 4, 3, 4, 3], [1, 2, 3, 4, 5, 6, 7], [5, 5, 5, 5]]
_STATS = ("decode_tokens", "spec_steps", "decode_rounds", "prefill_rounds", "finished")


def _interleaved_prompts():
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, 256, 2 + i)] for i in range(5)]


_ENGINES = {
    # (engine kwargs, draft model seed or None, prompts, new tokens, KV cache, weights)
    "lookup": (dict(num_slots=4, steps_per_round=4, spec_decode=3), None, _ENGINE_PROMPTS, 20,
               "none", "none"),
    "lookup_int8_kv": (dict(num_slots=4, steps_per_round=4, spec_decode=3), None, _ENGINE_PROMPTS, 16,
                       "int8", "none"),
    "lookup_int8_weights": (dict(num_slots=4, steps_per_round=3, spec_decode=3, spec_ngram=2), None,
                            _ENGINE_PROMPTS, 16, "none", "int8"),
    "draft": (dict(num_slots=3, steps_per_round=4, spec_decode=2), 9, _ENGINE_PROMPTS[:3], 16,
              "none", "none"),
    # more requests than slots: admission and retirement of the draft cache
    # follow the target's, and a reused slot's history is rewritten
    "draft_interleaved": (dict(num_slots=2, steps_per_round=2, spec_decode=2), 6, _interleaved_prompts(),
                          6, "none", "none"),
    "lookup_interleaved": (dict(num_slots=2, steps_per_round=2, spec_decode=2), None,
                           _interleaved_prompts(), 6, "none", "none"),
}


def _run(engine, prompts, n_new):
    out = engine.generate(prompts, max_new_tokens=n_new)
    return out, {k: getattr(engine.stats, k) for k in _STATS}


@pytest.mark.parametrize("kind", sorted(_ENGINES))
def test_spec_engine_streams_equal_jax_and_plain(kind):
    kw, draft_seed, prompts, n_new, kv, weights = _ENGINES[kind]
    jc, tc = _cfgs(quant_mode=kv)
    jp, tp = _models(2, weights)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if draft_seed is not None:
        jdc, tdc = _cfgs(num_layers=1)
        jdp, tdp = _models(draft_seed, num_layers=1)
        jkw["draft_model"], tkw["draft_model"] = (jdp, jdc), (tdp, tdc)
    ref, ref_stats = _run(JEngine(jp, jc, **jkw), prompts, n_new)
    eng = Engine(tp, tc, **tkw)
    out, stats = _run(eng, prompts, n_new)
    plain = Engine(tp, tc, num_slots=kw["num_slots"], steps_per_round=kw["steps_per_round"],
                   device="cpu").generate(prompts, max_new_tokens=n_new)
    assert out == ref == plain
    assert stats == ref_stats and stats["spec_steps"] > 0
    summary = eng.stats.summary()
    assert summary["spec_accept_per_step"] == round(stats["decode_tokens"] / stats["spec_steps"] - 1, 3)


def test_spec_engine_int8_lm_head_equals_the_plain_engines():
    """int8 projections and an int8 lm_head, which the JAX speculative path
    cannot run (see ``_models``): the port's speculative stream equals the
    JAX plain engine's and its own plain engine's."""
    jc, tc = _cfgs()
    jp, tp = _models(2, "int8", lm_head=True)
    kw = dict(num_slots=4, steps_per_round=3)
    ref = JEngine(jp, jc, **kw).generate(_ENGINE_PROMPTS, 16)
    plain = Engine(tp, tc, device="cpu", **kw).generate(_ENGINE_PROMPTS, 16)
    spec = Engine(tp, tc, device="cpu", spec_decode=3, **kw)
    assert spec.generate(_ENGINE_PROMPTS, 16) == ref == plain and spec.stats.spec_steps > 0


def test_spec_engine_bf16_equals_the_plain_engine():
    """bf16 on the port's CPU route: the verify step's tokens are the plain
    decode's (token j of the verify twin is that decode, bit for bit), so
    the speculative stream equals the plain one. Not held to JAX: in bf16
    the two packages' plain engines already part at near-ties (the JAX
    kernels round P to bf16, ROADMAP Queue 3)."""
    tc = t_params.ModelConfig.tiny(dtype="bfloat16", num_splits=1)
    tp = t_llama.quantize_model_weights(
        t_llama.init_params(tc, torch.Generator().manual_seed(3), device="cpu"), "int8", lm_head=True)
    plain = Engine(tp, tc, num_slots=4, steps_per_round=4, device="cpu").generate(_ENGINE_PROMPTS, 16)
    spec = Engine(tp, tc, num_slots=4, steps_per_round=4, spec_decode=3, device="cpu")
    assert spec.generate(_ENGINE_PROMPTS, 16) == plain and spec.stats.spec_steps > 0


def test_spec_engine_validation_matches_jax():
    """Each refusal of the JAX engine, with the same exception type."""
    jc, tc = _cfgs()
    jp, tp = _models(2)
    jdc, tdc = _cfgs(num_layers=1)
    jdp, tdp = _models(9, num_layers=1)
    bad = dict(vocab_size=jc.vocab_size * 2)
    jbad, tbad = _cfgs(**bad)
    cases = [
        (dict(draft_model="self"), ValueError, "requires spec_decode"),
        (dict(spec_decode=2, draft_model="bad"), ValueError, "vocab"),
        (dict(spec_decode=2, draft_model="short"), ValueError, "max_seq_len"),
        (dict(spec_decode=2, enable_sampling=True), ValueError, "greedy-only"),
        (dict(spec_decode=2, return_logprobs=True), ValueError, "greedy-only"),
        (dict(spec_decode=2, split=4), ValueError, "num_splits"),
        (dict(spec_decode=2, topk_logprobs=2), ValueError, "topk_logprobs"),
    ]
    for kw, exc, match in cases:
        for eng_cls, cfg, params, dm, extra in (
                (JEngine, jc, jp, {"self": (jdp, jdc), "bad": (None, jbad),
                                   "short": (jdp, dataclasses.replace(jdc, max_seq_len=jc.max_seq_len // 2))},
                 {}),
                (Engine, tc, tp, {"self": (tdp, tdc), "bad": (None, tbad),
                                  "short": (tdp, dataclasses.replace(tdc, max_seq_len=tc.max_seq_len // 2))},
                 dict(device="cpu"))):
            kw2 = dict(kw, **extra)
            if "draft_model" in kw2:
                kw2["draft_model"] = dm[kw2["draft_model"]]
            if kw2.pop("split", None):
                cfg = dataclasses.replace(cfg, num_splits=4)
            with pytest.raises(exc, match=match):
                eng_cls(params, cfg, num_slots=2, **kw2)
    # sharded speculative decoding is ported (tests/test_torch_tp.py); a mesh
    # whose data axis does not divide the slots is refused, as JAX refuses it
    from starflashattention_tpu_torch.parallel.mesh import Axis, Mesh

    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    tmesh = Mesh({"data": Axis("data", 2, 0, (0, 4), None, "gloo"),
                  "model": Axis("model", 4, 0, (0, 1, 2, 3), None, "gloo")}, torch.device("cpu"))
    for eng_cls, cfg, params, mesh, extra in ((JEngine, jc, jp, jmesh, {}), (Engine, tc, tp, tmesh,
                                                                              dict(device="cpu"))):
        with pytest.raises(ValueError, match="divisible by data axis"):
            eng_cls(params, cfg, num_slots=3, spec_decode=2, mesh=mesh, **extra)
    for eng_cls, cfg, params, extra in ((JEngine, jc, jp, {}), (Engine, tc, tp, dict(device="cpu"))):
        with pytest.raises(NotImplementedError, match="the verify program has no adapter operands"):
            eng_cls(params, cfg, num_slots=2, spec_decode=2, lora_adapters=[{}], **extra)
