"""The Mistral, Gemma and Gemma-2 families through the port's serving paths
against the JAX package's, on the CPU at tiny widths in float32.

Tiny Mistral (window 32, with and without 4 attention sinks), Gemma
(GeGLU, the embedding scale, a tied head, K2's 4 splits) and Gemma-2
(softcaps 50 / 30, a window on every second layer, post-norms,
``query_scale``; the overrides of tests/test_model_families.py) run greedy
through ``generate``, ``Engine``, ``PagedEngine`` and the prompt-lookup
speculative ``Engine``. The JAX side runs its Pallas kernels in interpret
mode; the port runs the plain twins of its kernels. Norm weights are
perturbed from 1 so that the post-norms and QK-norms carry weight.

Held exactly: greedy token streams, and ``PagedEngine``'s host page table,
its reclaimed-page counts and its pinned sink pages after every decode
round. Held within 1e-4: the prefill logits (as in
tests/test_torch_llama.py). Each family also trains: LoRA gradients
through the flash path within 5e-4 of each peak of JAX's
(tests/test_torch_train_variants.py holds the rest of training).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_contig
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.models import lora as j_lora
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu.serving import Engine as JEngine
from starflashattention_tpu.serving import PagedEngine as JPagedEngine
from starflashattention_tpu.serving import Request as JRequest
from starflashattention_tpu_torch.cache import contiguous as t_contig
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import lora as t_lora
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.serving import Engine, PagedEngine, Request
from starflashattention_tpu_torch.utils import bridge

torch.set_num_threads(1)

PAGE = 16
LOGIT_ATOL = 1e-4

_GEMMA = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=4, num_q_heads=2,
              num_kv_heads=1, head_dim=16, max_seq_len=64, dtype="float32", block_k=16)
FAMILIES = {
    "mistral": ("tiny", dict(sliding_window=32, num_splits=1, pages_per_compute_block=2)),
    "mistral+sinks": ("tiny", dict(sliding_window=32, attention_sinks=4, num_splits=1,
                                   pages_per_compute_block=2)),
    "gemma": ("gemma_7b", dict(_GEMMA, num_splits=4)),
    "gemma2": ("gemma2_9b", dict(_GEMMA, sliding_window=8, pages_per_compute_block=2)),
}
# prompts long enough that the bands are live and, on the tiny Mistral
# (128 rows, pages of 16, walk blocks of 2 pages), whole walk blocks fall
# below the band: pages are reclaimed, and with sinks pinned first
PROMPT_LENGTHS = {"tiny": (90, 40, 9), "gemma_7b": (20, 33, 7), "gemma2_9b": (20, 33, 7)}
NEW_TOKENS = 12


def _cfgs(family):
    preset, kw = FAMILIES[family]
    kw = dict(kw, dtype="float32")
    return getattr(j_params.ModelConfig, preset)(**kw), getattr(t_params.ModelConfig, preset)(**kw)


def _perturb_norms(params, seed):
    """Norm weights 1 + 0.1 N(0, 1), so that every norm's weight shows."""
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name, w in layers.items():
        if name.endswith("norm"):
            layers[name] = (np.asarray(w) + 0.1 * rng.standard_normal(w.shape)).astype(np.float32)
    out = dict(params, layers=layers)
    out["final_norm"] = (np.asarray(params["final_norm"])
                         + 0.1 * rng.standard_normal(params["final_norm"].shape)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _models(family):
    jc, _ = _cfgs(family)
    params = _perturb_norms(jax.tree.map(np.asarray, j_llama.init_params(jc, jax.random.PRNGKey(0))),
                            seed=1)
    return jax.tree.map(jnp.asarray, params), bridge.params_from_numpy(params)


def _prompts(family):
    preset = FAMILIES[family][0]
    vocab = _cfgs(family)[0].vocab_size
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in PROMPT_LENGTHS[preset]]


# ----------------------------------------------------------------- generate


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_matches_jax(family):
    jc, tc = _cfgs(family)
    jp, tp = _models(family)
    prompts = _prompts(family)
    width = max(map(len, prompts))
    padded = np.array([p + [0] * (width - len(p)) for p in prompts], np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    want = np.asarray(j_llama.generate(jp, jc, jnp.asarray(padded), jnp.asarray(lens),
                                       max_new_tokens=NEW_TOKENS))
    got = t_llama.generate(tp, tc, padded, lens, NEW_TOKENS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_logits_match_jax(family):
    jc, tc = _cfgs(family)
    jp, tp = _models(family)
    prompts = _prompts(family)
    width = max(map(len, prompts))
    padded = np.array([p + [0] * (width - len(p)) for p in prompts], np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    hkv, d = jc.kv_cache_dims()
    jcache = j_contig.init_cache(jc.num_layers, len(prompts), hkv, jc.max_seq_len, d,
                                 dtype=jnp.float32)
    jcos, jsin = j_llama.rope_tables(jc)
    want, _ = j_llama.prefill(jp, jcache, jnp.asarray(padded), jnp.asarray(lens), jcos, jsin, jc)
    tcache = t_contig.init_cache(tc.num_layers, len(prompts), hkv, tc.max_seq_len, d,
                                 dtype=torch.float32, device="cpu")
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    got, _ = t_llama.prefill(tp, tcache, torch.from_numpy(padded), torch.from_numpy(lens), tcos,
                             tsin, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


# ----------------------------------------------------------------- engines


def _serve(engine_cls, request_cls, params, cfg, prompts, **kw):
    eng = engine_cls(params, cfg, num_slots=2, steps_per_round=2, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_engine(family):
    jc, _ = _cfgs(family)
    jp, _ = _models(family)
    return _serve(JEngine, JRequest, jp, jc, _prompts(family))[1]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_matches_jax(family):
    _, tc = _cfgs(family)
    _, tp = _models(family)
    _, got = _serve(Engine, Request, tp, tc, _prompts(family), device="cpu")
    assert got == _jax_engine(family)


def _record_rounds(eng):
    """The host page table, reclaimed-page counts and pinned sink pages after
    every decode round."""
    rounds = []
    decode_round = eng._decode_round

    def recorded():
        decode_round()
        rounds.append((eng._host_table.copy(), eng._reclaimed.copy(),
                       [list(p) for p in eng._sink_pages]))

    eng._decode_round = recorded
    return rounds


def _paged_run(engine_cls, request_cls, params, cfg, prompts, **kw):
    eng = engine_cls(params, cfg, num_slots=2, steps_per_round=2, page_size=PAGE, native=False,
                     debug_validate=True, **kw)
    rounds = _record_rounds(eng)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, [r.output for r in reqs], rounds


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_paged_engine_matches_jax(family):
    """Streams, and after every decode round the page table with its null
    (reclaimed) entries and pinned sink pages, equal JAX's."""
    jc, tc = _cfgs(family)
    jp, tp = _models(family)
    prompts = _prompts(family)
    _, want, want_rounds = _paged_run(JPagedEngine, JRequest, jp, jc, prompts)
    eng, got, rounds = _paged_run(PagedEngine, Request, tp, tc, prompts, device="cpu")
    assert got == want
    assert got == _jax_engine(family)
    assert len(rounds) == len(want_rounds)
    for (table, reclaimed, sinks), (j_table, j_reclaimed, j_sinks) in zip(rounds, want_rounds):
        np.testing.assert_array_equal(table, j_table)
        np.testing.assert_array_equal(reclaimed, j_reclaimed)
        assert sinks == j_sinks
    if family.startswith("mistral"):
        assert max(r.max() for _, r, _ in rounds) > 0  # whole walk blocks were reclaimed
    if family == "mistral+sinks":
        assert any(any(p) for _, _, s in rounds for p in s)  # sink pages pinned
    if family == "gemma2":  # alternating full layers keep every page
        assert not any(r.any() for _, r, _ in rounds)
    assert eng.pool.free_pages == eng.num_pages - 1  # everything, sink pages too, came back


# ----------------------------------------------------------------- speculative


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spec_engine_matches_jax(family):
    """Prompt-lookup drafts (3 a round) verified with every variant on; the
    verify step takes one split, so Gemma's 4-split config serves here with
    one."""
    jc, tc = (dataclasses.replace(c, num_splits=1) for c in _cfgs(family))
    jp, tp = _models(family)
    prompts = [p * 2 for p in _prompts(family)]  # repeats, so lookups find drafts
    prompts = [p[: jc.max_seq_len - NEW_TOKENS - 8] for p in prompts]
    _, want = _serve(JEngine, JRequest, jp, jc, prompts, spec_decode=3)
    eng, got = _serve(Engine, Request, tp, tc, prompts, spec_decode=3, device="cpu")
    assert got == want
    _, plain = _serve(Engine, Request, tp, tc, prompts, device="cpu")
    assert got == plain
    assert eng.stats.spec_steps > 0


# ----------------------------------------------------------------- dense knobs

_HALF = 8  # tiny head_dim 16 / 2: one longrope factor per frequency
DENSE_KNOBS = {
    "attention_bias": dict(attention_bias=True),
    "qk_norm": dict(qk_norm=True),
    "llama3_scaling": dict(rope_scaling=("llama3", 8.0, 1.0, 4.0, 32)),
    "longrope_scaling": dict(rope_scaling=("longrope", 32, 128,
                                           tuple(1.0 + 0.1 * i for i in range(_HALF)),
                                           tuple(2.0 + 0.25 * i for i in range(_HALF)))),
    "tie_embeddings": dict(tie_embeddings=True),
    "query_scale": dict(query_scale=12.0),
    "interleaved_rope": dict(rope_style="interleaved"),
}


@pytest.mark.parametrize("knob", sorted(DENSE_KNOBS))
def test_dense_knob_streams_match_jax(knob):
    """The dense-model options the port ran untested: 8-token greedy streams
    at tiny fp32 with perturbed norm weights equal JAX's."""
    kw = dict(DENSE_KNOBS[knob], dtype="float32")
    jc, tc = j_params.ModelConfig.tiny(**kw), t_params.ModelConfig.tiny(**kw)
    params = _perturb_norms(jax.tree.map(np.asarray, j_llama.init_params(jc, jax.random.PRNGKey(3))),
                            seed=4)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jc.vocab_size, (2, 24)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    want = j_llama.generate(jax.tree.map(jnp.asarray, params), jc, jnp.asarray(prompts),
                            jnp.asarray(lens), max_new_tokens=8)
    got = t_llama.generate(bridge.params_from_numpy(params), tc, prompts, lens, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- refusals


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_training_refuses_the_variants(family):
    """Each family trains: LoRA (rank 4 on the four targets, the JAX
    package's adapters with b moved off zero) on a (2, 41) batch, past
    Mistral's window of 32, through the flash path: the loss within 1e-5 of
    JAX's and every adapter gradient within 5e-4 of its peak
    (tests/test_torch_train.py's tolerances)."""
    jc, tc = _cfgs(family)
    jp, tp = _models(family)
    ad = j_lora.init_lora(jc, jax.random.PRNGKey(1), rank=4)
    ad["layers"] = jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(jax.random.PRNGKey(2), x.shape), ad["layers"])
    batch = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 41)).astype(np.int32)
    jcos, jsin = j_llama.rope_tables(jc)
    fn = jax.jit(jax.value_and_grad(j_lora.loss_fn, argnums=1), static_argnames=("cfg",))
    want_loss, want = fn(jp, ad, jnp.asarray(batch), jc, jcos, jsin)
    cos, sin = t_llama.rope_tables(tc, device="cpu")
    loss, grads = t_lora.loss_and_grads(tp, bridge.params_from_numpy(jax.tree.map(np.asarray, ad)),
                                        torch.from_numpy(batch), tc, cos, sin)
    assert abs(float(loss) - float(want_loss)) < 1e-5
    got = jax.tree.leaves(bridge.params_to_numpy(grads))
    for g, w in zip(got, jax.tree.leaves(jax.tree.map(np.asarray, want)), strict=True):
        assert np.abs(g - w).max() <= 5e-4 * np.abs(w).max()


def test_sinks_with_a_per_layer_window_raise():
    cfg = t_params.ModelConfig.tiny(sliding_window=8, sliding_window_pattern=2, attention_sinks=2)
    with pytest.raises(ValueError, match="STATIC window"):
        t_llama._layer_window(cfg, 0)
