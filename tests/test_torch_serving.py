"""The port's serving layer (``Engine``, ``Scheduler``, sampling and the
masked serving prefill / multi-step decode) against the JAX package's, on
the CPU at ``ModelConfig.tiny`` in float32.

Both sides hold the same bytes: the JAX model is built and quantized (int8
projections and int8 lm_head) by the JAX package and reaches the port
through the numpy bridge. The JAX side runs its Pallas kernels in interpret
mode; the port runs the plain twins of its kernels.

Held exactly: greedy token streams, ``EngineStats`` counters, cache
lengths and untouched cache rows. Held within 1e-5: chosen-token and top-k
logprobs (float32 log-softmax of logits that agree to ~1e-6; same
summation order up to the last bits). Sampled draws cannot match (the
port's noise is its own counter-based hash): sampled tokens are held to
JAX's threshold set instead.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_cache
from starflashattention_tpu.core import sampling as j_sampling
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu.serving import Engine as JEngine
from starflashattention_tpu.serving import Request as JRequest
from starflashattention_tpu.serving import Scheduler as JScheduler
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.core import sampling as t_sampling
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import lora as t_lora
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.serving import Engine, PagedEngine, Request, SamplingParams, Scheduler
from starflashattention_tpu_torch.utils import bridge

torch.set_num_threads(1)

LOGPROB_ATOL = 1e-5
LOGIT_ATOL = 1e-4  # as tests/test_torch_llama.py
STATS = ("finished", "decode_rounds", "prefill_rounds", "preemptions", "prefix_hits",
         "decode_tokens")


def _cfgs():
    return (j_params.ModelConfig.tiny(dtype="float32", pages_per_compute_block=2),
            t_params.ModelConfig.tiny(dtype="float32", pages_per_compute_block=2))


@functools.lru_cache(maxsize=None)
def _models(seed=0):
    jc, _ = _cfgs()
    params = j_llama.quantize_model_weights(
        j_llama.init_params(jc, jax.random.PRNGKey(seed)), "int8", lm_head=True)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


def _prompts(lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in lengths]


def _stats(stats):
    return {k: getattr(stats, k) for k in STATS}


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """One JAX engine run per scenario, shared by the tests below."""
    jc, _ = _cfgs()
    jp, _ = _models()
    kw, prompts, n_new = _SCENARIOS[kind]
    eng = JEngine(jp, jc, **kw)
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, _stats(eng.stats)


def _port_run(kind, **extra):
    _, tc = _cfgs()
    _, tp = _models()
    kw, prompts, n_new = _SCENARIOS[kind]
    eng = Engine(tp, tc, device="cpu", **kw, **extra)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


_SCENARIOS = {
    # more requests than slots, logprobs and top-2 alternatives on
    "interleaved": (dict(num_slots=2, steps_per_round=3, return_logprobs=True, topk_logprobs=2),
                    _prompts((3, 7, 5, 12, 2)), 6),
    # chunked prefill: prompts below, across and several chunks wide
    "chunked": (dict(num_slots=2, steps_per_round=2, prefill_chunk=8), _prompts((3, 9, 17, 5), 2), 5),
}


@pytest.mark.parametrize("kind", sorted(_SCENARIOS))
def test_engine_streams_and_stats_match_jax(kind):
    ref, ref_stats = _jax_run(kind)
    eng, reqs = _port_run(kind)
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert _stats(eng.stats) == ref_stats
    assert eng.stats.finished == len(reqs) and len(eng.stats.ttfts_s) == len(reqs)


@functools.lru_cache(maxsize=None)
def _quantized_models():
    """int4 weights (grouped scales, int4 lm_head) for the int8-KV engines."""
    jc, _ = _cfgs()
    params = j_llama.quantize_model_weights(
        j_llama.init_params(jc, jax.random.PRNGKey(0)), "int4", lm_head=True)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


def test_engine_int8_kv_int4_weights_matches_jax():
    """A quantized deployment through the contiguous engine: int8 KV cache,
    int4 weights, more requests than slots; streams and counters equal."""
    kw, prompts, n_new = _SCENARIOS["interleaved"]
    jc, tc = (dataclasses.replace(c, quant_mode="int8") for c in _cfgs())
    jp, tp = _quantized_models()
    runs = []
    for eng_cls, req_cls, params, cfg, extra in ((JEngine, JRequest, jp, jc, {}),
                                                 (Engine, Request, tp, tc, dict(device="cpu"))):
        eng = eng_cls(params, cfg, **kw, **extra)
        reqs = [req_cls(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append(([r.output for r in reqs], _stats(eng.stats), [r.logprobs for r in reqs]))
    (out, stats, lps), (ref, ref_stats, ref_lps) = runs[1], runs[0]
    assert out == ref and stats == ref_stats
    for a, b in zip(lps, ref_lps):
        np.testing.assert_allclose(a, b, atol=LOGPROB_ATOL, rtol=0)


def test_engine_logprobs_match_jax():
    ref, _ = _jax_run("interleaved")
    _, reqs = _port_run("interleaved")
    for r, j in zip(reqs, ref):
        assert len(r.logprobs) == len(r.output)
        np.testing.assert_allclose(r.logprobs, j.logprobs, atol=LOGPROB_ATOL, rtol=0)
        assert [ids for ids, _ in r.topk] == [ids for ids, _ in j.topk]
        np.testing.assert_allclose([v for _, v in r.topk], [v for _, v in j.topk],
                                   atol=LOGPROB_ATOL, rtol=0)


@pytest.mark.parametrize("engine_cls", [Engine, PagedEngine], ids=["contiguous", "paged"])
def test_engine_eos_and_stop_sequences_follow_the_jax_stream(engine_cls):
    """EOS keeps the EOS token and ends the request; a 2-token stop sequence
    spanning a round boundary ends it and is cut — both on the JAX stream."""
    ref, _ = _jax_run("interleaved")
    _, tc = _cfgs()
    _, tp = _models()
    kw = dict(page_size=16) if engine_cls is PagedEngine else {}
    full = ref[1].output
    eos = full[2]
    out = engine_cls(tp, tc, num_slots=1, steps_per_round=4, device="cpu", **kw).generate(
        [ref[1].prompt], max_new_tokens=6, eos_token=eos)[0]
    assert out == full[: full.index(eos) + 1]
    stop = full[3:5]
    eng = engine_cls(tp, tc, num_slots=1, steps_per_round=4, device="cpu", return_logprobs=True, **kw)
    req = Request(uid=0, prompt=ref[1].prompt, max_new_tokens=6, stop=[stop])
    eng.submit(req)
    eng.run()
    cut = next(i for i in range(len(full) - 1) if full[i : i + 2] == stop)
    assert req.output == full[:cut]
    assert len(req.logprobs) == len(req.output)


def test_chunked_prefill_equals_whole_prompt_on_the_port():
    _, reqs = _port_run("chunked")
    _, tc = _cfgs()
    _, tp = _models()
    kw, prompts, n_new = _SCENARIOS["chunked"]
    whole = Engine(tp, tc, num_slots=2, steps_per_round=2, device="cpu").generate(prompts, n_new)
    assert [r.output for r in reqs] == whole


def test_scheduler_matches_jax():
    """Admission, preemption order, budgets and stop truncation step for step."""
    logs = []
    for sched_cls, req_cls in ((JScheduler, JRequest), (Scheduler, Request)):
        s = sched_cls(2, 64, capacity_slack=2)
        log = []
        for i in range(4):
            s.submit(req_cls(uid=i, prompt=[1, 2, i], max_new_tokens=4, stop=[[7, 8]]))
        log.append([i for i, _ in s.admit()])
        log.append(s.record_tokens(0, [5, 6]))
        log.append(s.preempt(1).uid)
        log.append([(i, r.uid) for i, r in s.admit()])
        log.append(s.record_tokens(0, [7, 8, 9]))
        log.append((s.slots[0].request, list(s.queue[0].output) if s.queue else None))
        log.append(s.active_mask())
        log.append(s.has_work)
        with pytest.raises(ValueError):
            s.submit(req_cls(uid=9, prompt=[0] * 60, max_new_tokens=3))
        logs.append(log)
    assert logs[0] == logs[1]


def test_prefill_serving_masks_match_jax():
    """Masked admission prefill: active rows' logits and cache rows match
    JAX; an inactive row's cache stays byte for byte as it was (even near
    the end of the cache, where its window would overrun) and its length is
    kept; reset rows start at 0."""
    jc, tc = _cfgs()
    jp, tp = _models()
    rng = np.random.default_rng(3)
    s = jc.max_seq_len
    shape = (jc.num_layers, 3, jc.num_kv_heads, s, jc.head_dim)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    lengths = np.array([5, s - 4, 9], np.int32)  # row 1 busy near the end
    toks = rng.integers(0, 256, (3, 16)).astype(np.int32)
    new_lengths = np.array([16, 16, 6], np.int32)
    active = np.array([True, False, True])
    reset = np.array([True, False, False])
    cos, sin = j_llama.rope_tables(jc)
    jcache = j_cache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths))
    ref, jcache = j_llama.prefill_serving(jp, jcache, jnp.asarray(toks), jnp.asarray(new_lengths),
                                          jnp.asarray(active), jnp.asarray(reset), cos, sin, jc)
    tcache = bridge.cache_from_numpy(k, v, lengths)
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    out, same = t_llama.prefill_serving(tp, tcache, torch.from_numpy(toks),
                                        torch.from_numpy(new_lengths), torch.from_numpy(active),
                                        torch.from_numpy(reset), tcos, tsin, tc)
    assert same is tcache
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
    np.testing.assert_array_equal(tcache.lengths.numpy(), [16, s - 4, 15])
    np.testing.assert_allclose(out.numpy()[active], np.asarray(ref)[active], atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tcache.k.numpy()[:, 1], k[:, 1])  # busy row untouched
    np.testing.assert_array_equal(tcache.v.numpy()[:, 1], v[:, 1])
    for row in (0, 2):
        np.testing.assert_allclose(tcache.k.numpy()[:, row], np.asarray(jcache.k)[:, row], atol=1e-5,
                                   rtol=0)
    # an ACTIVE window that overruns the cache still raises
    tcache.lengths[:] = torch.tensor([s - 4, 0, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="overruns the cache"):
        t_llama.prefill_serving(tp, tcache, torch.from_numpy(toks), torch.from_numpy(new_lengths),
                                torch.tensor([True, False, False]), torch.tensor([False] * 3),
                                tcos, tsin, tc)


def test_decode_multi_matches_jax():
    """n decode steps with one slot inactive: tokens, pending token, lengths
    and logprobs."""
    jc, tc = _cfgs()
    jp, tp = _models()
    rng = np.random.default_rng(4)
    shape = (jc.num_layers, 3, jc.num_kv_heads, jc.max_seq_len, jc.head_dim)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    lengths = np.array([7, 30, 0], np.int32)
    tok = np.array([3, 9, 4], np.int32)
    active = np.array([True, True, False])
    cos, sin = j_llama.rope_tables(jc)
    jcache = j_cache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths))
    jt, jpend, jcache, jlp, jtv, jti = j_llama.decode_multi(
        jp, jcache, jnp.asarray(tok), cos, sin, jnp.asarray(active), jc, 4, with_logprobs=True,
        topk_logprobs=3)
    tcache = bridge.cache_from_numpy(k, v, lengths)
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    tt, tpend, tcache, tlp, ttv, tti = t_llama.decode_multi(
        tp, tcache, torch.from_numpy(tok), tcos, tsin, torch.from_numpy(active), tc, 4,
        with_logprobs=True, topk_logprobs=3)
    live = active
    np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
    np.testing.assert_array_equal(tpend.numpy()[live], np.asarray(jpend)[live])
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
    np.testing.assert_array_equal(tcache.lengths.numpy(), [11, 34, 0])
    np.testing.assert_allclose(tlp.numpy()[live], np.asarray(jlp)[live], atol=LOGPROB_ATOL, rtol=0)
    np.testing.assert_array_equal(tti.numpy()[live], np.asarray(jti)[live])
    np.testing.assert_allclose(ttv.numpy()[live], np.asarray(jtv)[live], atol=LOGPROB_ATOL, rtol=0)
    assert tt.dtype == torch.int32 and tt.shape == (3, 4) and tlp.shape == (3, 4)


def _jax_keep(logits, state):
    """JAX's threshold set: core/sampling.py:100-125, evaluated with jnp."""
    v = logits.shape[-1]
    temperature = jnp.asarray(state["temperature"])
    top_k = jnp.asarray(state["top_k"])
    top_p = jnp.asarray(state["top_p"])
    min_p = jnp.asarray(state["min_p"])
    safe_t = jnp.where(temperature > 0.0, temperature, 1.0)
    scaled = jnp.asarray(logits) / safe_t[:, None]
    sorted_desc = -jnp.sort(-scaled, axis=-1)
    k = jnp.where(top_k > 0, jnp.clip(top_k, 1, v), v)
    thresh_k = jnp.take_along_axis(sorted_desc, (k - 1)[:, None], axis=-1)
    probs = jax.nn.softmax(sorted_desc, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    num_keep = jnp.maximum(jnp.sum((cum - probs) < top_p[:, None], axis=-1), 1)
    thresh_p = jnp.take_along_axis(sorted_desc, (num_keep - 1)[:, None], axis=-1)
    thresh_m = jnp.where(min_p > 0.0, sorted_desc[:, 0] + jnp.log(jnp.maximum(min_p, 1e-37)),
                         -jnp.inf)[:, None]
    thresh = jnp.maximum(jnp.maximum(thresh_k, thresh_p), thresh_m)
    return np.asarray(scaled >= thresh)


_SAMPLING_ROWS = [SamplingParams(),  # greedy
                  SamplingParams(temperature=0.8, top_k=5, seed=1),
                  SamplingParams(temperature=1.3, top_p=0.6, seed=2),
                  SamplingParams(temperature=0.7, min_p=0.2, seed=3),
                  SamplingParams(temperature=1.0, top_k=40, top_p=0.9, min_p=0.05, seed=4),
                  SamplingParams(temperature=0.5, top_p=0.0, seed=5)]


def test_sampling_threshold_set_matches_jax():
    """The port's kept set equals JAX's on the same logits and params; every
    port draw lies in it, and so does every JAX draw; greedy rows are the
    first maximum."""
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((len(_SAMPLING_ROWS), 256)) * 3).astype(np.float32)
    logits[0, [7, 200]] = logits[0].max() + 1.0  # a tie: argmax takes the first
    jstate = j_sampling.state_arrays(_SAMPLING_ROWS)
    tstate = {k: torch.from_numpy(v) for k, v in t_sampling.state_arrays(_SAMPLING_ROWS).items()}
    want = _jax_keep(logits, jstate)
    _, keep = t_sampling.keep_mask(torch.from_numpy(logits), tstate)
    np.testing.assert_array_equal(keep.numpy(), want)
    for pos in range(32):
        position = torch.full((len(_SAMPLING_ROWS),), pos, dtype=torch.int32)
        got = t_sampling.sample_tokens(torch.from_numpy(logits), tstate, position).numpy()
        ref = np.asarray(j_sampling.sample_tokens(jnp.asarray(logits), jstate, jnp.asarray(position)))
        assert got[0] == ref[0] == 7
        assert all(want[r, got[r]] and want[r, ref[r]] for r in range(len(_SAMPLING_ROWS)))


def test_sampling_is_a_pure_function_of_seed_position_and_logits():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 256)).astype(np.float32))
    rows = [SamplingParams(temperature=1.0, seed=s) for s in (11, 11, 12)]
    state = t_sampling.state_tensors(rows, "cpu")
    pos = torch.tensor([40, 40, 40], dtype=torch.int32)
    a = t_sampling.sample_tokens(logits[[0, 0, 0]], state, pos)
    b = t_sampling.sample_tokens(logits[[0, 0, 0]], state, pos)
    assert torch.equal(a, b) and a[0] == a[1]
    draws = {int(t_sampling.sample_tokens(logits[:1], t_sampling.state_tensors(rows[:1], "cpu"),
                                          torch.tensor([p]))[0]) for p in range(64)}
    assert len(draws) > 8  # the position really keys the noise
    g = t_sampling.gumbel_noise(torch.tensor([0]), torch.tensor([0]), 100_000)
    assert torch.isfinite(g).all() and abs(g.mean().item() - 0.5772) < 0.02  # Euler's constant


def test_sampled_engine_keeps_tokens_in_jax_threshold_set():
    """A sampled Engine run: each drawn token lies in JAX's top-k set of the
    logits the port's own prefill gives at that point (checked on the first
    token) and the run replays exactly."""
    _, tc = _cfgs()
    _, tp = _models()
    prompts = _prompts((6, 11, 4), 7)
    samp = [SamplingParams(temperature=0.9, top_k=3, seed=10 + i) for i in range(3)]

    def run():
        return Engine(tp, tc, num_slots=2, steps_per_round=3, enable_sampling=True,
                      device="cpu").generate(prompts, 5, sampling=samp)

    out = run()
    assert out == run()
    for p, o in zip(prompts, out):
        cache = t_cache.init_cache(tc.num_layers, 1, tc.num_kv_heads, tc.max_seq_len, tc.head_dim,
                                   dtype=torch.float32, device="cpu")
        cos, sin = t_llama.rope_tables(tc, device="cpu")
        logits, _ = t_llama.prefill(tp, cache, torch.tensor([p]), torch.tensor([len(p)]), cos, sin, tc)
        top3 = set(torch.topk(logits[0], 3).indices.tolist())
        assert o[0] in top3


def _data3_mesh():
    """A (data 3, model 1) mesh as its rank 0 sees it, without a process
    group: enough for what raises before any collective."""
    from starflashattention_tpu_torch.parallel.mesh import Axis, Mesh

    return Mesh({"data": Axis("data", 3, 0, (0, 1, 2), None, "gloo"),
                 "model": Axis("model", 1, 0, (0,), None, "gloo")}, torch.device("cpu"))


def test_engine_refuses_what_is_not_ported():
    """What the port still refuses (failure recovery), and what it now
    serves: ``mesh``, where it refuses what JAX refuses, 8 slots over a
    data axis of 3, with and without ``spec_decode`` (JAX
    engine.py:286-290); and ``lora_adapters``, where an engine holding a
    freshly initialized adapter (``b = 0``) serves a request on it exactly
    as the base model."""
    _, tc = _cfgs()
    _, tp = _models()
    for kw in (dict(mesh=_data3_mesh()), dict(mesh=_data3_mesh(), spec_decode=2)):
        if "spec_decode" in kw:
            tc = dataclasses.replace(tc, num_splits=1)
        with pytest.raises(ValueError, match="divisible by data axis"):
            Engine(tp, tc, device="cpu", **kw)
    adapter = t_lora.init_lora(tc, torch.Generator().manual_seed(0), rank=4, device="cpu")
    prompts = _prompts((5, 9))
    served = Engine(tp, tc, num_slots=2, lora_adapters=[adapter], device="cpu").generate(
        prompts, 4, adapters=[0, None])
    assert served == Engine(tp, tc, num_slots=2, device="cpu").generate(prompts, 4)
    eng = Engine(tp, tc, device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        eng.recover_device_state()
    with pytest.raises(ValueError, match="enable_sampling"):
        eng.submit(Request(uid=0, prompt=[1], max_new_tokens=2,
                           sampling=SamplingParams(temperature=1.0)))
