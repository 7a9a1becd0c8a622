"""The port's multi-LoRA serving against the JAX package's, on the CPU at
``ModelConfig.tiny`` in float32: N stacked adapters, one picked per
request, in both engines and under a (data 2, model 2) mesh.

Both sides hold the same bytes: the base model and the adapters are built
by the JAX package (``tests/test_multi_lora.py``'s adapters: ``init_lora``'s
``a``, a random ``b``, ranks 4 and 8) and reach the port through the numpy
bridge. Held exactly: the stacked tree's bytes, the one-hot selector and
greedy streams (against JAX's engines, and against the port's engine on
``lora.merge``d params, JAX's own oracle). Held within 1e-6: each row's
adapter delta. Sampled streams are held to the port's merged engine with
the same seeds (the port's noise is its own hash, so JAX's draws cannot be
reproduced).

One place where JAX is no oracle: its prefix cache keys pages by prompt
tokens alone, so a request on adapter 1 reuses pages written under
adapter 0. The port salts the key with the adapter; the test asserts the
port's streams with the cache equal its streams without it, and records
JAX's differing streams as the fault.

The TP x DP cases run one world of 4 gloo processes for the file
(``tests/torch_parallel_worker.py``, suite ``multi_lora``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.models import lora as j_lora
from starflashattention_tpu.parallel import tp as j_tp
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu.serving import Engine as JEngine
from starflashattention_tpu.serving import PagedEngine as JPagedEngine
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.core import quant as t_quant
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import lora as t_lora
from starflashattention_tpu_torch.parallel import tp as t_tp
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.serving import Engine, PagedEngine, SamplingParams
from starflashattention_tpu_torch.utils import bridge

import torch_parallel_worker as worker

torch.set_num_threads(1)

CFG = dict(dtype="float32", num_splits=1)
MOE = dict(CFG, num_experts=4, num_experts_per_tok=2, num_q_heads=8, num_kv_heads=4)
DELTA_ATOL = 1e-6
TOPK_ATOL = 1e-4  # JAX's test_multi_lora_paged_tp_matches_single_chip
NEW_TOKENS = 6


def _rand_lora(cfg, key, rank, targets=j_lora._TARGETS):
    """JAX's ``tests/test_multi_lora.py::_rand_lora``: ``init_lora``'s ``a``
    and a random ``b`` (``b = 0`` would make every delta 0)."""
    lr = j_lora.init_lora(cfg, jax.random.PRNGKey(key), rank=rank, targets=targets)
    lr["layers"] = {n: {"a": ab["a"], "b": jax.random.normal(jax.random.PRNGKey(key + 100), ab["b"].shape) * 0.05}
                    for n, ab in lr["layers"].items()}
    return lr


def _bridge(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def _setup(kind="dense"):
    """(JAX config, port config, JAX params, port params, JAX adapters, port
    adapters): ``dense`` float32, ``int8`` its int8 projections (and the
    dense weights they dequantize to, as a third params tree), ``moe`` a
    tiny Mixtral with adapters on the attention only, ``tp`` the mesh
    tests' model (8 q / 4 KV heads)."""
    kw = {"dense": CFG, "int8": CFG, "moe": MOE, "tp": worker.LORA_TP_CFG}[kind]
    jc, tc = j_params.ModelConfig.tiny(**kw), t_params.ModelConfig.tiny(**kw)
    jp = j_llama.init_params(jc, jax.random.PRNGKey(3 if kind == "int8" else 0))
    if kind == "int8":
        jp = j_llama.quantize_model_weights(jp, "int8")
    targets = ("wqkv", "wo") if kind == "moe" else j_lora._TARGETS
    jl = [_rand_lora(jc, 1, 4, targets), _rand_lora(jc, 2, 8, targets)]
    return jc, tc, jp, _bridge(jp), jl, [_bridge(lr) for lr in jl]


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


# ---------------------------------------------------------------- models/lora


def test_stack_adapters_matches_jax():
    """``stack_adapters`` at ranks 4 and 8: (L, N, in, r_max) / (L, N,
    r_max, out), rank 4 zero-padded, each scale folded into its ``b``,
    byte for byte JAX's; ``num_adapters`` reads N."""
    jc, _, _, _, jl, tl = _setup()
    want = j_lora.stack_adapters(jl)
    got = t_lora.stack_adapters(tl)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name, ab in want["layers"].items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(got["layers"][name][k].numpy(), np.asarray(ab[k]))
    assert got["layers"]["wqkv"]["a"].shape == (jc.num_layers, 2, jc.hidden_size, 8)
    # stored (L, in, N, r): delta_multi reads a layer's a as one (in, N * r) matrix
    assert all(ab["a"].transpose(1, 2).is_contiguous() for ab in got["layers"].values())
    assert t_lora.num_adapters(got) == j_lora.num_adapters(want) == 2
    # the padded ranks add exact zeros
    assert not got["layers"]["wo"]["a"][:, 0, :, 4:].any() and not got["layers"]["wo"]["b"][:, 0, 4:].any()


def test_stack_adapters_refuses_mixed_targets():
    """Adapters that target different projections do not stack (JAX's
    ValueError), nor does an empty list."""
    _, tc, _, _, _, tl = _setup()
    attn_only = t_lora.init_lora(tc, torch.Generator().manual_seed(0), rank=4, targets=("wqkv", "wo"), device="cpu")
    with pytest.raises(ValueError, match="different projections"):
        t_lora.stack_adapters([tl[0], attn_only])
    with pytest.raises(ValueError, match="at least one"):
        t_lora.stack_adapters([])


@pytest.mark.parametrize("shape", [(5,), (3, 7)], ids=["decode", "prefill"])
def test_delta_multi_matches_jax(shape):
    """``delta_multi`` at (B, in) and (B, S, in) with a selector of both
    adapters and a base row, every target of layer 1: within 1e-6 of
    JAX's, exactly 0 on the base row."""
    jc, _, _, _, jl, tl = _setup()
    j_st, t_st = j_lora.stack_adapters(jl), t_lora.stack_adapters(tl)
    rng = np.random.default_rng(1)
    idx = np.array([0, 1, -1, 1, 0][:shape[0]])
    j_sel = j_lora.adapter_onehot(idx, 2)
    t_sel = t_lora.adapter_onehot(idx, 2)
    t_layer = t_lora.layer_slice(t_st, 1)
    for name, ab in j_st["layers"].items():
        fan_in = ab["a"].shape[2]
        x = rng.standard_normal((*shape, fan_in)).astype(np.float32)
        want = j_lora.delta_multi(jnp.asarray(x), {name: {k: v[1] for k, v in ab.items()}}, name, j_sel)
        got = t_lora.delta_multi(torch.from_numpy(x), t_layer, name, t_sel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=DELTA_ATOL, err_msg=name)
        assert got.shape == (*shape, ab["b"].shape[-1]) and got.dtype == torch.float32
        assert not got[2].any(), f"{name}: the base row's delta is not exactly 0"
        assert got.abs().max() > 1e-2  # the adapters do change the projection
    assert t_lora.delta_multi(torch.zeros(2, 4), t_layer, "absent", t_sel[:2]) is None


def test_adapter_onehot_matches_jax():
    """(B,) ids with -1 (the base model) -> JAX's (B, N) f32 one-hot, from a
    list and from a tensor."""
    idx = [2, -1, 0, 1, -1]
    want = np.asarray(j_lora.adapter_onehot(np.array(idx), 3))
    for got in (t_lora.adapter_onehot(idx, 3), t_lora.adapter_onehot(torch.tensor(idx), 3)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert not want[1].any() and not want[4].any()


# ---------------------------------------------------------------- engines


@functools.lru_cache(maxsize=None)
def _jax_streams(kind, prompts, adapters, **kw):
    jc, _, jp, _, jl, _ = _setup(kind)
    return JEngine(jp, jc, lora_adapters=jl, **dict(kw)).generate(
        [list(p) for p in prompts], max_new_tokens=NEW_TOKENS, adapters=list(adapters))


ENGINE_PROMPTS = tuple(tuple(p) for p in _prompts((6, 11, 4)))
ENGINE_ADAPTERS = (0, 1, None)


def test_engine_matches_jax_and_merged():
    """``Engine`` with adapters [0, 1, None] in one batch: the streams equal
    JAX's multi-LoRA engine's, and each equals the port's engine on the
    params with that adapter merged (the base model for None)."""
    _, tc, _, tp, _, tl = _setup()
    want = _jax_streams("dense", ENGINE_PROMPTS, ENGINE_ADAPTERS, num_slots=4, steps_per_round=3)
    eng = Engine(tp, tc, num_slots=4, steps_per_round=3, lora_adapters=tl, device="cpu")
    got = eng.generate([list(p) for p in ENGINE_PROMPTS], NEW_TOKENS, adapters=list(ENGINE_ADAPTERS))
    assert got == want
    for prompt, aid, stream in zip(ENGINE_PROMPTS, ENGINE_ADAPTERS, got):
        p_i = tp if aid is None else t_lora.merge(tp, tl[aid], tc)
        ref = Engine(p_i, tc, num_slots=2, steps_per_round=3, device="cpu").generate([list(prompt)], NEW_TOKENS)
        assert stream == ref[0], aid
    assert eng.stats.finished == 3


def test_paged_engine_matches_engine():
    """``PagedEngine`` (pages of 16, the prefill chunked in 8s, so the paged
    continuation runs the adapters too) serves the contiguous engine's
    streams, and every page goes back to the pool."""
    _, tc, _, tp, _, tl = _setup()
    prompts = _prompts((7, 13, 21), seed=5)
    adapters = [1, None, 0]
    want = Engine(tp, tc, num_slots=2, steps_per_round=3, lora_adapters=tl, device="cpu").generate(
        prompts, NEW_TOKENS, adapters=adapters)
    eng = PagedEngine(tp, tc, num_slots=2, steps_per_round=3, page_size=16, prefill_chunk=8, lora_adapters=tl,
                      debug_validate=True, device="cpu")
    assert eng.generate(prompts, NEW_TOKENS, adapters=adapters) == want
    assert eng.pool.free_pages == eng.num_pages - 1


def test_preempted_request_resumes_on_its_adapter():
    """A pool too small for every slot preempts; the preempted request
    re-prefills its prompt and output under its own adapter, so the
    streams equal an engine's whose pool never runs out."""
    _, tc, _, tp, _, tl = _setup()
    prompts = _prompts((28, 28, 28), seed=7)
    adapters = [0, 1, 1]
    want = Engine(tp, tc, num_slots=3, steps_per_round=3, lora_adapters=tl, device="cpu").generate(
        prompts, 12, adapters=adapters)
    eng = PagedEngine(tp, tc, num_slots=3, steps_per_round=3, page_size=16, num_pages=5, lora_adapters=tl,
                      device="cpu")
    assert eng.generate(prompts, 12, adapters=adapters) == want
    assert eng.stats.preemptions > 0


def test_int8_base_matches_jax():
    """Adapters over an int8-quantized base: the streams equal JAX's, and
    equal the port's engine on the dequantized dense weights with the same
    adapters (JAX's test_multi_lora_over_quantized_base)."""
    _, tc, _, tp, _, tl = _setup("int8")
    prompt = [4, 9, 2, 6, 1]
    want = _jax_streams("int8", (tuple(prompt),), (1,), num_slots=2, steps_per_round=2)
    got = Engine(tp, tc, num_slots=2, steps_per_round=2, lora_adapters=tl, device="cpu").generate(
        [prompt], NEW_TOKENS, adapters=[1])
    assert got == want
    dense = {**tp, "layers": {n: t_quant.dequantize_weight(w) if isinstance(w, dict) else w
                              for n, w in tp["layers"].items()}}
    assert Engine(dense, tc, num_slots=2, steps_per_round=2, lora_adapters=tl, device="cpu").generate(
        [prompt], NEW_TOKENS, adapters=[1]) == got


def test_moe_attention_adapters_match_jax():
    """A tiny Mixtral takes adapters on wqkv and wo only (JAX's
    ``_target_shapes`` leaves the expert stacks out): ``Engine`` with
    adapters [1, 0, None] equals JAX's, ``PagedEngine`` too."""
    _, tc, _, tp, _, tl = _setup("moe")
    prompts = tuple(tuple(p) for p in _prompts((9, 5, 12), seed=3))
    adapters = (1, 0, None)
    want = _jax_streams("moe", prompts, adapters, num_slots=4, steps_per_round=3)
    assert sorted(tl[0]["layers"]) == ["wo", "wqkv"]
    got = Engine(tp, tc, num_slots=4, steps_per_round=3, lora_adapters=tl, device="cpu").generate(
        [list(p) for p in prompts], NEW_TOKENS, adapters=list(adapters))
    assert got == want
    assert PagedEngine(tp, tc, num_slots=4, steps_per_round=3, page_size=16, lora_adapters=tl,
                       device="cpu").generate([list(p) for p in prompts], NEW_TOKENS, adapters=list(adapters)) == want


def test_sampling_with_chunked_prefill_matches_merged():
    """Adapters compose with per-request sampling and chunked prefill: the
    sampled streams equal the port's merged-model engine's with the same
    seeds (a sampled base row beside it equals the base engine's)."""
    _, tc, _, tp, _, tl = _setup()
    prompts = [[5, 3, 8, 1, 9, 2, 7], [2, 2, 7, 1, 8]]
    sp = [SamplingParams(temperature=1.0, top_k=16, seed=11), SamplingParams(temperature=0.8, seed=12)]
    eng = Engine(tp, tc, num_slots=2, steps_per_round=2, enable_sampling=True, prefill_chunk=4, lora_adapters=tl,
                 device="cpu")
    got = eng.generate(prompts, 5, sampling=sp, adapters=[1, None])
    for i, p_i in enumerate((t_lora.merge(tp, tl[1], tc), tp)):
        ref = Engine(p_i, tc, num_slots=2, steps_per_round=2, enable_sampling=True, device="cpu").generate(
            [prompts[i]], 5, sampling=[sp[i]])
        assert got[i] == ref[0], i


def test_guards():
    """JAX's refusals, with its reasons: an adapter out of range, adapters
    with ``spec_decode``, an MLA model with adapters; and the port's own
    checks of the ``adapters`` list and the selector's shape."""
    jc, tc, _, tp, _, tl = _setup()
    with pytest.raises(ValueError, match="out of range"):
        Engine(tp, tc, num_slots=2, lora_adapters=tl, device="cpu").generate([[1, 2]], 2, adapters=[5])
    with pytest.raises(ValueError, match="out of range"):
        Engine(tp, tc, num_slots=2, device="cpu").generate([[1, 2]], 2, adapters=[0])
    with pytest.raises(NotImplementedError, match="the verify program has no adapter operands"):
        Engine(tp, tc, num_slots=2, spec_decode=2, lora_adapters=tl, device="cpu")
    mla = t_params.ModelConfig.deepseek_v2_lite(num_layers=1, vocab_size=256, max_seq_len=64)
    with pytest.raises(NotImplementedError, match="MLA"):
        Engine({}, mla, lora_adapters=tl, device="cpu")
    with pytest.raises(ValueError, match="adapters has 1 entries for 2 prompts"):
        Engine(tp, tc, num_slots=2, lora_adapters=tl, device="cpu").generate([[1], [2]], 2, adapters=[0])
    stack = t_lora.stack_adapters(tl)
    cache = t_cache.init_cache(tc.num_layers, 2, tc.num_kv_heads, tc.max_seq_len, tc.head_dim,
                               dtype=torch.float32, device="cpu")
    cos, sin = t_llama.rope_tables(tc, device="cpu")
    with pytest.raises(ValueError, match="lora_sel"):
        t_llama.decode_step(tp, cache, torch.tensor([1, 2]), cos, sin, tc, lora=stack,
                            lora_sel=t_lora.adapter_onehot([0, 1, 1], 2))
    with pytest.raises(ValueError, match="go together"):
        t_llama.decode_step(tp, cache, torch.tensor([1, 2]), cos, sin, tc, lora=stack)


# ---------------------------------------------------------------- prefix cache keyed by adapter


def _same_prompt_two_adapters(eng, prompt):
    """The prompt on adapter 0, then on adapter 1, one engine."""
    return [eng.generate([prompt], 4, adapters=[a])[0] for a in (0, 1)]


def test_prefix_cache_keyed_by_adapter():
    """One 40-token prompt on adapter 0, then on adapter 1, through a
    ``PagedEngine`` with pages of 16. Without the cache both engines give
    the same streams. With it JAX's request on adapter 1 reuses the 2 pages
    written under adapter 0 and its stream changes (the recorded fault:
    JAX's ``prefix_cache._page_keys`` keys by tokens alone); the port's
    cache matches within an adapter only, so its streams stay equal to
    those without the cache, and a third request on adapter 1 hits its
    own pages."""
    jc, tc, jp, tp, jl, tl = _setup()
    prompt = _prompts((40,), seed=11)[0]
    j_plain = _same_prompt_two_adapters(JPagedEngine(jp, jc, num_slots=2, page_size=16, lora_adapters=jl), prompt)
    j_cached = JPagedEngine(jp, jc, num_slots=2, page_size=16, lora_adapters=jl, prefix_cache=True)
    j_streams = _same_prompt_two_adapters(j_cached, prompt)
    assert j_cached.stats.prefix_hits == 1 and j_streams[0] == j_plain[0]
    assert j_streams[1] != j_plain[1], "the JAX fault is gone: move this case to equality"
    t_plain = _same_prompt_two_adapters(PagedEngine(tp, tc, num_slots=2, page_size=16, lora_adapters=tl,
                                                    device="cpu"), prompt)
    assert t_plain == j_plain
    cached = PagedEngine(tp, tc, num_slots=2, page_size=16, lora_adapters=tl, prefix_cache=True, debug_validate=True,
                         device="cpu")
    assert _same_prompt_two_adapters(cached, prompt) == t_plain
    assert cached.stats.prefix_hits == 0
    assert cached.generate([prompt], 4, adapters=[1])[0] == t_plain[1]
    assert cached.stats.prefix_hits == 1 and cached.stats.prefix_tokens_reused == 32


def test_prefix_cache_hits_unchanged_without_adapters():
    """Base-model requests (on an engine with adapters, and on one without)
    hit each other's pages exactly as before: the same hits, tokens reused
    and streams, equal to the streams without the cache."""
    _, tc, _, tp, _, tl = _setup()
    system = _prompts((32,), seed=2)[0]
    prompts = [system + p for p in _prompts((5, 9, 3), seed=4)]
    plain = PagedEngine(tp, tc, num_slots=1, page_size=16, device="cpu").generate(prompts, 4)
    for kw in ({}, {"lora_adapters": tl}):
        eng = PagedEngine(tp, tc, num_slots=1, page_size=16, prefix_cache=True, device="cpu", **kw)
        assert eng.generate(prompts, 4) == plain
        assert (eng.stats.prefix_hits, eng.stats.prefix_tokens_reused) == (2, 64)


# ---------------------------------------------------------------- tensor + data parallelism


def test_shard_lora_layout():
    """``shard_lora`` on each rank of a (data 2, model 2) mesh: ``b`` of
    wqkv / w_gate_up the rank's columns of JAX's fused permutation
    (``tp._wqkv_perm`` / ``_gate_up_perm``), ``a`` whole; ``a`` of wo /
    w_down the rank's input rows, ``b`` whole; fresh tensors, ``a`` in the
    stack's serving layout."""
    jc, tc, _, _, _, tl = _setup("tp")
    stack = t_lora.stack_adapters(tl)
    perms = {"wqkv": j_tp._wqkv_perm(jc, 2), "w_gate_up": j_tp._gate_up_perm(jc, 2)}
    for rank in range(4):
        mesh = worker.fake_mesh({"data": 2, "model": 2}, rank)
        m = mesh.axes["model"].index
        local = t_tp.shard_lora(stack, mesh, tc)
        for name, ab in stack["layers"].items():
            a, b = local["layers"][name]["a"], local["layers"][name]["b"]
            if name in perms:
                cols = perms[name].reshape(2, -1)[m]
                np.testing.assert_array_equal(b.numpy(), ab["b"].numpy()[..., cols])
                np.testing.assert_array_equal(a.numpy(), ab["a"].numpy())
            else:
                rows = ab["a"].shape[2] // 2
                np.testing.assert_array_equal(a.numpy(), ab["a"].numpy()[:, :, m * rows:(m + 1) * rows])
                np.testing.assert_array_equal(b.numpy(), ab["b"].numpy())
            assert a.untyped_storage().data_ptr() != ab["a"].untyped_storage().data_ptr()
            assert a.transpose(1, 2).is_contiguous(), f"{name}: a left lora.serving_layout"
    assert t_tp.lora_specs(stack) == {"layers": {n: t_tp._LORA_KIND[n] for n in stack["layers"]}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both mesh cases on the port's 4 ranks, once: [each rank's arrays]."""
    _, _, jp, _, jl, _ = _setup("tp")
    inputs = worker.encode(jax.tree.map(np.asarray, jp), "lora_tp/params")
    for i, lr in enumerate(jl):
        inputs.update(worker.encode(jax.tree.map(np.asarray, lr), f"lora_tp/lora{i}"))
    prompts = _prompts(worker.LORA_TP_PROMPTS, seed=7)
    inputs["lora_tp/lens"] = np.array([len(p) for p in prompts])
    inputs["lora_tp/prompts"] = np.array([t for p in prompts for t in p], np.int32)
    return worker.run_world("multi_lora", inputs, tmp_path_factory.mktemp("multi_lora_world"))


def _one_process(case):
    """The case on the single-process port engine (no mesh)."""
    _, tc, _, tp, _, tl = _setup("tp")
    eng_name, kw, adapters, n_new = worker.LORA_TP_CASES[case]
    cls = Engine if eng_name == "Engine" else PagedEngine
    eng = cls(tp, tc, lora_adapters=tl, device="cpu", **kw)
    reqs = worker.lora_requests(_prompts(worker.LORA_TP_PROMPTS, seed=7), adapters, n_new)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return worker.lora_outputs(reqs, case)


@pytest.mark.parametrize("case", list(worker.LORA_TP_CASES))
def test_tp_matches_single_process(world, case):
    """Twins of JAX's test_multi_lora_tp_matches_single_chip (contiguous)
    and test_multi_lora_paged_tp_matches_single_chip (paged, top-k
    logprobs) on (data 2, model 2): every rank's streams equal the
    single-process port engine's (and, contiguous, JAX's single-chip
    engine's); the top-k ids equal and their logprobs within 1e-4."""
    want = _one_process(case)
    for res in world:
        np.testing.assert_array_equal(res[f"{case}/streams"], want[f"{case}/streams"])
        assert int(res[f"{case}/finished"]) == len(worker.LORA_TP_PROMPTS)
        if f"{case}/topk_ids" in want:
            np.testing.assert_array_equal(res[f"{case}/topk_ids"], want[f"{case}/topk_ids"])
            np.testing.assert_allclose(res[f"{case}/topk_vals"], want[f"{case}/topk_vals"], rtol=0, atol=TOPK_ATOL)
    if case == "engine":
        eng_name, kw, adapters, n_new = worker.LORA_TP_CASES[case]
        jc, _, jp, _, jl, _ = _setup("tp")
        j_streams = JEngine(jp, jc, lora_adapters=jl, **kw).generate(
            _prompts(worker.LORA_TP_PROMPTS, seed=7), max_new_tokens=n_new, adapters=list(adapters))
        np.testing.assert_array_equal(want[f"{case}/streams"], [t for s in j_streams for t in s + [-1]])
