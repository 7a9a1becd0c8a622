"""Mixture-of-experts MLPs of the port against the JAX package's, on the CPU
at tiny widths in float32.

``_moe_mlp`` with Mixtral's router (softmax over the top-k logits) and
DeepSeek's (softmax over all experts, top-k, times
``routed_scaling_factor`` 1.5, plus a shared expert) on dense, int8 and
int4 expert stacks; a forced router tie, which must pick the lower expert
index as ``jax.lax.top_k`` does; the prefill and decode logits of a tiny
Mixtral-style model; greedy streams of ``generate``, ``Engine`` and
``PagedEngine`` with dense, int8 and int4 experts; the bridge on the MoE
trees; and the training refusal. The JAX side runs its Pallas kernels in
interpret mode, the port the plain twins of its kernels; both sides hold
the same bytes (the JAX params cross through ``utils.bridge``).

Tolerances: routing and token streams exactly; fp32 outputs and logits
within 1e-5 of their largest magnitude (the two sides sum the same fp32
products in other orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_contig
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu_torch.cache import contiguous as t_contig
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import train as t_train
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.serving import Engine, PagedEngine, Request
from starflashattention_tpu_torch.utils import bridge

torch.set_num_threads(1)

REL_TOL = 1e-5  # of the largest magnitude
NEW_TOKENS = 6
PROMPT_LENGTHS = (11, 6, 3)
ROUTERS = {
    "mixtral": dict(),
    "deepseek": dict(router_pre_softmax=True, routed_scaling_factor=1.5, n_shared_experts=1,
                     first_k_dense=1, dense_inter_size=96),
}
MOE = dict(dtype="float32", num_splits=1, num_experts=4, num_experts_per_tok=2, num_q_heads=8,
           num_kv_heads=4)


def _cfgs(router="mixtral", **kw):
    kw = dict(MOE, **ROUTERS[router], **kw)
    return j_params.ModelConfig.tiny(**kw), t_params.ModelConfig.tiny(**kw)


@functools.lru_cache(maxsize=None)
def _models(router="mixtral", experts="dense"):
    """JAX params (experts dense, or int8 / int4 with ``wo`` and ``wqkv``)
    and the port's bridged copy."""
    jc, _ = _cfgs(router)
    params = j_llama.init_params(jc, jax.random.PRNGKey(0))
    if experts != "dense":
        params = j_llama.quantize_model_weights(params, experts)
    params = jax.tree.map(np.asarray, params)
    return jax.tree.map(jnp.asarray, params), bridge.params_from_numpy(params)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL_TOL * np.abs(want).max())


# ----------------------------------------------------------------- the MLP


@pytest.mark.parametrize("experts", ["dense", "int8", "int4"])
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_mlp_matches_jax(router, experts):
    jc, tc = _cfgs(router)
    jp, tp = _models(router, experts)
    x = np.random.default_rng(3).standard_normal((5, jc.hidden_size)).astype(np.float32)
    for lidx in range(jc.num_layers):
        lp = {k: v[lidx] for k, v in jp["layers"].items() if not isinstance(v, dict)}
        want = j_llama._moe_mlp(jnp.asarray(x), lp, jc, layers=jp["layers"], lidx=lidx)
        got = t_llama._moe_mlp(torch.from_numpy(x), tp["layers"], lidx, tc)
        _close(got, want)
    if experts == "int4":  # per expert (L, E, G, O) scales: the rank tags the format
        assert tp["layers"]["moe_gate_up"]["scale"].dim() == 4


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_router_tie_picks_the_lower_expert(router):
    """Experts 1 and 2 score exactly the same and only one of the two fits
    in the top 2: both packages take expert 1."""
    jc, tc = _cfgs(router)
    h = jc.hidden_size
    rng = np.random.default_rng(4)
    x = np.abs(rng.standard_normal((6, h))).astype(np.float32) + 0.1
    router_w = np.zeros((h, 4), np.float32)
    router_w[:, 0], router_w[:, 3] = 0.02, -0.02  # expert 0 first, 3 last, 1 and 2 tied at 0
    w = t_llama.route(torch.from_numpy(x), torch.from_numpy(router_w), tc)
    assert (w[:, 1] > 0).all() and (w[:, 2] == 0).all()
    jp, tp = _models(router)
    lp = {k: v[0] for k, v in jp["layers"].items() if not isinstance(v, dict)}
    lp["moe_router"] = jnp.asarray(router_w)
    layers = dict(tp["layers"], moe_router=torch.from_numpy(router_w)[None])
    want = j_llama._moe_mlp(jnp.asarray(x), lp, jc)
    got = t_llama._moe_mlp(torch.from_numpy(x), layers, 0, tc)
    _close(got, want)
    # expert 1's output, not expert 2's: the two differ far beyond the tolerance
    router_2 = router_w.copy()
    router_2[:, 2] = 1e-3  # expert 2 now just above expert 1
    layers_2 = dict(layers, moe_router=torch.from_numpy(router_2)[None])
    assert np.abs(t_llama._moe_mlp(torch.from_numpy(x), layers_2, 0, tc).numpy()
                  - np.asarray(want)).max() > 1e3 * REL_TOL * np.abs(np.asarray(want)).max()


# ----------------------------------------------------------------- the model


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in PROMPT_LENGTHS]


def _padded(prompts):
    width = max(map(len, prompts))
    return (np.array([p + [0] * (width - len(p)) for p in prompts], np.int32),
            np.array([len(p) for p in prompts], np.int32))


def test_prefill_and_decode_logits_match_jax():
    jc, tc = _cfgs("mixtral")
    jp, tp = _models("mixtral")
    padded, lens = _padded(_prompts(jc.vocab_size))
    hkv, d = jc.kv_cache_dims()
    jcache = j_contig.init_cache(jc.num_layers, len(lens), hkv, jc.max_seq_len, d, dtype=jnp.float32)
    jcos, jsin = j_llama.rope_tables(jc)
    want, jcache = j_llama.prefill(jp, jcache, jnp.asarray(padded), jnp.asarray(lens), jcos, jsin, jc)
    tcache = t_contig.init_cache(tc.num_layers, len(lens), hkv, tc.max_seq_len, d, dtype=torch.float32,
                                 device="cpu")
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    got, tcache = t_llama.prefill(tp, tcache, torch.from_numpy(padded), torch.from_numpy(lens), tcos,
                                  tsin, tc)
    _close(got, want)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    want, _ = j_llama.decode_step(jp, jcache, jnp.asarray(tok), jcos, jsin, jc)
    got, _ = t_llama.decode_step(tp, tcache, torch.from_numpy(tok), tcos, tsin, tc)
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_stream(router, experts):
    jc, _ = _cfgs(router)
    jp, _ = _models(router, experts)
    padded, lens = _padded(_prompts(jc.vocab_size))
    return np.asarray(j_llama.generate(jp, jc, jnp.asarray(padded), jnp.asarray(lens),
                                       max_new_tokens=NEW_TOKENS)).tolist()


def _port_streams(tp, tc, prompts):
    """Greedy streams of the port's generate, Engine and PagedEngine."""
    padded, lens = _padded(prompts)
    out = {"generate": t_llama.generate(tp, tc, padded, lens, NEW_TOKENS, device="cpu").tolist()}
    for name, make in (("Engine", lambda: Engine(tp, tc, num_slots=2, steps_per_round=2, device="cpu")),
                       ("PagedEngine", lambda: PagedEngine(tp, tc, num_slots=2, steps_per_round=2,
                                                           page_size=16, native=False, device="cpu"))):
        eng = make()
        reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[name] = [r.output for r in reqs]
    return out


@pytest.mark.parametrize("experts", ["dense", "int8", "int4"])
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_streams_match_jax(router, experts):
    _, tc = _cfgs(router)
    _, tp = _models(router, experts)
    want = _jax_stream(router, experts)
    for entry, got in _port_streams(tp, tc, _prompts(tc.vocab_size)).items():
        assert got == want, entry


# ----------------------------------------------------------------- bridge, refusals


@pytest.mark.parametrize("experts", ["dense", "int8", "int4"])
def test_bridge_carries_moe_trees(experts):
    jp, tp = _models("deepseek", experts)
    jl, tl = jax.tree_util.tree_flatten_with_path(jp)[0], jax.tree_util.tree_flatten_with_path(
        bridge.params_to_numpy(tp))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32), np.asarray(b).astype(np.float32))
        assert np.asarray(a).shape == np.asarray(b).shape
    assert tp["layers"]["moe_shared_gate_up"].shape[0] == tp["layers"]["moe_router"].shape[0]


def test_moe_is_served_not_trained():
    """DeepSeek's routing is served, not trained (JAX's training ignores
    it: ROADMAP Queue 3); Mixtral's is both (tests/test_torch_moe_train.py)."""
    _, tc = _cfgs("deepseek")
    t_llama.check_supported(tc)
    with pytest.raises(NotImplementedError, match="DeepSeek's routing.*Queue 3"):
        t_train._check_trainable({"layers": {}}, tc, None, None)
    t_train._check_trainable({"layers": {}}, _cfgs()[1], None, None)
