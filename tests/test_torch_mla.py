"""DeepSeek's MLA (absorbed latent attention) in the port against the JAX
package, on the CPU at tiny widths in float32.

The configs are tests/test_mla.py's ``_tiny_mla_cfg`` (4 query heads on one
latent KV head, a 128-lane latent row), with the low-rank q projection
(``q_lora_rank``), and with DeepSeek-V2's MoE (softmax-all router times
``routed_scaling_factor`` 1.5, a shared expert, a dense first layer) on
dense, int8 and int4 expert stacks. Held to JAX: ``_mla_qkv`` /
``_mla_out``, the prefill and decode logits, greedy streams of
``generate``, ``Engine`` and ``PagedEngine`` (and the JAX ``PagedEngine``'s
page tables after every round), and the bridge on the MLA trees; the
decode also at 4 splits (K2's partials and their merge). The plain twins
of the decode (K1), paged decode (K7) and prefill (K5) kernels at the
card's latent geometry (D 640, 16 query heads a KV head) are held to the
JAX package's ``core/reference``, and the split partials there (K2) to
JAX's ``flash_decode_with_stats`` and its merge. The refusals JAX has
(mesh, spec decoding and LoRA with MLA, quantized KV) and training's.

Tolerances: token streams and page tables exactly; fp32 logits and
projections within 1e-5 of their largest magnitude.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_contig
from starflashattention_tpu.core import reference as j_ref
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu.serving import PagedEngine as JPagedEngine
from starflashattention_tpu.serving import Request as JRequest
from starflashattention_tpu_torch.cache import contiguous as t_contig
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import lora as t_lora
from starflashattention_tpu_torch.models import train as t_train
from starflashattention_tpu_torch.ops import flash_decode, flash_prefill, paged_decode
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.serving import Engine, PagedEngine, Request
from starflashattention_tpu_torch.utils import bridge

j_fd = importlib.import_module("starflashattention_tpu.ops.flash_decode")  # ops/__init__ shadows the module

torch.set_num_threads(1)

REL_TOL = 1e-5  # of the largest magnitude
NEW_TOKENS = 6
PROMPT_LENGTHS = (11, 6, 3)
PAGE = 16
TINY_MLA = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_q_heads=4,
                num_kv_heads=1, head_dim=24, max_seq_len=64, dtype="float32", num_splits=1,
                block_k=16, mla=True, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16, query_scale=24.0)
CONFIGS = {
    "mla": {},
    "mla_4_splits": dict(num_splits=4),  # the decode's split-KV partials (K2) and their merge
    "mla_q_lora": dict(q_lora_rank=16),
    "deepseek_v2": dict(num_experts=4, num_experts_per_tok=2, n_shared_experts=1, first_k_dense=1,
                        dense_inter_size=48, router_pre_softmax=True, routed_scaling_factor=1.5),
}


def _cfgs(name):
    kw = dict(TINY_MLA, **CONFIGS[name])
    return j_params.ModelConfig(**kw), t_params.ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _models(name, experts="dense"):
    """JAX params (dense, or ``wo`` and the experts int8 / int4) and the
    port's bridged copy."""
    jc, _ = _cfgs(name)
    params = j_llama.init_params(jc, jax.random.PRNGKey(0))
    if experts != "dense":
        params = j_llama.quantize_model_weights(params, experts)
    params = jax.tree.map(np.asarray, params)
    return jax.tree.map(jnp.asarray, params), bridge.params_from_numpy(params)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL_TOL * np.abs(want).max())


# ----------------------------------------------------------------- projections


@pytest.mark.parametrize("name", ["mla", "mla_q_lora"])
def test_mla_qkv_and_out_match_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _models(name)
    assert jc.kv_cache_dims() == tc.kv_cache_dims() == (1, 128)
    jcos, jsin = j_llama.rope_tables(jc)
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    assert tcos.shape == (jc.max_seq_len, jc.qk_rope_head_dim // 2)
    _close(tcos, jcos)  # the two libraries' cos differ in the last fp32 bit
    rng = np.random.default_rng(5)
    for lead, pos in (((3,), np.array([0, 17, 63])), ((2, 5), np.array([[0, 1, 2, 3, 4], [30, 31, 32, 33, 34]]))):
        h = rng.standard_normal((*lead, jc.hidden_size)).astype(np.float32)
        lidx = 1
        lp = {k: v[lidx] for k, v in jp["layers"].items() if not isinstance(v, dict)}
        want = j_llama._mla_qkv(jnp.asarray(h), lp, jc, jcos, jsin, jnp.asarray(pos, jnp.int32))
        got = t_llama._mla_qkv(torch.from_numpy(h), tp["layers"], lidx, tc, tcos, tsin,
                               torch.from_numpy(pos))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)
        o = rng.standard_normal((*lead, jc.num_q_heads, 128)).astype(np.float32)
        _close(t_llama._mla_out(torch.from_numpy(o), tp["layers"], lidx, tc),
               j_llama._mla_out(jnp.asarray(o), lp, jc))


# ----------------------------------------------------------------- the model


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in PROMPT_LENGTHS]


def _padded(prompts):
    width = max(map(len, prompts))
    return (np.array([p + [0] * (width - len(p)) for p in prompts], np.int32),
            np.array([len(p) for p in prompts], np.int32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_logits_match_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _models(name)
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
    _close(tcache.k, jcache.k)  # the latent rows [c | k_pe | 0]
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    want, _ = j_llama.decode_step(jp, jcache, jnp.asarray(tok), jcos, jsin, jc)
    got, _ = t_llama.decode_step(tp, tcache, torch.from_numpy(tok), tcos, tsin, tc)
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_stream(name, experts):
    jc, _ = _cfgs(name)
    jp, _ = _models(name, experts)
    padded, lens = _padded(_prompts(jc.vocab_size))
    return np.asarray(j_llama.generate(jp, jc, jnp.asarray(padded), jnp.asarray(lens),
                                       max_new_tokens=NEW_TOKENS)).tolist()


def _record_tables(eng):
    """The host page table after every decode round."""
    rounds = []
    decode_round = eng._decode_round

    def recorded():
        decode_round()
        rounds.append(eng._host_table.copy())

    eng._decode_round = recorded
    return rounds


def _serve(eng, request_cls, prompts):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("name,experts", [("mla", "dense"), ("mla_4_splits", "dense"), ("mla_q_lora", "dense"),
                                          ("deepseek_v2", "dense"), ("deepseek_v2", "int8"),
                                          ("deepseek_v2", "int4")])
def test_streams_match_jax(name, experts):
    """The port's generate, Engine and PagedEngine give JAX's greedy stream."""
    _, tc = _cfgs(name)
    _, tp = _models(name, experts)
    prompts = _prompts(tc.vocab_size)
    want = _jax_stream(name, experts)
    padded, lens = _padded(prompts)
    assert t_llama.generate(tp, tc, padded, lens, NEW_TOKENS, device="cpu").tolist() == want
    assert _serve(Engine(tp, tc, num_slots=2, steps_per_round=2, device="cpu"), Request, prompts) == want
    assert _serve(PagedEngine(tp, tc, num_slots=2, steps_per_round=2, page_size=PAGE, native=False,
                              device="cpu"), Request, prompts) == want


def test_paged_engine_matches_jax_paged_engine():
    """DeepSeek-V2 on the latent pages: streams and the page table after
    every decode round equal the JAX PagedEngine's."""
    jc, tc = _cfgs("deepseek_v2")
    jp, tp = _models("deepseek_v2")
    prompts = _prompts(jc.vocab_size)
    runs = []
    for cls, req, params, cfg, kw in ((JPagedEngine, JRequest, jp, jc, {}),
                                      (PagedEngine, Request, tp, tc, dict(device="cpu"))):
        eng = cls(params, cfg, num_slots=2, steps_per_round=2, page_size=PAGE, native=False,
                  debug_validate=True, **kw)
        tables = _record_tables(eng)
        runs.append((_serve(eng, req, prompts), tables))
    (want, want_tables), (got, tables) = runs
    assert got == want == _jax_stream("deepseek_v2", "dense")
    assert len(tables) == len(want_tables)
    for a, b in zip(tables, want_tables):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("experts", ["dense", "int4"])
def test_bridge_carries_mla_trees(experts):
    jp, tp = _models("deepseek_v2", experts)
    layers = tp["layers"]
    assert "wqkv" not in layers and isinstance(layers["dense_mlp"], dict)
    assert layers["mla_wuk"].shape == (2, 4, 16, 32) and layers["mla_wuv"].shape == (2, 4, 32, 16)
    if experts == "int4":
        assert layers["wo"]["scale"].dim() == 3 and layers["moe_down"]["scale"].dim() == 4
    back = bridge.params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ----------------------------------------------------------------- the latent geometry's twins


def test_latent_kernel_twins_match_reference():
    """K1, K7 and K5's plain twins at the card's latent geometry (D 640, 16
    query heads on one KV head, sm_scale 192 ** -0.5) against JAX's
    ``core/reference``: ragged lengths, 16-row shuffled pages, a causal
    chunk at an offset."""
    rng = np.random.default_rng(6)
    b, hq, s, d, sm = 2, 16, 64, flash_decode.LATENT_HEAD_DIM, 192.0**-0.5
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((1, b, 1, s, d)).astype(np.float32)
    v = rng.standard_normal((1, b, 1, s, d)).astype(np.float32)
    lens = np.array([37, 64], np.int32)
    want = j_ref.decode_reference(jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
                                  jnp.asarray(lens), sm_scale=sm)
    got = flash_decode.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(lens), layer=0, sm_scale=sm, num_splits=1)
    _close(got, want)
    pps = s // PAGE
    table = (rng.permutation(b * pps) + 1).reshape(b, pps).astype(np.int32)
    pools = []
    for x in (k, v):
        pool = np.zeros((1, 1, b * pps + 1, PAGE, d), np.float32)
        pool[0, 0, table.reshape(-1)] = x[0, :, 0].reshape(b * pps, PAGE, d)
        pools.append(torch.from_numpy(pool))
    # K7 rounds q * sm_scale to q's dtype first, a no-op in fp32
    got = paged_decode.paged_flash_decode(torch.from_numpy(q), *pools, torch.from_numpy(table),
                                          torch.from_numpy(lens), layer=0, sm_scale=sm)
    _close(got, want)
    sq, off = 24, np.array([40, 7], np.int32)
    qp = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    plens = off + np.array([sq, 13], np.int32)
    want = j_ref.mha_reference(jnp.asarray(qp), jnp.asarray(k[0]), jnp.asarray(v[0]),
                               lengths=jnp.asarray(plens), causal=True, q_offset=jnp.asarray(off),
                               sm_scale=sm)
    got = flash_prefill.flash_prefill(torch.from_numpy(qp), torch.from_numpy(k[0]), torch.from_numpy(v[0]),
                                      torch.from_numpy(plens), q_offsets=torch.from_numpy(off),
                                      sm_scale=sm)
    _close(got, want)


def test_latent_split_partials_match_jax():
    """K2 at the card's latent geometry: the port's
    ``flash_decode_with_stats`` (4 splits) against JAX's (o, m, l), in
    interpret mode, and ``lse_combine_splits`` of them against JAX's merged
    output; a split past a row's length holds m = NEG_INF, l = 0, o = 0."""
    rng = np.random.default_rng(7)
    b, hq, s, d, sm = 3, 16, 256, flash_decode.LATENT_HEAD_DIM, 192.0**-0.5
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((1, b, 1, s, d)).astype(np.float32)
    v = rng.standard_normal((1, b, 1, s, d)).astype(np.float32)
    lens = np.array([37, 129, 256], np.int32)
    kw = dict(layer=0, sm_scale=sm, num_splits=4, block_k=32)
    want = j_fd.flash_decode_with_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), **kw)
    got = flash_decode.flash_decode_with_stats(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                               torch.from_numpy(lens), **kw)
    assert got[0].shape == (b, hq, 4, d) and got[1].shape == got[2].shape == (b, hq, 4)
    dead = np.asarray(want[1]) < -1e30  # splits that hold no row of their sequence
    assert dead.any() and np.all(got[1].numpy()[dead] < -1e30) and np.all(got[2].numpy()[dead] == 0)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy()[~dead], w[~dead], rtol=0, atol=REL_TOL * np.abs(w[~dead]).max())
    _close(flash_decode.lse_combine_splits(*got), j_fd.lse_combine_splits(*want))
    _close(flash_decode.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                     torch.from_numpy(lens), **kw),
           j_fd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), **kw))


# ----------------------------------------------------------------- refusals


def test_mla_refusals():
    jc, tc = _cfgs("mla")
    _, tp = _models("mla")
    for kw in (dict(spec_decode=2), dict(lora_adapters=[{}]), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="MLA"):
            Engine(tp, tc, num_slots=2, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="MLA"):
        PagedEngine(tp, tc, num_slots=2, page_size=PAGE, lora_adapters=[{}], device="cpu")
    for cfg in (tc, _cfgs("deepseek_v2")[1]):
        t_llama.check_supported(cfg)  # served
    with pytest.raises(NotImplementedError, match="14c-train"):
        t_train._check_trainable({"layers": {}}, tc, None, None)
    with pytest.raises(NotImplementedError, match="14c-train"):
        t_lora.init_lora(tc, device="cpu")
    with pytest.raises(NotImplementedError, match="DeepSeek's routing.*Queue 3"):  # its routing is refused first
        t_train._check_trainable({"layers": {}}, _cfgs("deepseek_v2")[1], None, None)
    for mod in (j_params, t_params):
        with pytest.raises(ValueError, match="quantized KV"):
            mod.ModelConfig(**dict(TINY_MLA, quant_mode="int8"))


def test_latent_forms_the_card_refuses():
    """D 640 runs on the card in the forms MLA uses, at any number of
    splits and up to 16 query heads a KV head; the others raise before a
    launch, naming what is left in the ROADMAP."""
    bf16 = torch.bfloat16
    flash_decode.check_head_dim("k", 640, bf16, bf16)
    flash_decode.check_head_dim("k", 640, bf16, bf16, group=16)
    for args in ((bf16, torch.int8), (torch.float32, torch.float32)):
        with pytest.raises(ValueError, match="640"):
            flash_decode.check_head_dim("k", 640, *args)
    for kw in (dict(plain=False), dict(verify=True)):
        with pytest.raises(ValueError, match="K1 verify at D 640"):
            flash_decode.check_head_dim("k", 640, bf16, bf16, **kw)
    with pytest.raises(ValueError, match="at most 16"):
        flash_decode.check_head_dim("k", 640, bf16, bf16, group=32)
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode.check_head_dim("k", 512, bf16, bf16)
    q = torch.zeros((1, 16, 4, 640), dtype=bf16)
    k = torch.zeros((1, 1, 8, 640), dtype=bf16)
    opts = flash_prefill.prefill_options(None, 0, None, 0, True)
    flash_prefill.check_card_inputs("K5", q, k, k, latent=(True, False, opts))
    for latent in ((True, True, opts), (False, False, opts),
                   (True, False, flash_prefill.prefill_options(8, 0, None, 0, True))):
        with pytest.raises(ValueError, match="K5 / K12 at D 640"):
            flash_prefill.check_card_inputs("K5", q, k, k, latent=latent)
    with pytest.raises(ValueError, match="at most 8"):  # K12 (no latent form)
        flash_prefill.check_card_inputs("K12", q, k, k)
