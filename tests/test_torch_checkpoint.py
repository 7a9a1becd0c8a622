"""The port's checkpoints (``models/checkpoint``) against the JAX package's
and against transformers, on the CPU with tiny random HF models built here.

The HF models are the JAX package's own test models
(tests/test_checkpoint.py, test_model_families.py, test_moe.py and
test_mla.py): Llama, Llama with Llama-3 RoPE scaling, Mistral (window 6),
Qwen2 (QKV bias), Qwen3 (QK-norm), Qwen3-MoE, Mixtral, Gemma, Gemma-2,
Phi-3 (fused projections) with and without longrope, and DeepSeek-V2's MLA
with the direct q, with ``q_lora_rank`` and with its MoE (shared experts, a
dense first layer). For each:

- ``config_from_hf`` equals JAX's, field for field (``dataclasses.asdict``);
- the converted tree equals JAX's leaf for leaf, bit for bit, in fp32 and
  in bf16, from fp32 and from bf16 state dicts;
- the port's prefill and next decode logits match the HF forward within
  the JAX package's tolerances for the family;
- greedy ``generate`` streams equal JAX's, exactly.

Also: ``load_hf_model`` on a ``save_pretrained`` safetensors directory
served through the port's ``Engine`` against JAX's ``Engine``; the
refusals (JAX's, with JAX's messages, and DeepSeek's ``norm_topk_prob``,
which JAX accepts); the native save / restore of int8, fp8 and int4 trees
(the same bits, dtypes and streams) and of tuple-valued configs (equal and
hashable); ``param_count`` against JAX's on dense and quantized trees.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.models import checkpoint as j_ckpt
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu.serving import Engine as JEngine
from starflashattention_tpu_torch.cache import contiguous as t_contig
from starflashattention_tpu_torch.models import checkpoint as t_ckpt
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.serving import Engine
from starflashattention_tpu_torch.utils import bridge

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

NEW_TOKENS = 5
_COMMON = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
               tie_word_embeddings=False, attn_implementation="eager")
_PHI3 = dict(_COMMON, max_position_embeddings=64, original_max_position_embeddings=64,
             pad_token_id=0, bos_token_id=1, eos_token_id=2)
_DEEPSEEK = dict(_COMMON, num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                 v_head_dim=16, max_position_embeddings=64, rms_norm_eps=1e-6)
# name: (config class, model class, config keywords, torch seed, (atol, rtol) of the
# logits against HF as the JAX package's test of the family holds them, prompt length)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(_COMMON, rms_norm_eps=1e-5), 0, (2e-4, 2e-3), 9),
    "llama3-rope": ("LlamaConfig", "LlamaForCausalLM",
                    dict(_COMMON, rope_theta=5e5, rope_scaling={
                        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                        "original_max_position_embeddings": 32}), 12, (2e-4, 2e-3), 9),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(_COMMON, sliding_window=6), 2, (3e-4, 2e-3), 9),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(_COMMON, rope_theta=1e6, use_sliding_window=False), 1,
              (3e-4, 2e-3), 9),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(_COMMON, head_dim=16, use_sliding_window=False), 1,
              (2e-4, 2e-4), 9),
    "qwen3-moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  dict(_COMMON, moe_intermediate_size=96, head_dim=16, num_experts=4, num_experts_per_tok=2,
                       norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[], rms_norm_eps=1e-6,
                       use_sliding_window=False), 7, (3e-4, 2e-3), 9),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(_COMMON, intermediate_size=96, num_local_experts=4, num_experts_per_tok=2, rope_theta=1e6,
                     sliding_window=None), 3, (5e-4, 5e-3), 9),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(_COMMON, num_key_value_heads=1, head_dim=24, rms_norm_eps=1e-6, tie_word_embeddings=True), 3,
              (3e-4, 2e-3), 9),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(_COMMON, num_hidden_layers=4, head_dim=16, rms_norm_eps=1e-6, sliding_window=6,
                    attn_logit_softcapping=50.0, final_logit_softcapping=30.0, query_pre_attn_scalar=12,
                    tie_word_embeddings=True), 4, (3e-4, 2e-3), 9),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", _PHI3, 5, (3e-4, 2e-3), 9),
    "phi3-longrope": ("Phi3Config", "Phi3ForCausalLM",
                      dict(_PHI3, original_max_position_embeddings=16, rope_scaling={
                          "type": "longrope", "short_factor": [1.0 + 0.05 * i for i in range(8)],
                          "long_factor": [2.0 + 0.25 * i for i in range(8)]}), 6, (3e-4, 2e-3), 20),
    "deepseek-v2": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                    dict(_DEEPSEEK, q_lora_rank=None, n_routed_experts=None, first_k_dense_replace=2), 8,
                    (3e-4, 2e-3), 9),
    "deepseek-v2-q-lora": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                           dict(_DEEPSEEK, q_lora_rank=48, n_routed_experts=None, first_k_dense_replace=2), 9,
                           (3e-4, 2e-3), 9),
    "deepseek-v2-moe": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                        dict(_DEEPSEEK, num_hidden_layers=3, moe_intermediate_size=32, q_lora_rank=None,
                             n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
                             first_k_dense_replace=1, moe_layer_freq=1, topk_method="greedy",
                             norm_topk_prob=False, routed_scaling_factor=1.5, aux_loss_alpha=0.0,
                             seq_aux=False), 11, (3e-4, 2e-3), 9),
}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@functools.lru_cache(maxsize=None)
def _hf(family):
    cfg_cls, model_cls, kw, seed, _, _ = FAMILIES[family]
    hf_cfg = getattr(transformers, cfg_cls)(**kw)
    torch.manual_seed(seed)
    return hf_cfg, getattr(transformers, model_cls)(hf_cfg).eval()


@functools.lru_cache(maxsize=None)
def _fp32_models(family):
    """(JAX config, JAX params, port config, port params): the fp32 trees of
    both packages, their configs at dtype float32."""
    hf_cfg, model = _hf(family)
    state = model.state_dict()
    jc, tc = j_ckpt.config_from_hf(hf_cfg), t_ckpt.config_from_hf(hf_cfg)
    jp = j_ckpt.load_hf_state_dict(state, jc, dtype=jnp.float32)
    tp = t_ckpt.load_hf_state_dict(state, tc, dtype=torch.float32, device="cpu")
    return (dataclasses.replace(jc, dtype="float32"), jp, dataclasses.replace(tc, dtype="float32"), tp)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [(prefix, tree)]


def _int_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _assert_same_tree(got, want):
    """Same paths, dtypes, shapes and bits (``jax.tree.map`` sorts keys, so
    the order is not compared)."""
    got, want = sorted(_paths(got), key=lambda x: x[0]), sorted(_paths(want), key=lambda x: x[0])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert a.is_contiguous(), path
        assert torch.equal(_int_bits(a), _int_bits(b)), path


def _padded(prompts):
    width = max(map(len, prompts))
    return (np.array([p + [0] * (width - len(p)) for p in prompts], np.int32),
            np.array([len(p) for p in prompts], np.int32))


# ----------------------------------------------------------------- conversion


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_from_hf_matches_jax(family):
    hf_cfg, _ = _hf(family)
    got = t_ckpt.config_from_hf(hf_cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(j_ckpt.config_from_hf(hf_cfg))
    hash(got)


@pytest.mark.parametrize("source", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tree_matches_jax_bit_for_bit(family, dtype, source):
    """The port's tree against JAX's bridged tree: every leaf's bits, from
    an fp32 and from a bf16 state dict (JAX rounds both through fp32)."""
    hf_cfg, model = _hf(family)
    state = {k: v.to(DTYPES[source][0]) for k, v in model.state_dict().items()}
    cfg = t_ckpt.config_from_hf(hf_cfg)
    want = j_ckpt.load_hf_state_dict(state, j_ckpt.config_from_hf(hf_cfg), dtype=DTYPES[dtype][1])
    got = t_ckpt.load_hf_state_dict(state, cfg, dtype=DTYPES[dtype][0], device="cpu")
    _assert_same_tree(got, bridge.params_from_numpy(jax.tree.map(np.asarray, want)))


def test_tree_from_numpy_state_and_default_dtype():
    """A numpy state dict (as safetensors' numpy loader gives it) converts
    like the torch one, and ``dtype=None`` takes ``cfg.dtype`` (bf16)."""
    hf_cfg, model = _hf("qwen2")
    cfg = t_ckpt.config_from_hf(hf_cfg)
    state = model.state_dict()
    got = t_ckpt.load_hf_state_dict({k: v.numpy() for k, v in state.items()}, cfg, device="cpu")
    _assert_same_tree(got, t_ckpt.load_hf_state_dict(state, cfg, dtype="bfloat16", device="cpu"))
    assert got["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("field,value,name", [("intermediate_size", 96, "mlp.gate_proj.weight"),
                                              ("num_kv_heads", 1, "self_attn.k_proj.weight"),
                                              ("hidden_size", 32, "self_attn.q_proj.weight")])
def test_wrong_shapes_raise(field, value, name):
    """A state dict that does not fit the config raises ``ValueError``
    naming the tensor; nothing is broadcast to fit."""
    hf_cfg, model = _hf("llama")
    cfg = dataclasses.replace(t_ckpt.config_from_hf(hf_cfg), **{field: value})
    with pytest.raises(ValueError, match=name.replace(".", "[.]")):
        t_ckpt.load_hf_state_dict(model.state_dict(), cfg, device="cpu")


# ----------------------------------------------------------------- numerics


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_hf_forward(family):
    """The port's prefill logits, then the decode step's on HF's argmax
    token, against the HF forward (the JAX package's tolerance for the
    family)."""
    _, model = _hf(family)
    _, _, cfg, params = _fp32_models(family)
    atol, rtol, seq = *FAMILIES[family][4], FAMILIES[family][5]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, seq))
    with torch.no_grad():
        hf = model(torch.from_numpy(toks)).logits.numpy()
    hkv, d = cfg.kv_cache_dims()
    cache = t_contig.init_cache(cfg.num_layers, 2, hkv, cfg.max_seq_len, d, dtype=torch.float32, device="cpu")
    cos, sin = t_llama.rope_tables(cfg, device="cpu")
    ours, cache = t_llama.prefill(params, cache, torch.from_numpy(toks).to(torch.int32),
                                  torch.full((2,), seq, dtype=torch.int32), cos, sin, cfg)
    np.testing.assert_allclose(ours.numpy(), hf[:, -1], atol=atol, rtol=rtol)
    nxt = hf[:, -1].argmax(-1)
    with torch.no_grad():
        hf2 = model(torch.from_numpy(np.concatenate([toks, nxt[:, None]], axis=1))).logits.numpy()[:, -1]
    ours2, _ = t_llama.decode_step(params, cache, torch.from_numpy(nxt).to(torch.int32), cos, sin, cfg)
    np.testing.assert_allclose(ours2.numpy(), hf2, atol=atol, rtol=rtol)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generate_matches_jax(family):
    jc, jp, tc, tp = _fp32_models(family)
    rng = np.random.default_rng(1)
    padded, lens = _padded([[int(t) for t in rng.integers(0, tc.vocab_size, n)] for n in (9, 6)])
    want = np.asarray(j_llama.generate(jp, jc, jnp.asarray(padded), jnp.asarray(lens), max_new_tokens=NEW_TOKENS))
    got = t_llama.generate(tp, tc, padded, lens, NEW_TOKENS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_load_hf_model_serves_like_jax(tmp_path):
    """A ``save_pretrained`` safetensors directory through ``load_hf_model``
    into each package's ``Engine``: the same greedy tokens."""
    _, model = _hf("llama")
    model.save_pretrained(tmp_path, safe_serialization=True)
    assert (tmp_path / "model.safetensors").exists()
    cfg, params = t_ckpt.load_hf_model(str(tmp_path), dtype=torch.float32, device="cpu")
    jcfg, jparams = j_ckpt.load_hf_model(str(tmp_path), dtype=jnp.float32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_same_tree(params, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams)))
    prompts = [[3, 17, 42, 9], [5, 11]]
    got = Engine(params, dataclasses.replace(cfg, dtype="float32"), num_slots=2, steps_per_round=2,
                 device="cpu").generate(prompts, max_new_tokens=8)
    want = JEngine(jparams, dataclasses.replace(jcfg, dtype="float32"), num_slots=2,
                   steps_per_round=2).generate(prompts, max_new_tokens=8)
    assert got == want


# ----------------------------------------------------------------- refusals


def _refused(family, **over):
    cfg_cls, _, kw, _, _, _ = FAMILIES[family]
    return getattr(transformers, cfg_cls)(**dict(kw, **over))


REFUSALS = {
    "deepseek-v3-moe": lambda: _deepseek_v3(),
    "group-limited-greedy": lambda: _refused("deepseek-v2-moe", topk_method="group_limited_greedy", n_group=2,
                                             topk_group=1),
    "moe-layer-freq": lambda: _refused("deepseek-v2-moe", moe_layer_freq=2),
    "deepseek-yarn": lambda: _refused("deepseek-v2", rope_scaling={
        "type": "yarn", "factor": 2.0, "original_max_position_embeddings": 32}),
    "qwen3-moe-unnormalised": lambda: _refused("qwen3-moe", norm_topk_prob=False),
    "qwen3-moe-sparse-step": lambda: _refused("qwen3-moe", decoder_sparse_step=2),
    "qwen3-moe-mlp-only": lambda: _refused("qwen3-moe", mlp_only_layers=[0]),
    "rope-type": lambda: _refused("llama", rope_scaling={"rope_type": "dynamic", "factor": 2.0}),
}


def _deepseek_v3():
    cfg = _refused("deepseek-v2-moe")
    cfg.model_type = "deepseek_v3"
    return cfg


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(case):
    hf_cfg = REFUSALS[case]()
    with pytest.raises(ValueError) as jax_err:
        j_ckpt.config_from_hf(hf_cfg)
    with pytest.raises(ValueError) as port_err:
        t_ckpt.config_from_hf(hf_cfg)
    assert str(port_err.value) == str(jax_err.value)


def test_deepseek_norm_topk_prob_is_refused():
    """DeepSeek normalises its top-k weights with ``norm_topk_prob``; the
    router here does not (and transformers' DeepseekV2 ignores the flag, so
    HF parity cannot tell): JAX serves such a config, the port refuses it."""
    hf_cfg = _refused("deepseek-v2-moe", norm_topk_prob=True)
    assert j_ckpt.config_from_hf(hf_cfg).num_experts == 8
    with pytest.raises(ValueError, match="norm_topk_prob"):
        t_ckpt.config_from_hf(hf_cfg)


# ----------------------------------------------------------------- native checkpoints


@functools.lru_cache(maxsize=None)
def _tiny():
    """JAX's tiny fp32 tree, bridged, and the port's config."""
    jc = j_params.ModelConfig.tiny(dtype="float32", num_splits=1)
    jp = j_llama.init_params(jc, jax.random.PRNGKey(0))
    return jc, jp, t_params.ModelConfig.tiny(dtype="float32", num_splits=1), bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_native_round_trip_of_quantized_trees(tmp_path, mode):
    """A quantized tree (projections and lm_head) saves and restores with
    the same paths, dtypes and bits, and generates the same tokens."""
    _, _, cfg, dense = _tiny()
    params = t_llama.quantize_model_weights(dense, mode, lm_head=True, int4_group=32 if mode == "int4" else None)
    assert isinstance(params["layers"]["wqkv"], dict) and isinstance(params["lm_head"], dict)
    t_ckpt.save_checkpoint(tmp_path / "ckpt", params, cfg)
    cfg2, params2 = t_ckpt.load_checkpoint(tmp_path / "ckpt", device="cpu")
    assert cfg2 == cfg
    _assert_same_tree(params2, params)
    prompts, lens = np.array([[1, 2, 3, 4]], np.int32), np.array([4], np.int32)
    np.testing.assert_array_equal(t_llama.generate(params2, cfg2, prompts, lens, 4, device="cpu").numpy(),
                                  t_llama.generate(params, cfg, prompts, lens, 4, device="cpu").numpy())


def test_native_round_trip_writes_each_leaf_once(tmp_path):
    """A leaf that views a larger tensor is written as its own bytes."""
    _, _, cfg, dense = _tiny()
    params = dict(dense, lm_head=dense["embed"].T)  # a transposed view
    t_ckpt.save_checkpoint(tmp_path, params, dataclasses.replace(cfg, tie_embeddings=False))
    _, back = t_ckpt.load_checkpoint(tmp_path, device="cpu")
    assert back["lm_head"].is_contiguous() and torch.equal(back["lm_head"], dense["embed"].T)
    total = sum(t.numel() * t.element_size() for _, t in _paths(params))
    assert (tmp_path / t_ckpt.PARAMS_FILE).stat().st_size < total + 64 * 1024


PHI3_LONGROPE = ("longrope", 4096, 131072, tuple(1.0 + 0.01 * i for i in range(64)),
                 tuple(2.0 + 0.5 * i for i in range(64)))


@pytest.mark.parametrize("preset", ["llama31_8b", "phi3_medium_longrope", "phi3-longrope-hf"])
def test_native_round_trip_of_tuple_configs(tmp_path, preset):
    """Configs with tuple fields (Llama-3.1's RoPE warp, longrope's nested
    factor tuples) come back equal and hashable."""
    if preset == "llama31_8b":
        cfg = t_params.ModelConfig.llama31_8b()
    elif preset == "phi3_medium_longrope":
        cfg = t_params.ModelConfig.phi3_medium(rope_scaling=PHI3_LONGROPE)
    else:
        cfg = t_ckpt.config_from_hf(_hf("phi3-longrope")[0])
    assert isinstance(cfg.rope_scaling, tuple)
    t_ckpt.save_checkpoint(tmp_path, {"embed": torch.zeros(2, 2)}, cfg)
    back, _ = t_ckpt.load_checkpoint(tmp_path, device="cpu")
    assert back == cfg and hash(back) == hash(cfg)


def test_native_round_trip_generates_like_the_hf_tree(tmp_path):
    """An HF family tree (Gemma-2: four norms, tied head) saved and
    restored generates the tokens JAX generates from the same HF model."""
    jc, jp, tc, tp = _fp32_models("gemma2")
    t_ckpt.save_checkpoint(tmp_path, tp, tc)
    cfg, params = t_ckpt.load_checkpoint(tmp_path, device="cpu")
    assert cfg == tc
    _assert_same_tree(params, tp)
    padded, lens = _padded([[5, 9, 2, 40, 7], [3, 3]])
    want = np.asarray(j_llama.generate(jp, jc, jnp.asarray(padded), jnp.asarray(lens), max_new_tokens=NEW_TOKENS))
    np.testing.assert_array_equal(t_llama.generate(params, cfg, padded, lens, NEW_TOKENS, device="cpu").numpy(),
                                  want)


# ----------------------------------------------------------------- param_count


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_param_count_matches_jax(mode):
    jc, jp, _, tp = _tiny()
    if mode is not None:
        group = 32 if mode == "int4" else None
        jp = j_llama.quantize_model_weights(jp, mode, lm_head=True, **({"int4_group": group} if group else {}))
        tp = t_llama.quantize_model_weights(tp, mode, lm_head=True, int4_group=group)
    assert t_llama.param_count(tp) == j_llama.param_count(jp)


@pytest.mark.parametrize("family", ["mixtral", "deepseek-v2-moe"])
def test_param_count_of_hf_trees_matches_jax(family):
    _, jp, _, tp = _fp32_models(family)
    assert t_llama.param_count(tp) == j_llama.param_count(jp)
