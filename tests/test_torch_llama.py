"""The PyTorch port's greedy generate (prefill + decode) against the JAX
package's, on the CPU at ``ModelConfig.tiny``.

The JAX model is built and quantized (int8 projections and int8 lm_head)
by the JAX package; its params reach the port through the numpy bridge, so
both sides hold the same bytes. The JAX side runs its Pallas kernels in
interpret mode; the port runs the plain twins of its kernels.

Tolerances: in float32 both sides evaluate the same expressions and differ
in summation order only; through 2 layers that stays below 1e-5 on logits
of magnitude ~3, so logits are held to 1e-4 and token streams must be
identical. In bfloat16 the two libraries round intermediate activations at
the same places but their fp32 sums (and silu) differ in the last bits, so
a bf16 rounding can flip between them; logits are held to 0.05 (about one
bf16 ulp of the largest logit, times a few layers of propagation).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_cache
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu.runtime import steps as j_steps
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.runtime import steps as t_steps
from starflashattention_tpu_torch.utils import bridge

torch.set_num_threads(1)

LOGIT_ATOL_F32 = 1e-4
LOGIT_ATOL_BF16 = 5e-2
SPLITS = {"one_split": 256, "four_splits": 32}  # block_k at tiny (S=128) -> 1 or 4 splits
PROMPT_LENGTHS = np.array([12, 7, 1], np.int32)


def _cfgs(dtype, block_k):
    return (j_params.ModelConfig.tiny(dtype=dtype, block_k=block_k),
            t_params.ModelConfig.tiny(dtype=dtype, block_k=block_k))


@functools.lru_cache(maxsize=None)
def _models(dtype="float32"):
    """JAX params (int8 weights, int8 lm_head) and the port's bridged copy."""
    jc, _ = _cfgs(dtype, 256)
    params = j_llama.quantize_model_weights(
        j_llama.init_params(jc, jax.random.PRNGKey(0)), "int8", lm_head=True)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


def _prompts():
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, (3, 12)).astype(np.int32)


def _jax_prefill_and_decode(dtype, block_k, steps):
    jc, _ = _cfgs(dtype, block_k)
    jp, _ = _models(dtype)
    cache = j_cache.init_cache(jc.num_layers, 3, jc.num_kv_heads, jc.max_seq_len, jc.head_dim,
                               dtype=jnp.dtype(dtype))
    cos, sin = j_llama.rope_tables(jc)
    logits, cache = j_llama.prefill(jp, cache, jnp.asarray(_prompts()), jnp.asarray(PROMPT_LENGTHS),
                                    cos, sin, jc)
    out, toks = [np.asarray(logits, np.float32)], []
    for _ in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.array(tok))
        logits, cache = j_llama.decode_step(jp, cache, tok, cos, sin, jc)
        out.append(np.asarray(logits, np.float32))
    return out, toks, cache


def _port_prefill_and_decode(dtype, block_k, toks):
    _, tc = _cfgs(dtype, block_k)
    _, tp = _models(dtype)
    cache = t_cache.init_cache(tc.num_layers, 3, tc.num_kv_heads, tc.max_seq_len, tc.head_dim,
                               dtype=t_llama.torch_dtype(dtype), device="cpu")
    cos, sin = t_llama.rope_tables(tc, device="cpu")
    logits, same = t_llama.prefill(tp, cache, torch.from_numpy(_prompts()),
                                   torch.from_numpy(PROMPT_LENGTHS), cos, sin, tc)
    assert same is cache  # updated in place
    out = [logits.float().numpy()]
    for tok in toks:  # feed the JAX tokens, so a flip cannot desynchronize the chains
        logits, _ = t_llama.decode_step(tp, cache, torch.from_numpy(tok), cos, sin, tc)
        out.append(logits.float().numpy())
    return out, cache


@pytest.mark.parametrize("splits", sorted(SPLITS))
def test_prefill_and_decode_logits_match_jax(splits):
    """Prefill logits, then a 4-step decode chain, and the final cache."""
    jax_logits, toks, jax_cache = _jax_prefill_and_decode("float32", SPLITS[splits], steps=4)
    port_logits, port_cache = _port_prefill_and_decode("float32", SPLITS[splits], toks)
    assert len(port_logits) == 5
    for step, (out, ref) in enumerate(zip(port_logits, jax_logits)):
        assert out.shape == (3, 256)
        np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL_F32, rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(port_cache.lengths.numpy(), np.asarray(jax_cache.lengths))
    # valid cache rows (the prefill also writes its padded rows; both sides
    # write the same ones)
    np.testing.assert_allclose(port_cache.k.numpy(), np.asarray(jax_cache.k), atol=1e-5, rtol=0)
    np.testing.assert_allclose(port_cache.v.numpy(), np.asarray(jax_cache.v), atol=1e-5, rtol=0)


@pytest.mark.parametrize("splits", sorted(SPLITS))
def test_generate_streams_match_jax(splits):
    jc, tc = _cfgs("float32", SPLITS[splits])
    jp, tp = _models()
    ref = j_llama.generate(jp, jc, jnp.asarray(_prompts()), jnp.asarray(PROMPT_LENGTHS),
                           max_new_tokens=6)
    out = t_llama.generate(tp, tc, _prompts(), PROMPT_LENGTHS, 6, device="cpu")
    assert out.dtype == torch.int32 and out.shape == (3, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# quantized deployments: (config overrides, weight mode); the weight mode
# also quantizes the lm_head. Prompts are 4 x 64 = 256 rows, so the
# w8a8_prefill cases really take W8A8 / W4A8 in the prefill.
QUANT_CASES = {
    "int4_weights": (dict(), "int4"),
    "int8_kv": (dict(quant_mode="int8"), "int8"),
    "int8_kv_four_splits": (dict(quant_mode="int8", block_k=32), "int8"),
    "fp8_kv": (dict(quant_mode="fp8"), "int8"),
    "w8a8_prefill_int8": (dict(w8a8_prefill=True), "int8"),
    "w4a8_prefill_int4_int8_kv": (dict(w8a8_prefill=True, quant_mode="int8"), "int4"),
}


@functools.lru_cache(maxsize=None)
def _weights(mode):
    jc, _ = _cfgs("float32", 256)
    params = j_llama.quantize_model_weights(
        j_llama.init_params(jc, jax.random.PRNGKey(0)), mode, lm_head=True)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantized_generate_streams_match_jax(case):
    """Greedy streams of the quantized deployments equal JAX's token for
    token (float32 at tiny; 4 ragged prompts in a 64-column batch)."""
    overrides, mode = QUANT_CASES[case]
    jc = j_params.ModelConfig.tiny(dtype="float32", **overrides)
    tc = t_params.ModelConfig.tiny(dtype="float32", **overrides)
    jp, tp = _weights(mode)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 256, (4, 64)).astype(np.int32)
    lengths = np.array([64, 41, 7, 60], np.int32)
    ref = j_llama.generate(jp, jc, jnp.asarray(prompts), jnp.asarray(lengths), max_new_tokens=6)
    out = t_llama.generate(tp, tc, prompts, lengths, 6, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bf16_logits_match_jax():
    jax_logits, toks, _ = _jax_prefill_and_decode("bfloat16", 32, steps=2)
    port_logits, _ = _port_prefill_and_decode("bfloat16", 32, toks)
    for step, (out, ref) in enumerate(zip(port_logits, jax_logits)):
        np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL_BF16, rtol=0, err_msg=f"step {step}")


def test_quantize_model_weights_matches_jax():
    """The port quantizes the bridged dense params to the JAX bytes. The
    scales may differ by one fp32 ulp: JAX jit-compiles this step, and XLA
    turns ``absmax / 127`` into ``absmax * (1 / 127)``."""
    jc, _ = _cfgs("float32", 256)
    dense = j_llama.init_params(jc, jax.random.PRNGKey(0))
    ref = j_llama.quantize_model_weights(dense, "int8", lm_head=True)
    out = t_llama.quantize_model_weights(
        bridge.params_from_numpy(jax.tree.map(np.asarray, dense)), "int8", lm_head=True)
    pairs = [(out["layers"][name], ref["layers"][name]) for name in ("wqkv", "wo", "w_gate_up", "w_down")]
    for got, want in pairs + [(out["lm_head"], ref["lm_head"])]:
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        np.testing.assert_array_max_ulp(got["scale"].numpy(), np.asarray(want["scale"]), maxulp=1)
    np.testing.assert_array_equal(out["embed"].numpy(), np.asarray(ref["embed"]))


def test_init_params_layout_matches_jax():
    jc, tc = _cfgs("float32", 256)
    jp = j_llama.quantize_model_weights(j_llama.init_params(jc, jax.random.PRNGKey(0)), "int8",
                                        lm_head=True)
    tp = t_llama.quantize_model_weights(
        t_llama.init_params(tc, torch.Generator().manual_seed(0), device="cpu"), "int8", lm_head=True)
    direct = t_llama.init_params(tc, torch.Generator().manual_seed(0), quantize="int8", device="cpu")
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    for tree in (tp, direct):
        tree = dict(tree, lm_head=tp["lm_head"])
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tree)
        assert got == shapes


def test_prefill_rejects_window_past_the_cache():
    """The JAX write would shift the window left over valid rows; the port
    raises instead."""
    _, tc = _cfgs("float32", 256)
    _, tp = _models()
    cache = t_cache.init_cache(tc.num_layers, 3, tc.num_kv_heads, tc.max_seq_len, tc.head_dim,
                               dtype=torch.float32, device="cpu")
    cache.lengths[:] = torch.tensor([0, 120, 3], dtype=torch.int32)
    cos, sin = t_llama.rope_tables(tc, device="cpu")
    with pytest.raises(ValueError, match="overruns the cache"):
        t_llama.prefill(tp, cache, torch.from_numpy(_prompts()), torch.from_numpy(PROMPT_LENGTHS),
                        cos, sin, tc)


def test_decode_at_a_full_cache_clamps_like_jax():
    """Decode writes at min(pos, S-1), as the JAX package does."""
    jc, tc = _cfgs("float32", 256)
    jp, tp = _models()
    s = jc.max_seq_len
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, 3, 2, s, 16), dtype=np.float32)
    v = rng.standard_normal((2, 3, 2, s, 16), dtype=np.float32)
    lengths = np.array([s - 1, 5, s - 1], np.int32)
    tok = np.array([3, 4, 5], np.int32)
    jcache = j_cache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths))
    cos, sin = j_llama.rope_tables(jc)
    ref, jcache = j_llama.decode_step(jp, jcache, jnp.asarray(tok), cos, sin, jc)
    tcache = bridge.cache_from_numpy(k, v, lengths)
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    out, tcache = t_llama.decode_step(tp, tcache, torch.from_numpy(tok), tcos, tsin, tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL_F32, rtol=0)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_attention_decode_step_quantized_matches_jax(mode):
    """The reference-API step on an int8 / fp8 cache: the row is quantized
    against the cache's scales and attention folds them in."""
    acfg_kw = dict(num_q_heads=4, num_kv_heads=2, head_dim=16, num_splits=4, block_k=32,
                   quant_mode=mode)
    jcfg, tcfg = j_params.AttentionConfig(**acfg_kw), t_params.AttentionConfig(**acfg_kw)
    rng = np.random.default_rng(6)
    jcache = j_cache.init_cache(2, 2, 2, 128, 16, quant_mode=mode, calibration_scale=5.0)
    chunk = rng.standard_normal((2, 2, 40, 16), dtype=np.float32)
    jcache = j_cache.advance(j_cache.append_prefill(jcache, 1, jnp.asarray(chunk),
                                                    jnp.asarray(-chunk)), 40)
    tcache = bridge.cache_from_numpy(**bridge_fields(jcache))
    q = rng.standard_normal((2, 4, 16), dtype=np.float32)
    kv = rng.standard_normal((2, 2, 16), dtype=np.float32)
    cos, sin = j_steps._rope_tables(jcfg, 128)
    ref, jcache = j_steps.attention_decode_step(jcfg, jcache, 1, jnp.asarray(q), jnp.asarray(kv),
                                                jnp.asarray(kv * 2), cos, sin)
    tcos, tsin = t_steps.rope_tables(tcfg, 128, device="cpu")
    out, tcache = t_steps.attention_decode_step(tcfg, tcache, 1, torch.from_numpy(q),
                                                torch.from_numpy(kv), torch.from_numpy(kv * 2),
                                                tcos, tsin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tcache.k.view(torch.uint8).numpy(), np.asarray(jcache.k).view(np.uint8))


def bridge_fields(jcache):
    return {name: np.asarray(getattr(jcache, name)) for name in bridge.CACHE_FIELDS}


@pytest.mark.parametrize("bias", [False, True])
def test_mha_fwd_matches_jax(bias):
    """The reference-API step: fused qkv in, one layer's decode attention
    out, the row appended in place."""
    acfg_kw = dict(num_q_heads=4, num_kv_heads=2, head_dim=16, num_splits=4, block_k=32)
    jcfg, tcfg = j_params.AttentionConfig(**acfg_kw), t_params.AttentionConfig(**acfg_kw)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 2, 2, 128, 16), dtype=np.float32)
    v = rng.standard_normal((3, 2, 2, 128, 16), dtype=np.float32)
    lengths = np.array([9, 70], np.int32)
    qkv = rng.standard_normal((2, 8, 16), dtype=np.float32)
    biases = [rng.standard_normal(n * 16, dtype=np.float32) if bias else None for n in (4, 2, 2)]
    jcache = j_cache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths))
    cos, sin = j_steps._rope_tables(jcfg, 128)
    ref, jcache = j_steps.mha_fwd(jcfg, jcache, 1, jnp.asarray(qkv), cos, sin,
                                  *[None if b is None else jnp.asarray(b) for b in biases])
    tcache = bridge.cache_from_numpy(k, v, lengths)
    tcos, tsin = t_steps.rope_tables(tcfg, 128, device="cpu")
    out, tcache = t_steps.mha_fwd(tcfg, tcache, 1, torch.from_numpy(qkv), tcos, tsin,
                                  *[None if b is None else torch.from_numpy(b) for b in biases])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tcache.lengths.numpy(), lengths)  # advance() is the caller's
    t_cache.advance(tcache)
    np.testing.assert_array_equal(tcache.lengths.numpy(), lengths + 1)


def test_split_fused_qkv_matches_jax():
    cfg_kw = dict(num_q_heads=4, num_kv_heads=2, head_dim=16)
    x = np.random.default_rng(4).standard_normal((3, 8 * 16), dtype=np.float32)
    ref = j_steps.split_fused_qkv(jnp.asarray(x), j_params.AttentionConfig(**cfg_kw))
    out = t_steps.split_fused_qkv(torch.from_numpy(x), t_params.AttentionConfig(**cfg_kw))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_sample_greedy_takes_the_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    np.testing.assert_array_equal(t_llama.sample(logits).numpy(),
                                  np.asarray(j_llama.sample(jnp.asarray(logits.numpy()))))
    assert t_llama.sample(logits).dtype == torch.int32
