"""The port's training path against the JAX package's, on the CPU.

Covered: K5's base-2 LSE (``flash_prefill(return_lse=True)``, causal and
not), the FA2 backward K12 (``flash_prefill_bwd`` through its plain twin,
fed JAX's own ``o`` and ``lse``), the differentiable ``flash_attention``,
``models/train`` (``forward_train``, ``loss_fn``, ``loss_and_grads``,
``train_step``, remat) and ``models/lora`` (``init_lora``, ``loss_fn``,
``merge``), at ``ModelConfig.tiny(dtype="float32")``; the attention options
of the variants (window, sinks, softcap) through the backward and
``flash_attention`` (tests/test_torch_train_variants.py trains the
families). The JAX side runs its
Pallas kernels in interpret mode; the model and the adapters are built by
the JAX package and reach the port through the numpy bridge, the inputs
come from a seeded numpy generator.

Tolerances (fp32 on both sides, sums in another order): the LSE and the
attention outputs 1e-5; backward gradients 2e-5 of each gradient's peak
(``tests/test_flash_bwd.py``'s tolerance); logits 2e-4 and parameter
gradients 5e-4 of each gradient's peak (``tests/test_train.py``'s); remat
against no remat 1e-5. The 8-step SGD trajectories compound the sums'
order through 8 updates: losses within 1e-4, params and momentum within
1e-4 of each leaf's peak. Integer results (token streams, refusals) and
the no-op of a zero-init adapter are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_cache
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.models import lora as j_lora
from starflashattention_tpu.models import train as j_train
from starflashattention_tpu.ops.flash_bwd import flash_attention as j_flash_attention
from starflashattention_tpu.ops.flash_bwd import flash_prefill_bwd as j_flash_prefill_bwd
from starflashattention_tpu.ops.flash_prefill import flash_prefill as j_flash_prefill
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import lora as t_lora
from starflashattention_tpu_torch.models import train as t_train
from starflashattention_tpu_torch.ops import flash_bwd as t_fb
from starflashattention_tpu_torch.ops import flash_prefill as t_fp
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.utils import bridge

torch.set_num_threads(1)

ATOL = 1e-5
BWD_RTOL = 2e-5
LOGIT_ATOL = 2e-4
GRAD_RTOL = 5e-4
STEP_TOL = 1e-4
LR = 0.2
STEPS = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _assert_tree_close(got, want, rtol):
    """Every leaf of the port's tree (torch) against JAX's (numpy), relative
    to each leaf's peak."""
    got_np = bridge.params_to_numpy(got)
    flat_g = jax.tree.leaves(got_np)
    flat_w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert jax.tree.structure(got_np) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape
        assert _rel_err(g, w) < rtol, _rel_err(g, w)


# ---------------------------------------------------------------- K5 LSE


def _lse_inputs(rng, b=3, hq=4, hkv=2, sq=24, skv=64, d=16):
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    q_off = np.array([0, 17, 5], np.int32)
    lengths = np.array([20, 17 + sq, 0], np.int32)  # row 0 ragged, row 2 empty
    return q, k, v, q_off, lengths


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_lse_matches_jax(rng, causal):
    q, k, v, q_off, lengths = _lse_inputs(rng)
    jo, jlse = j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                               causal=causal, q_offsets=jnp.asarray(q_off), block_q=8, block_k=128,
                               return_lse=True)
    o, lse = t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths), causal=causal,
                                q_offsets=_t(q_off), return_lse=True)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    jlse = np.asarray(jlse)
    empty = jlse > 1e38
    assert empty[2].all() and not empty[:2].any()  # the zero-length row, and only it
    np.testing.assert_array_equal(lse.numpy()[empty], np.float32(3e38))
    np.testing.assert_allclose(lse.numpy()[~empty], jlse[~empty], atol=ATOL, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)


def test_prefill_lse_default_call_unchanged(rng):
    """The call without the LSE returns the same output as before."""
    q, k, v, q_off, lengths = _lse_inputs(rng)
    out = t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths), q_offsets=_t(q_off))
    o, _ = t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths), q_offsets=_t(q_off), return_lse=True)
    torch.testing.assert_close(out, o, rtol=0, atol=0)


# ---------------------------------------------------------------- K12


_BWD_CASES = {  # B, Hq, Hkv, Sq, Skv, D, causal, window, q_offsets: tests/test_flash_bwd.py's shapes
    "gqa": (2, 4, 2, 48, 48, 32, True, None, None),
    "non_divisible_non_causal": (1, 2, 2, 33, 33, 32, False, None, None),
    "window": (2, 8, 2, 64, 64, 32, True, 16, None),
    "mqa": (2, 4, 1, 40, 40, 32, True, None, None),
    "chunked_q_offsets": (2, 4, 2, 16, 64, 32, True, None, (10, 32)),
}


def _bwd_inputs(rng, case):
    b, hq, hkv, sq, skv, d, causal, window, offs = _BWD_CASES[case]
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    if offs is None:
        q_off = np.zeros(b, np.int32)
        lengths = np.array([skv, max(1, skv - 13)][:b], np.int32)
    else:
        q_off = np.array(offs, np.int32)
        lengths = q_off + sq
    return q, k, v, do, lengths, q_off, causal, window


@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_bwd_plain_matches_jax(rng, case):
    q, k, v, do, lengths, q_off, causal, window = _bwd_inputs(rng, case)
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    jo, jlse = j_flash_prefill(*args, causal=causal, q_offsets=jnp.asarray(q_off), block_q=16,
                               block_k=16, return_lse=True, window=window)
    want = j_flash_prefill_bwd(*args[:3], jo, jlse, jnp.asarray(do), args[3], jnp.asarray(q_off),
                               causal=causal, block_q=16, block_k=16, window=window)
    got = t_fb.flash_prefill_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), _t(lengths), _t(q_off),
                                 causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_err(g.numpy(), w) < BWD_RTOL, (name, _rel_err(g.numpy(), w))


@pytest.mark.parametrize("case", ["gqa", "chunked_q_offsets"])
def test_flash_attention_grads_match_jax(rng, case):
    q, k, v, _, lengths, q_off, causal, _ = _bwd_inputs(rng, case)
    w = rng.standard_normal((q.shape[-1],), dtype=np.float32)
    sq = q.shape[2]
    # the loss reads only valid rows: a row past its sequence's length is
    # unspecified for both implementations
    rowmask = ((q_off[:, None] + np.arange(sq)[None, :]) < lengths[:, None])[:, None, :, None]

    def j_loss(q, k, v):
        o = j_flash_attention(q, k, v, jnp.asarray(lengths), causal=causal, q_offsets=jnp.asarray(q_off),
                              block_q=16, block_k=16, bwd_block_q=16, bwd_block_k=16)
        return jnp.sum(jnp.where(rowmask, o, 0.0) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = t_fb.flash_attention(tq, tk, tv, _t(lengths), causal=causal, q_offsets=_t(q_off))
    loss = (torch.where(_t(rowmask), o, 0.0) * _t(w)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), wnt) < BWD_RTOL, (name, _rel_err(g.numpy(), wnt))


def test_flash_attention_forward_is_flash_prefill(rng):
    q, k, v, _, lengths, q_off, causal, _ = _bwd_inputs(rng, "gqa")
    o = t_fb.flash_attention(_t(q), _t(k), _t(v), _t(lengths), causal=causal)
    torch.testing.assert_close(o, t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths)), rtol=0, atol=0)


# ---------------------------------------------------------------- the model


@functools.lru_cache(maxsize=None)
def _model():
    """(JAX cfg, port cfg, JAX params, the port's bridged params (a fresh
    copy is made by each caller that updates in place), JAX rope, port rope,
    the (2, 17) token batch)."""
    jc = j_params.ModelConfig.tiny(dtype="float32")
    tc = t_params.ModelConfig.tiny(dtype="float32")
    jp = j_llama.init_params(jc, jax.random.PRNGKey(0))
    batch = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 17)).astype(np.int32)
    return (jc, tc, jp, jax.tree.map(np.asarray, jp), j_llama.rope_tables(jc),
            t_llama.rope_tables(tc, device="cpu"), batch)


def _port_params():
    return bridge.params_from_numpy(_model()[3])


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(use_flash):
    jc, _, jp, _, (cos, sin), _, batch = _model()
    fn = jax.jit(jax.value_and_grad(j_train.loss_fn), static_argnames=("cfg", "use_flash"))
    loss, grads = fn(jp, jnp.asarray(batch), jc, cos, sin, use_flash=use_flash)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_train_matches_jax(use_flash):
    jc, tc, jp, _, (jcos, jsin), (cos, sin), batch = _model()
    want = j_train.forward_train(jp, jnp.asarray(batch[:, :-1]), jc, jcos, jsin, use_flash=use_flash)
    got = t_train.forward_train(_port_params(), _t(batch[:, :-1]), tc, cos, sin, use_flash=use_flash)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("use_flash", [True, False])
def test_grads_match_jax(use_flash):
    _, tc, _, _, _, (cos, sin), batch = _model()
    jloss, jgrads = _jax_loss_and_grads(use_flash)
    loss, grads = t_train.loss_and_grads(_port_params(), _t(batch), tc, cos, sin, use_flash=use_flash)
    assert abs(float(loss) - jloss) < 1e-5
    _assert_tree_close(grads, jgrads, GRAD_RTOL)


def test_remat_matches_no_remat():
    _, tc, _, _, _, (cos, sin), batch = _model()
    l1, g1 = t_train.loss_and_grads(_port_params(), _t(batch), tc, cos, sin, remat=True)
    l2, g2 = t_train.loss_and_grads(_port_params(), _t(batch), tc, cos, sin, remat=False)
    assert abs(float(l1) - float(l2)) < ATOL
    for a, b in zip(t_train.tree_leaves(g1), t_train.tree_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("remat", [True, False])
def test_remat_reruns_the_attention_forward(monkeypatch, remat):
    """Under remat the backward reruns each layer's forward: 2 L attention
    forwards with the LSE a step (L without), and L backwards."""
    _, tc, _, _, _, (cos, sin), batch = _model()
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = t_fb.flash_prefill, t_fb.flash_prefill_bwd

    def count_fwd(*args, **kw):
        calls["fwd"] += kw.get("return_lse", False)
        return fwd(*args, **kw)

    def count_bwd(*args, **kw):
        calls["bwd"] += 1
        return bwd(*args, **kw)

    monkeypatch.setattr(t_fb, "flash_prefill", count_fwd)
    monkeypatch.setattr(t_fb, "flash_prefill_bwd", count_bwd)
    t_train.loss_and_grads(_port_params(), _t(batch), tc, cos, sin, remat=remat)
    n = tc.num_layers
    assert calls == {"fwd": 2 * n if remat else n, "bwd": n}


def test_train_step_matches_jax():
    jc, tc, jp, _, (jcos, jsin), (cos, sin), batch = _model()
    jopt = jax.tree.map(jnp.zeros_like, jp)
    params = _port_params()
    momentum = t_train.tree_map(torch.zeros_like, params)
    jlosses, losses = [], []
    for _ in range(STEPS):
        jp, jopt, jloss = j_train.train_step(jp, jopt, jnp.asarray(batch), jc, jcos, jsin, LR)
        params, momentum, loss = t_train.train_step(params, momentum, _t(batch), tc, cos, sin, LR)
        jlosses.append(float(jloss))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, atol=STEP_TOL, rtol=0)
    _assert_tree_close(params, jp, STEP_TOL)
    _assert_tree_close(momentum, jopt, STEP_TOL)


def test_forward_train_matches_serving_prefill():
    """The training forward is the model the serving prefill runs: its
    last-position logits equal ``llama.prefill``'s on a fresh cache."""
    _, tc, _, _, _, (cos, sin), batch = _model()
    tokens = _t(batch[:, :-1])
    b, s = tokens.shape
    params = _port_params()
    want = t_train.forward_train(params, tokens, tc, cos, sin)[:, -1]
    cache = t_cache.init_cache(tc.num_layers, b, tc.num_kv_heads, tc.max_seq_len, tc.head_dim,
                               dtype=torch.float32, device="cpu")
    got, _ = t_llama.prefill(params, cache, tokens, torch.full((b,), s, dtype=torch.int32), cos, sin, tc)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


# ---------------------------------------------------------------- LoRA


@functools.lru_cache(maxsize=None)
def _adapters():
    """JAX adapters (rank 4) with b moved off zero, as tests/test_lora.py
    builds them, in numpy."""
    jc = _model()[0]
    ad = j_lora.init_lora(jc, jax.random.PRNGKey(1), rank=4)
    ad["layers"] = jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(jax.random.PRNGKey(2), x.shape), ad["layers"])
    return jax.tree.map(np.asarray, ad)


def test_lora_zero_init_is_exact_noop():
    _, tc, _, _, _, (cos, sin), batch = _model()
    ad = t_lora.init_lora(tc, torch.Generator().manual_seed(1), rank=4, device="cpu")
    assert all(float(ab["b"].abs().max()) == 0.0 for ab in ad["layers"].values())
    assert float(ad["scale"]) == 2.0  # alpha = 2 r
    params, tokens = _port_params(), _t(batch[:, :-1])
    base = t_train.forward_train(params, tokens, tc, cos, sin)
    with_ad = t_train.forward_train(params, tokens, tc, cos, sin, lora=ad)
    torch.testing.assert_close(with_ad, base, rtol=0, atol=0)


def test_lora_grads_match_jax_and_base_stays_frozen():
    jc, tc, jp, _, (jcos, jsin), (cos, sin), batch = _model()
    ad_np = _adapters()
    want_loss, want = jax.value_and_grad(j_lora.loss_fn, argnums=1)(
        jp, jax.tree.map(jnp.asarray, ad_np), jnp.asarray(batch), jc, jcos, jsin)
    params = _port_params()
    before = [p.clone() for p in t_train.tree_leaves(params)]
    ad = bridge.params_from_numpy(ad_np)
    loss, grads = t_lora.loss_and_grads(params, ad, _t(batch), tc, cos, sin)
    assert abs(float(loss) - float(want_loss)) < 1e-5
    _assert_tree_close(grads, want, GRAD_RTOL)
    losses = [float(loss)]
    for _ in range(5):  # adapter-only SGD, as tests/test_lora.py trains
        ad = t_train.tree_map(lambda x: x, ad)
        with torch.no_grad():
            for a, g in zip(t_train.tree_leaves(ad), t_train.tree_leaves(grads)):
                a.sub_(0.5 * g)
        loss, grads = t_lora.loss_and_grads(params, ad, _t(batch), tc, cos, sin)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for a, b in zip(t_train.tree_leaves(params), before):
        assert torch.equal(a, b)


def test_lora_merge_matches_adapted_forward_and_jax():
    jc, tc, jp, _, _, (cos, sin), batch = _model()
    ad_np = _adapters()
    params, ad = _port_params(), bridge.params_from_numpy(ad_np)
    merged = t_lora.merge(params, ad, tc)
    _assert_tree_close(merged, j_lora.merge(jp, jax.tree.map(jnp.asarray, ad_np), jc), 1e-6)
    tokens = _t(batch[:, :-1])
    runtime = t_train.forward_train(params, tokens, tc, cos, sin, lora=ad)
    folded = t_train.forward_train(merged, tokens, tc, cos, sin)
    torch.testing.assert_close(folded, runtime, rtol=0, atol=2e-3)


def test_lora_merged_generate_matches_jax():
    """Fine-tune, merge, serve: the merged model's greedy stream equals the
    JAX package's merged model's."""
    jc, tc, jp, _, _, _, _ = _model()
    ad_np = _adapters()
    prompts = np.random.default_rng(1).integers(0, jc.vocab_size, (3, 12)).astype(np.int32)
    lengths = np.array([12, 7, 1], np.int32)
    jmerged = j_lora.merge(jp, jax.tree.map(jnp.asarray, ad_np), jc)
    want = j_llama.generate(jmerged, jc, jnp.asarray(prompts), jnp.asarray(lengths), max_new_tokens=6)
    merged = t_lora.merge(_port_params(), bridge.params_from_numpy(ad_np), tc)
    got = t_llama.generate(merged, tc, prompts, lengths, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lora_merge_refuses_quantized_base():
    _, tc, _, _, _, _, _ = _model()
    ad = t_lora.init_lora(tc, torch.Generator().manual_seed(1), rank=4, device="cpu")
    qparams = t_llama.quantize_model_weights(_port_params(), "int8")
    with pytest.raises(ValueError, match="quantized"):
        t_lora.merge(qparams, ad, tc)


def test_lora_targets_validated():
    tc = t_params.ModelConfig.tiny(dtype="float32", num_experts=4, num_experts_per_tok=2)
    with pytest.raises(ValueError, match="not adaptable"):
        t_lora.init_lora(tc, targets=("w_gate_up",), device="cpu")
    assert set(t_lora.init_lora(tc, targets=("wqkv", "wo"), device="cpu")["layers"]) == {"wqkv", "wo"}


def test_bridge_carries_adapter_and_grad_trees():
    ad_np = _adapters()
    ad = bridge.params_from_numpy(ad_np)
    assert ad["scale"].shape == () and ad["layers"]["wqkv"]["a"].shape == ad_np["layers"]["wqkv"]["a"].shape
    back = bridge.params_to_numpy(ad)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ad_np)):
        np.testing.assert_array_equal(a, b)
    _, grads = _jax_loss_and_grads(True)
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(bridge.params_from_numpy(grads))),
                    jax.tree.leaves(grads)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- refusals


def test_training_refuses_unported_paths():
    _, tc, _, _, _, (cos, sin), batch = _model()
    params, tokens = _port_params(), _t(batch[:, :-1])
    with pytest.raises(TypeError, match="parallel.mesh.Axis"):  # TP trains: the axis, not its name
        t_train.forward_train(params, tokens, tc, cos, sin, axis_name="model")
    with pytest.raises(ValueError, match="context-parallel training requires the flash path"):
        t_train.forward_train(params, tokens, tc, cos, sin, use_flash=False, seq_axis_name=object())
    with pytest.raises(TypeError, match="parallel.mesh.Axis"):
        t_train.forward_train(params, tokens, tc, cos, sin, seq_axis_name="seq")
    deepseek = t_params.ModelConfig.tiny(dtype="float32", num_experts=4, num_experts_per_tok=2,
                                         router_pre_softmax=True, n_shared_experts=1)
    with pytest.raises(NotImplementedError, match="router_pre_softmax, n_shared_experts.*Queue 3"):
        t_train.forward_train(params, tokens, deepseek, cos, sin)
    mla = t_params.ModelConfig.tiny(dtype="float32", mla=True, head_dim=24, qk_nope_head_dim=16,
                                    qk_rope_head_dim=8, kv_lora_rank=32, v_head_dim=16, num_kv_heads=1)
    with pytest.raises(NotImplementedError, match="14c"):
        t_train.forward_train(params, tokens, mla, cos, sin)
    with pytest.raises(ValueError, match="dense weights"):
        t_train.forward_train(t_llama.quantize_model_weights(params, "int8"), tokens, tc, cos, sin)


@pytest.mark.parametrize("kwargs", [dict(window=8), dict(sinks=2, window=8), dict(softcap=30.0)])
def test_flash_attention_refuses_unported_options(rng, kwargs):
    """The options the variants train with: gradients through
    ``flash_attention`` against JAX's (``test_flash_attention_grads_match_jax``
    with the option on, on the chunked case: JAX gives a padded row whose
    band holds no valid key an LSE of -2.4e38 and NaN gradients, the port
    3e38 and zeros)."""
    q, k, v, _, lengths, q_off, causal, _ = _bwd_inputs(rng, "chunked_q_offsets")
    w = rng.standard_normal((q.shape[-1],), dtype=np.float32)
    rowmask = ((q_off[:, None] + np.arange(q.shape[2])[None, :]) < lengths[:, None])[:, None, :, None]

    def j_loss(q, k, v):
        o = j_flash_attention(q, k, v, jnp.asarray(lengths), causal=causal, q_offsets=jnp.asarray(q_off),
                              block_q=16, block_k=16, bwd_block_q=16, bwd_block_k=16, **kwargs)
        return jnp.sum(jnp.where(rowmask, o, 0.0) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = t_fb.flash_attention(tq, tk, tv, _t(lengths), causal=causal, q_offsets=_t(q_off), **kwargs)
    got = torch.autograd.grad((torch.where(_t(rowmask), o, 0.0) * _t(w)).sum(), (tq, tk, tv))
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), wnt) < BWD_RTOL, (name, _rel_err(g.numpy(), wnt))


def test_flash_attention_refuses_kv_offset(rng):
    """``kv_offset`` (ring context parallelism) is ported: with a window and
    sinks the backward's gradients equal JAX's on a chunk whose sinks'
    boundary it moves; the variants with ``causal=False`` are not ported."""
    q, k, v, do, lengths, _, _, _ = _bwd_inputs(rng, "gqa")
    kw = dict(causal=True, window=8, sinks=6, kv_offset=4)
    jo, jlse = j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                               block_q=8, block_k=128, return_lse=True, **kw)
    q_off = jnp.zeros((q.shape[0],), jnp.int32)
    want = j_flash_prefill_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jlse, jnp.asarray(do),
                               jnp.asarray(lengths), q_off, block_q=8, block_k=128, **kw)
    got = t_fb.flash_prefill_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), _t(lengths), **kw)
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), wnt) < BWD_RTOL, (name, _rel_err(g.numpy(), wnt))
    with pytest.raises(NotImplementedError, match="Queue 2"):
        t_fb.flash_attention(_t(q), _t(k), _t(v), _t(lengths), causal=False, window=8)


def test_init_lora_does_not_fall_back_to_the_cpu():
    """Without a card, ``init_lora`` given no device raises instead of
    quietly running on the CPU (the training functions run where the params
    live)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lora.init_lora(_model()[1])
