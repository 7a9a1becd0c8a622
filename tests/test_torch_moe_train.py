"""The port's MoE training against the JAX package's, on the CPU.

Covered: ``models/train._moe_mlp_train`` (output and vjp, with the router,
both expert stacks and the activations as inputs, and a router tie that
must go to the lower expert), ``forward_train`` (through the flash path and
the plain attention), ``loss_and_grads``, remat, an 8-step ``train_step``
trajectory, LoRA on an MoE base (``lora.loss_and_grads``, ``merge`` then
the serving prefill), Qwen3-MoE's QK-norm, and the refusal of DeepSeek's
routing knobs, which JAX's ``_moe_mlp_train`` accepts and ignores. Model:
``ModelConfig.tiny(dtype="float32", num_experts=4, num_experts_per_tok=2)``
built by the JAX package, bridged to the port as numpy; inputs from a
seeded numpy generator. The JAX side runs its Pallas kernels in interpret
mode. (The TP x DP and CP twins run in the gloo worlds of
``tests/test_torch_tp_train.py`` and ``tests/test_torch_parallel.py``.)

Tolerances (fp32 on both sides, sums in another order), as
``tests/test_torch_train.py``: the MoE's output and vjp 1e-5 of each
array's peak; logits 2e-4; parameter gradients 5e-4 of each gradient's
peak; remat against no remat 1e-5; the 8-step trajectory 1e-4 (losses,
and params and momentum of each leaf's peak); the merged model's prefill
against the adapted forward 2e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.models import lora as j_lora
from starflashattention_tpu.models import train as j_train
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import lora as t_lora
from starflashattention_tpu_torch.models import train as t_train
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.utils import bridge

torch.set_num_threads(1)

MOE = dict(dtype="float32", num_experts=4, num_experts_per_tok=2)
MOE_RTOL = 1e-5
LOGIT_ATOL = 2e-4
GRAD_RTOL = 5e-4
REMAT_ATOL = 1e-5
STEP_TOL = 1e-4
MERGE_ATOL = 2e-3
LR = 0.2
STEPS = 8
EXPERT_LEAVES = ("moe_router", "moe_gate_up", "moe_down")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _assert_tree_close(got, want, rtol):
    """Every leaf of the port's tree (torch) against JAX's, relative to each
    leaf's peak."""
    got_np = bridge.params_to_numpy(got)
    want_np = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got_np) == jax.tree.structure(want_np)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_np), jax.tree.leaves(got_np)):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert _rel_err(g, w) < rtol, (jax.tree_util.keystr(path), _rel_err(g, w))


def _model(qk_norm=False):
    """(JAX cfg, port cfg, JAX params, their numpy copy, JAX rope, port
    rope, the (2, 17) token batch) of the tiny MoE, with Qwen3-MoE's
    QK-norm or without."""
    return _build(bool(qk_norm))


@functools.lru_cache(maxsize=None)
def _build(qk_norm):
    jc = j_params.ModelConfig.tiny(**MOE, qk_norm=qk_norm)
    tc = t_params.ModelConfig.tiny(**MOE, qk_norm=qk_norm)
    jp = j_llama.init_params(jc, jax.random.PRNGKey(0))
    batch = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 17)).astype(np.int32)
    return (jc, tc, jp, jax.tree.map(np.asarray, jp), j_llama.rope_tables(jc),
            t_llama.rope_tables(tc, device="cpu"), batch)


def _port_params(qk_norm=False):
    return bridge.params_from_numpy(_model(qk_norm)[3])


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(qk_norm=False):
    jc, _, jp, _, (cos, sin), _, batch = _model(qk_norm)
    fn = jax.jit(jax.value_and_grad(j_train.loss_fn), static_argnames=("cfg",))
    loss, grads = fn(jp, jnp.asarray(batch), jc, cos, sin)
    return float(loss), jax.tree.map(np.asarray, grads)


# ---------------------------------------------------------------- the MoE block


def _moe_inputs(tie):
    """Activations (2, 9, H) and one layer's router and expert stacks from a
    seeded generator. With ``tie`` the router's columns are v * (2, 1, 1,
    -1): every token's logits tie experts 1 and 2 at the top-2 boundary
    (behind expert 0 where h . v > 0, behind expert 3 where it is < 0)."""
    cfg = _model()[0]
    h_dim, inter, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    rng = np.random.default_rng(7 if tie else 5)
    h = rng.standard_normal((2, 9, h_dim), dtype=np.float32)
    router = rng.standard_normal((h_dim, e), dtype=np.float32) * 0.3
    if tie:
        router = router[:, :1] * np.array([2.0, 1.0, 1.0, -1.0], np.float32)
    gate_up = (rng.standard_normal((e, h_dim, 2 * inter)) / np.sqrt(h_dim)).astype(np.float32)
    down = (rng.standard_normal((e, inter, h_dim)) / np.sqrt(inter)).astype(np.float32)
    ct = rng.standard_normal((2, 9, h_dim), dtype=np.float32)
    return h, router, gate_up, down, ct


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "router_tie"])
def test_moe_mlp_train_and_vjp_match_jax(tie):
    """The block alone: its output, and its vjp with respect to the
    activations, the router and both expert stacks, against JAX's
    ``_moe_mlp_train``. Under the tie JAX's ``lax.top_k`` and the port's
    stable sort both pick expert 1 over expert 2, so the router's gradient
    reaches column 1 and not column 2."""
    jc, tc = _model()[:2]
    h, router, gate_up, down, ct = _moe_inputs(tie)

    def j_fn(h, r, g, d):
        return j_train._moe_mlp_train(h, {"moe_router": r, "moe_gate_up": g, "moe_down": d}, jc)

    want, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (h, router, gate_up, down)))
    want_grads = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_() for a in (h, router, gate_up, down)]
    layers = {"moe_router": [leaves[1]], "moe_gate_up": [leaves[2]], "moe_down": [leaves[3]]}
    got = t_train._moe_mlp_train(leaves[0], layers, 0, tc)
    grads = torch.autograd.grad((got * _t(ct)).sum(), leaves)
    assert got.shape == h.shape and got.dtype == torch.float32
    assert _rel_err(got.detach().numpy(), want) < MOE_RTOL
    for name, g, w in zip(("h", "router", "gate_up", "down"), grads, want_grads):
        assert _rel_err(g.numpy(), w) < MOE_RTOL, (name, _rel_err(g.numpy(), w))
    if tie:
        logits = _t(h) @ _t(router)
        assert torch.equal(logits[..., 1], logits[..., 2])
        g_router = grads[1].numpy()
        assert np.abs(g_router[:, 1]).max() > 0 and np.abs(g_router[:, 2]).max() == 0
        assert np.abs(grads[2].numpy()[2]).max() == 0  # expert 2 is never picked


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("use_flash", [True, False])
def test_moe_forward_train_matches_jax(use_flash):
    jc, tc, jp, _, (jcos, jsin), (cos, sin), batch = _model()
    want = j_train.forward_train(jp, jnp.asarray(batch[:, :-1]), jc, jcos, jsin, use_flash=use_flash)
    got = t_train.forward_train(_port_params(), _t(batch[:, :-1]), tc, cos, sin, use_flash=use_flash)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["mixtral", "qwen3_moe"])
def test_moe_grads_match_jax(qk_norm):
    """Every gradient against ``jax.value_and_grad(loss_fn)``, the router
    and both expert stacks among them and non-zero in every layer; with
    ``qk_norm`` Qwen3-MoE's form (the q / k norms before RoPE)."""
    _, tc, _, _, _, (cos, sin), batch = _model(qk_norm)
    jloss, jgrads = _jax_loss_and_grads(qk_norm)
    loss, grads = t_train.loss_and_grads(_port_params(qk_norm), _t(batch), tc, cos, sin)
    assert abs(float(loss) - jloss) < 1e-5
    _assert_tree_close(grads, jgrads, GRAD_RTOL)
    for name in EXPERT_LEAVES + (("q_norm", "k_norm") if qk_norm else ()):
        g = grads["layers"][name]
        assert all(float(g[i].abs().max()) > 0 for i in range(tc.num_layers)), name
    # every expert of every layer is picked by some token of the batch
    assert all(float(grads["layers"]["moe_down"][i, e].abs().max()) > 0
               for i in range(tc.num_layers) for e in range(tc.num_experts))


def test_moe_remat_matches_no_remat():
    """The backward's rerun of each layer routes as its forward did."""
    _, tc, _, _, _, (cos, sin), batch = _model()
    l1, g1 = t_train.loss_and_grads(_port_params(), _t(batch), tc, cos, sin, remat=True)
    l2, g2 = t_train.loss_and_grads(_port_params(), _t(batch), tc, cos, sin, remat=False)
    assert abs(float(l1) - float(l2)) < REMAT_ATOL
    for a, b in zip(t_train.tree_leaves(g1), t_train.tree_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=0, atol=REMAT_ATOL)


def test_moe_train_step_matches_jax():
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


def test_moe_forward_train_matches_serving_prefill():
    """The training forward is the MoE model the serving prefill runs: its
    last-position logits equal ``llama.prefill``'s on a fresh cache."""
    _, tc, _, _, _, (cos, sin), batch = _model()
    tokens = _t(batch[:, :-1])
    b, s = tokens.shape
    params = _port_params()
    want = t_train.forward_train(params, tokens, tc, cos, sin)[:, -1]
    cache = t_cache.init_cache(tc.num_layers, b, tc.num_kv_heads, tc.max_seq_len, tc.head_dim,
                               dtype=torch.float32, device="cpu")
    got, _ = t_llama.prefill(params, cache, tokens, torch.full((b,), s, dtype=torch.int32), cos, sin, tc)
    torch.testing.assert_close(got, want, rtol=0, atol=MERGE_ATOL)


# ---------------------------------------------------------------- LoRA on an MoE base


@functools.lru_cache(maxsize=None)
def _adapters():
    """JAX adapters (rank 4) on the MoE base, ``wqkv`` and ``wo`` (JAX
    freezes the expert stacks), b moved off zero."""
    jc = _model()[0]
    ad = j_lora.init_lora(jc, jax.random.PRNGKey(1), rank=4, targets=("wqkv", "wo"))
    ad["layers"] = jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(jax.random.PRNGKey(2), x.shape), ad["layers"])
    return jax.tree.map(np.asarray, ad)


def test_moe_lora_grads_match_jax_and_base_stays_frozen():
    jc, tc, jp, _, (jcos, jsin), (cos, sin), batch = _model()
    ad_np = _adapters()
    fn = jax.jit(jax.value_and_grad(j_lora.loss_fn, argnums=1), static_argnames=("cfg",))
    want_loss, want = fn(jp, jax.tree.map(jnp.asarray, ad_np), jnp.asarray(batch), jc, jcos, jsin)
    params = _port_params()
    before = [p.clone() for p in t_train.tree_leaves(params)]
    loss, grads = t_lora.loss_and_grads(params, bridge.params_from_numpy(ad_np), _t(batch), tc, cos, sin)
    assert abs(float(loss) - float(want_loss)) < 1e-5
    _assert_tree_close(grads, want, GRAD_RTOL)
    assert set(grads["layers"]) == {"wqkv", "wo"}
    for a, b in zip(t_train.tree_leaves(params), before):
        assert torch.equal(a, b)


def test_moe_lora_merge_then_prefill_matches_adapted_forward():
    """``lora.merge`` on the MoE base (the expert stacks untouched), then
    the serving prefill: its last-position logits against the adapted
    ``forward_train``'s; the merged tree against JAX's merge."""
    jc, tc, jp, _, _, (cos, sin), batch = _model()
    ad_np = _adapters()
    params, ad = _port_params(), bridge.params_from_numpy(ad_np)
    merged = t_lora.merge(params, ad, tc)
    _assert_tree_close(merged, j_lora.merge(jp, jax.tree.map(jnp.asarray, ad_np), jc), 1e-6)
    for name in EXPERT_LEAVES:
        assert merged["layers"][name] is params["layers"][name]
    tokens = _t(batch[:, :-1])
    b, s = tokens.shape
    want = t_train.forward_train(params, tokens, tc, cos, sin, lora=ad)[:, -1]
    cache = t_cache.init_cache(tc.num_layers, b, tc.num_kv_heads, tc.max_seq_len, tc.head_dim,
                               dtype=torch.float32, device="cpu")
    got, _ = t_llama.prefill(merged, cache, tokens, torch.full((b,), s, dtype=torch.int32), cos, sin, tc)
    torch.testing.assert_close(got, want, rtol=0, atol=MERGE_ATOL)


# ---------------------------------------------------------------- DeepSeek's routing


_DEEPSEEK_KNOBS = {
    "router_pre_softmax": dict(router_pre_softmax=True, routed_scaling_factor=1.5),
    "n_shared_experts": dict(n_shared_experts=1),
    "first_k_dense": dict(first_k_dense=1, dense_inter_size=96),
}


@pytest.mark.parametrize("knob", list(_DEEPSEEK_KNOBS))
def test_deepseek_routing_refused_where_jax_ignores_it(knob):
    """JAX's training forward takes each DeepSeek routing knob and trains
    Mixtral's routing regardless (no oracle: ROADMAP Queue 3); the port
    refuses it, alone and under LoRA, before any work."""
    jc = j_params.ModelConfig.tiny(**MOE, **_DEEPSEEK_KNOBS[knob])
    tc = t_params.ModelConfig.tiny(**MOE, **_DEEPSEEK_KNOBS[knob])
    jp = j_llama.init_params(jc, jax.random.PRNGKey(0))
    batch = _model()[6]
    cos, sin = j_llama.rope_tables(jc)
    logits = j_train.forward_train(jp, jnp.asarray(batch[:, :-1]), jc, cos, sin, use_flash=False)
    assert bool(jnp.isfinite(logits).all())
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    tcos, tsin = t_llama.rope_tables(tc, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{knob}.*Queue 3"):
        t_train.loss_and_grads(params, _t(batch), tc, tcos, tsin)
    ad = t_lora.init_lora(tc, torch.Generator().manual_seed(1), rank=4, targets=("wqkv", "wo"), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 3"):
        t_lora.loss_and_grads(params, ad, _t(batch), tc, tcos, tsin)
