"""Training on the attention variants through the port against the JAX
package's, on the CPU.

Covered: K5's base-2 LSE with the sliding window, sinks and softcap
(``flash_prefill(return_lse=True)``, ragged lengths, chunked q offsets, D 16
and 32); the FA2 backward K12 with the same options (``flash_prefill_bwd``
through its plain twin, fed JAX's own ``o`` and ``lse``); the
differentiable ``flash_attention`` against JAX's, and with sinks against
JAX's ``mha_reference`` (as tests/test_sinks.py holds JAX's); and
``models/train`` / ``models/lora`` on tiny Mistral with and without sinks,
Gemma and Gemma-2 (the families of tests/test_torch_families.py, at 40
tokens so that the bands are live): logits, every parameter's gradient
with the flash path and the plain one, Gemma-2 with sinks (which JAX
training takes and serving refuses), an 8-step SGD trajectory, LoRA
gradients and the merged model's greedy stream, and the training forward
against the serving prefill. The JAX side runs its Pallas kernels in
interpret mode; the port runs the plain twins of its kernels, which a CPU
tensor takes.

Tolerances, as tests/test_torch_train.py's (fp32 on both sides, sums in
another order): the LSE and the attention outputs 1e-5; backward gradients
2e-5 of each gradient's peak; logits 2e-4 and parameter gradients 5e-4 of
each gradient's peak; losses 1e-5; the 8-step trajectory 1e-4 (losses,
and each leaf of the params and the momentum against its peak); the
training forward against the serving prefill 2e-3 (as there). Integer
results (token streams, empty LSE rows) are exact.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.core.reference import mha_reference as j_mha_reference
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.models import lora as j_lora
from starflashattention_tpu.models import train as j_train
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import lora as t_lora
from starflashattention_tpu_torch.models import train as t_train
from starflashattention_tpu_torch.ops import flash_bwd as t_fb
from starflashattention_tpu_torch.ops import flash_prefill as t_fp
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.utils import bridge

# the JAX package's ops/__init__ re-exports functions under the module names
j_fp, j_fb = (importlib.import_module(f"starflashattention_tpu.ops.{name}")
              for name in ("flash_prefill", "flash_bwd"))

torch.set_num_threads(1)

ATOL = 1e-5
BWD_RTOL = 2e-5
LOGIT_ATOL = 2e-4
GRAD_RTOL = 5e-4
STEP_TOL = 1e-4
LR = 0.2
STEPS = 8

# (window, sinks, softcap): a band, sinks inside a band tile and past one,
# a softcap, all of them (tests/test_torch_variants.py's)
VARIANTS = {
    "window": (48, 0, None),
    "window+sinks": (48, 4, None),
    "window+wide-sinks": (40, 70, None),
    "softcap": (None, 0, 30.0),
    "all": (48, 4, 50.0),
}

_GEMMA = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=4, num_q_heads=2,
              num_kv_heads=1, head_dim=16, max_seq_len=64, dtype="float32", block_k=16)
FAMILIES = {  # tests/test_torch_families.py's
    "mistral": ("tiny", dict(sliding_window=32, num_splits=1, pages_per_compute_block=2)),
    "mistral+sinks": ("tiny", dict(sliding_window=32, attention_sinks=4, num_splits=1,
                                   pages_per_compute_block=2)),
    "gemma": ("gemma_7b", dict(_GEMMA, num_splits=4)),
    "gemma2": ("gemma2_9b", dict(_GEMMA, sliding_window=8, pages_per_compute_block=2)),
    "gemma2+sinks": ("gemma2_9b", dict(_GEMMA, sliding_window=8, attention_sinks=2)),
}
TOKENS = 41  # a (2, 41) batch: 40 positions, past Mistral's window of 32 and Gemma-2's of 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _opts(name):
    w, sk, cap = VARIANTS[name]
    return dict(window=w, sinks=sk, softcap=cap)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _assert_tree_close(got, want, rtol):
    """Every leaf of the port's tree (torch) against JAX's (numpy), relative
    to each leaf's peak."""
    got_np = bridge.params_to_numpy(got)
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        assert g.shape == w.shape
        assert _rel_err(g, w) < rtol, _rel_err(g, w)


# ---------------------------------------------------------------- K5 with the LSE


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_lse_variants_match_jax(rng, variant, d):
    """Chunked offsets (96, 30, 0), ragged lengths (192, 110) and a
    zero-length sequence, whose rows hold 3e38 exactly, as JAX's."""
    b, hq, hkv, sq, skv = 3, 4, 2, 96, 192
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    q_off = np.array([96, 30, 0], np.int32)
    lengths = np.array([192, 110, 0], np.int32)
    jo, jlse = j_fp.flash_prefill(_j(q), _j(k), _j(v), _j(lengths), q_offsets=_j(q_off), block_q=32,
                                  block_k=64, return_lse=True, **_opts(variant))
    o, lse = t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths), q_offsets=_t(q_off), return_lse=True,
                                **_opts(variant))
    jlse = np.asarray(jlse)
    empty = jlse > 1e38
    assert empty[2].all() and not empty[:2].any()
    np.testing.assert_array_equal(lse.numpy()[empty], np.float32(3e38))
    np.testing.assert_allclose(lse.numpy()[~empty], jlse[~empty], atol=ATOL, rtol=0)
    np.testing.assert_allclose(o.numpy()[:2], np.asarray(jo)[:2], atol=ATOL, rtol=0)


# ---------------------------------------------------------------- K12


def _bwd_inputs(rng, d=32):
    """B=2, Hq=4, Hkv=2: a 48-row chunk at offset 48 of a 96-row sequence,
    and one at offset 10 of a 50-row sequence (10 rows past its length)."""
    q = rng.standard_normal((2, 4, 48, d), dtype=np.float32)
    k = rng.standard_normal((2, 2, 96, d), dtype=np.float32)
    v = rng.standard_normal((2, 2, 96, d), dtype=np.float32)
    do = rng.standard_normal((2, 4, 48, d), dtype=np.float32)
    return q, k, v, do, np.array([96, 50], np.int32), np.array([48, 10], np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bwd_variants_plain_matches_jax(rng, variant):
    q, k, v, do, lengths, q_off = _bwd_inputs(rng)
    opts = _opts(variant)
    args = [_j(a) for a in (q, k, v, lengths)]
    jo, jlse = j_fp.flash_prefill(*args, q_offsets=_j(q_off), block_q=16, block_k=16, return_lse=True,
                                  **opts)
    want = j_fb.flash_prefill_bwd(*args[:3], jo, jlse, _j(do), args[3], _j(q_off), block_q=16,
                                  block_k=16, **opts)
    got = t_fb.flash_prefill_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), _t(lengths), _t(q_off),
                                 **opts)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_err(g.numpy(), w) < BWD_RTOL, (name, _rel_err(g.numpy(), w))


def _valid_rows(lengths, q_off, sq):
    return ((q_off[:, None] + np.arange(sq)[None, :]) < lengths[:, None])[:, None, :, None]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flash_attention_variant_grads_match_jax(rng, variant):
    """Gradients of a loss over the valid rows (a row past its sequence's
    length is unspecified for both implementations)."""
    q, k, v, _, lengths, q_off = _bwd_inputs(rng)
    w = rng.standard_normal((q.shape[-1],), dtype=np.float32)
    rowmask = _valid_rows(lengths, q_off, q.shape[2])
    opts = _opts(variant)

    def j_loss(q, k, v):
        o = j_fb.flash_attention(q, k, v, _j(lengths), q_offsets=_j(q_off), block_q=16, block_k=16,
                                 bwd_block_q=16, bwd_block_k=16, **opts)
        return jnp.sum(jnp.where(rowmask, o, 0.0) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = t_fb.flash_attention(tq, tk, tv, _t(lengths), q_offsets=_t(q_off), **opts)
    got = torch.autograd.grad((torch.where(_t(rowmask), o, 0.0) * _t(w)).sum(), (tq, tk, tv))
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), wnt) < BWD_RTOL, (name, _rel_err(g.numpy(), wnt))


def test_flash_attention_sinks_grads_match_reference(rng):
    """tests/test_sinks.py's check on the port: the sinks flow through the
    backward, against autograd of JAX's ``mha_reference``."""
    b, hq, hkv, s, d, w, sk = 1, 4, 2, 128, 32, 48, 16
    q = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    wgt = rng.standard_normal((b, hq, s, d), dtype=np.float32)

    def j_loss(q, k, v):
        return jnp.sum(j_mha_reference(q, k, v, causal=True, sliding_window=w, attention_sinks=sk) * wgt)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = t_fb.flash_attention(tq, tk, tv, window=w, sinks=sk)
    got = torch.autograd.grad((o * _t(wgt)).sum(), (tq, tk, tv))
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), wnt) < BWD_RTOL, (name, _rel_err(g.numpy(), wnt))


# ---------------------------------------------------------------- the families


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
def _model(family):
    """(JAX cfg, port cfg, JAX params, the params in numpy (the port bridges
    a fresh copy from them), JAX rope, port rope, the (2, 41) batch)."""
    jc, tc = _cfgs(family)
    params = _perturb_norms(jax.tree.map(np.asarray, j_llama.init_params(jc, jax.random.PRNGKey(0))),
                            seed=1)
    batch = np.random.default_rng(3).integers(0, jc.vocab_size, (2, TOKENS)).astype(np.int32)
    return (jc, tc, jax.tree.map(jnp.asarray, params), params, j_llama.rope_tables(jc),
            t_llama.rope_tables(tc, device="cpu"), batch)


def _port_params(family):
    return bridge.params_from_numpy(_model(family)[3])


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(family, use_flash):
    jc, _, jp, _, (cos, sin), _, batch = _model(family)
    fn = jax.jit(jax.value_and_grad(j_train.loss_fn), static_argnames=("cfg", "use_flash"))
    loss, grads = fn(jp, _j(batch), jc, cos, sin, use_flash=use_flash)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_train_variants_match_jax(family, use_flash):
    jc, tc, jp, _, (jcos, jsin), (cos, sin), batch = _model(family)
    want = j_train.forward_train(jp, _j(batch[:, :-1]), jc, jcos, jsin, use_flash=use_flash)
    got = t_train.forward_train(_port_params(family), _t(batch[:, :-1]), tc, cos, sin, use_flash=use_flash)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_variant_grads_match_jax(family, use_flash):
    """Every parameter's gradient, the post-norm stacks included."""
    _, tc, _, _, _, (cos, sin), batch = _model(family)
    jloss, jgrads = _jax_loss_and_grads(family, use_flash)
    loss, grads = t_train.loss_and_grads(_port_params(family), _t(batch), tc, cos, sin, use_flash=use_flash)
    assert abs(float(loss) - jloss) < 1e-5
    _assert_tree_close(grads, jgrads, GRAD_RTOL)
    if tc.post_norms:
        assert float(grads["layers"]["post_attn_norm"].abs().max()) > 0


def test_gemma2_with_sinks_trains_where_serving_refuses():
    """Gemma-2 with 2 sinks: the sinks ride the sliding layers' window in
    training (JAX's ``_windowed_attn``), while serving refuses sinks with a
    per-layer window; the flash path's logits and loss equal the plain
    path's and JAX's."""
    _, tc, _, _, _, (cos, sin), batch = _model("gemma2+sinks")
    with pytest.raises(ValueError, match="STATIC window"):
        t_llama._layer_window(tc, 0)
    params, tokens = _port_params("gemma2+sinks"), _t(batch[:, :-1])
    flash = t_train.forward_train(params, tokens, tc, cos, sin, use_flash=True)
    plain = t_train.forward_train(params, tokens, tc, cos, sin, use_flash=False)
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), atol=LOGIT_ATOL, rtol=0)
    no_sinks = t_train.forward_train(_port_params("gemma2"), tokens, _cfgs("gemma2")[1], cos, sin)
    assert float((flash - no_sinks).abs().max()) > 100 * LOGIT_ATOL  # the sinks move the logits
    jloss, _ = _jax_loss_and_grads("gemma2+sinks", True)
    assert abs(float(t_train.loss_fn(params, _t(batch), tc, cos, sin)) - jloss) < 1e-5


def test_gemma2_train_step_trajectory_matches_jax():
    jc, tc, jp, _, (jcos, jsin), (cos, sin), batch = _model("gemma2")
    jopt = jax.tree.map(jnp.zeros_like, jp)
    params = _port_params("gemma2")
    momentum = t_train.tree_map(torch.zeros_like, params)
    step = jax.jit(j_train.train_step, static_argnames=("cfg",))
    jlosses, losses = [], []
    for _ in range(STEPS):
        jp, jopt, jloss = step(jp, jopt, _j(batch), jc, jcos, jsin, LR)
        params, momentum, loss = t_train.train_step(params, momentum, _t(batch), tc, cos, sin, LR)
        jlosses.append(float(jloss))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, atol=STEP_TOL, rtol=0)
    _assert_tree_close(params, jp, STEP_TOL)
    _assert_tree_close(momentum, jopt, STEP_TOL)


@functools.lru_cache(maxsize=None)
def _adapters():
    """JAX adapters (rank 4) for the tiny Gemma-2, with b moved off zero."""
    jc = _model("gemma2")[0]
    ad = j_lora.init_lora(jc, jax.random.PRNGKey(1), rank=4)
    ad["layers"] = jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(jax.random.PRNGKey(2), x.shape), ad["layers"])
    return jax.tree.map(np.asarray, ad)


def test_gemma2_lora_grads_match_jax_and_base_stays_frozen():
    jc, tc, jp, _, (jcos, jsin), (cos, sin), batch = _model("gemma2")
    ad_np = _adapters()
    fn = jax.jit(jax.value_and_grad(j_lora.loss_fn, argnums=1), static_argnames=("cfg",))
    want_loss, want = fn(jp, jax.tree.map(_j, ad_np), _j(batch), jc, jcos, jsin)
    params = _port_params("gemma2")
    before = [p.clone() for p in t_train.tree_leaves(params)]
    loss, grads = t_lora.loss_and_grads(params, bridge.params_from_numpy(ad_np), _t(batch), tc, cos, sin)
    assert abs(float(loss) - float(want_loss)) < 1e-5
    _assert_tree_close(grads, want, GRAD_RTOL)
    for a, b in zip(t_train.tree_leaves(params), before):
        assert torch.equal(a, b)


def test_gemma2_lora_merged_generate_matches_jax():
    """Merge the adapters and serve: the merged Gemma-2's greedy stream
    equals the JAX package's merged model's, and its training logits the
    adapted forward's."""
    jc, tc, jp, _, _, (cos, sin), batch = _model("gemma2")
    ad_np = _adapters()
    jmerged = j_lora.merge(jp, jax.tree.map(_j, ad_np), jc)
    params, ad = _port_params("gemma2"), bridge.params_from_numpy(ad_np)
    merged = t_lora.merge(params, ad, tc)
    _assert_tree_close(merged, jmerged, 1e-6)
    tokens = _t(batch[:, :-1])
    torch.testing.assert_close(t_train.forward_train(merged, tokens, tc, cos, sin),
                               t_train.forward_train(params, tokens, tc, cos, sin, lora=ad), rtol=0, atol=2e-3)
    prompts = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 20)).astype(np.int32)
    lengths = np.array([20, 13], np.int32)
    want = j_llama.generate(jmerged, jc, _j(prompts), _j(lengths), max_new_tokens=6)
    got = t_llama.generate(merged, tc, prompts, lengths, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", ["mistral", "mistral+sinks", "gemma", "gemma2"])
def test_forward_train_matches_serving_prefill(family):
    """The training forward is the model the serving prefill runs (windows,
    sinks, softcaps, post-norms, GeGLU, the embedding scale): its
    last-position logits equal ``llama.prefill``'s on a fresh cache."""
    _, tc, _, _, _, (cos, sin), batch = _model(family)
    tokens = _t(batch[:, :-1])
    b, s = tokens.shape
    params = _port_params(family)
    want = t_train.forward_train(params, tokens, tc, cos, sin)[:, -1]
    hkv, d = tc.kv_cache_dims()
    cache = t_cache.init_cache(tc.num_layers, b, hkv, tc.max_seq_len, d, dtype=torch.float32, device="cpu")
    got, _ = t_llama.prefill(params, cache, tokens, torch.full((b,), s, dtype=torch.int32), cos, sin, tc)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
