"""Llama-family GQA transformer, dense-GQA subset — twin of the JAX
``models/llama.py``.

Greedy ``generate`` = ``prefill`` + repeated ``decode_step``; the serving
engines' entry points ``prefill_serving`` / ``decode_multi`` (contiguous
cache) and ``prefill_serving_paged`` / ``decode_multi_paged`` (paged
pools) take per-row ``active`` / ``reset`` masks, and so do the
speculative rounds ``spec_decode_multi`` (prompt-lookup drafts) and
``spec_decode_multi_draft`` (a draft model), whose verify step attends T
tokens a sequence at once. All use the JAX
package's parameter layout: layer weights stacked on a leading (L, ...) axis
and used as ``x @ w`` (so weights bridge by copy, never by transpose).
Quantized projections stay stacked and reach their kernel with a layer
index, so no per-layer copy is made: int8 / fp8 weights ``quant_matmul``,
int4 weights ``quant_matmul_int4``; with ``cfg.w8a8_prefill``, prefill rows
(>= 256) of int8 and int4 weights take ``quant_matmul_w8a8`` /
``quant_matmul_w4a8`` instead. Layers run in a Python loop (PyTorch is
eager; the JAX package scans).

With ``cfg.quant_mode`` "int8" / "fp8" the KV cache holds quantized values
with fixed per-head scales: new rows are quantized before the appends, the
decode attentions fold the scales around their kernels, and the prefill
attends dequantized rows.

The cache is updated IN PLACE: every entry point writes the new K/V rows
into the cache's tensors and advances ``cache.lengths``, where the JAX
package donates the cache to its jitted step and returns a new one. Each
returns the same cache object for call-site parity.

On CUDA tensors every projection of a quantized model, the cache appends
(contiguous, paged and the verify step's block) and the attentions
(prefill, contiguous and paged decode, verify) run on the hand-written
kernels of ``ops/``; on CPU
tensors the same code runs their plain versions.

The attention variants of the Mistral, Gemma and Gemma-2 families ride
along: a sliding window (per layer with ``sliding_window_pattern > 1``, a
Python int each layer, :func:`_layer_window`), attention sinks and the
attention softcap go to every attention call; GeGLU, the embedding scale,
Gemma-2's post-norms and the final logit softcap are plain torch ops.

Mixture-of-experts MLPs (:func:`_mlp_block`) take either router (Mixtral's
softmax over the top-k logits, or DeepSeek's softmax over all experts, then
top-k times ``routed_scaling_factor``), DeepSeek's shared experts and its
dense first layers. Dense experts run JAX's formulation (every expert on
every row, the routing weights zeroing the unselected pairs); quantized
experts run one stacked-layer K4 / K6 call per expert at index
``lidx * E + e`` on a free (L * E, ...) view of the stack. DeepSeek's MLA
(:func:`_mla_qkv`, :func:`_mla_out`) caches one latent row per token and
attends it as one KV head of ``kv_cache_dims()[1]`` lanes (640 for
V2-Lite) with the absorbed queries, on the same attention kernels.

Tensor parallelism: every entry point takes ``axis_name`` (a
``parallel.mesh.Axis``, where JAX names the axis), with ``params``,
``cache`` and ``cfg`` this rank's shard (``parallel/tp.py``). The outputs
of ``wo`` and of the MLP are summed over the axis (two all-reduces a
layer), the W8A8 / W4A8 row-parallel projections quantize with the full
row's scale, the vocab-sharded head's logits are all-gathered, MoE
experts shard whole (global expert ``index * E_local + e``) and
DeepSeek's shared experts and dense first layers count on index 0 only.

Multi-LoRA serving: the serving entries (``prefill``, ``decode_step``,
``prefill_serving(_paged)``, ``decode_step_paged``, ``decode_multi(_paged)``)
take ``lora`` (``models/lora.stack_adapters``, under TP this rank's shard,
``parallel.tp.shard_lora``) and ``lora_sel`` (the (B, N) one-hot of each
row's adapter, zero for the base model). Each layer adds the row's adapter
to ``wqkv`` (in x's dtype, before the bias), ``wo`` (to the fp32 output,
before the TP sum) and, in a dense MLP, ``w_gate_up`` / ``w_down``, where
and in the dtypes the JAX package adds them (llama.py:411-424, :851-898).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from starflashattention_tpu_torch.cache import contiguous, paged
from starflashattention_tpu_torch.core import drafting, quant
from starflashattention_tpu_torch.core import sampling as core_sampling
from starflashattention_tpu_torch.core.rope import apply_rope, rope_table
from starflashattention_tpu_torch.models import lora as lora_lib
from starflashattention_tpu_torch.ops.flash_decode import flash_verify_append
from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill
from starflashattention_tpu_torch.ops.quant_matmul import (quant_matmul, quant_matmul_int4,
                                                          quant_matmul_w4a8, quant_matmul_w8a8)
from starflashattention_tpu_torch.runtime.params import ModelConfig
from starflashattention_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

_QUANT_WEIGHTS = ("wqkv", "wo", "w_gate_up", "w_down", "moe_gate_up", "moe_down")
W8A8_MIN_ROWS = 256  # prefill rows from which cfg.w8a8_prefill takes the int8-activation kernels
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


_GATE_ACTS = {
    "silu": F.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),  # HF gelu_pytorch_tanh
    "gelu_exact": F.gelu,
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an MLP activation the port does not
    run (the JAX package takes the same three)."""
    if cfg.mlp_activation not in _GATE_ACTS:
        raise NotImplementedError(f"mlp_activation={cfg.mlp_activation!r} is not supported")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _stack_quantized(per_layer: list[dict]) -> dict:
    return {"w": torch.stack([p["w"] for p in per_layer]),
            "scale": torch.stack([p["scale"] for p in per_layer])}


def _quantize(w: torch.Tensor, mode: str, int4_group: int | None = None) -> dict:
    if mode == "int4":
        return quant.quantize_weight_int4(w, int4_group)
    return quant.quantize_weight(w, mode)


def _quantize_stacked(w: torch.Tensor, mode: str, int4_group: int | None = None) -> dict:
    """Quantize an (L, H, O) stack one layer at a time (the fp32
    intermediate is one layer's worth)."""
    return _stack_quantized([_quantize(w[i], mode, int4_group) for i in range(w.shape[0])])


def quantize_model_weights(params: Params, mode: str = "int8", lm_head: bool = False,
                           consume: bool = False, int4_group: int | None = None) -> Params:
    """Weight-only quantization of the projection stacks (and the lm_head
    with ``lm_head=True``): per-output-channel scales for "int8" / "fp8",
    nibble-packed grouped scales for "int4" (``int4_group`` caps the group,
    default 128); the embedding stays dense. ``consume=True`` drops each
    dense stack from ``params`` as it is quantized. Same weight bytes as the
    JAX package; the scales agree with it to one fp32 ulp, because the JAX
    package jit-compiles this step and XLA multiplies by ``1 / qmax`` where
    the division here (and JAX's eager ``quantize_weight``) divides by
    ``qmax``."""
    src_layers = params["layers"]
    layers = dict(src_layers)
    for name in (n for n in _QUANT_WEIGHTS if n in src_layers):
        if isinstance(src_layers[name], dict):
            continue
        w = src_layers.pop(name) if consume else src_layers[name]
        layers[name] = _quantize_stacked(w, mode, int4_group)
        del w
    out = dict(params)
    out["layers"] = layers
    if lm_head and "lm_head" in params and not isinstance(params["lm_head"], dict):
        w = out.pop("lm_head")
        if consume:
            params.pop("lm_head")
        out["lm_head"] = _quantize(w, mode, int4_group)
        del w
    return out


def param_count(params: Params) -> int:
    """Elements of every leaf of the tree; a quantized ``{"w", "scale"}``
    leaf counts the elements of both, as the JAX package counts them."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator | None = None,
    *,
    quantize: str | None = None,
    int4_group: int | None = None,
    device: torch.device | str | None = None,
) -> Params:
    """Random-init parameters on ``device`` (default ``cuda``) from
    ``generator`` (default: a generator on that device seeded with 0).
    Layer params are stacked on a leading L axis, as in the JAX package,
    in ``cfg.dtype``.

    ``quantize`` ("int8" / "fp8" / "int4", with ``int4_group``) generates
    each big projection (and each layer's (E, H, O) expert stack) one layer
    at a time and quantizes it at once, so the dense stack never exists;
    the lm_head stays dense (quantize it with
    ``quantize_model_weights(..., lm_head=True)``). The tree is the JAX
    package's (JAX llama.py:250-335): MoE configs carry the router, the
    expert stacks, DeepSeek's shared experts and its dense first layers'
    side stack ``dense_mlp`` (a dict, k-leading) in place of ``w_gate_up`` /
    ``w_down``; MLA configs carry the latent projections in place of
    ``wqkv``. The values differ from the JAX package's (another generator):
    tests bridge JAX's params with ``utils.bridge.params_from_numpy``
    instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    h, d = cfg.hidden_size, cfg.head_dim
    hq, hkv, inter, n_layers = cfg.num_q_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.num_layers

    def norm01(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        return w / torch.tensor(fan_in**0.5, dtype=dtype, device=dev)

    def big(shape, fan_in):
        if quantize is None:
            return norm01(shape, fan_in)
        return _stack_quantized([_quantize(norm01(shape[1:], fan_in), quantize, int4_group)
                                 for _ in range(shape[0])])

    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)  # noqa: E731
    embed = norm01((cfg.vocab_size, h), 1.0)  # first: the generator's order of the dense configs
    layers: Params = {"attn_norm": ones(n_layers, h)}
    if cfg.mla:  # the latent projections replace wqkv; wo takes Hq * v_head_dim rows
        c, nope, rope_d, v_dim = (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                                  cfg.v_head_dim)
        if cfg.q_lora_rank is not None:
            layers["mla_wq_a"] = norm01((n_layers, h, cfg.q_lora_rank), h)
            layers["mla_q_a_norm"] = ones(n_layers, cfg.q_lora_rank)
            layers["mla_wq_b"] = norm01((n_layers, cfg.q_lora_rank, hq * (nope + rope_d)),
                                        cfg.q_lora_rank)
        else:
            layers["mla_wq"] = norm01((n_layers, h, hq * (nope + rope_d)), h)
        layers["mla_wkv_a"] = norm01((n_layers, h, c + rope_d), h)
        layers["mla_kv_a_norm"] = ones(n_layers, c)
        layers["mla_wuk"] = norm01((n_layers, hq, nope, c), c)
        layers["mla_wuv"] = norm01((n_layers, hq, c, v_dim), c)
        layers["wo"] = big((n_layers, hq * v_dim, h), hq * v_dim)
    else:
        # wqkv columns: [q (Hq*D) | k (Hkv*D) | v (Hkv*D)], head-major
        layers["wqkv"] = big((n_layers, h, (hq + 2 * hkv) * d), h)
        layers["wo"] = big((n_layers, hq * d, h), hq * d)
    layers["mlp_norm"] = ones(n_layers, h)
    if cfg.num_experts:
        e = cfg.num_experts
        layers["moe_router"] = norm01((n_layers, h, e), h)
        # per expert [gate (I) | up (I)] and down, stacked (L, E, ...)
        layers["moe_gate_up"] = big((n_layers, e, h, 2 * inter), h)
        layers["moe_down"] = big((n_layers, e, inter, h), inter)
        if cfg.n_shared_experts:  # one dense SwiGLU of n_shared * I on every row
            si = cfg.n_shared_experts * inter
            layers["moe_shared_gate_up"] = norm01((n_layers, h, 2 * si), h)
            layers["moe_shared_down"] = norm01((n_layers, si, h), si)
        if cfg.first_k_dense:  # the dense first layers' side stack, k-leading
            k, di = cfg.first_k_dense, cfg.dense_inter_size
            layers["dense_mlp"] = {"w_gate_up": norm01((k, h, 2 * di), h),
                                   "w_down": norm01((k, di, h), di)}
    else:
        # w_gate_up columns: [gate (I) | up (I)]
        layers["w_gate_up"] = big((n_layers, h, 2 * inter), h)
        layers["w_down"] = big((n_layers, inter, h), inter)
    params: Params = {"embed": embed, "layers": layers, "final_norm": ones(h)}
    if cfg.attention_bias:
        params["layers"]["bqkv"] = norm01((n_layers, (hq + 2 * hkv) * d), h)
    if cfg.qk_norm:
        params["layers"]["q_norm"] = ones(n_layers, d)
        params["layers"]["k_norm"] = ones(n_layers, d)
    if cfg.post_norms:  # Gemma-2: mlp_norm doubles as the pre-feedforward norm
        params["layers"]["post_attn_norm"] = ones(n_layers, h)
        params["layers"]["post_mlp_norm"] = ones(n_layers, h)
    if not cfg.tie_embeddings:
        params["lm_head"] = norm01((h, cfg.vocab_size), h)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, cast to x's dtype BEFORE the weight multiply (the
    JAX package's order, which bf16 parity depends on)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Embedding gather, with Gemma's sqrt(hidden) scaling of the OUTPUT (a
    tied lm_head stays unscaled; JAX llama.py:389-397)."""
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = (x.float() * cfg.hidden_size**0.5).to(x.dtype)
    return x


def _layer_window(cfg: ModelConfig, lidx: int) -> int | None:
    """Layer ``lidx``'s sliding window (JAX llama.py:353-366): the config's
    window on every layer with pattern 1; with pattern P > 1 (Gemma-2)
    layer L slides iff (L + 1) % P != 0 and the full layers pass a window
    beyond any length, ``max_seq_len + 2``. A per-layer window with sinks
    raises ``ValueError``, as the JAX kernels refuse sinks with a traced
    window."""
    w = cfg.sliding_window
    if w is None or cfg.sliding_window_pattern == 1:
        return w
    if cfg.attention_sinks:
        raise ValueError("attention sinks need a STATIC window: a per-layer window "
                         "(sliding_window_pattern > 1) does not take them")
    return w if (lidx + 1) % cfg.sliding_window_pattern else cfg.max_seq_len + 2


def _attn_options(cfg: ModelConfig, lidx: int) -> dict:
    """The attention variants of layer ``lidx`` as the ops take them."""
    return {"window": _layer_window(cfg, lidx), "sinks": cfg.attention_sinks,
            "softcap": cfg.attn_softcap}


def _residual_add(x, out, layers: Params, lidx: int, post_key: str, eps: float):
    """x + out, with Gemma-2's post-norm of the sublayer output before the
    add when the layers carry ``post_key`` (JAX llama.py:369-375)."""
    out = out.to(x.dtype)
    if post_key in layers:
        out = rms_norm(out, layers[post_key][lidx], eps)
    return x + out


def _dense_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` at fp32 (the JAX package's ``jnp.dot`` of a dense weight
    outside Pallas, fp32 accumulate)."""
    return torch.matmul(x.float(), w.float())


def _gated(gu: torch.Tensor, act, dtype: torch.dtype) -> torch.Tensor:
    """``act(gate) * up`` of a [gate | up] row, cast to ``dtype``."""
    inter = gu.shape[-1] // 2
    return (act(gu[..., :inter]) * gu[..., inter:]).to(dtype)


def _wq_matmul(x2d: torch.Tensor, w: dict, layer, out_dtype=None) -> torch.Tensor:
    """Weight-only kernel for a quantized dict: int4 (grouped scales; the
    scale's rank tags the format) or int8 / fp8."""
    fn = quant_matmul_int4 if quant.is_int4_weight(w) else quant_matmul
    return fn(x2d, w["w"], w["scale"], layer=layer, out_dtype=out_dtype)


_ROW_PARALLEL = ("wo", "w_down")  # input dim sharded under TP: their W8A8 row scales reduce over the axis


def _make_proj(layers: Params, lidx: int, cfg: ModelConfig, axis_name=None):
    """Projection closure for one layer -> fp32 outputs (or ``out_dtype``
    written by the quantized kernel). Quantized stacks go to their kernel
    with the layer index; dense ones to ``torch.matmul`` at fp32 (the JAX
    package's ``jnp.dot`` outside Pallas). With ``cfg.w8a8_prefill``, at
    least ``W8A8_MIN_ROWS`` rows and int8-dtype weights (int8, or packed
    int4), the int8-activation kernels take the rows (JAX llama.py:75-104);
    fp8 weights and decode rows stay weight-only. Under TP (``axis_name``)
    the row-parallel projections quantize with the full row's scale
    (``quantize_rows``'s ``axis``)."""

    def proj(x: torch.Tensor, name: str, out_dtype=None) -> torch.Tensor:
        w = layers[name]
        if isinstance(w, dict):
            flat = x.reshape(-1, x.shape[-1])
            if cfg.w8a8_prefill and flat.shape[0] >= W8A8_MIN_ROWS and w["w"].dtype == torch.int8:
                fn = quant_matmul_w4a8 if quant.is_int4_weight(w) else quant_matmul_w8a8
                out = fn(flat, w["w"], w["scale"], layer=lidx, out_dtype=out_dtype,
                         axis=axis_name if name in _ROW_PARALLEL else None)
            else:
                out = _wq_matmul(flat, w, lidx, out_dtype=out_dtype)
            return out.reshape(*x.shape[:-1], out.shape[-1])
        return _dense_dot(x, w[lidx])

    return proj


def _apply_qk_norm(q, k, layers, lidx, cfg):
    if "q_norm" not in layers:
        return q, k
    return (rms_norm(q, layers["q_norm"][lidx], cfg.rms_norm_eps),
            rms_norm(k, layers["k_norm"][lidx], cfg.rms_norm_eps))


def _adapted(out: torch.Tensor, x: torch.Tensor, name: str, lora_l, lora_sel) -> torch.Tensor:
    """``out``, the projection ``name`` of ``x``, plus each row's adapter
    delta (``lora.delta_multi``, in x's dtype) when the layer's stacked
    adapters ``lora_l`` target it."""
    d = lora_lib.delta_multi(x, lora_l, name, lora_sel) if lora_l is not None else None
    return out if d is None else out + d


def _swiglu(x: torch.Tensor, proj, cfg: ModelConfig, lora_l=None, lora_sel=None) -> torch.Tensor:
    """Gated MLP -> fp32: gate_up written in x's dtype, ``act(gate) * up``
    cast to x's dtype (SwiGLU's silu, or Gemma's GeGLU), w_down written in
    fp32; the adapters' deltas on gate_up before the gate and on w_down's
    output."""
    gu = _adapted(proj(x, "w_gate_up", out_dtype=x.dtype), x, "w_gate_up", lora_l, lora_sel)
    act = _gated(gu, _GATE_ACTS[cfg.mlp_activation], x.dtype)
    return _adapted(proj(act, "w_down"), act, "w_down", lora_l, lora_sel)


def _split_heads_decode(qkv: torch.Tensor, cfg: ModelConfig):
    """(B, (Hq+2Hkv)*D) flat [q|k|v] -> q (B,Hq,D), k/v (B,Hkv,D)."""
    b = qkv.shape[0]
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = qkv.reshape(b, hq + 2 * hkv, d)
    return qkv[:, :hq], qkv[:, hq:hq + hkv], qkv[:, hq + hkv:]


def _split_heads_prefill(qkv: torch.Tensor, cfg: ModelConfig):
    """(B, S, (Hq+2Hkv)*D) flat [q|k|v] -> q (B,Hq,S,D), k/v (B,Hkv,S,D)."""
    b, s, _ = qkv.shape
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = qkv.reshape(b, s, hq + 2 * hkv, d).transpose(1, 2)
    return qkv[:, :hq], qkv[:, hq:hq + hkv], qkv[:, hq + hkv:]


def _qkv(h, layers, lidx, proj, cfg, x_dtype, lora_l=None, lora_sel=None):
    qkv = _adapted(proj(h, "wqkv", out_dtype=x_dtype).to(x_dtype), h, "wqkv", lora_l, lora_sel)
    if "bqkv" in layers:
        qkv = qkv + layers["bqkv"][lidx]
    return qkv


def _logits(x: torch.Tensor, params: Params, cfg: ModelConfig, axis_name=None) -> torch.Tensor:
    """Final norm and lm_head (a quantized lm_head is always weight-only),
    then Gemma-2's final logit softcap when configured. Under TP with a
    vocab-sharded head (``cfg.lm_head_sharded``) the (.., V/T) slices are
    all-gathered over ``axis_name``: an exact concatenation."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, dict):
        logits = _wq_matmul(x, head, 0)
    else:
        logits = _dense_dot(x, head)
    if axis_name is not None and cfg.lm_head_sharded:
        from starflashattention_tpu_torch.parallel.comm import all_gather

        logits = all_gather(logits, axis_name, dim=-1)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def rope_tables(cfg: ModelConfig, device: torch.device | str | None = None):
    """fp32 cos/sin tables (max_seq_len, rotary dim // 2) on ``device``
    (default cuda); the rotary dim is head_dim, or with MLA the decoupled
    ``qk_rope_head_dim`` (JAX llama.py:661-667)."""
    rot = cfg.qk_rope_head_dim if cfg.mla else cfg.head_dim
    return rope_table(cfg.max_seq_len, rot, base=cfg.rope_base,
                      scaling=cfg.rope_scaling, device=resolve_device(device))


# ---------------------------------------------------------------------------
# Mixture of experts (JAX llama.py:427-616)
# ---------------------------------------------------------------------------


def _first_shard_only(axis_name) -> bool:
    """Under TP a replicated side stack (DeepSeek's shared experts, its dense
    first layers) contributes on index 0 of the axis only, so that the
    caller's sum adds one copy (JAX gates it with ``axis_index == 0``; the
    other ranks skip the work)."""
    return axis_name is not None and axis_name.index != 0


def _shared_expert(flat: torch.Tensor, layers: Params, lidx: int, cfg: ModelConfig, axis_name=None):
    """DeepSeek's shared experts: a dense SwiGLU on every row -> fp32 (N, H),
    or 0 without them (and on every TP rank but the first). silu whatever
    ``mlp_activation`` says, as JAX llama.py:442 has it."""
    if not cfg.n_shared_experts or _first_shard_only(axis_name):
        return 0.0
    act = _gated(_dense_dot(flat, layers["moe_shared_gate_up"][lidx]), F.silu, flat.dtype)
    return _dense_dot(act, layers["moe_shared_down"][lidx])


def _dense_first_mlp(flat: torch.Tensor, dense: Params, lidx: int, cfg: ModelConfig, axis_name=None):
    """A DeepSeek dense first layer (``first_k_dense``): the gated MLP of the
    side stack's row ``lidx`` -> fp32 (N, H); zeros on every TP rank but the
    first."""
    if _first_shard_only(axis_name):
        return torch.zeros((flat.shape[0], flat.shape[1]), dtype=torch.float32, device=flat.device)
    li = min(lidx, cfg.first_k_dense - 1)
    act = _gated(_dense_dot(flat, dense["w_gate_up"][li]), _GATE_ACTS[cfg.mlp_activation], flat.dtype)
    return _dense_dot(act, dense["w_down"][li])


def _top_k(x: torch.Tensor, k: int):
    """The ``k`` largest of each row, descending, ties to the lower index
    (as ``jax.lax.top_k``; a stable sort keeps equal values in index
    order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(flat: torch.Tensor, router: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Routing weights (N, E) fp32, zero for the unselected experts, from the
    fp32 router logits: Mixtral's softmax over the top-k logits (Qwen3-MoE's
    too), or with ``router_pre_softmax`` DeepSeek's softmax over all
    experts, then the top-k probabilities, not renormalized, times
    ``routed_scaling_factor``."""
    r = _dense_dot(flat, router)
    k = cfg.num_experts_per_tok
    if cfg.router_pre_softmax:
        top_w, top_idx = _top_k(torch.softmax(r, dim=-1), k)
        top_w = top_w * cfg.routed_scaling_factor
    else:
        top_logit, top_idx = _top_k(r, k)
        top_w = torch.softmax(top_logit, dim=-1)
    return torch.zeros_like(r).scatter_(-1, top_idx, top_w)


def _expert_view(w: dict) -> dict:
    """A quantized (L, E, ...) expert stack as the free (L * E, ...) view
    the stacked-layer kernels index (int4 scales keep their group axis)."""
    return {key: t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]) for key, t in w.items()}


def _moe_mlp(x: torch.Tensor, layers: Params, lidx: int, cfg: ModelConfig, axis_name=None) -> torch.Tensor:
    """Top-k routed MoE MLP of layer ``lidx`` -> fp32 (JAX llama.py:470-576).
    Every expert runs on every row and the routing weights zero the
    unselected pairs. Quantized stacks: per expert, gate_up written in x's
    dtype and down in fp32 by the weight-only kernel at index ``lidx * E +
    e`` (K4 for int8 / fp8, K6 for int4), summed in expert order. Expert
    parallelism (``axis_name``): the stacks hold this rank's ``E_local``
    whole experts, global experts ``index * E_local + e``; the router is
    replicated and routes over all ``cfg.num_experts``, and the caller's
    sum over the axis completes the routed sum."""
    flat = x.reshape(-1, x.shape[-1])  # (N, H)
    dense_w = route(flat, layers["moe_router"][lidx], cfg)  # (N, E)
    wg, wd = layers["moe_gate_up"], layers["moe_down"]
    e_local = wg["w"].shape[1] if isinstance(wg, dict) else wg.shape[1]
    if axis_name is not None and e_local != cfg.num_experts:
        dense_w = dense_w[:, axis_name.index * e_local:(axis_name.index + 1) * e_local]
    if isinstance(wg, dict):
        n_exp = e_local
        wg_f, wd_f = _expert_view(wg), _expert_view(wd)
        out = torch.zeros((flat.shape[0], wd["w"].shape[-1]), dtype=torch.float32, device=x.device)
        for e in range(n_exp):
            eidx = lidx * n_exp + e
            act = _gated(_wq_matmul(flat, wg_f, eidx, out_dtype=x.dtype), F.silu, x.dtype)
            out = out + _wq_matmul(act, wd_f, eidx) * dense_w[:, e][:, None]
    else:
        gu = torch.einsum("nh,ehi->eni", flat.float(), wg[lidx].float())  # (E, N, 2I)
        y = torch.einsum("eni,eih->enh", _gated(gu, F.silu, x.dtype).float(), wd[lidx].float())
        out = torch.einsum("enh,ne->nh", y, dense_w)
    out = out + _shared_expert(flat, layers, lidx, cfg, axis_name)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _mlp_block(x: torch.Tensor, layers: Params, lidx: int, proj, cfg: ModelConfig, axis_name=None,
               lora_l=None, lora_sel=None):
    """The layer's MLP -> fp32: the gated dense MLP, or the MoE, with
    DeepSeek's dense first layers (``lidx < first_k_dense``, a plain Python
    test where JAX's scan takes a ``lax.cond``; JAX llama.py:579-616).
    Under TP it is this rank's partial sum; the caller reduces it. Adapters
    apply to the dense MLP only (a MoE config's adapters have no MLP
    targets, JAX lora.py:32-42)."""
    if not cfg.num_experts:
        return _swiglu(x, proj, cfg, lora_l, lora_sel)
    if cfg.first_k_dense:
        if "dense_mlp" not in layers:
            raise ValueError("cfg.first_k_dense is set but layers['dense_mlp'] is missing")
        if lidx < cfg.first_k_dense:
            out = _dense_first_mlp(x.reshape(-1, x.shape[-1]), layers["dense_mlp"], lidx, cfg, axis_name)
            return out.reshape(*x.shape[:-1], out.shape[-1])
    return _moe_mlp(x, layers, lidx, cfg, axis_name)


def _reduce(out: torch.Tensor, axis_name) -> torch.Tensor:
    """The sum over the TP axis of a row-parallel output (JAX's ``psum``;
    one all-reduce after ``wo`` and one after the MLP)."""
    if axis_name is None:
        return out
    from starflashattention_tpu_torch.parallel.comm import all_reduce

    return all_reduce(out, axis_name)


def _mlp_residual(x, layers, lidx, proj, cfg, axis_name=None, lora_l=None, lora_sel=None):
    h = rms_norm(x, layers["mlp_norm"][lidx], cfg.rms_norm_eps)
    out = _reduce(_mlp_block(h, layers, lidx, proj, cfg, axis_name, lora_l, lora_sel), axis_name)
    return _residual_add(x, out, layers, lidx, "post_mlp_norm", cfg.rms_norm_eps)


# ---------------------------------------------------------------------------
# DeepSeek MLA, absorbed latent form (JAX llama.py:742-812)
# ---------------------------------------------------------------------------


def _mla_project_q(h: torch.Tensor, layers: Params, lidx: int, cfg: ModelConfig) -> torch.Tensor:
    """(..., H) -> per-head queries (..., Hq, nope + rope) in h's dtype: the
    direct projection (V2-Lite) or q_a -> norm -> q_b."""
    if "mla_wq_a" in layers:
        qa = rms_norm(_dense_dot(h, layers["mla_wq_a"][lidx]).to(h.dtype),
                      layers["mla_q_a_norm"][lidx], cfg.rms_norm_eps)
        q = _dense_dot(qa, layers["mla_wq_b"][lidx])
    else:
        q = _dense_dot(h, layers["mla_wq"][lidx])
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return q.reshape(*h.shape[:-1], cfg.num_q_heads, qk_dim).to(h.dtype)


def _mla_qkv(h: torch.Tensor, layers: Params, lidx: int, cfg: ModelConfig, cos, sin, pos):
    """MLA's projections in absorbed latent form -> (q, k_row, v_row), the
    head axis inserted at -2 (Hq heads for q, one for the rows). The cache
    row is ``k_row = [c | k_pe | 0]`` and ``v_row = [c | 0]`` at the width
    of ``kv_cache_dims()[1]`` (c the normed kv latent, k_pe the decoupled
    roped key); the query is ``[q_nope @ W_uk | q_pe | 0]``, the absorption
    in fp32 rounded to h's dtype, so its scores equal the unabsorbed
    ``q_nope . k_nope + q_pe . k_pe``. MLA ropes interleaved whatever
    ``cfg.rope_style`` says. ``pos`` has h's leading shape."""
    c_rank, rope_d, nope = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    _, d_pad = cfg.kv_cache_dims()
    q = _mla_project_q(h, layers, lidx, cfg)  # (..., Hq, nope + rope)
    q_pe = apply_rope(q[..., nope:], pos[..., None], cos, sin, style="interleaved")
    q_abs = torch.einsum("...hn,hnc->...hc", q[..., :nope].float(),
                         layers["mla_wuk"][lidx].float()).to(h.dtype)
    kv = _dense_dot(h, layers["mla_wkv_a"][lidx]).to(h.dtype)  # (..., c + rope)
    c = rms_norm(kv[..., :c_rank], layers["mla_kv_a_norm"][lidx], cfg.rms_norm_eps)[..., None, :]
    k_pe = apply_rope(kv[..., None, c_rank:], pos[..., None], cos, sin, style="interleaved")
    pad = d_pad - c_rank - rope_d

    def zeros(like, n):
        return torch.zeros((*like.shape[:-1], n), dtype=h.dtype, device=h.device)

    q_cat = torch.cat([q_abs, q_pe.to(h.dtype), zeros(q_abs, pad)], dim=-1)
    k_row = torch.cat([c, k_pe.to(h.dtype), zeros(c, pad)], dim=-1)
    v_row = torch.cat([c, zeros(c, rope_d + pad)], dim=-1)
    return q_cat, k_row, v_row


def _mla_out(o: torch.Tensor, layers: Params, lidx: int, cfg: ModelConfig) -> torch.Tensor:
    """Latent attention output (..., Hq, d_pad) -> (..., Hq * v_head_dim):
    its first ``kv_lora_rank`` lanes through each head's W_uv in fp32."""
    out = torch.einsum("...hc,hcv->...hv", o[..., :cfg.kv_lora_rank].float(),
                       layers["mla_wuv"][lidx].float())
    return out.reshape(*out.shape[:-2], -1).to(o.dtype)


# ---------------------------------------------------------------------------
# One layer (shared by the contiguous and the paged cache)
# ---------------------------------------------------------------------------


def _rope_positions(pos: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Positions for the RoPE table lookup, clamped to its last row as the
    JAX package's gather clamps. Only rows that do not really decode or
    prefill (the serving engines' idle slots) can reach past it."""
    return torch.clamp(pos, max=cos.shape[0] - 1)


def _attn_residual(x, o, layers, lidx, proj, cfg, axis_name, lora_l, lora_sel):
    """x plus the attention's ``wo`` output (fp32, the adapters' delta added
    before the TP sum, JAX llama.py:894-898)."""
    out = _reduce(_adapted(proj(o, "wo"), o, "wo", lora_l, lora_sel), axis_name)
    return _residual_add(x, out, layers, lidx, "post_attn_norm", cfg.rms_norm_eps)


def _decode_layer(x, lidx: int, layers: Params, cfg: ModelConfig, cos, sin, pos,
                  attend, axis_name=None, lora_l=None, lora_sel=None) -> torch.Tensor:
    """One decoder layer of the decode step; ``attend(lidx, q, k_new,
    v_new)`` appends this token's K/V to the cache in place and returns the
    attention output (B, Hq, D). Under TP (``axis_name``, a
    ``parallel.mesh.Axis``) ``layers`` and ``cfg`` are this rank's shard
    (its heads, its MLP columns) and the outputs of ``wo`` and of the MLP
    are summed over the axis (JAX llama.py:897-906). ``lora_l`` (this
    layer of a stacked adapter tree, ``lora.layer_slice``) and ``lora_sel``
    add each row's adapter."""
    proj = _make_proj(layers, lidx, cfg, axis_name)
    h = rms_norm(x, layers["attn_norm"][lidx], cfg.rms_norm_eps)
    if cfg.mla:  # one shared latent row a token, absorbed queries
        q, k_new, v_new = _mla_qkv(h, layers, lidx, cfg, cos, sin, pos)
    else:
        q, k_new, v_new = _split_heads_decode(_qkv(h, layers, lidx, proj, cfg, x.dtype, lora_l, lora_sel), cfg)
        q, k_new = _apply_qk_norm(q, k_new, layers, lidx, cfg)
        q = apply_rope(q, pos, cos, sin, style=cfg.rope_style)
        k_new = apply_rope(k_new, pos, cos, sin, style=cfg.rope_style)
    o = attend(lidx, q, k_new, v_new)
    o = _mla_out(o, layers, lidx, cfg) if cfg.mla else o.reshape(o.shape[0], -1)
    x = _attn_residual(x, o, layers, lidx, proj, cfg, axis_name, lora_l, lora_sel)
    return _mlp_residual(x, layers, lidx, proj, cfg, axis_name, lora_l, lora_sel)


def _prefill_layer(x, lidx: int, layers: Params, cfg: ModelConfig, cos, sin, pos,
                   attend, axis_name=None, lora_l=None, lora_sel=None) -> torch.Tensor:
    """One decoder layer of the prefill; ``attend(lidx, q, k_new, v_new)``
    writes the chunk's K/V into the cache in place and returns the attention
    output (B, Hq, Sq, D). ``axis_name`` and the adapters as in
    :func:`_decode_layer`."""
    b, sq = pos.shape
    proj = _make_proj(layers, lidx, cfg, axis_name)
    h = rms_norm(x, layers["attn_norm"][lidx], cfg.rms_norm_eps)
    if cfg.mla:  # (B, Sq, H*, D) from the helper; the kernels take heads first
        q, k_new, v_new = (t.transpose(1, 2) for t in _mla_qkv(h, layers, lidx, cfg, cos, sin, pos))
    else:
        q, k_new, v_new = _split_heads_prefill(_qkv(h, layers, lidx, proj, cfg, x.dtype, lora_l, lora_sel), cfg)
        q, k_new = _apply_qk_norm(q, k_new, layers, lidx, cfg)
        q = apply_rope(q, pos[:, None, :], cos, sin, style=cfg.rope_style)
        k_new = apply_rope(k_new, pos[:, None, :], cos, sin, style=cfg.rope_style)
    o = attend(lidx, q, k_new, v_new).transpose(1, 2)  # (B, Sq, Hq, D)
    o = _mla_out(o, layers, lidx, cfg) if cfg.mla else o.reshape(b, sq, -1)
    x = _attn_residual(x, o, layers, lidx, proj, cfg, axis_name, lora_l, lora_sel)
    return _mlp_residual(x, layers, lidx, proj, cfg, axis_name, lora_l, lora_sel)


def _step_lengths(lengths: torch.Tensor, active: torch.Tensor | None):
    """(write position, lengths after the step, attended lengths) of one
    decode step. ``active=False`` rows neither advance nor attend: their
    stale length would make the kernel walk a dead range, and their output
    is discarded, so they attend zero rows (JAX llama.py:698-707)."""
    pos = lengths.clone()
    if active is None:
        now = pos + 1
        return pos, now, now
    now = pos + active.to(torch.int32)
    return pos, now, torch.where(active, now, torch.zeros_like(now))


def _check_axis(axis_name) -> None:
    if isinstance(axis_name, str):
        raise TypeError("axis_name takes a parallel.mesh.Axis (mesh.axis(name)), not an axis's name")


def _check_lora(lora, lora_sel, rows: int) -> None:
    if (lora is None) != (lora_sel is None):
        raise ValueError("lora and lora_sel go together: the stacked adapters and each row's one-hot selector")
    if lora is not None and tuple(lora_sel.shape) != (rows, lora_lib.num_adapters(lora)):
        raise ValueError(f"lora_sel is {tuple(lora_sel.shape)}, expected (rows {rows}, adapters "
                         f"{lora_lib.num_adapters(lora)})")


def _decode_run(params: Params, tokens: torch.Tensor, pos: torch.Tensor, cos, sin,
                cfg: ModelConfig, attend, axis_name=None, lora=None, lora_sel=None) -> torch.Tensor:
    _check_axis(axis_name)
    _check_lora(lora, lora_sel, tokens.shape[0])
    x = _embed_tokens(params, tokens, cfg)  # (B, H)
    rope_pos = _rope_positions(pos, cos)
    layers = params["layers"]
    for lidx in range(cfg.num_layers):
        x = _decode_layer(x, lidx, layers, cfg, cos, sin, rope_pos, attend, axis_name,
                          lora_lib.layer_slice(lora, lidx), lora_sel)
    return _logits(x, params, cfg, axis_name)


def _prefill_run(params: Params, tokens: torch.Tensor, new_lengths: torch.Tensor,
                 start: torch.Tensor, cos, sin, cfg: ModelConfig, attend, axis_name=None, lora=None,
                 lora_sel=None) -> torch.Tensor:
    """Every layer over a (B, Sq) chunk at positions ``start[b] + i`` ->
    (B, V) fp32 logits at each row's last valid token."""
    _check_axis(axis_name)
    _check_lora(lora, lora_sel, tokens.shape[0])
    b, sq = tokens.shape
    pos = start[:, None] + torch.arange(sq, device=start.device, dtype=torch.int32)[None, :]
    rope_pos = _rope_positions(pos, cos)
    x = _embed_tokens(params, tokens, cfg)  # (B, Sq, H)
    layers = params["layers"]
    for lidx in range(cfg.num_layers):
        x = _prefill_layer(x, lidx, layers, cfg, cos, sin, rope_pos, attend, axis_name,
                           lora_lib.layer_slice(lora, lidx), lora_sel)
    last = torch.clamp(new_lengths - 1, min=0).long()
    x_last = x[torch.arange(b, device=x.device), last]
    return _logits(x_last, params, cfg, axis_name)


def _as_mask(mask, device) -> torch.Tensor:
    return torch.as_tensor(mask).to(device=device, dtype=torch.bool)


# ---------------------------------------------------------------------------
# Decode step (one token per sequence, whole model), contiguous cache
# ---------------------------------------------------------------------------


def decode_step(params: Params, cache: contiguous.KVCache, tokens: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, cfg: ModelConfig,
                active: torch.Tensor | None = None, axis_name=None, lora=None, lora_sel=None):
    """One decode step: (B,) token ids -> (B, V) fp32 logits. Writes each
    layer's new K/V row into ``cache`` and advances ``cache.lengths`` IN
    PLACE; returns ``(logits, cache)``. ``active`` (B,) bool: rows that
    really decode; the others still write a row at their stale length (past
    their valid rows) but neither advance nor attend. Runs on the device of
    the tensors. ``axis_name`` (a ``parallel.mesh.Axis``): this rank's
    tensor-parallel shard of the params, the cache and ``cfg``
    (``parallel.tp``), two all-reduces a layer. ``lora`` / ``lora_sel``:
    the stacked adapters and each row's (B, N) one-hot (module doc)."""
    check_supported(cfg)
    if active is not None:
        active = _as_mask(active, cache.lengths.device)
    pos, lengths_now, att_lengths = _step_lengths(cache.lengths, active)

    def attend(lidx, q, k_new, v_new):  # the append at lengths, clamped below S, in the attention's launch
        return contiguous.append_decode_attend(cache, lidx, q, k_new, v_new, att_lengths,
                                               sm_scale=cfg.sm_scale(), num_splits=cfg.num_splits,
                                               block_k=cfg.block_k, **_attn_options(cfg, lidx))

    logits = _decode_run(params, tokens, pos, cos, sin, cfg, attend, axis_name, lora, lora_sel)
    cache.lengths.copy_(lengths_now)
    return logits, cache


# ---------------------------------------------------------------------------
# Prefill (prompt chunk, whole model), contiguous cache
# ---------------------------------------------------------------------------


def _prefill_contiguous(params, cache: contiguous.KVCache, tokens, new_lengths, cos, sin,
                        cfg: ModelConfig, active, axis_name=None, lora=None, lora_sel=None):
    check_supported(cfg)
    b, sq = tokens.shape
    start = cache.lengths.clone()
    new_lengths = new_lengths.to(device=start.device, dtype=torch.int32)
    rows = None
    if active is not None:
        active = _as_mask(active, start.device)
        new_lengths = torch.where(active, new_lengths, torch.zeros_like(new_lengths))
        rows = active.nonzero().flatten()  # one host sync; busy rows stay untouched
    contiguous.check_prefill_window(cache, sq, rows)  # before RoPE indexes past its table
    kv_lengths = start + new_lengths
    # a quantized cache is attended through a dequantized copy of the rows
    # K5 reads (every row's first kv_lengths[b]; one host sync a prefill)
    span = int(kv_lengths.max()) if cache.k_scales is not None else None

    def attend(lidx, q, k_new, v_new):
        contiguous.append_prefill(cache, lidx, k_new, v_new, rows, check=False)
        k, v = cache.k[lidx], cache.v[lidx]
        if span is not None:
            ks, vs = cache.layer_scales(lidx)
            k = contiguous.dequantize_rows(k[:, :, :span], ks, q.dtype)
            v = contiguous.dequantize_rows(v[:, :, :span], vs, q.dtype)
        return flash_prefill(q, k, v, lengths=kv_lengths, causal=True, q_offsets=start,
                             sm_scale=cfg.sm_scale(), **_attn_options(cfg, lidx))  # (B, Hq, Sq, D)

    logits = _prefill_run(params, tokens, new_lengths, start, cos, sin, cfg, attend, axis_name, lora, lora_sel)
    cache.lengths.copy_(kv_lengths)
    return logits, cache


def prefill(params: Params, cache: contiguous.KVCache, tokens: torch.Tensor,
            new_lengths: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            cfg: ModelConfig, axis_name=None, lora=None, lora_sel=None):
    """Prompt ingestion: (B, Sq) right-padded tokens with ``new_lengths``
    valid per row -> (B, V) fp32 logits at each row's last valid token.
    Writes the whole Sq-row window of every layer into ``cache`` at
    ``cache.lengths`` and advances the lengths by ``new_lengths``, IN PLACE;
    returns ``(logits, cache)``.

    Raises if ``cache.lengths + Sq`` exceeds the cache: the JAX package's
    ``dynamic_update_slice`` would shift such a window left over valid rows
    instead. ``axis_name``, ``lora`` and ``lora_sel`` as in
    :func:`decode_step`."""
    return _prefill_contiguous(params, cache, tokens, new_lengths, cos, sin, cfg, active=None,
                               axis_name=axis_name, lora=lora, lora_sel=lora_sel)


def prefill_serving(params: Params, cache: contiguous.KVCache, tokens: torch.Tensor,
                    new_lengths: torch.Tensor, active, reset, cos: torch.Tensor,
                    sin: torch.Tensor, cfg: ModelConfig, axis_name=None, lora=None, lora_sel=None):
    """Masked prefill for admission (JAX llama.py:1182-1229): ``reset``
    rows restart their cache at length 0 first; ``active`` rows append this
    chunk's tokens; every other row's cache and length stay exactly as they
    were. Whole-prompt admission passes reset == active; chunked prefill
    resets only on a prompt's first chunk. Returns each active row's
    last-valid-position logits (other rows' logits are meaningless) and the
    cache, updated IN PLACE. Raises if an active window runs past the
    cache."""
    cache.lengths.masked_fill_(_as_mask(reset, cache.lengths.device), 0)
    return _prefill_contiguous(params, cache, tokens, new_lengths, cos, sin, cfg, active=active,
                               axis_name=axis_name, lora=lora, lora_sel=lora_sel)


# ---------------------------------------------------------------------------
# Paged cache: decode step and prefill
# ---------------------------------------------------------------------------


def decode_step_paged(params: Params, cache: paged.PagedKVCache, tokens: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor, cfg: ModelConfig,
                      active: torch.Tensor | None = None, axis_name=None, lora=None, lora_sel=None):
    """One decode step against the page pools (JAX llama.py:1632-1747): each
    layer appends through the page table at ``min(pos, S_logical - 1)`` and
    attends, in one launch of kernel K7 with K8 folded in
    (``cache.paged.append_decode_attend_paged``). Inactive rows' table rows
    point at the null page 0, so their appends land there harmlessly.
    Updates the pools and ``cache.lengths`` IN PLACE."""
    check_supported(cfg)
    if active is not None:
        active = _as_mask(active, cache.lengths.device)
    pos, lengths_now, att_lengths = _step_lengths(cache.lengths, active)

    def attend(lidx, q, k_new, v_new):  # the append at lengths, clamped below S, in the attention's launch
        return paged.append_decode_attend_paged(cache, lidx, q, k_new, v_new, att_lengths,
                                                sm_scale=cfg.sm_scale(), **_attn_options(cfg, lidx))

    logits = _decode_run(params, tokens, pos, cos, sin, cfg, attend, axis_name, lora, lora_sel)
    cache.lengths.copy_(lengths_now)
    return logits, cache


def prefill_serving_paged(params: Params, cache: paged.PagedKVCache, tokens: torch.Tensor,
                          new_lengths: torch.Tensor, active, reset, cos: torch.Tensor,
                          sin: torch.Tensor, cfg: ModelConfig, prefix_len: int = 0, axis_name=None,
                          lora=None, lora_sel=None):
    """Paged admission prefill (JAX llama.py:1750-1890, 1973-2020); masks as
    in :func:`prefill_serving`. Each active row's chunk is scattered into
    its pages first (inactive rows write nothing). With ``prefix_len == 0``
    (whole prompts into fresh slots) attention runs on the chunk's own K/V;
    with ``prefix_len > 0`` (chunked continuation and prefix-cache hits)
    each row's first ``prefix_len + Sq`` pooled positions are gathered back
    contiguous, so KV index == absolute position, and attended with
    ``q_offsets = start``. ``prefix_len`` bounds every active row's start,
    as the engine quantizes it. Quantized pools: the chunk is quantized
    before the scatter, and attention reads the quantize -> dequantize
    round trip of the chunk, or the dequantized gathered prefix (JAX
    llama.py:1821-1853)."""
    check_supported(cfg)
    dev = cache.lengths.device
    b, sq = tokens.shape
    cache.lengths.masked_fill_(_as_mask(reset, dev), 0)
    start = cache.lengths.clone()
    active = _as_mask(active, dev)
    new_lengths = new_lengths.to(device=dev, dtype=torch.int32)
    new_lengths = torch.where(active, new_lengths, torch.zeros_like(new_lengths))
    kv_lengths = start + new_lengths
    index = paged.chunk_index(cache.page_table, start, new_lengths, sq, cache.page_size)
    span = min(prefix_len + sq, cache.pages_per_seq * cache.page_size)

    def attend(lidx, q, k_new, v_new):
        kv = []
        for pool, new, scales in zip((cache.k_pages, cache.v_pages), (k_new, v_new),
                                     cache.layer_scales(lidx)):
            new = contiguous.quantize_new(new, scales, pool.dtype)
            paged.scatter_prefill_chunk(pool, lidx, new, cache.page_table, start, new_lengths,
                                        index=index)
            if prefix_len > 0:
                new = paged.gather_prefix(pool, lidx, cache.page_table, span)
            kv.append(contiguous.dequantize_rows(new, scales, q.dtype))
        return flash_prefill(q, kv[0], kv[1], lengths=kv_lengths, causal=True, q_offsets=start,
                             sm_scale=cfg.sm_scale(), **_attn_options(cfg, lidx))

    logits = _prefill_run(params, tokens, new_lengths, start, cos, sin, cfg, attend, axis_name, lora, lora_sel)
    cache.lengths.copy_(kv_lengths)
    return logits, cache


# ---------------------------------------------------------------------------
# Serving decode rounds
# ---------------------------------------------------------------------------


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """log P(tok) under log_softmax(logits) -> (B,) fp32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp.gather(1, tok.long()[:, None])[:, 0]


def topk_token_logprobs(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k alternatives per row under the unmodified distribution ->
    ((B, k) fp32 logprobs, descending; (B, k) int32 token ids)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    v, i = torch.topk(lp, k, dim=-1)
    return v, i.to(torch.int32)


def _decode_rounds(step, tok, cache, n_steps, sampling, with_logprobs, topk_logprobs):
    """``n_steps`` calls of ``step(tok) -> logits`` with the next token
    chosen on the device each time: no host sync inside the loop."""
    toks, lps, tk_v, tk_i = [], [], [], []
    for _ in range(n_steps):
        logits = step(tok)
        if sampling is None:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            # the post-step length IS the new token's absolute position
            nxt = core_sampling.sample_tokens(logits, sampling, cache.lengths)
        toks.append(nxt)
        if with_logprobs:
            lps.append(token_logprob(logits, nxt))
        if topk_logprobs:
            v, i = topk_token_logprobs(logits, topk_logprobs)
            tk_v.append(v)
            tk_i.append(i)
        tok = nxt
    res = (torch.stack(toks, dim=1), tok, cache)  # (B, n), (B,), cache
    if with_logprobs:
        res = res + (torch.stack(lps, dim=1),)  # (B, n)
    if topk_logprobs:
        res = res + (torch.stack(tk_v, dim=1), torch.stack(tk_i, dim=1))  # (B, n, K) each
    return res


def decode_multi(params: Params, cache: contiguous.KVCache, tok: torch.Tensor, cos, sin, active,
                 cfg: ModelConfig, n_steps: int, sampling: dict | None = None,
                 with_logprobs: bool = False, topk_logprobs: int = 0,
                 max_len_hint: int | None = None, axis_name=None, lora=None, lora_sel=None) -> tuple:
    """``n_steps`` decode steps (JAX llama.py:1071-1179) -> (tokens (B, n)
    int32, next pending token (B,), cache[, chosen-token logprobs (B, n)]
    [, top-k logprobs (B, n, K), top-k ids (B, n, K)]), all on the device:
    the caller reads them back once. ``sampling`` (tensors from
    ``core.sampling.state_tensors``) switches argmax to per-slot sampling
    keyed on (seed, position); logprobs are under the unmodified
    distribution. ``max_len_hint`` sizes the TPU grid and is unused here
    (the kernels walk each row's own length). ``lora`` / ``lora_sel`` as in
    :func:`decode_step`, the same selector every step."""
    del max_len_hint
    active = _as_mask(active, cache.lengths.device)
    return _decode_rounds(
        lambda t: decode_step(params, cache, t, cos, sin, cfg, active=active, axis_name=axis_name, lora=lora,
                              lora_sel=lora_sel)[0],
        tok, cache, n_steps, sampling, with_logprobs, topk_logprobs)


def decode_multi_paged(params: Params, cache: paged.PagedKVCache, tok: torch.Tensor, cos, sin,
                       active, cfg: ModelConfig, n_steps: int, sampling: dict | None = None,
                       with_logprobs: bool = False, topk_logprobs: int = 0,
                       max_len_hint: int | None = None, axis_name=None, lora=None, lora_sel=None) -> tuple:
    """Paged twin of :func:`decode_multi` (JAX llama.py:1893-1970)."""
    del max_len_hint
    active = _as_mask(active, cache.lengths.device)
    return _decode_rounds(
        lambda t: decode_step_paged(params, cache, t, cos, sin, cfg, active=active, axis_name=axis_name,
                                    lora=lora, lora_sel=lora_sel)[0],
        tok, cache, n_steps, sampling, with_logprobs, topk_logprobs)


# ---------------------------------------------------------------------------
# Speculative decoding (prompt-lookup or draft-model drafts + multi-token verify)
# ---------------------------------------------------------------------------


def _verify_core(params: Params, cache: contiguous.KVCache, tokens: torch.Tensor, cos, sin,
                 cfg: ModelConfig, active: torch.Tensor | None = None, axis_name=None) -> torch.Tensor:
    """T consecutive tokens per sequence in one step (JAX llama.py:1237-1328)
    -> fp32 logits at EVERY position (B, T, V); the cache gains T rows per
    active row, IN PLACE. Structurally the prefill layer (``_prefill_layer``)
    with an ``attend`` that appends the T rows at ``min(start, S - T)`` (the
    JAX clamp, made in the kernel) and attends them at ``start + 1``, in one
    launch of K1's verify mode with K9 folded in
    (``ops.flash_decode.flash_verify_append``). Inactive rows write no row
    and keep their length; their attention output is discarded. The caller
    rolls ``cache.lengths`` back to the accepted prefix."""
    check_supported(cfg)
    _check_axis(axis_name)
    b, t = tokens.shape
    start = cache.lengths.clone()
    if active is None:
        n_valid = torch.full_like(start, t)
    else:
        n_valid = torch.where(active, torch.full_like(start, t), torch.zeros_like(start))
    att_lengths = start + 1

    def attend(lidx, q, k_new, v_new):  # the block append at start, clamped to S - T, in the attention's launch
        ks, vs = cache.layer_scales(lidx)
        return flash_verify_append(q, cache.k, cache.v,
                                   contiguous.quantize_new(k_new, ks, cache.k.dtype).contiguous(),
                                   contiguous.quantize_new(v_new, vs, cache.v.dtype).contiguous(), start,
                                   n_valid, att_lengths, layer=lidx, sm_scale=cfg.sm_scale(),
                                   block_k=cfg.block_k, k_scales=ks, v_scales=vs,
                                   **_attn_options(cfg, lidx))  # (B, Hq, T, D)

    pos = start[:, None] + torch.arange(t, device=start.device, dtype=torch.int32)[None, :]
    rope_pos = _rope_positions(pos, cos)
    x = _embed_tokens(params, tokens, cfg)  # (B, T, H)
    layers = params["layers"]
    for lidx in range(cfg.num_layers):
        x = _prefill_layer(x, lidx, layers, cfg, cos, sin, rope_pos, attend, axis_name)
    cache.lengths.copy_(start + n_valid)
    return _logits(x.reshape(b * t, -1), params, cfg, axis_name).reshape(b, t, -1)


def _accept(logits: torch.Tensor, draft: torch.Tensor, active: torch.Tensor):
    """Accept-longest-prefix on the verify logits (JAX llama.py:1367-1391):
    -> (this round's tokens (B, T), emitted counts (B,), accepted counts
    (B,), bonus tokens (B,)). Row b's first ``n_emit[b]`` tokens are its
    accepted drafts and the model's own next token."""
    preds = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, T), the first maximum
    match = (preds[:, :-1] == draft).to(torch.int32)
    acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)  # longest accepted prefix
    acc = torch.where(active, acc, torch.zeros_like(acc))
    bonus = preds.gather(1, acc[:, None].long())[:, 0]
    n_emit = torch.where(active, acc + 1, torch.zeros_like(acc))
    t = preds.shape[1]
    cols = torch.arange(t, dtype=torch.int32, device=preds.device)[None, :]
    draft_pad = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
    out = torch.where(cols < acc[:, None], draft_pad,
                      torch.where(cols == acc[:, None], bonus[:, None], torch.zeros_like(draft_pad)))
    return out, n_emit, acc, bonus


def _spec_step(params: Params, cache: contiguous.KVCache, history: torch.Tensor,
               pending: torch.Tensor, cos, sin, active: torch.Tensor, cfg: ModelConfig,
               num_draft: int, ngram: int, axis_name=None):
    """One prompt-lookup round (JAX llama.py:1331-1392): draft -> verify ->
    accept. Returns (history, pending, tokens (B, k+1), n_emit (B,)); the
    cache is updated IN PLACE and rolled back to ``start + n_emit``.
    Inactive rows keep their cache, history and pending token."""
    start = cache.lengths.clone()
    history0 = history
    history = drafting.write_token(history, start, pending)
    draft = drafting.propose_drafts(history, start, pending, num_draft=num_draft, ngram=ngram)
    tokens = torch.cat([pending[:, None], draft], dim=1)  # (B, T)
    logits = _verify_core(params, cache, tokens, cos, sin, cfg, active=active, axis_name=axis_name)
    out, n_emit, acc, bonus = _accept(logits, draft, active)
    cache.lengths.copy_(start + n_emit)
    hist_new = drafting.write_block(history, start + 1, draft)
    hist_new = drafting.write_token(hist_new, start + acc + 1, bonus)
    history = torch.where(active[:, None], hist_new, history0)
    return history, torch.where(active, bonus, pending), out, n_emit


def spec_decode_multi(params: Params, cache: contiguous.KVCache, history: torch.Tensor,
                      tok: torch.Tensor, cos, sin, active, cfg: ModelConfig, n_steps: int,
                      num_draft: int = 4, ngram: int = 4, max_len_hint: int | None = None,
                      axis_name=None) -> tuple:
    """``n_steps`` prompt-lookup speculative rounds (JAX llama.py:1430-1465)
    -> (tokens (B, n, k+1), counts (B, n), next pending (B,), cache,
    history), all on the device: row b of round i emitted ``counts[b, i]``
    tokens ``tokens[b, i, :counts[b, i]]``. Greedy only; the cache is updated
    IN PLACE and the history (B, S_hist) int32 comes back as a new tensor.
    ``max_len_hint`` sizes the TPU grid and is unused here. ``axis_name``:
    the verify step is tensor-parallel as :func:`decode_step` (each rank's
    argmax sees the full-vocab logits, so the accept decisions are equal)."""
    del max_len_hint
    active = _as_mask(active, cache.lengths.device)
    outs, counts = [], []
    for _ in range(n_steps):
        history, tok, out, n_emit = _spec_step(params, cache, history, tok, cos, sin, active, cfg,
                                               num_draft, ngram, axis_name)
        outs.append(out)
        counts.append(n_emit)
    return torch.stack(outs, dim=1), torch.stack(counts, dim=1), tok, cache, history


def _spec_step_draft_model(params: Params, cache: contiguous.KVCache, dparams: Params,
                           dcache: contiguous.KVCache, pending: torch.Tensor, cos, sin, dcos,
                           dsin, active: torch.Tensor, cfg: ModelConfig, dcfg: ModelConfig,
                           num_draft: int, axis_name=None, draft_axis_name=None):
    """One draft-model round (JAX llama.py:1468-1552): k+1 draft decode
    steps feed [pending, d_1..d_k] (step j's argmax is d_j; the last step
    only appends d_k's row), the target verifies them in one step, both
    caches roll back to ``start + n_emit`` in lockstep. Returns (pending,
    tokens (B, k+1), n_emit (B,))."""
    start = cache.lengths.clone()
    tok, drafts = pending, []
    for _ in range(num_draft + 1):
        logits, _ = decode_step(dparams, dcache, tok, dcos, dsin, dcfg, active=active,
                                axis_name=draft_axis_name)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        drafts.append(tok)
    draft = torch.stack(drafts[:num_draft], dim=1)  # (B, k)
    tokens = torch.cat([pending[:, None], draft], dim=1)
    logits = _verify_core(params, cache, tokens, cos, sin, cfg, active=active, axis_name=axis_name)
    out, n_emit, _, bonus = _accept(logits, draft, active)
    cache.lengths.copy_(start + n_emit)
    dcache.lengths.copy_(start + n_emit)  # inactive rows never advanced: start is their length
    return torch.where(active, bonus, pending), out, n_emit


def spec_decode_multi_draft(params: Params, cache: contiguous.KVCache, dparams: Params,
                            dcache: contiguous.KVCache, tok: torch.Tensor, cos, sin, dcos, dsin,
                            active, cfg: ModelConfig, dcfg: ModelConfig, n_steps: int,
                            num_draft: int = 4, max_len_hint: int | None = None, axis_name=None,
                            draft_axis_name=None) -> tuple:
    """``n_steps`` draft-model speculative rounds (JAX llama.py:1594-1624)
    -> (tokens (B, n, k+1), counts (B, n), next pending, cache, draft
    cache); both caches are updated IN PLACE. Under TP the target is
    sharded over ``axis_name`` and the draft runs whole on every rank
    (``draft_axis_name`` None, as in JAX's TP engine)."""
    del max_len_hint
    active = _as_mask(active, cache.lengths.device)
    outs, counts = [], []
    for _ in range(n_steps):
        tok, out, n_emit = _spec_step_draft_model(params, cache, dparams, dcache, tok, cos, sin,
                                                  dcos, dsin, active, cfg, dcfg, num_draft, axis_name,
                                                  draft_axis_name)
        outs.append(out)
        counts.append(n_emit)
    return torch.stack(outs, dim=1), torch.stack(counts, dim=1), tok, cache, dcache


# ---------------------------------------------------------------------------
# Sampling and generation
# ---------------------------------------------------------------------------


def sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling -> (B,) int32: the first maximum, as ``jnp.argmax``
    takes it. Per-request temperature / top-k / top-p / min-p sampling is
    ``core.sampling.sample_tokens``, which the serving engines use."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def generate(
    params: Params,
    cfg: ModelConfig,
    prompts,  # (B, Sp) int, right-padded
    prompt_lengths,  # (B,)
    max_new_tokens: int,
    *,
    cache: contiguous.KVCache | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Greedy prefill + autoregressive decode -> (B, max_new_tokens) int32
    token ids. Runs on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``), where ``params`` must already live. A given
    ``cache`` is filled IN PLACE."""
    check_supported(cfg)
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, generate runs on {dev}")
    prompts = torch.as_tensor(np.asarray(prompts) if not torch.is_tensor(prompts) else prompts)
    prompts = prompts.to(device=dev, dtype=torch.int32)
    prompt_lengths = torch.as_tensor(
        np.asarray(prompt_lengths) if not torch.is_tensor(prompt_lengths) else prompt_lengths
    ).to(device=dev, dtype=torch.int32)
    b = prompts.shape[0]
    if cache is None:
        hkv, d = cfg.kv_cache_dims()
        cache = contiguous.init_cache(cfg.num_layers, b, hkv, cfg.max_seq_len, d,
                                      dtype=torch_dtype(cfg.dtype), quant_mode=cfg.quant_mode,
                                      calibration_scale=cfg.kv_calibration_scale, device=dev)
    cos, sin = rope_tables(cfg, device=dev)
    logits, cache = prefill(params, cache, prompts, prompt_lengths, cos, sin, cfg)
    out = []
    tok = sample(logits)
    for i in range(max_new_tokens):
        out.append(tok)
        if i == max_new_tokens - 1:
            break
        logits, cache = decode_step(params, cache, tok, cos, sin, cfg)
        tok = sample(logits)
    return torch.stack(out, dim=1)
