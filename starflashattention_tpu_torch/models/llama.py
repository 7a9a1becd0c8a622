"""Llama-family GQA transformer, dense-GQA subset — twin of the JAX
``models/llama.py``.

Greedy ``generate`` = ``prefill`` + repeated ``decode_step``, with the JAX
package's parameter layout: layer weights stacked on a leading (L, ...) axis
and used as ``x @ w`` (so weights bridge by copy, never by transpose).
Quantized projections stay stacked and reach ``quant_matmul`` with a layer
index, so no per-layer copy is made. Layers run in a Python loop (PyTorch
is eager; the JAX package scans).

The cache is updated IN PLACE: ``prefill`` and ``decode_step`` write the
new K/V rows into ``cache.k``/``cache.v`` and advance ``cache.lengths``,
where the JAX package donates the cache to its jitted step and returns a
new one. Both return the same cache object for call-site parity.

On CUDA tensors every projection of a quantized model, the cache append
and both attentions run on the hand-written kernels of ``ops/``; on CPU
tensors the same code runs their plain versions. Config fields outside
this slice raise ``NotImplementedError`` (:func:`check_supported`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from starflashattention_tpu_torch.cache import contiguous
from starflashattention_tpu_torch.core import quant
from starflashattention_tpu_torch.core.rope import apply_rope, rope_table
from starflashattention_tpu_torch.ops.flash_decode import flash_decode
from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill
from starflashattention_tpu_torch.ops.quant_matmul import quant_matmul
from starflashattention_tpu_torch.runtime.params import ModelConfig
from starflashattention_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

_QUANT_WEIGHTS = ("wqkv", "wo", "w_gate_up", "w_down")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for config fields this slice does not
    port; each names the ROADMAP queue that holds it."""
    unported = {
        "num_experts (MoE)": cfg.num_experts != 0,
        "mla": cfg.mla,
        "sliding_window": cfg.sliding_window is not None,
        "attn_softcap": cfg.attn_softcap is not None,
        "final_softcap": cfg.final_softcap is not None,
        "post_norms": cfg.post_norms,
        "embed_scale": cfg.embed_scale,
        f"mlp_activation={cfg.mlp_activation!r}": cfg.mlp_activation != "silu",
        f"quant_mode={cfg.quant_mode!r} (quantized KV cache)": cfg.quant_mode != "none",
        "w8a8_prefill (kernel K10)": cfg.w8a8_prefill,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported yet: {', '.join(bad)} (ROADMAP Queue 1 item 10 onward, Queue 2)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _stack_quantized(per_layer: list[dict]) -> dict:
    return {"w": torch.stack([p["w"] for p in per_layer]),
            "scale": torch.stack([p["scale"] for p in per_layer])}


def _quantize_stacked(w: torch.Tensor, mode: str) -> dict:
    """Quantize an (L, H, O) stack one layer at a time (the fp32
    intermediate is one layer's worth)."""
    return _stack_quantized([quant.quantize_weight(w[i], mode) for i in range(w.shape[0])])


def quantize_model_weights(params: Params, mode: str = "int8", lm_head: bool = False,
                           consume: bool = False) -> Params:
    """Weight-only quantization of the projection stacks (and the lm_head
    with ``lm_head=True``) with per-output-channel scales; the embedding
    stays dense. ``consume=True`` drops each dense stack from ``params`` as
    it is quantized. Same weight bytes as the JAX package; the scales agree
    with it to one fp32 ulp, because the JAX package jit-compiles this step
    and XLA multiplies by ``1 / qmax`` where the division here (and JAX's
    eager ``quantize_weight``) divides by ``qmax``."""
    src_layers = params["layers"]
    layers = dict(src_layers)
    for name in (n for n in _QUANT_WEIGHTS if n in src_layers):
        if isinstance(src_layers[name], dict):
            continue
        w = src_layers.pop(name) if consume else src_layers[name]
        layers[name] = _quantize_stacked(w, mode)
        del w
    out = dict(params)
    out["layers"] = layers
    if lm_head and "lm_head" in params and not isinstance(params["lm_head"], dict):
        w = out.pop("lm_head")
        if consume:
            params.pop("lm_head")
        out["lm_head"] = quant.quantize_weight(w, mode)
        del w
    return out


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator | None = None,
    *,
    quantize: str | None = None,
    device: torch.device | str | None = None,
) -> Params:
    """Random-init parameters on ``device`` (default ``cuda``) from
    ``generator`` (default: a generator on that device seeded with 0).
    Layer params are stacked on a leading L axis, as in the JAX package,
    in ``cfg.dtype``.

    ``quantize`` ("int8" / "fp8") generates each big projection one layer
    at a time and quantizes it at once, so the dense stack never exists;
    the lm_head stays dense (quantize it with
    ``quantize_model_weights(..., lm_head=True)``). The values differ from
    the JAX package's (another generator): tests bridge JAX's params with
    ``utils.bridge.params_from_numpy`` instead."""
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
        return _stack_quantized([quant.quantize_weight(norm01(shape[1:], fan_in), quantize)
                                 for _ in range(shape[0])])

    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)  # noqa: E731
    params: Params = {
        "embed": norm01((cfg.vocab_size, h), 1.0),
        "layers": {
            "attn_norm": ones(n_layers, h),
            # wqkv columns: [q (Hq*D) | k (Hkv*D) | v (Hkv*D)], head-major
            "wqkv": big((n_layers, h, (hq + 2 * hkv) * d), h),
            "wo": big((n_layers, hq * d, h), hq * d),
            "mlp_norm": ones(n_layers, h),
            # w_gate_up columns: [gate (I) | up (I)]
            "w_gate_up": big((n_layers, h, 2 * inter), h),
            "w_down": big((n_layers, inter, h), inter),
        },
        "final_norm": ones(h),
    }
    if cfg.attention_bias:
        params["layers"]["bqkv"] = norm01((n_layers, (hq + 2 * hkv) * d), h)
    if cfg.qk_norm:
        params["layers"]["q_norm"] = ones(n_layers, d)
        params["layers"]["k_norm"] = ones(n_layers, d)
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


def _embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _wq_matmul(x2d: torch.Tensor, w: dict, layer, out_dtype=None) -> torch.Tensor:
    return quant_matmul(x2d, w["w"], w["scale"], layer=layer, out_dtype=out_dtype)


def _make_proj(layers: Params, lidx: int):
    """Projection closure for one layer -> fp32 outputs (or ``out_dtype``
    written by the quantized kernel). Quantized stacks go to
    ``quant_matmul`` with the layer index; dense ones to ``torch.matmul``
    at fp32 (the JAX package's ``jnp.dot`` outside Pallas)."""

    def proj(x: torch.Tensor, name: str, out_dtype=None) -> torch.Tensor:
        w = layers[name]
        if isinstance(w, dict):
            out = _wq_matmul(x.reshape(-1, x.shape[-1]), w, lidx, out_dtype=out_dtype)
            return out.reshape(*x.shape[:-1], out.shape[-1])
        return torch.matmul(x.float(), w[lidx].float())

    return proj


def _apply_qk_norm(q, k, layers, lidx, cfg):
    if "q_norm" not in layers:
        return q, k
    return (rms_norm(q, layers["q_norm"][lidx], cfg.rms_norm_eps),
            rms_norm(k, layers["k_norm"][lidx], cfg.rms_norm_eps))


def _swiglu(x: torch.Tensor, proj) -> torch.Tensor:
    """SwiGLU MLP -> fp32: gate_up written in x's dtype, ``silu(gate) * up``
    cast to x's dtype, w_down written in fp32."""
    gu = proj(x, "w_gate_up", out_dtype=x.dtype)
    inter = gu.shape[-1] // 2
    gate, up = gu[..., :inter], gu[..., inter:]
    act = (F.silu(gate) * up).to(x.dtype)
    return proj(act, "w_down")


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


def _qkv(h, layers, lidx, proj, cfg, x_dtype):
    qkv = proj(h, "wqkv", out_dtype=x_dtype).to(x_dtype)
    if "bqkv" in layers:
        qkv = qkv + layers["bqkv"][lidx]
    return qkv


def _logits(x: torch.Tensor, params: Params, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, dict):
        return _wq_matmul(x, head, 0)
    return torch.matmul(x.float(), head.float())


def rope_tables(cfg: ModelConfig, device: torch.device | str | None = None):
    """fp32 cos/sin tables (max_seq_len, head_dim // 2) on ``device``
    (default cuda)."""
    return rope_table(cfg.max_seq_len, cfg.head_dim, base=cfg.rope_base,
                      scaling=cfg.rope_scaling, device=resolve_device(device))


def _mlp_residual(x, layers, lidx, proj, cfg):
    h = rms_norm(x, layers["mlp_norm"][lidx], cfg.rms_norm_eps)
    return x + _swiglu(h, proj).to(x.dtype)


# ---------------------------------------------------------------------------
# Decode step (one token per sequence, whole model)
# ---------------------------------------------------------------------------


def _decode_layer(x, cache: contiguous.KVCache, lidx: int, layers: Params, cfg: ModelConfig,
                  cos, sin, pos, att_lengths) -> torch.Tensor:
    """One decoder layer of the decode step: appends this token's K/V to
    layer ``lidx`` of the cache in place and returns the new residual."""
    proj = _make_proj(layers, lidx)
    h = rms_norm(x, layers["attn_norm"][lidx], cfg.rms_norm_eps)
    q, k_new, v_new = _split_heads_decode(_qkv(h, layers, lidx, proj, cfg, x.dtype), cfg)
    q, k_new = _apply_qk_norm(q, k_new, layers, lidx, cfg)
    q = apply_rope(q, pos, cos, sin, style=cfg.rope_style)
    k_new = apply_rope(k_new, pos, cos, sin, style=cfg.rope_style)

    contiguous.append_decode(cache, lidx, k_new, v_new)  # at lengths, clamped below S
    o = flash_decode(q, cache.k, cache.v, att_lengths, layer=lidx, sm_scale=cfg.sm_scale(),
                     num_splits=cfg.num_splits, block_k=cfg.block_k)  # (B, Hq, D)
    x = x + proj(o.reshape(o.shape[0], -1), "wo").to(x.dtype)
    return _mlp_residual(x, layers, lidx, proj, cfg)


def decode_step(params: Params, cache: contiguous.KVCache, tokens: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, cfg: ModelConfig):
    """One decode step: (B,) token ids -> (B, V) fp32 logits. Writes each
    layer's new K/V row into ``cache`` and advances ``cache.lengths`` IN
    PLACE; returns ``(logits, cache)``. Runs on the device of the tensors."""
    check_supported(cfg)
    x = _embed_tokens(params, tokens)  # (B, H)
    pos = cache.lengths.clone()
    att_lengths = pos + 1
    layers = params["layers"]
    for lidx in range(cfg.num_layers):
        x = _decode_layer(x, cache, lidx, layers, cfg, cos, sin, pos, att_lengths)
    cache.lengths.copy_(att_lengths)
    return _logits(x, params, cfg), cache


# ---------------------------------------------------------------------------
# Prefill (prompt chunk, whole model)
# ---------------------------------------------------------------------------


def _prefill_layer(x, cache: contiguous.KVCache, lidx: int, layers: Params, cfg: ModelConfig,
                   cos, sin, start, pos, kv_lengths) -> torch.Tensor:
    b, sq = pos.shape
    proj = _make_proj(layers, lidx)
    h = rms_norm(x, layers["attn_norm"][lidx], cfg.rms_norm_eps)
    q, k_new, v_new = _split_heads_prefill(_qkv(h, layers, lidx, proj, cfg, x.dtype), cfg)
    q, k_new = _apply_qk_norm(q, k_new, layers, lidx, cfg)
    q = apply_rope(q, pos[:, None, :], cos, sin, style=cfg.rope_style)
    k_new = apply_rope(k_new, pos[:, None, :], cos, sin, style=cfg.rope_style)

    contiguous.append_prefill(cache, lidx, k_new, v_new)  # rows [start, start + Sq)

    o = flash_prefill(q, cache.k[lidx], cache.v[lidx], lengths=kv_lengths, causal=True,
                      q_offsets=start, sm_scale=cfg.sm_scale())  # (B, Hq, Sq, D)
    o = o.transpose(1, 2).reshape(b, sq, -1)
    x = x + proj(o, "wo").to(x.dtype)
    return _mlp_residual(x, layers, lidx, proj, cfg)


def prefill(params: Params, cache: contiguous.KVCache, tokens: torch.Tensor,
            new_lengths: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            cfg: ModelConfig):
    """Prompt ingestion: (B, Sq) right-padded tokens with ``new_lengths``
    valid per row -> (B, V) fp32 logits at each row's last valid token.
    Writes the whole Sq-row window of every layer into ``cache`` at
    ``cache.lengths`` and advances the lengths by ``new_lengths``, IN PLACE;
    returns ``(logits, cache)``.

    Raises if ``cache.lengths + Sq`` exceeds the cache: the JAX package's
    ``dynamic_update_slice`` would shift such a window left over valid rows
    instead."""
    check_supported(cfg)
    b, sq = tokens.shape
    contiguous.check_prefill_window(cache, sq)  # before RoPE indexes past its table
    start = cache.lengths.clone()
    new_lengths = new_lengths.to(device=start.device, dtype=torch.int32)
    pos = start[:, None] + torch.arange(sq, device=start.device, dtype=torch.int32)[None, :]
    kv_lengths = start + new_lengths
    x = _embed_tokens(params, tokens)  # (B, Sq, H)
    layers = params["layers"]
    for lidx in range(cfg.num_layers):
        x = _prefill_layer(x, cache, lidx, layers, cfg, cos, sin, start, pos, kv_lengths)
    cache.lengths.copy_(kv_lengths)
    last = torch.clamp(new_lengths - 1, min=0).long()
    x_last = x[torch.arange(b, device=x.device), last]
    return _logits(x_last, params, cfg), cache


# ---------------------------------------------------------------------------
# Sampling and generation
# ---------------------------------------------------------------------------


def sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling -> (B,) int32: the first maximum, as ``jnp.argmax``
    takes it. Temperature sampling comes with the serving port (ROADMAP
    Queue 1 item 9)."""
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
                                      dtype=torch_dtype(cfg.dtype), device=dev)
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
