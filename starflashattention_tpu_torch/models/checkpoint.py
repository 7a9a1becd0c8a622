"""Checkpoints: HuggingFace weights into the port's tree, and the port's own
native save / restore — twin of the JAX ``models/checkpoint.py``.

:func:`config_from_hf` maps a transformers config of any supported family
(Llama / Llama-3, Mistral, Qwen2, Qwen3, Qwen3-MoE, Mixtral, Gemma,
Gemma-2, Phi-3, DeepSeek-V2) to a ``ModelConfig``, field for field as the
JAX package does, with one refusal more: DeepSeek's ``norm_topk_prob``
(below). :func:`load_hf_state_dict` converts an HF state dict (torch
tensors or numpy arrays, (out, in) projections) into the tree of
``models/llama.init_params``: (L, H, O) stacks used as ``x @ w``, q / k / v
fused into ``wqkv`` [q|k|v], gate / up into ``w_gate_up`` [gate|up],
experts on an (L, E, ...) axis, MLA's ``kv_b_proj`` split into ``wuk`` /
``wuv``. Each stack is allocated once on ``device`` and filled layer by
layer, so the peak is the HF dict plus the tree; every cast rounds to
nearest even, as JAX's ``jnp.asarray(fp32, dtype)`` does, so both
packages give the same bits.

:func:`save_checkpoint` / :func:`load_checkpoint` write and read the
port's own tree (quantized ``{"w", "scale"}`` leaves as they are: int8,
fp8 and int4 payloads with their scales) with ``torch.save`` /
``torch.load(weights_only=True)``, and the config as ``config.json``; the
config's tuple fields come back as tuples, so the restored config equals
the saved one and hashes (the JAX package rebuilds ``rope_scaling`` as a
list there).

HF checkpoints use the "half" (rotate_half) RoPE convention, the
``ModelConfig`` default. ``transformers`` is imported only by
:func:`load_hf_model`.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Mapping

import torch

from starflashattention_tpu_torch.models.llama import torch_dtype
from starflashattention_tpu_torch.runtime.params import ModelConfig
from starflashattention_tpu_torch.utils.bridge import tensor_from_numpy
from starflashattention_tpu_torch.utils.device import resolve_device

PARAMS_FILE, CONFIG_FILE = "params.pt", "config.json"


def _hf_rope_scaling(hf_config) -> tuple | None:
    """HF rope_scaling dict -> the hashable tuple ModelConfig carries."""
    rs = getattr(hf_config, "rope_scaling", None)
    if not isinstance(rs, dict):
        return None
    kind = rs.get("rope_type", rs.get("type"))
    if kind == "longrope":
        # Phi-3 su-scaling: per-dim factor lists as tuples; the target is the
        # checkpoint's full max_position_embeddings (HF derives the
        # attention factor from it, not from a shorter serving table)
        return (
            "longrope",
            int(getattr(hf_config, "original_max_position_embeddings", hf_config.max_position_embeddings)),
            int(hf_config.max_position_embeddings),
            tuple(float(f) for f in rs["short_factor"]),
            tuple(float(f) for f in rs["long_factor"]),
        )
    if kind == "llama3":
        return ("llama3", float(rs.get("factor", 8.0)), float(rs.get("low_freq_factor", 1.0)),
                float(rs.get("high_freq_factor", 4.0)), int(rs.get("original_max_position_embeddings", 8192)))
    if kind == "linear":
        return ("linear", float(rs.get("factor", 1.0)))
    raise ValueError(f"unsupported rope_scaling type {kind!r}")


def _as_torch(t) -> torch.Tensor:
    """``t`` (torch tensor or numpy array, ml_dtypes' bf16 / fp8 included)
    as a torch tensor in its own dtype, with no cast."""
    return t.detach() if isinstance(t, torch.Tensor) else tensor_from_numpy(t)


def _to_tensor(t, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``t`` (torch tensor or numpy array) as a new contiguous tensor in
    ``dtype`` on ``device``: one cast, rounding to nearest even (the bits of
    JAX's ``jnp.asarray(fp32, dtype)``; bf16 to bf16 is exact), with no
    detour through host fp32."""
    src = _as_torch(t)
    return torch.empty(src.shape, dtype=dtype, device=device).copy_(src)


def _target_dtype(dtype, cfg: ModelConfig) -> torch.dtype:
    if dtype is None:
        return torch_dtype(cfg.dtype)
    return torch_dtype(dtype) if isinstance(dtype, str) else dtype


def config_from_hf(hf_config) -> ModelConfig:
    """ModelConfig from a transformers config of any supported family, as
    the JAX package maps it. Raises ``ValueError`` for what neither package
    serves (DeepSeek-V3's router, ``group_limited_greedy``, ``moe_layer_freq
    != 1``, yarn; Qwen3-MoE without ``norm_topk_prob``, with a sparse step or
    dense layers), and, where the JAX package accepts it, for a DeepSeek MoE
    with ``norm_topk_prob=True``: DeepSeek normalises the top-k weights
    then, which the router here does not."""
    model_type = getattr(hf_config, "model_type", "llama")
    # Qwen2 always carries q/k/v biases; Llama-family configs have an
    # attention_bias flag (default False)
    attention_bias = bool(getattr(hf_config, "attention_bias", False) or model_type == "qwen2")
    # Mistral: sliding_window is the window (None: none); Qwen2 gates it
    # behind use_sliding_window (default False)
    window = getattr(hf_config, "sliding_window", None)
    if not getattr(hf_config, "use_sliding_window", True):
        window = None
    qk_norm = model_type in ("qwen3", "qwen3_moe")  # architectural, no flag
    # DeepSeek V2 / V3: MLA; V2's greedy MoE (softmax over all experts, top-k
    # unnormalised, times routed_scaling_factor; shared experts; the first k
    # layers dense)
    is_deepseek = model_type in ("deepseek_v2", "deepseek_v3")
    mla_kw = {}
    deepseek_moe = is_deepseek and bool(getattr(hf_config, "n_routed_experts", None))
    if deepseek_moe:
        if model_type == "deepseek_v3":
            raise ValueError("DeepSeek-V3 MoE (sigmoid scores + e_score_correction_bias) "
                             "is unsupported — V2's greedy softmax gate only")
        if getattr(hf_config, "topk_method", "greedy") != "greedy":
            raise ValueError("DeepSeek MoE topk_method "
                             f"{hf_config.topk_method!r} is unsupported (greedy only — "
                             "group_limited_greedy's device-group masking is not "
                             "implemented)")
        if getattr(hf_config, "moe_layer_freq", 1) != 1:
            raise ValueError("DeepSeek moe_layer_freq != 1 is unsupported")
        if getattr(hf_config, "norm_topk_prob", False):
            raise ValueError("DeepSeek MoE with norm_topk_prob=True is unsupported: the router "
                             "weights the top-k experts by their softmax over all experts, "
                             "unnormalised (times routed_scaling_factor)")
        first_k = int(getattr(hf_config, "first_k_dense_replace", 0) or 0)
        mla_kw.update(
            n_shared_experts=int(getattr(hf_config, "n_shared_experts", 0) or 0),
            first_k_dense=first_k,
            dense_inter_size=hf_config.intermediate_size if first_k else None,
            router_pre_softmax=True,
            routed_scaling_factor=float(getattr(hf_config, "routed_scaling_factor", 1.0)),
        )
    if is_deepseek:
        if getattr(hf_config, "rope_scaling", None) is not None:
            raise ValueError("DeepSeek yarn rope_scaling is unsupported")
        mla_kw.update(
            mla=True,
            kv_lora_rank=hf_config.kv_lora_rank,
            q_lora_rank=getattr(hf_config, "q_lora_rank", None),
            qk_nope_head_dim=hf_config.qk_nope_head_dim,
            qk_rope_head_dim=hf_config.qk_rope_head_dim,
            v_head_dim=hf_config.v_head_dim,
            query_scale=float(hf_config.qk_nope_head_dim + hf_config.qk_rope_head_dim),
        )
    # Gemma: GeGLU and sqrt(hidden)-scaled embeddings; its (1 + w) RMSNorm
    # is folded into the stored weights by load_hf_state_dict
    is_gemma = model_type in ("gemma", "gemma2")
    is_gemma2 = model_type == "gemma2"
    hidden_act = getattr(hf_config, "hidden_act", None) or getattr(hf_config, "hidden_activation", None)
    if is_gemma or hidden_act == "gelu_pytorch_tanh":
        mlp_activation = "gelu_tanh"
    elif hidden_act == "gelu":
        mlp_activation = "gelu_exact"  # HF's erf GELU, not the tanh form
    else:
        mlp_activation = "silu"
    # Gemma-2: alternating sliding / full layers, score and logit softcaps,
    # query_pre_attn_scalar, post-norms; one split (the softcap)
    gemma2_kw = {}
    if is_gemma2:
        gemma2_kw = dict(
            attn_softcap=getattr(hf_config, "attn_logit_softcapping", None),
            final_softcap=getattr(hf_config, "final_logit_softcapping", None),
            query_scale=float(
                getattr(hf_config, "query_pre_attn_scalar", None)
                or (getattr(hf_config, "head_dim", None)
                    or hf_config.hidden_size // hf_config.num_attention_heads)
            ),
            sliding_window_pattern=2,
            post_norms=True,
            num_splits=1,
        )
    num_experts = (
        getattr(hf_config, "num_local_experts", 0)
        or (getattr(hf_config, "num_experts", 0) if model_type == "qwen3_moe" else 0)
        or (hf_config.n_routed_experts if deepseek_moe else 0)
        or 0
    )
    inter = hf_config.intermediate_size
    if deepseek_moe:
        # intermediate_size is the routed experts' width; the dense first
        # layers' width travels as dense_inter_size
        inter = hf_config.moe_intermediate_size
    if model_type == "qwen3_moe":
        # softmax over all, top-k, renormalised equals the softmax over the
        # top-k logits only with norm_topk_prob
        if not getattr(hf_config, "norm_topk_prob", True):
            raise ValueError("qwen3_moe with norm_topk_prob=False is unsupported: the "
                             "router computes softmax over the selected experts "
                             "(equivalent to HF's normalized form only)")
        if getattr(hf_config, "decoder_sparse_step", 1) != 1:
            raise ValueError("qwen3_moe decoder_sparse_step != 1 unsupported")
        if getattr(hf_config, "mlp_only_layers", None):
            raise ValueError("qwen3_moe mlp_only_layers is unsupported (every layer must "
                             "be routed — mixed dense/MoE stacks need per-layer params)")
        inter = hf_config.moe_intermediate_size
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=inter,
        num_layers=hf_config.num_hidden_layers,
        num_q_heads=hf_config.num_attention_heads,
        num_kv_heads=(1 if is_deepseek
                      else getattr(hf_config, "num_key_value_heads", None) or hf_config.num_attention_heads),
        head_dim=(hf_config.qk_nope_head_dim + hf_config.qk_rope_head_dim if is_deepseek
                  else getattr(hf_config, "head_dim", None)
                  or hf_config.hidden_size // hf_config.num_attention_heads),
        rms_norm_eps=hf_config.rms_norm_eps,
        rope_base=getattr(hf_config, "rope_theta", 10000.0),
        rope_scaling=_hf_rope_scaling(hf_config),
        max_seq_len=min(getattr(hf_config, "max_position_embeddings", 4096), 8192),
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        attention_bias=attention_bias,
        sliding_window=window,
        qk_norm=qk_norm,
        num_experts=num_experts,
        num_experts_per_tok=getattr(hf_config, "num_experts_per_tok", 2),
        mlp_activation=mlp_activation,
        embed_scale=is_gemma,
        norm_plus_one=is_gemma,
        **gemma2_kw,
        **mla_kw,
    )


def load_hf_state_dict(state: Mapping[str, Any], cfg: ModelConfig, dtype=None,
                       device: torch.device | str | None = None) -> dict:
    """An HF state dict (torch tensors or numpy arrays, any float dtype, on
    any device) -> the port's params tree in ``dtype`` (default
    ``cfg.dtype``; a torch dtype or its name) on ``device`` (default
    ``cuda``). Every stack is allocated once and filled layer by layer."""
    dtype = _target_dtype(dtype, cfg)
    dev = resolve_device(device)
    L, d, I, E = cfg.num_layers, cfg.head_dim, cfg.intermediate_size, cfg.num_experts
    hq, hkv, h = cfg.num_q_heads, cfg.num_kv_heads, cfg.hidden_size

    def get(name: str, shape=None) -> torch.Tensor:
        t = _as_torch(state[name])
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: got {tuple(t.shape)}, want {tuple(shape)}")
        return t

    def put(dst: torch.Tensor, name: str) -> None:  # equal shapes (copy_ would broadcast), one cast
        dst.copy_(get(name, dst.shape))

    def proj(dst: torch.Tensor, name: str) -> None:  # HF's (out, in) as this tree's (in, out)
        dst.copy_(get(name, dst.shape[::-1]).T)

    def norm(dst: torch.Tensor, name: str) -> None:
        # Gemma stores RMSNorm weights as offsets (x * (1 + w)): the +1 is
        # added in fp32, then rounded once, so the runtime's x * w is exact
        w = get(name, dst.shape)
        dst.copy_(w.to(device=dev, dtype=torch.float32) + 1.0 if cfg.norm_plus_one else w)

    def stack(*shape, zeros=False) -> torch.Tensor:
        return (torch.zeros if zeros else torch.empty)(shape, dtype=dtype, device=dev)

    layers: dict[str, Any] = {"attn_norm": stack(L, h)}
    if cfg.mla:
        c, nope, rope_d, vdim = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        qd = hq * (nope + rope_d)
        if cfg.q_lora_rank is not None:
            mla = {"wq_a": stack(L, h, cfg.q_lora_rank), "q_a_norm": stack(L, cfg.q_lora_rank),
                   "wq_b": stack(L, cfg.q_lora_rank, qd)}
        else:
            mla = {"wq": stack(L, h, qd)}
        mla.update(wkv_a=stack(L, h, c + rope_d), kv_a_norm=stack(L, c), wuk=stack(L, hq, nope, c),
                   wuv=stack(L, hq, c, vdim))
        layers["wo"] = stack(L, hq * vdim, h)
    else:
        wqkv = stack(L, h, (hq + 2 * hkv) * d)
        layers["wo"] = stack(L, hq * d, h)
    layers["mlp_norm"] = stack(L, h)
    if E:
        # a dense first layer's slices of the expert stacks stay zero
        dense_first = cfg.first_k_dense
        moe = {"router": stack(L, h, E, zeros=dense_first), "gate_up": stack(L, E, h, 2 * I, zeros=dense_first),
               "down": stack(L, E, I, h, zeros=dense_first)}
        if cfg.n_shared_experts:
            si = cfg.n_shared_experts * I
            moe.update(shared_gate_up=stack(L, h, 2 * si, zeros=dense_first),
                       shared_down=stack(L, si, h, zeros=dense_first))
        if dense_first:
            di = cfg.dense_inter_size
            dense = {"w_gate_up": stack(dense_first, h, 2 * di), "w_down": stack(dense_first, di, h)}
    else:
        w_gate_up, w_down = stack(L, h, 2 * I), stack(L, I, h)
    bqkv = stack(L, (hq + 2 * hkv) * d) if cfg.attention_bias else None
    if cfg.qk_norm:
        q_norm, k_norm = stack(L, d), stack(L, d)
    if cfg.post_norms:
        post_attn_norm, post_mlp_norm = stack(L, h), stack(L, h)

    for i in range(L):
        p = f"model.layers.{i}."
        sa = p + "self_attn."
        if cfg.mla:
            # the q path (direct or low-rank), the shared latent projection,
            # and kv_b split per head into W_uk (the first nope rows) and
            # W_uv (the next v rows), the absorbed form's operands
            if cfg.q_lora_rank is not None:
                proj(mla["wq_a"][i], sa + "q_a_proj.weight")
                put(mla["q_a_norm"][i], sa + "q_a_layernorm.weight")
                proj(mla["wq_b"][i], sa + "q_b_proj.weight")
            else:
                proj(mla["wq"][i], sa + "q_proj.weight")
            proj(mla["wkv_a"][i], sa + "kv_a_proj_with_mqa.weight")
            put(mla["kv_a_norm"][i], sa + "kv_a_layernorm.weight")
            kvb = get(sa + "kv_b_proj.weight", (hq * (nope + vdim), c)).reshape(hq, nope + vdim, c)
            mla["wuk"][i].copy_(kvb[:, :nope, :])
            mla["wuv"][i].copy_(kvb[:, nope:, :].transpose(1, 2))
        elif sa + "qkv_proj.weight" in state:
            proj(wqkv[i], sa + "qkv_proj.weight")  # Phi-3's fused rows [q|k|v]: wqkv's columns
        else:
            for name, lo, hi in (("q", 0, hq * d), ("k", hq * d, (hq + hkv) * d),
                                 ("v", (hq + hkv) * d, (hq + 2 * hkv) * d)):
                proj(wqkv[i, :, lo:hi], sa + f"{name}_proj.weight")
        if bqkv is not None:  # Qwen2: the biases in wqkv's [q|k|v] order
            for name, lo, hi in (("q", 0, hq * d), ("k", hq * d, (hq + hkv) * d),
                                 ("v", (hq + hkv) * d, (hq + 2 * hkv) * d)):
                put(bqkv[i, lo:hi], sa + f"{name}_proj.bias")
        proj(layers["wo"][i], sa + "o_proj.weight")
        if E and i < cfg.first_k_dense:
            # DeepSeek's first_k_dense_replace layer: its weights go to the
            # k-leading dense_mlp stack; its expert slices stay zero
            proj(dense["w_gate_up"][i, :, :di], p + "mlp.gate_proj.weight")
            proj(dense["w_gate_up"][i, :, di:], p + "mlp.up_proj.weight")
            proj(dense["w_down"][i], p + "mlp.down_proj.weight")
        elif E:
            # Mixtral: block_sparse_moe.gate (E, h), experts w1 = gate, w3 =
            # up, w2 = down; Qwen3-MoE and DeepSeek: mlp.gate and
            # mlp.experts.E.{gate,up,down}_proj (DeepSeek adds
            # mlp.shared_experts.*)
            qwen_moe = p + "mlp.gate.weight" in state
            proj(moe["router"][i], p + ("mlp.gate.weight" if qwen_moe else "block_sparse_moe.gate.weight"))
            gate, up, down = ("gate_proj", "up_proj", "down_proj") if qwen_moe else ("w1", "w3", "w2")
            for e in range(E):
                ep = p + (f"mlp.experts.{e}." if qwen_moe else f"block_sparse_moe.experts.{e}.")
                proj(moe["gate_up"][i, e, :, :I], ep + f"{gate}.weight")
                proj(moe["gate_up"][i, e, :, I:], ep + f"{up}.weight")
                proj(moe["down"][i, e], ep + f"{down}.weight")
            if cfg.n_shared_experts:
                sp = p + "mlp.shared_experts."
                proj(moe["shared_gate_up"][i, :, :si], sp + "gate_proj.weight")
                proj(moe["shared_gate_up"][i, :, si:], sp + "up_proj.weight")
                proj(moe["shared_down"][i], sp + "down_proj.weight")
        elif p + "mlp.gate_up_proj.weight" in state:
            proj(w_gate_up[i], p + "mlp.gate_up_proj.weight")  # Phi-3's fused [gate|up]
            proj(w_down[i], p + "mlp.down_proj.weight")
        else:
            proj(w_gate_up[i, :, :I], p + "mlp.gate_proj.weight")
            proj(w_gate_up[i, :, I:], p + "mlp.up_proj.weight")
            proj(w_down[i], p + "mlp.down_proj.weight")
        if cfg.qk_norm:  # Qwen3's per-head (D,) QK-norm weights
            put(q_norm[i], sa + "q_norm.weight")
            put(k_norm[i], sa + "k_norm.weight")
        norm(layers["attn_norm"][i], p + "input_layernorm.weight")
        if cfg.post_norms:
            # Gemma-2's four norms: post_attention_layernorm is the attention's
            # post-norm there (the MLP's pre-norm in the Llama family)
            norm(post_attn_norm[i], p + "post_attention_layernorm.weight")
            norm(layers["mlp_norm"][i], p + "pre_feedforward_layernorm.weight")
            norm(post_mlp_norm[i], p + "post_feedforward_layernorm.weight")
        else:
            norm(layers["mlp_norm"][i], p + "post_attention_layernorm.weight")

    # the JAX package's key order
    params: dict[str, Any] = {
        "embed": _to_tensor(state["model.embed_tokens.weight"], dtype, dev),
        "layers": {k: layers[k] for k in ("attn_norm", "wo", "mlp_norm")},
        "final_norm": stack(h),
    }
    norm(params["final_norm"], "model.norm.weight")
    out = params["layers"]
    if cfg.mla:
        out.update({"mla_" + name: t for name, t in mla.items()})
    else:
        out["wqkv"] = wqkv
    if E:
        out.update(moe_router=moe["router"], moe_gate_up=moe["gate_up"], moe_down=moe["down"])
        if cfg.n_shared_experts:
            out.update(moe_shared_gate_up=moe["shared_gate_up"], moe_shared_down=moe["shared_down"])
        if cfg.first_k_dense:
            out["dense_mlp"] = dense
    else:
        out.update(w_gate_up=w_gate_up, w_down=w_down)
    if bqkv is not None:
        out["bqkv"] = bqkv
    if cfg.qk_norm:
        out.update(q_norm=q_norm, k_norm=k_norm)
    if cfg.post_norms:
        out.update(post_attn_norm=post_attn_norm, post_mlp_norm=post_mlp_norm)
    if not cfg.tie_embeddings:
        params["lm_head"] = stack(h, cfg.vocab_size)
        proj(params["lm_head"], "lm_head.weight")
    _check_shapes(params, cfg)
    return params


def _check_shapes(params: dict, cfg: ModelConfig) -> None:
    d, hq, hkv, h = cfg.head_dim, cfg.num_q_heads, cfg.num_kv_heads, cfg.hidden_size
    I, E, L = cfg.intermediate_size, cfg.num_experts, cfg.num_layers
    if cfg.mla:
        expect = {
            ("layers", "mla_wkv_a"): (L, h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            ("layers", "mla_wuk"): (L, hq, cfg.qk_nope_head_dim, cfg.kv_lora_rank),
            ("layers", "mla_wuv"): (L, hq, cfg.kv_lora_rank, cfg.v_head_dim),
            ("layers", "wo"): (L, hq * cfg.v_head_dim, h),
            ("embed",): (cfg.vocab_size, h),
        }
    else:
        expect = {
            ("layers", "wqkv"): (L, h, (hq + 2 * hkv) * d),
            ("layers", "wo"): (L, hq * d, h),
            ("embed",): (cfg.vocab_size, h),
        }
    if E:
        expect[("layers", "moe_router")] = (L, h, E)
        expect[("layers", "moe_gate_up")] = (L, E, h, 2 * I)
        expect[("layers", "moe_down")] = (L, E, I, h)
        if cfg.n_shared_experts:
            si = cfg.n_shared_experts * I
            expect[("layers", "moe_shared_gate_up")] = (L, h, 2 * si)
            expect[("layers", "moe_shared_down")] = (L, si, h)
        if cfg.first_k_dense:
            di = cfg.dense_inter_size
            expect[("layers", "dense_mlp", "w_gate_up")] = (cfg.first_k_dense, h, 2 * di)
            expect[("layers", "dense_mlp", "w_down")] = (cfg.first_k_dense, di, h)
    else:
        expect[("layers", "w_gate_up")] = (L, h, 2 * I)
        expect[("layers", "w_down")] = (L, I, h)
    if cfg.attention_bias:
        expect[("layers", "bqkv")] = (L, (hq + 2 * hkv) * d)
    for path, shape in expect.items():
        node = params
        for k in path:
            node = node[k]
        if tuple(node.shape) != shape:
            raise ValueError(f"{'.'.join(path)}: got {tuple(node.shape)}, want {shape}")


def load_hf_model(model_name_or_path: str, dtype=None, device: torch.device | str | None = None):
    """Load through transformers (a local directory or a cached model) ->
    ``(cfg, params)`` on ``device`` (default ``cuda``)."""
    from transformers import AutoConfig, AutoModelForCausalLM

    cfg = config_from_hf(AutoConfig.from_pretrained(model_name_or_path))
    model = AutoModelForCausalLM.from_pretrained(model_name_or_path)
    return cfg, load_hf_state_dict(model.state_dict(), cfg, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Native checkpoints: the port's own tree, quantized leaves as they are, so
# a serving restart neither rereads the bf16 original nor re-quantizes it
# ---------------------------------------------------------------------------


def _own_storage(tree: Any) -> Any:
    """``tree`` with every tensor that views a larger storage copied, so
    ``torch.save`` writes each leaf's own bytes and no more."""
    if isinstance(tree, dict):
        return {k: _own_storage(v) for k, v in tree.items()}
    whole = tree.untyped_storage().nbytes() == tree.numel() * tree.element_size()
    return tree if whole and tree.is_contiguous() else tree.contiguous().clone()


def save_checkpoint(path, params: dict, cfg: ModelConfig) -> None:
    """Write ``params`` (any nesting of dicts of tensors, quantized leaves
    included) to ``path/params.pt`` and ``cfg`` to ``path/config.json``."""
    path = pathlib.Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(_own_storage(params), path / PARAMS_FILE)
    (path / CONFIG_FILE).write_text(json.dumps(dataclasses.asdict(cfg)))


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _config_from_json(text: str) -> ModelConfig:
    """A ``ModelConfig`` from ``json.dumps(dataclasses.asdict(cfg))``, with
    every tuple-typed field (``rope_scaling``, nested for longrope) rebuilt
    as tuples, so it equals ``cfg`` and hashes."""
    raw = json.loads(text)
    for f in dataclasses.fields(ModelConfig):
        if "tuple" in str(f.type) and f.name in raw:
            raw[f.name] = _tuples(raw[f.name])
    return ModelConfig(**raw)


def load_checkpoint(path, device: torch.device | str | None = None):
    """Restore ``(cfg, params)`` written by :func:`save_checkpoint` onto
    ``device`` (default ``cuda``): the same tree, dtypes and bits."""
    path = pathlib.Path(path).resolve()
    cfg = _config_from_json((path / CONFIG_FILE).read_text())
    params = torch.load(path / PARAMS_FILE, map_location=resolve_device(device), weights_only=True, mmap=True)
    return cfg, params
