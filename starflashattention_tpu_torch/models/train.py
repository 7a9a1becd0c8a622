"""Training forward, loss and SGD step — twin of the JAX ``models/train.py``
(dense-GQA Llama and Mixtral-routed MoE; full fine-tuning and LoRA).

``forward_train`` gives fp32 logits at every position, built from the
serving model's blocks (``models/llama``: ``rms_norm``, the fused-QKV
split, RoPE, QK-norm, the embedding). Its projections are ``torch.matmul``
in the params' dtype and only the head runs in fp32, as JAX's ``jnp.dot``
calls do; the serving path's ``_make_proj`` upcasts weights to fp32, which
under autograd would keep an fp32 copy of every weight for the backward.
Attention is ``ops.flash_bwd.flash_attention`` (K5 with the LSE forward,
K12 backward) by default, or :func:`_attn_plain` (``use_flash=False``),
which materializes the (B, H, S, S) scores. Both take the attention
variants of the Mistral, Gemma and Gemma-2 families: the sliding window of
each layer (:func:`_train_window`: on a full layer of a pattern > 1 config
no window at all, the unbanded kernels), the sinks and the softcap; the
layers take the post-norms and GeGLU, the embedding its scale and the head
the final softcap, as the serving model does. ``remat=True`` (the default)
runs each layer under ``torch.utils.checkpoint``, as JAX wraps its layer
body in ``jax.checkpoint``: the backward reruns each layer's forward, so a
step launches the attention forward twice a layer.

Gradients: ``loss_and_grads`` (``jax.value_and_grad(loss_fn)``) returns a
tree shaped like ``params``; ``train_step`` is JAX's SGD with momentum 0.9,
updating ``params`` and the momentum IN PLACE. Each layer's weights are
taken from the (L, ...) stacks with ``unbind``, whose backward stacks the
per-layer gradients once.

Context parallelism: ``seq_axis_name`` (a ``parallel.mesh.Axis``, where
JAX takes the axis's name) makes ``tokens`` rank i's contiguous chunk of
each sequence, positions ``[i * S, (i + 1) * S)``: RoPE takes those global
positions (``pos0 = i * S``, JAX ``train.py:186-187``) and attention is
``parallel.ring.ring_attention`` over the axis with each layer's window and
sinks (JAX ``_windowed_attn``, ``:128-142``, ``:201-208``). It needs the
flash path, as in JAX. The loss is the chunk's mean and the gradients are
the chunk's: ``parallel.train.make_cp_train_step`` averages them over the
axes. Every rank of the axis runs the forward and the backward together.

Tensor parallelism: ``axis_name`` (a ``parallel.mesh.Axis``) runs the
Megatron-sharded form (JAX ``train.py:31-98``): ``params`` and ``cfg`` are
this rank's shard (``parallel.tp.shard_params``, ``tp._shard_cfg``), the
activations are replicated, Megatron's f (identity forward, a sum of the
cotangent backward: ``parallel.comm.copy_to_axis``) enters every
column-parallel branch, g (a sum forward, the identity backward:
``reduce_from_axis``) completes every row-parallel projection, and the
vocab-sharded head's logit slices are gathered with an explicit backward
(``comm.all_gather_grad``, JAX's ``_gather_vocab``). Every collective of
the training path sits inside such a pair, so autograd transposes none.
The replicated parameters' gradients come out whole and equal on every
rank of the axis; the sharded ones stay with their shard.
Composes with ``seq_axis_name``: the ring rotates head-sharded KV chunks.

MoE (:func:`_moe_mlp_train`, JAX ``train.py:262-297``): Mixtral's routing
(Qwen3-MoE's ``norm_topk_prob`` form is the same math), every local expert
run densely on every token as batched ``torch.bmm`` in the params'
dtype, under ``axis_name`` expert-parallel (the stacks hold this rank's
whole experts, the replicated router routes over all of them). LoRA, CP
and TP take it with no other change.

Not ported, each raising ``NotImplementedError``: DeepSeek's routing knobs
(``router_pre_softmax``, ``n_shared_experts``, ``first_k_dense``: JAX's
``_moe_mlp_train`` ignores them, so it is no oracle there; ROADMAP Queue
3), MLA (item 14c-train: JAX's training path reads ``wqkv`` and has no MLA
form) and every config field ``llama.check_supported`` refuses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from starflashattention_tpu_torch.core.rope import apply_rope
from starflashattention_tpu_torch.models import llama, lora as _lora
from starflashattention_tpu_torch.ops.flash_bwd import flash_attention
from starflashattention_tpu_torch.runtime.params import ModelConfig

MOMENTUM = 0.9
DEEPSEEK_ROUTING = ("training with DeepSeek's routing ({knobs}) is not ported: the JAX package's "
                    "_moe_mlp_train ignores these knobs and trains Mixtral's routing, so it is no oracle "
                    "for them (ROADMAP Queue 3)")


def _comm():
    """``parallel.comm``, imported when a tensor-parallel path first needs
    it (``parallel`` imports this module)."""
    from starflashattention_tpu_torch.parallel import comm

    return comm




# ---------------------------------------------------------------------------
# Trees of tensors (nested dicts), as JAX's pytrees
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in its leaf order."""
    it = iter(leaves)

    def build(t):
        return {k: build(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    return build(tree)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def value_and_grad(fn, tree):
    """``(fn(tree), d fn / d tree)`` with the gradient shaped like ``tree``;
    a leaf the loss does not reach gets zeros, as in JAX. The leaves enter
    as detached views (no copy), so ``tree`` itself is untouched."""
    leaves = [leaf.detach().requires_grad_() for leaf in tree_leaves(tree)]
    loss = fn(tree_unflatten(tree, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), tree_unflatten(tree, grads)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _check_trainable(params, cfg: ModelConfig, axis_name, seq_axis_name, use_flash=True) -> None:
    if isinstance(axis_name, str):
        raise TypeError("axis_name takes a parallel.mesh.Axis (mesh.axis(name)), not an axis's name")
    if isinstance(seq_axis_name, str):
        raise TypeError("seq_axis_name takes a parallel.mesh.Axis (mesh.axis(name)), not an axis's name")
    if seq_axis_name is not None and not use_flash:
        raise ValueError("context-parallel training requires the flash path (use_flash=True): the plain "
                         "attention twin is single-device")
    if cfg.num_experts:
        knobs = [name for name in ("router_pre_softmax", "n_shared_experts", "first_k_dense")
                 if getattr(cfg, name)]
        if knobs:
            raise NotImplementedError(DEEPSEEK_ROUTING.format(knobs=", ".join(knobs)))
    if cfg.mla:
        raise NotImplementedError(_lora.MLA_TRAINING)
    llama.check_supported(cfg)
    quantized = [name for name, w in params["layers"].items() if isinstance(w, dict)]
    if quantized or isinstance(params.get("lm_head"), dict):
        raise ValueError(f"training takes dense weights; quantized: {quantized or ['lm_head']}")


def _train_window(cfg: ModelConfig, i: int) -> int | None:
    """Layer ``i``'s window as JAX's ``_windowed_attn`` picks it: the
    config's on every layer with pattern 1; with pattern P > 1 (Gemma-2) on
    the sliding layers, ``(i + 1) % P != 0``, and none on the full layers.
    Unlike ``llama._layer_window`` it takes sinks with a pattern, as JAX
    training does (they ride the sliding layers' window)."""
    w = cfg.sliding_window
    if w is None or cfg.sliding_window_pattern == 1 or (i + 1) % cfg.sliding_window_pattern:
        return w
    return None


def _attn_plain(q, k, v, cfg: ModelConfig, i: int):
    """Plain causal attention of layer ``i``, the twin of JAX's
    ``_attn_jnp``: explicit (B, Hq, S, S) scores with the softcap, the
    layer's window and the sinks, differentiated by autograd. Scores and
    softmax run in fp32 and the output is cast to q's dtype (JAX runs them
    in the activations' dtype: the same at fp32, and the fp32 form is the
    yardstick for the bf16 kernels on the card)."""
    s = q.shape[2]
    g = cfg.num_q_heads // cfg.num_kv_heads
    kq = torch.repeat_interleave(k, g, dim=1).float()
    vq = torch.repeat_interleave(v, g, dim=1).float()
    scale = cfg.sm_scale() or cfg.head_dim**-0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    window = _train_window(cfg, i)
    if window is not None:
        mask = mask & ((pos[None, :] > pos[:, None] - window) | (pos[None, :] < cfg.attention_sinks))
    scores = torch.where(mask, scores, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vq).to(q.dtype)


def _proj(x, layers, ll, i, name, lscale):
    """``x @ w`` of layer ``i`` in the params' dtype, plus the delta of its
    adapter in the layer's adapter slice ``ll``."""
    out = x @ layers[name][i]
    d = _lora.delta(x, ll, name, lscale)
    return out if d is None else out + d


def _layer(x, i: int, layers: dict, adapters: dict, lscale, pos, cos, sin, cfg: ModelConfig,
           use_flash: bool, seq_axis=None, axis=None):
    """Decoder layer ``i`` on (B, S, H) activations; ``layers`` and
    ``adapters`` hold per-layer sequences of weights and adapter factors;
    with ``seq_axis`` the attention is the ring over it; with ``axis`` the
    layer is this rank's tensor-parallel shard (Megatron's f and g)."""
    b, s, _ = x.shape
    eps = cfg.rms_norm_eps
    ll = {n: {"a": ab["a"][i], "b": ab["b"][i]} for n, ab in adapters.items()} or None
    h = _comm().copy_to_axis(llama.rms_norm(x, layers["attn_norm"][i], eps), axis)
    qkv = _proj(h, layers, ll, i, "wqkv", lscale)
    if "bqkv" in layers:
        qkv = qkv + layers["bqkv"][i]
    q, k, v = llama._split_heads_prefill(qkv, cfg)
    q, k = llama._apply_qk_norm(q, k, layers, i, cfg)
    q = apply_rope(q, pos, cos, sin, style=cfg.rope_style)
    k = apply_rope(k, pos, cos, sin, style=cfg.rope_style)
    if use_flash:
        window = _train_window(cfg, i)
        kw = dict(causal=True, sm_scale=cfg.sm_scale(), window=window,
                  sinks=0 if window is None else cfg.attention_sinks, softcap=cfg.attn_softcap)
        if seq_axis is None:
            o = flash_attention(q, k, v, **kw)
        else:
            from starflashattention_tpu_torch.parallel.ring import ring_attention

            o = ring_attention(q, k, v, axis_name=seq_axis, **kw)
    else:
        o = _attn_plain(q, k, v, cfg, i)
    o = o.transpose(1, 2).reshape(b, s, -1)
    attn_out = _comm().reduce_from_axis(_proj(o, layers, ll, i, "wo", lscale), axis)
    x = llama._residual_add(x, attn_out, layers, i, "post_attn_norm", eps)
    h = _comm().copy_to_axis(llama.rms_norm(x, layers["mlp_norm"][i], eps), axis)
    if cfg.num_experts:
        mlp = _moe_mlp_train(h, layers, i, cfg, axis)
    else:
        gu = _proj(h, layers, ll, i, "w_gate_up", lscale)
        inter = gu.shape[-1] // 2
        act = llama._GATE_ACTS[cfg.mlp_activation](gu[..., :inter]) * gu[..., inter:]
        mlp = _proj(act, layers, ll, i, "w_down", lscale)
    mlp_out = _comm().reduce_from_axis(mlp, axis)
    return llama._residual_add(x, mlp_out, layers, i, "post_mlp_norm", eps)


def _moe_mlp_train(h, layers: dict, i: int, cfg: ModelConfig, axis=None):
    """Layer ``i``'s top-k routed MoE on (B, S, H) activations, the twin of
    JAX's ``_moe_mlp_train``: fp32 router logits, the top k (ties to the
    lower expert, ``llama._top_k``), their softmax cast to h's dtype and
    scattered into dense (B, S, E) weights; then every local expert on
    every token, gate_up, silu (whatever ``mlp_activation`` says, as JAX
    has it) times up, down, as batched products over the expert axis in the
    params' dtype, mixed by the local slice of the weights. (The serving
    ``llama._moe_mlp`` upcasts each expert stack to fp32, which autograd
    would keep for the backward.)

    With ``axis`` the stacks hold this rank's ``E_l`` whole experts, global
    experts ``index * E_l + e``: Megatron's f sits on the router weight (its
    gradient is each rank's partial over its experts; on ``h``, whose f is
    at the norm, it would count the router path twice) and the caller's g
    completes the routed sum."""
    router = _comm().copy_to_axis(layers["moe_router"][i], axis)
    logits = torch.matmul(h.float(), router.float())  # (B, S, E), every expert of the model
    top_logit, top_idx = llama._top_k(logits, cfg.num_experts_per_tok)
    top_w = torch.softmax(top_logit, dim=-1).to(h.dtype)
    weights = torch.zeros(logits.shape, dtype=h.dtype, device=h.device).scatter(-1, top_idx, top_w)
    w_gate_up, w_down = layers["moe_gate_up"][i], layers["moe_down"][i]  # (E_l, H, 2I), (E_l, I, H)
    e_local = w_gate_up.shape[0]
    if axis is not None:
        weights = weights[..., axis.index * e_local:(axis.index + 1) * e_local]
    flat = h.reshape(-1, h.shape[-1])
    # bmm on the activations expanded over the experts (a view): torch.matmul
    # would fold the (N, H) x (E_l, H, 2I) product into one mm on a
    # transposed copy of the stack
    gate, up = torch.bmm(flat.expand(e_local, -1, -1), w_gate_up).chunk(2, dim=-1)  # (E_l, N, I) each
    down = torch.bmm(F.silu(gate) * up, w_down)  # (E_l, N, H)
    out = torch.einsum("enh,ne->nh", down, weights.reshape(-1, e_local))
    return out.reshape(h.shape[:-1] + out.shape[-1:])


def forward_train(
    params,
    tokens: torch.Tensor,  # (B, S) int
    cfg: ModelConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    use_flash: bool = True,
    remat: bool = True,
    axis_name: str | None = None,
    seq_axis_name: str | None = None,
    lora: dict | None = None,
) -> torch.Tensor:
    """All-position fp32 logits (B, S, V): the training twin of the serving
    prefill, cache-free and differentiable. Runs on the device of
    ``params``. With ``seq_axis_name`` (context parallelism, see the module
    doc) ``tokens`` is this rank's chunk and the logits are its rows. With
    ``axis_name`` (tensor parallelism, see the module doc) ``params`` and
    ``cfg`` are this rank's shard; the logits are whole on every rank."""
    _check_trainable(params, cfg, axis_name, seq_axis_name, use_flash)
    b, s = tokens.shape
    pos0 = 0 if seq_axis_name is None else seq_axis_name.index * s
    if pos0 + s > cos.shape[0]:
        raise ValueError(f"sequence length {pos0 + s} exceeds the RoPE table ({cos.shape[0]} rows)")
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    x = llama._embed_tokens(params, tokens, cfg)
    pos = torch.arange(pos0, pos0 + s, device=x.device)[None, None, :]  # (1, 1, S): every sequence and head
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    adapters, lscale = {}, None
    if lora is not None:
        adapters = {name: {"a": ab["a"].unbind(0), "b": ab["b"].unbind(0)}
                    for name, ab in lora["layers"].items()}
        lscale = lora["scale"]
    for i in range(cfg.num_layers):
        args = (x, i, layers, adapters, lscale, pos, cos, sin, cfg, use_flash, seq_axis_name, axis_name)
        x = checkpoint(_layer, *args, use_reentrant=False) if remat else _layer(*args)
    xn = llama.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    vocab_sharded = axis_name is not None and cfg.lm_head_sharded
    if vocab_sharded:
        xn = _comm().copy_to_axis(xn, axis_name)  # the vocab shards are column-parallel in V
    logits = torch.matmul(xn.float(), head.float())  # jnp.dot(..., preferred_element_type=f32)
    if vocab_sharded:
        logits = _comm().all_gather_grad(logits, axis_name, dim=-1)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def loss_tokens(params, inp, tgt, cfg: ModelConfig, cos, sin, *, use_flash=True, remat=True,
                axis_name=None, seq_axis_name=None, lora=None) -> torch.Tensor:
    """Next-token cross-entropy (mean over every position) with inputs and
    targets as separate (B, S) arrays: the shardable form (under context
    parallelism a chunk's last target lies in the next chunk, so ``inp``
    and ``tgt`` are cut from the (B, S + 1) batch before it is sharded)."""
    logits = forward_train(params, inp, cfg, cos, sin, use_flash=use_flash, remat=remat,
                           axis_name=axis_name, seq_axis_name=seq_axis_name, lora=lora)
    logp = torch.log_softmax(logits, dim=-1)
    tgt = torch.as_tensor(tgt, device=logp.device).long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


def loss_fn(params, batch, cfg: ModelConfig, cos, sin, *, use_flash=True, remat=True,
            axis_name=None, seq_axis_name=None, lora=None) -> torch.Tensor:
    """Next-token cross-entropy over a (B, S + 1) token batch; with
    ``seq_axis_name``, rank i's window ``[i * S, (i + 1) * S + 1)`` of the
    global batch (one token past its chunk: the chunk's last target)."""
    batch = torch.as_tensor(batch)
    return loss_tokens(params, batch[:, :-1], batch[:, 1:], cfg, cos, sin, use_flash=use_flash,
                       remat=remat, axis_name=axis_name, seq_axis_name=seq_axis_name, lora=lora)


def loss_and_grads(params, batch, cfg: ModelConfig, cos, sin, *, use_flash=True, remat=True,
                   seq_axis_name=None, axis_name=None):
    """``(loss, grads)`` of :func:`loss_fn` with respect to ``params``,
    the grads shaped like ``params`` (``jax.value_and_grad(loss_fn)``);
    with ``seq_axis_name`` this rank's chunk's loss and gradients, with
    ``axis_name`` this rank's shard's gradients."""
    return value_and_grad(
        lambda p: loss_fn(p, batch, cfg, cos, sin, use_flash=use_flash, remat=remat,
                          seq_axis_name=seq_axis_name, axis_name=axis_name), params)


def train_step(params, momentum, batch, cfg: ModelConfig, cos, sin, lr: float, *, use_flash=True,
               remat=True):
    """One SGD-with-momentum step, JAX's ``m = 0.9 m + g; p = p - lr m`` in
    the params' own dtype, applied IN PLACE to ``params`` and ``momentum``
    (no copy of the model is made). Returns ``(params, momentum, loss)``."""
    loss, grads = loss_and_grads(params, batch, cfg, cos, sin, use_flash=use_flash, remat=remat)
    sgd_update_(params, momentum, grads, lr)
    return params, momentum, loss


def sgd_update_(params, momentum, grads, lr: float) -> None:
    """JAX's ``m = 0.9 m + g; p = p - lr m``, in place, in each parameter's
    dtype."""
    with torch.no_grad():
        for p, m, g in zip(tree_leaves(params), tree_leaves(momentum), tree_leaves(grads)):
            m.mul_(MOMENTUM).add_(g)
            p.add_(m, alpha=-lr)
