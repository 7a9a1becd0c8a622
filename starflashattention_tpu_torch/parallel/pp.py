"""Pipeline-parallel decode: layer stages over a ``pipe`` mesh axis — twin
of the JAX ``parallel/pp.py``.

One process a rank, as the rest of ``parallel``:

- the stacked layer params and the KV cache shard their leading L axis over
  ``pipe``: each stage holds ``L / P`` contiguous layers of both, and no
  weight moves; the embedding, the final norm and the lm_head are
  replicated (stage 0 embeds, the last stage runs the head);
- GPipe microbatching: the batch splits into M microbatches; stage s runs
  microbatch j on its layers once it has received j's (mb, H) activation
  from stage s - 1 (``comm.recv``), then sends it on (``comm.send``), so
  the stages overlap in the steady state. JAX's schedule runs idle ticks
  during fill and drain, which write a sacrificial last cache row; the
  port runs no idle tick, so that row is left as it was;
- each microbatch's layers are the single-device ``llama._decode_layer``;
  the stage's (L_local, B, ...) cache is viewed as (L_local * M, mb, ...)
  (a free view) and the kernels' layer index is ``lidx * M + j``, as JAX
  addresses the (layer, microbatch) pair;
- the last stage's (B, V) logits reach every rank by a broadcast over
  ``pipe`` (JAX sums zeros from the other stages): the same bytes
  everywhere;
- with a ``model`` axis too (a 2-D ``(pipe, model)`` mesh) each stage's
  layers are Megatron-sharded as in ``parallel/tp.py``, two all-reduces a
  layer within the stage;
- Gemma-2's alternating windows key off the GLOBAL layer index
  (``stage * L_local + lidx``); ``first_k_dense`` is refused, as in JAX.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.cache import contiguous
from starflashattention_tpu_torch.cache.contiguous import KVCache
from starflashattention_tpu_torch.models import llama
from starflashattention_tpu_torch.parallel import comm
from starflashattention_tpu_torch.parallel import tp as tp_mod
from starflashattention_tpu_torch.runtime.params import ModelConfig

PIPE = "pipe"
MODEL = tp_mod.MODEL


def _tp_size(mesh) -> int:
    model = mesh.axes.get(MODEL)
    return 1 if model is None else model.size


def _pipe_first(spec):
    """A TP layer spec with its leading L axis on ``pipe``."""
    if isinstance(spec, dict):
        return {k: _pipe_first(v) for k, v in spec.items()}
    return (PIPE, *tuple(spec)[1:])


def _replicated(tree):
    return {k: _replicated(v) for k, v in tree.items()} if isinstance(tree, dict) else ()


def _leading_pipe(tree):
    return {k: _leading_pipe(v) for k, v in tree.items()} if isinstance(tree, dict) else (PIPE,)


def pp_param_specs(params: dict, cfg: ModelConfig | None = None, mesh=None) -> dict:
    """Every stacked layer leaf (quantized ``{"w", "scale"}`` stacks and
    expert stacks included) on ``pipe`` along its leading L axis; the rest
    replicated. On a ``(pipe, model)`` mesh the layer specs combine ``pipe``
    with ``tp.param_specs``' Megatron dimensions (JAX pp.py:62-87)."""
    if mesh is not None and _tp_size(mesh) > 1:
        base = tp_mod.param_specs(cfg, weight_quant=tp_mod._params_are_weight_quant(params),
                                  lm_head_quant=tp_mod._params_have_quant_lm_head(params))
        return {**{k: v for k, v in base.items() if k != "layers"},
                "layers": {k: _pipe_first(v) for k, v in base["layers"].items()}}
    return {**{k: _replicated(v) for k, v in params.items() if k != "layers"},
            "layers": _leading_pipe(params["layers"])}


def _cache_specs(quantized: bool, tp: int) -> KVCache:
    hkv = MODEL if tp > 1 else None
    return KVCache(k=(PIPE, None, hkv, None, None), v=(PIPE, None, hkv, None, None), lengths=(),
                   k_scales=(PIPE, hkv) if quantized else None, v_scales=(PIPE, hkv) if quantized else None)


def shard_params_pp(params: dict, mesh, cfg: ModelConfig | None = None) -> dict:
    """This rank's params for the PP (or PP x TP) step from the full tree:
    its stage's layers, and with a ``model`` axis its TP shard of them (the
    fused columns permuted as ``tp.shard_params`` does)."""
    tp = _tp_size(mesh)
    specs = pp_param_specs(params, cfg, mesh)
    out = {k: tp_mod._local_tree(v, specs[k], mesh) for k, v in params.items() if k != "layers"}
    out["layers"] = {name: tp_mod._local_tree(w, specs["layers"][name], mesh,
                                              tp_mod._PERMS[name](cfg, tp) if name in tp_mod._PERMS and tp > 1
                                              else None)
                     for name, w in params["layers"].items()}
    return out


def shard_cache_pp(cache: KVCache, mesh) -> KVCache:
    """This rank's shard of a full cache: its stage's layers (and its KV
    heads under a ``model`` axis); the lengths whole."""
    return tp_mod._shard_fields(cache, _cache_specs(cache.k_scales is not None, _tp_size(mesh)), mesh)


def make_pp_decode_step(mesh, cfg: ModelConfig, params_example: dict | None = None,
                        num_microbatches: int | None = None, max_len_hint: int | None = None):
    """``step(params, cache, tokens, cos, sin) -> (logits (B, V), cache)``
    pipelined over ``mesh.axis("pipe")``, with this rank's params
    (:func:`shard_params_pp`) and cache (:func:`shard_cache_pp`, updated IN
    PLACE) and the global (B,) tokens; Megatron-sharded within each stage
    when the mesh also has a ``model`` axis. ``num_microbatches`` defaults
    to the stage count; the batch must divide by it. ``params_example``
    and ``max_len_hint`` fix JAX's specs and grid and are unused here."""
    del params_example, max_len_hint
    pipe = mesh.axis(PIPE)
    stages = pipe.size
    if cfg.num_layers % stages:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by pipe axis {stages}")
    if cfg.first_k_dense:
        raise NotImplementedError("DeepSeek first_k_dense does not compose with PP yet (the k-leading "
                                  "dense_mlp side stack does not shard over the pipe axis like the L-leading "
                                  "stacks)")
    m = num_microbatches or stages
    l_local = cfg.num_layers // stages
    if _tp_size(mesh) > 1:
        tp_mod._check(cfg, mesh)
        scfg, axis = tp_mod._shard_cfg(cfg, mesh), mesh.axis(MODEL)
    else:
        scfg, axis = cfg, None
    stage = pipe.index

    def step(params, cache, tokens, cos, sin):
        tokens = torch.as_tensor(tokens, device=cache.lengths.device)
        b = tokens.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        mb = b // m

        def view(t):  # (L_local, B, ...) -> (L_local * M, mb, ...): a free view
            return t.view(l_local * m, mb, *t.shape[2:])

        def rep(s):  # per-layer scales for the (layer, microbatch) index
            return None if s is None else s.repeat_interleave(m, dim=0)

        k_flat, v_flat = view(cache.k), view(cache.v)
        ks_flat, vs_flat = rep(cache.k_scales), rep(cache.v_scales)
        pos_full = cache.lengths.clone()
        layers = params["layers"]
        h = cfg.hidden_size
        dtype = params["embed"].dtype
        acc = []
        for j in range(m):
            rows = slice(j * mb, (j + 1) * mb)
            mcache = KVCache(k=k_flat, v=v_flat, lengths=pos_full[rows].clone(), k_scales=ks_flat,
                             v_scales=vs_flat)
            pos = pos_full[rows]
            att = pos + 1

            def attend(lidx, q, k_new, v_new, j=j, mcache=mcache, att=att):
                li = lidx * m + j
                return contiguous.append_decode_attend(
                    mcache, li, q, k_new, v_new, att, sm_scale=scfg.sm_scale(), num_splits=scfg.num_splits,
                    block_k=scfg.block_k, **llama._attn_options(scfg, stage * l_local + lidx))

            if stage == 0:
                x = llama._embed_tokens(params, tokens[rows], scfg)
            else:
                x = comm.recv((mb, h), dtype, tokens.device, pipe, stage - 1)
            rope_pos = llama._rope_positions(pos, cos)
            for lidx in range(l_local):
                x = llama._decode_layer(x, lidx, layers, scfg, cos, sin, rope_pos, attend, axis)
            if stage < stages - 1:
                comm.send(x, pipe, stage + 1)
            else:
                acc.append(llama._logits(x, params, scfg, axis))
        logits = torch.cat(acc) if acc else None
        logits = comm.broadcast(logits, (b, cfg.vocab_size), torch.float32, tokens.device, pipe, stages - 1)
        cache.lengths.copy_(pos_full + 1)
        return logits, cache

    return step
