"""Tensor + data parallel model steps — twin of the JAX ``parallel/tp.py``.

The JAX package runs a whole step under ``shard_map`` over a ``(data,
model)`` mesh from one controller. The port runs one process per rank
(SPMD): each rank holds its own shard and runs the same single-device code
at 1/T width, with ``mesh.axis("model")`` where JAX names the axis:

- column-parallel projections (``wqkv``, ``w_gate_up``) hold their output
  columns' shard, row-parallel ones (``wo``, ``w_down``) their input rows'
  shard, and ``models/llama`` sums the partial outputs over ``model`` (two
  all-reduces a layer); W8A8 / W4A8 row-parallel projections quantize with
  the full row's scale (``quantize_rows``'s max over the axis);
- the fused ``[q|k|v]`` and ``[gate|up]`` columns are permuted once, at
  shard time, into per-shard-contiguous order (:func:`permute_params_for_tp`),
  so a rank's shard is a well-formed local layout; GQA co-locates each KV
  head with its query heads, so attention needs no communication;
- the lm_head is vocab-sharded and its logit slices are all-gathered;
- MoE experts shard whole over ``model`` (expert parallelism); the router,
  DeepSeek's shared experts and its dense first layers are replicated, the
  latter two counted on index 0 only;
- the batch rows (cache slots) shard over ``data``.

:func:`shard_params` and :func:`shard_cache` take the FULL trees (the same on
every rank) and return this rank's local tensors, cut as JAX's
:func:`param_specs` / :func:`cache_specs` place them (a spec is a tuple of
axis names, one a dimension, as JAX's ``PartitionSpec``). The ``make_tp_*``
builders return functions that take this rank's params and cache and the
GLOBAL per-slot inputs (tokens, masks, lengths: the same on every rank, as
JAX's global arrays), run this rank's data rows, and return global outputs:
what a data shard computes is all-gathered over ``data``, so every rank
holds the same tokens, logits and counts bit for bit, and the serving
engines' schedulers, one a rank, make the same decisions. The cache is
updated in place.

The builders take none of the flags JAX uses to pick its specs
(``quantized``, ``weight_quant``, ``lm_head_quant``, the draft's): the
port's params and caches carry their own structure.

Multi-LoRA under TP (JAX tp.py:100-146): :func:`shard_lora` cuts a stacked
adapter tree (``models/lora.stack_adapters``) as the weights it adapts.
Column-parallel targets (``wqkv``, ``w_gate_up``) keep ``a`` whole and take
their shard of ``b``'s output columns in the permuted fused order, so each
rank's delta lands on its own columns; row-parallel targets (``wo``,
``w_down``) take their shard of ``a``'s input rows and keep ``b`` whole,
and the layer's sum over ``model`` completes the delta (it is added before
that sum). The serving builders given ``lora_stack`` take the rank's stack
and the global (B, N) selector as trailing operands, the selector's rows
cut over ``data`` like every per-slot input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from starflashattention_tpu_torch.cache.contiguous import KVCache
from starflashattention_tpu_torch.cache.paged import PagedKVCache
from starflashattention_tpu_torch.core import quant
from starflashattention_tpu_torch.models import llama
from starflashattention_tpu_torch.parallel import comm
from starflashattention_tpu_torch.runtime.params import ModelConfig

DATA, MODEL = "data", "model"


def _wqkv_perm(cfg: ModelConfig, tp: int) -> np.ndarray:
    """Column permutation: flat [q|k|v] -> [q_0|k_0|v_0 | q_1|k_1|v_1 | ...]."""
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    q_off, k_off, v_off = 0, hq * d, (hq + hkv) * d
    parts = []
    for t in range(tp):
        parts.append(np.arange(t * (hq // tp) * d, (t + 1) * (hq // tp) * d) + q_off)
        parts.append(np.arange(t * (hkv // tp) * d, (t + 1) * (hkv // tp) * d) + k_off)
        parts.append(np.arange(t * (hkv // tp) * d, (t + 1) * (hkv // tp) * d) + v_off)
    return np.concatenate(parts)


def _gate_up_perm(cfg: ModelConfig, tp: int) -> np.ndarray:
    """Column permutation: flat [gate|up] -> [gate_0|up_0 | gate_1|up_1 | ...]."""
    inter = cfg.intermediate_size
    parts = []
    for t in range(tp):
        parts.append(np.arange(t * (inter // tp), (t + 1) * (inter // tp)))
        parts.append(np.arange(t * (inter // tp), (t + 1) * (inter // tp)) + inter)
    return np.concatenate(parts)


_PERMS = {"wqkv": _wqkv_perm, "bqkv": _wqkv_perm, "w_gate_up": _gate_up_perm}


def _take_cols(w, idx: np.ndarray):
    """Columns ``idx`` of the last axis of a dense weight or of a quantized
    ``{"w", "scale"}`` pair (per-output-channel scales commute with a column
    permutation, so both take the same columns)."""
    if isinstance(w, dict):
        return {k: _take_cols(v, idx) for k, v in w.items()}
    return torch.index_select(w, -1, torch.as_tensor(idx, device=w.device))


def permute_params_for_tp(params: dict, cfg: ModelConfig, tp: int) -> dict:
    """The one-time fused-column permutation that makes contiguous
    model-axis shards self-consistent local layouts (see the module doc).
    Apply once, to fresh single-device params; :func:`shard_params` takes
    each rank's columns of the permuted order without building it whole."""
    if tp == 1:
        return params
    layers = dict(params["layers"])
    for name, perm in _PERMS.items():
        if name in layers:
            layers[name] = _take_cols(layers[name], perm(cfg, tp))
    # MoE expert stacks need no permutation: the expert axis shards whole experts
    return {**params, "layers": layers}


# Quantized {"w", "scale"} spec pairs (JAX tp.py:148-161). Column-parallel
# weights shard the output dim of the payload and of its per-output-channel
# scale; row-parallel ones the contraction dim of the payload only. int4
# scales are (L, G, O): row-parallel shards the group axis with the rows.
_COL_QSPEC = {"w": (None, None, MODEL), "scale": (None, MODEL)}
_ROW_QSPEC = {"w": (None, MODEL, None), "scale": ()}
_COL_QSPEC_I4 = {"w": (None, None, MODEL), "scale": (None, None, MODEL)}
_ROW_QSPEC_I4 = {"w": (None, MODEL, None), "scale": (None, MODEL, None)}


def param_specs(cfg: ModelConfig, *, weight_quant: str | bool = False, lm_head_quant: str | bool = False) -> dict:
    """The spec tree of ``llama.init_params``' structure (JAX tp.py:164-250):
    a tuple of axis names a leaf (``()`` replicated). ``weight_quant``
    ("int8", "int4" or False) and ``lm_head_quant`` match the structure after
    ``llama.quantize_model_weights``."""
    layers = {
        "attn_norm": (),
        "wqkv": (None, None, MODEL),  # permuted per-shard [q_t|k_t|v_t]
        "wo": (None, MODEL, None),  # row-parallel: the head rows sharded
        "mlp_norm": (),
        "w_gate_up": (None, None, MODEL),  # permuted per-shard [gate_t|up_t]
        "w_down": (None, MODEL, None),
    }
    specs = {"embed": (), "layers": layers, "final_norm": (), "lm_head": (None, MODEL)}
    if cfg.num_experts:
        del layers["w_gate_up"], layers["w_down"]
        layers["moe_router"] = ()
        layers["moe_gate_up"] = (None, MODEL, None, None)
        layers["moe_down"] = (None, MODEL, None, None)
        if cfg.n_shared_experts:
            layers["moe_shared_gate_up"] = ()
            layers["moe_shared_down"] = ()
        if cfg.first_k_dense:
            layers["dense_mlp"] = {"w_gate_up": (), "w_down": ()}
    if weight_quant:
        int4 = weight_quant == "int4"
        for name in ("wqkv",) + (() if cfg.num_experts else ("w_gate_up",)):
            layers[name] = dict(_COL_QSPEC_I4 if int4 else _COL_QSPEC)
        for name in ("wo",) + (() if cfg.num_experts else ("w_down",)):
            layers[name] = dict(_ROW_QSPEC_I4 if int4 else _ROW_QSPEC)
        if cfg.num_experts:
            for name in ("moe_gate_up", "moe_down"):
                layers[name] = {"w": (None, MODEL, None, None),
                                "scale": (None, MODEL, None, None) if int4 else (None, MODEL, None)}
    if cfg.attention_bias:
        layers["bqkv"] = (None, MODEL)
    if cfg.qk_norm:
        layers["q_norm"] = ()
        layers["k_norm"] = ()
    if cfg.post_norms:
        layers["post_attn_norm"] = ()
        layers["post_mlp_norm"] = ()
    if cfg.tie_embeddings:
        specs.pop("lm_head")
    elif lm_head_quant:
        specs["lm_head"] = {"w": (None, MODEL),
                            "scale": (None, MODEL) if lm_head_quant == "int4" else (MODEL,)}
    return specs


def cache_specs() -> KVCache:
    """Specs of the (L, B, Hkv, S, D) cache: batch on data, KV heads on model."""
    return KVCache(k=(None, DATA, MODEL, None, None), v=(None, DATA, MODEL, None, None), lengths=(DATA,),
                   k_scales=(None, MODEL), v_scales=(None, MODEL))


def draft_cache_specs() -> KVCache:
    """Specs of a replicated draft model's cache: only the batch rides data."""
    return KVCache(k=(None, DATA), v=(None, DATA), lengths=(DATA,), k_scales=(), v_scales=())


def paged_cache_specs() -> PagedKVCache:
    """Specs of the page pools (L, Hkv, P, page, D): KV heads on model, the
    PAGE axis on data (each data shard owns a private pool partition, and
    its table rows hold page ids local to it); the table's slot rows and
    the lengths on data."""
    return PagedKVCache(k_pages=(None, MODEL, DATA, None, None), v_pages=(None, MODEL, DATA, None, None),
                        page_table=(DATA, None), lengths=(DATA,), k_scales=(None, MODEL),
                        v_scales=(None, MODEL))


def _quant_kind(w) -> str | bool:
    if not isinstance(w, dict):
        return False
    return "int4" if quant.is_int4_weight(w) else "int8"


def _params_are_weight_quant(params: dict) -> str | bool:
    """False, "int8" (fp8 too: the same layout) or "int4"."""
    return _quant_kind(params["layers"].get("wqkv"))


def _params_have_quant_lm_head(params: dict) -> str | bool:
    return _quant_kind(params.get("lm_head"))


def _axis(mesh, name):
    """The mesh's axis ``name``, or None when the mesh has none (size 1)."""
    return mesh.axes.get(name)


def _local(x: torch.Tensor, spec: tuple, mesh, perm: np.ndarray | None = None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each named dimension cut
    into the axis's equal chunks, chunk ``index``; a dimension with ``perm``
    takes its chunk of the permuted order. Returned contiguous (the kernels
    take dense tensors) and never sharing memory with ``x``, so that an
    update in place (a training step) leaves the full tree as it was."""
    orig = x
    for dim, name in enumerate(spec):
        ax = None if name is None else _axis(mesh, name)
        if ax is None or ax.size == 1:
            continue
        n = x.shape[dim]
        if n % ax.size:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} is not divisible by the {name} axis ({ax.size})")
        c = n // ax.size
        if perm is not None and dim == x.dim() - 1:
            x = torch.index_select(x, dim, torch.as_tensor(perm[ax.index * c:(ax.index + 1) * c], device=x.device))
        else:
            x = x.narrow(dim, ax.index * c, c)
    x = x.contiguous()
    if x.untyped_storage().data_ptr() == orig.untyped_storage().data_ptr():
        x = x.clone()
    return x


def _local_tree(tree, specs, mesh, perm=None):
    if isinstance(tree, dict):
        return {k: _local_tree(v, specs[k], mesh, perm) for k, v in tree.items()}
    return _local(tree, specs, mesh, perm)


def _check_int4_groups(params: dict, tp: int) -> None:
    """Row-parallel int4 shards the packed contraction axis, which must cut
    at scale-group boundaries (nibble pairs live within a group)."""
    for name in ("wo", "w_down"):
        w = params["layers"].get(name)
        if isinstance(w, dict) and quant.is_int4_weight(w):
            groups = w["scale"].shape[-2]
            if groups % tp:
                raise ValueError(
                    f"int4 weight {name!r} has {groups} scale groups, not divisible by model-axis size {tp}; "
                    f"re-quantize with quantize_model_weights(..., 'int4', int4_group=g) such that "
                    f"(contraction/g) % tp == 0")


def shard_params(params: dict, mesh, cfg: ModelConfig) -> dict:
    """This rank's local params from the full (single-device) tree: the
    fused columns permuted (:func:`permute_params_for_tp`) and every leaf
    cut as :func:`param_specs` places it. The full tree is not modified."""
    model = _axis(mesh, MODEL)
    tp = 1 if model is None else model.size
    if _params_are_weight_quant(params) == "int4":
        _check_int4_groups(params, tp)
    specs = param_specs(cfg, weight_quant=_params_are_weight_quant(params),
                        lm_head_quant=_params_have_quant_lm_head(params))
    out = {}
    for key, val in params.items():
        if key != "layers":
            out[key] = _local_tree(val, specs[key], mesh)
            continue
        out["layers"] = {name: _local_tree(w, specs["layers"][name], mesh,
                                           _PERMS[name](cfg, tp) if name in _PERMS and tp > 1 else None)
                         for name, w in val.items()}
    return out


def _shard_fields(cache, specs, mesh):
    fields = {}
    for f in dataclasses.fields(cache):
        val = getattr(cache, f.name)
        fields[f.name] = None if val is None else _local(val, getattr(specs, f.name), mesh)
    return type(cache)(**fields)


def shard_cache(cache: KVCache, mesh) -> KVCache:
    """This rank's shard of a full cache: its data shard's rows, its KV heads."""
    return _shard_fields(cache, cache_specs(), mesh)


def shard_draft_cache(cache: KVCache, mesh) -> KVCache:
    """This rank's rows of a replicated draft model's cache (every head)."""
    return _shard_fields(cache, draft_cache_specs(), mesh)


def shard_paged_cache(cache: PagedKVCache, mesh) -> PagedKVCache:
    """This rank's shard of full page pools (its KV heads of its data shard's
    pool partition) and its data shard's table rows and lengths."""
    return _shard_fields(cache, paged_cache_specs(), mesh)


_LORA_COL = {"a": (), "b": (None, None, None, MODEL)}  # (L, N, r, out): the output columns sharded
_LORA_ROW = {"a": (None, None, MODEL, None), "b": ()}  # (L, N, in, r): the input rows sharded
_LORA_KIND = {"wqkv": _LORA_COL, "w_gate_up": _LORA_COL, "wo": _LORA_ROW, "w_down": _LORA_ROW}


def lora_specs(stack: dict) -> dict:
    """The spec tree of a stacked adapter tree (JAX tp.py:122-125)."""
    return {"layers": {name: _LORA_KIND[name] for name in stack["layers"]}}


def shard_lora(stack: dict, mesh, cfg: ModelConfig) -> dict:
    """This rank's shard of a FULL stacked adapter tree (the same on every
    rank): ``b`` of a column-parallel target takes its columns of the fused
    permutation the base weight got (:func:`_wqkv_perm`,
    :func:`_gate_up_perm`), ``a`` of a row-parallel one its input rows.
    Fresh tensors, ``a`` in ``lora.serving_layout``; the full tree is not
    modified."""
    from starflashattention_tpu_torch.models.lora import serving_layout

    model = _axis(mesh, MODEL)
    tp = 1 if model is None else model.size
    specs = lora_specs(stack)["layers"]
    layers = {}
    for name, ab in stack["layers"].items():
        perm = _PERMS[name](cfg, tp) if name in _PERMS and tp > 1 else None
        layers[name] = {"a": serving_layout(_local(ab["a"], specs[name]["a"], mesh)),
                        "b": _local(ab["b"], specs[name]["b"], mesh, perm)}
    return {"layers": layers}


def _check(cfg: ModelConfig, mesh) -> None:
    model = _axis(mesh, MODEL)
    if model is None:
        raise ValueError(f"a tensor-parallel step needs a {MODEL!r} axis (mesh axes: {mesh.axis_names})")
    tp = model.size
    if cfg.num_kv_heads % tp:
        raise ValueError(f"num_kv_heads {cfg.num_kv_heads} not divisible by model-axis size {tp}")
    if cfg.num_experts:
        if cfg.num_experts % tp:
            raise ValueError(f"num_experts {cfg.num_experts} not divisible by model-axis size {tp} (experts "
                             "shard whole over the axis)")
    elif cfg.intermediate_size % tp:
        raise ValueError(f"intermediate_size {cfg.intermediate_size} not divisible by {tp}")
    if not cfg.tie_embeddings and cfg.vocab_size % tp:
        raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by model-axis size {tp} (lm_head is "
                         "vocab-sharded)")


def _shard_cfg(cfg: ModelConfig, mesh) -> ModelConfig:
    """Per-shard model geometry: the single-device program at 1/T width
    (its heads, its MLP slice, its vocab slice of the lm_head). MoE keeps
    the GLOBAL expert count (the replicated router routes over all)."""
    tp = _axis(mesh, MODEL).size
    return dataclasses.replace(
        cfg, num_q_heads=cfg.num_q_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size if cfg.num_experts else cfg.intermediate_size // tp,
        lm_head_sharded=not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# Global per-slot inputs in, global outputs out
# ---------------------------------------------------------------------------


def _rows(x, data):
    """This data shard's rows of a global (B, ...) tensor (or of each
    tensor of a dict, the sampling state)."""
    if isinstance(x, dict):
        return {k: _rows(v, data) for k, v in x.items()}
    if data is None or data.size == 1:
        return x
    n = x.shape[0] // data.size
    return x[data.index * n:(data.index + 1) * n]


def _gathered(outs, data):
    """Every data shard's rows of each output, concatenated in shard order."""
    if data is None or data.size == 1:
        return outs
    return tuple(comm.all_gather(o, data, dim=0) if isinstance(o, torch.Tensor) else o for o in outs)


def _check_rows(n_rows: int, mesh) -> None:
    data = _axis(mesh, DATA)
    if data is not None and n_rows % data.size:
        raise ValueError(f"batch of {n_rows} rows not divisible by data axis {data.size}")


def make_tp_decode_step(mesh, cfg: ModelConfig):
    """The sharded decode step: ``step(params, cache, tokens, cos, sin) ->
    (logits (B, V), cache)`` with this rank's ``params`` (:func:`shard_params`)
    and ``cache`` (:func:`shard_cache`) and the global (B,) tokens; two
    all-reduces a layer over ``model``, the logits gathered over ``data``."""
    _check(cfg, mesh)
    scfg, model, data = _shard_cfg(cfg, mesh), _axis(mesh, MODEL), _axis(mesh, DATA)

    def step(params, cache, tokens, cos, sin):
        _check_rows(len(tokens), mesh)
        tok = _rows(torch.as_tensor(tokens, device=cache.lengths.device), data)
        logits, cache = llama.decode_step(params, cache, tok, cos, sin, scfg, axis_name=model)
        return _gathered((logits,), data)[0], cache

    return step


def make_tp_prefill(mesh, cfg: ModelConfig):
    """The sharded prefill: ``fn(params, cache, tokens, new_lengths, cos,
    sin) -> (logits (B, V), cache)``, global (B, Sq) tokens."""
    _check(cfg, mesh)
    scfg, model, data = _shard_cfg(cfg, mesh), _axis(mesh, MODEL), _axis(mesh, DATA)

    def fn(params, cache, tokens, new_lengths, cos, sin):
        _check_rows(len(tokens), mesh)
        dev = cache.lengths.device
        logits, cache = llama.prefill(params, cache, _rows(torch.as_tensor(tokens, device=dev), data),
                                      _rows(torch.as_tensor(new_lengths, device=dev), data), cos, sin, scfg,
                                      axis_name=model)
        return _gathered((logits,), data)[0], cache

    return fn


def _lora_operands(rest: list, lora_stack, data) -> tuple:
    """(this rank's stack, this data shard's selector rows) from a builder's
    trailing operands, or (None, None) when it was built without adapters."""
    if lora_stack is None:
        return None, None
    stack, sel = rest
    return stack, _rows(sel, data)


def _decode_multi_fn(mesh, cfg, n_steps, sampling, with_logprobs, topk_logprobs, lora_stack, entry):
    _check(cfg, mesh)
    scfg, model, data = _shard_cfg(cfg, mesh), _axis(mesh, MODEL), _axis(mesh, DATA)

    def fn(params, cache, tok, cos, sin, active, *rest):
        rest = list(rest)
        samp = _rows(rest.pop(0), data) if sampling else None
        lora, sel = _lora_operands(rest, lora_stack, data)
        out = entry(params, cache, _rows(tok, data), cos, sin, _rows(active, data), scfg, n_steps,
                    sampling=samp, with_logprobs=with_logprobs, topk_logprobs=topk_logprobs, axis_name=model,
                    lora=lora, lora_sel=sel)
        toks, pending, cache, extra = out[0], out[1], out[2], out[3:]
        toks, pending, *extra = _gathered((toks, pending, *extra), data)
        return (toks, pending, cache, *extra)

    return fn


def make_tp_decode_multi(mesh, cfg: ModelConfig, n_steps: int, sampling: bool = False,
                         with_logprobs: bool = False, topk_logprobs: int = 0, lora_stack: dict | None = None):
    """The sharded serving decode round: ``fn(params, cache, tok, cos, sin,
    active[, sampling state]) -> (tokens (B, n), pending (B,), cache[,
    logprobs (B, n)][, top-k logprobs, ids])``, the TP + DP twin of
    ``llama.decode_multi``. Each data shard samples its own rows (keyed on
    (seed, position): the same draw on every rank of its model group).
    ``lora_stack`` (its structure only) builds the multi-LoRA form: ``fn``
    then takes two more operands, this rank's stack (:func:`shard_lora`) and
    the global (B, N) one-hot selector."""
    return _decode_multi_fn(mesh, cfg, n_steps, sampling, with_logprobs, topk_logprobs, lora_stack,
                            llama.decode_multi)


def make_tp_decode_multi_paged(mesh, cfg: ModelConfig, n_steps: int, sampling: bool = False,
                               with_logprobs: bool = False, topk_logprobs: int = 0, lora_stack: dict | None = None):
    """The paged twin of :func:`make_tp_decode_multi`: the cache is this
    rank's shard of the pools (:func:`shard_paged_cache`)."""
    return _decode_multi_fn(mesh, cfg, n_steps, sampling, with_logprobs, topk_logprobs, lora_stack,
                            llama.decode_multi_paged)


def make_tp_prefill_serving(mesh, cfg: ModelConfig, lora_stack: dict | None = None):
    """The sharded admission prefill: ``fn(params, cache, tokens,
    new_lengths, active, reset, cos, sin) -> (logits (B, V), cache)``;
    ``lora_stack`` as in :func:`make_tp_decode_multi`."""
    _check(cfg, mesh)
    scfg, model, data = _shard_cfg(cfg, mesh), _axis(mesh, MODEL), _axis(mesh, DATA)

    def fn(params, cache, tokens, new_lengths, active, reset, cos, sin, *rest):
        r = [_rows(t, data) for t in (tokens, new_lengths, active, reset)]
        lora, sel = _lora_operands(list(rest), lora_stack, data)
        logits, cache = llama.prefill_serving(params, cache, *r, cos, sin, scfg, axis_name=model, lora=lora,
                                              lora_sel=sel)
        return _gathered((logits,), data)[0], cache

    return fn


def make_tp_prefill_serving_paged(mesh, cfg: ModelConfig, prefix_len: int = 0, lora_stack: dict | None = None):
    """The sharded paged admission prefill; ``prefix_len`` > 0 is the chunked
    continuation (each shard gathers its prefix from its own partition);
    ``lora_stack`` as in :func:`make_tp_decode_multi`."""
    _check(cfg, mesh)
    scfg, model, data = _shard_cfg(cfg, mesh), _axis(mesh, MODEL), _axis(mesh, DATA)

    def fn(params, cache, tokens, new_lengths, active, reset, cos, sin, *rest):
        r = [_rows(t, data) for t in (tokens, new_lengths, active, reset)]
        lora, sel = _lora_operands(list(rest), lora_stack, data)
        logits, cache = llama.prefill_serving_paged(params, cache, *r, cos, sin, scfg, prefix_len=prefix_len,
                                                    axis_name=model, lora=lora, lora_sel=sel)
        return _gathered((logits,), data)[0], cache

    return fn


def make_tp_spec_decode_multi(mesh, cfg: ModelConfig, n_steps: int, num_draft: int, ngram: int = 4):
    """The sharded prompt-lookup speculative round: ``fn(params, cache,
    history, tok, cos, sin, active) -> (tokens (B, n, k+1), counts (B, n),
    pending, cache, history)``; drafting, acceptance and the (B, S) history
    ride the data axis with the rows, the verify step is TP-sharded."""
    _check(cfg, mesh)
    scfg, model, data = _shard_cfg(cfg, mesh), _axis(mesh, MODEL), _axis(mesh, DATA)

    def fn(params, cache, history, tok, cos, sin, active):
        toks, counts, pending, cache, history = llama.spec_decode_multi(
            params, cache, _rows(history, data), _rows(tok, data), cos, sin, _rows(active, data), scfg,
            n_steps, num_draft=num_draft, ngram=ngram, axis_name=model)
        toks, counts, pending, history = _gathered((toks, counts, pending, history), data)
        return toks, counts, pending, cache, history

    return fn


def make_tp_spec_decode_multi_draft(mesh, cfg: ModelConfig, dcfg: ModelConfig, n_steps: int, num_draft: int):
    """The sharded draft-model speculative round: ``fn(params, cache,
    dparams, dcache, tok, cos, sin, dcos, dsin, active) -> (tokens, counts,
    pending, cache, dcache)``. The draft runs whole on every rank over its
    data rows (``dparams`` full, ``dcache`` from :func:`shard_draft_cache`),
    so every model shard drafts the same tokens; the target verifies them
    TP-sharded."""
    _check(cfg, mesh)
    scfg, model, data = _shard_cfg(cfg, mesh), _axis(mesh, MODEL), _axis(mesh, DATA)

    def fn(params, cache, dparams, dcache, tok, cos, sin, dcos, dsin, active):
        toks, counts, pending, cache, dcache = llama.spec_decode_multi_draft(
            params, cache, dparams, dcache, _rows(tok, data), cos, sin, dcos, dsin, _rows(active, data), scfg,
            dcfg, n_steps, num_draft=num_draft, axis_name=model, draft_axis_name=None)
        toks, counts, pending = _gathered((toks, counts, pending), data)
        return toks, counts, pending, cache, dcache

    return fn


def make_tp_draft_prefill_serving(mesh, dcfg: ModelConfig):
    """Admission prefill of the replicated draft model on a sharded engine:
    the contract of :func:`make_tp_prefill_serving`, the whole draft on
    every rank over its data rows."""
    data = _axis(mesh, DATA)

    def fn(params, cache, tokens, new_lengths, active, reset, cos, sin):
        r = [_rows(t, data) for t in (tokens, new_lengths, active, reset)]
        logits, cache = llama.prefill_serving(params, cache, *r, cos, sin, dcfg)
        return _gathered((logits,), data)[0], cache

    return fn
