"""LoRA fine-tuning — the training half of the JAX ``models/lora.py``.

Two small factors per projection, ``w_eff = w + (alpha / r) * a @ b``, with
``a ~ N(0, 1 / in)`` and ``b = 0``, so an adapted model starts exactly at
its base (arXiv:2106.09685). :func:`loss_fn` trains the adapters on a
frozen base through ``train.forward_train(lora=)``, on the same kernels as
full fine-tuning; :func:`merge` folds the adapters into the dense weights,
after which ``llama.generate`` and the engines serve the result as any
checkpoint.

An adapter tree is ``{"layers": {name: {"a": (L, in, r), "b": (L, r,
out)}}, "scale": alpha / r}`` (a 0-d tensor, as in the JAX package, where it
is a leaf that ``jax.grad`` differentiates too).

Multi-LoRA serving (S-LoRA style, JAX lora.py:133-205): :func:`stack_adapters`
stacks N trained adapters into one tree, :func:`adapter_onehot` turns each
batch row's adapter id into a (B, N) selector, and :func:`delta_multi` adds
each row's own adapter to a projection, which the serving entries of
``models/llama`` and both engines (``lora_adapters``, ``Request.adapter``) do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from starflashattention_tpu_torch.runtime.params import ModelConfig
from starflashattention_tpu_torch.utils.device import resolve_device

# projections that accept adapters, with (in, out) shapes derived from cfg
TARGETS = ("wqkv", "wo", "w_gate_up", "w_down")
MLA_TRAINING = ("training an MLA model is not ported yet (ROADMAP Queue 1 item 14c-train): the "
                "JAX training path reads wqkv and has no MLA form")


def _target_shapes(cfg: ModelConfig) -> dict:
    h, d = cfg.hidden_size, cfg.head_dim
    hq, hkv, inter = cfg.num_q_heads, cfg.num_kv_heads, cfg.intermediate_size
    shapes = {"wqkv": (h, (hq + 2 * hkv) * d), "wo": (hq * d, h)}
    if not cfg.num_experts:
        shapes["w_gate_up"] = (h, 2 * inter)
        shapes["w_down"] = (inter, h)
    return shapes


def init_lora(
    cfg: ModelConfig,
    generator: torch.Generator | None = None,
    rank: int = 8,
    *,
    alpha: float | None = None,
    targets: tuple[str, ...] = TARGETS,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> dict:
    """Adapter tree on ``device`` (default ``cuda``) from ``generator``
    (default: one on that device seeded with 0); ``alpha`` defaults to
    ``2 * rank``. ``b = 0``: the adapted model starts exactly at the base.
    The values differ from the JAX package's (another generator): tests
    bridge JAX's adapters with ``utils.bridge.params_from_numpy``."""
    if cfg.mla:
        raise NotImplementedError(MLA_TRAINING)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if alpha is None:
        alpha = float(2 * rank)
    shapes = _target_shapes(cfg)
    unknown = [t for t in targets if t not in shapes]
    if unknown:
        raise ValueError(f"LoRA targets {unknown} not adaptable for this config "
                         f"(available: {sorted(shapes)}; MoE expert stacks are frozen)")
    n_layers = cfg.num_layers
    layers = {}
    for name in targets:
        fan_in, fan_out = shapes[name]
        a = torch.randn((n_layers, fan_in, rank), generator=generator, dtype=dtype, device=dev)
        layers[name] = {"a": a / torch.tensor(fan_in, dtype=dtype, device=dev).sqrt(),
                        "b": torch.zeros((n_layers, rank, fan_out), dtype=dtype, device=dev)}
    return {"layers": layers, "scale": torch.tensor(alpha / rank, dtype=dtype, device=dev)}


def delta(x: torch.Tensor, ll: dict | None, name: str, scale):
    """Adapter contribution ``scale * (x @ a) @ b`` of one layer's slice
    ``ll`` (``{name: {"a": (in, r), "b": (r, out)}}``), computed in the
    adapter's dtype and returned in x's, or None when the projection has no
    adapter."""
    if ll is None or name not in ll:
        return None
    a, b = ll[name]["a"], ll[name]["b"]
    return ((x.to(a.dtype) @ a @ b) * scale).to(x.dtype)


def merge(params: dict, lora: dict, cfg: ModelConfig) -> dict:
    """Fold the adapters into the dense base weights, ``w + scale * a @ b``
    a layer at a time (the fp32 update of one layer is the largest
    intermediate). Returns a new params dict; ``params`` is unchanged.
    Refuses quantized weights: merge into the dense checkpoint, then
    quantize."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    scale = lora["scale"]
    for name, ab in lora["layers"].items():
        w = out["layers"][name]
        if isinstance(w, dict):
            raise ValueError(f"cannot merge LoRA into quantized weight {name!r}; merge into the "
                             "dense checkpoint first, then quantize")
        out["layers"][name] = torch.stack([
            w[i] + ((ab["a"][i] @ ab["b"][i]) * scale).to(w.dtype)
            for i in range(w.shape[0])])
    return out


def loss_fn(base_params, lora, batch, cfg: ModelConfig, cos, sin, *, use_flash=True, remat=True):
    """Adapter-only training loss: the base is detached, so gradients reach
    only ``lora``."""
    from starflashattention_tpu_torch.models import train

    frozen = train.tree_map(torch.Tensor.detach, base_params)
    return train.loss_fn(frozen, batch, cfg, cos, sin, use_flash=use_flash, remat=remat, lora=lora)


def loss_and_grads(base_params, lora, batch, cfg: ModelConfig, cos, sin, *, use_flash=True,
                   remat=True):
    """``(loss, grads)`` of :func:`loss_fn` with respect to the adapter tree,
    shaped like ``lora`` (``jax.value_and_grad(lora.loss_fn, argnums=1)``)."""
    from starflashattention_tpu_torch.models import train

    return train.value_and_grad(
        lambda ad: loss_fn(base_params, ad, batch, cfg, cos, sin, use_flash=use_flash, remat=remat),
        lora)


# ---------------------------------------------------------------------------
# Multi-LoRA serving: N adapters resident, one picked per request
# ---------------------------------------------------------------------------


def serving_layout(a: torch.Tensor) -> torch.Tensor:
    """A stacked ``a`` (..., N, in, r) with the same shape and values, stored
    as (..., in, N, r): :func:`delta_multi` then reads layer ``l``'s ``a``
    as one (in, N * r) matrix without a copy."""
    return a.transpose(-3, -2).contiguous().transpose(-3, -2)


def stack_adapters(loras: list[dict], device: torch.device | str | None = None) -> dict:
    """Stack N trained adapters for serving -> ``{"layers": {name: {"a": (L,
    N, in, r_max), "b": (L, N, r_max, out)}}}`` on ``device`` (default: the
    adapters' own). Ranks below the largest are zero-padded (a padded rank
    adds exact zeros), and each adapter's ``scale`` is folded into its ``b``
    in the adapter's dtype before stacking, so the values equal the JAX
    package's. ``a`` is stored in :func:`serving_layout`. Every adapter must
    target the same projections."""
    if not loras:
        raise ValueError("stack_adapters needs at least one adapter")
    names = sorted(loras[0]["layers"])
    for lr in loras[1:]:
        if sorted(lr["layers"]) != names:
            raise ValueError(f"adapters target different projections: {names} vs {sorted(lr['layers'])}")
    r_max = max(lr["layers"][names[0]]["a"].shape[-1] for lr in loras)
    dev = torch.device(device) if device is not None else loras[0]["layers"][names[0]]["a"].device
    layers = {}
    for name in names:
        a_s, b_s = [], []
        for lr in loras:
            a, b = lr["layers"][name]["a"].to(dev), lr["layers"][name]["b"].to(dev)
            pad = r_max - a.shape[-1]
            a_s.append(F.pad(a, (0, pad)))
            b_s.append(F.pad(b, (0, 0, 0, pad)) * torch.as_tensor(lr["scale"], dtype=b.dtype, device=dev))
        layers[name] = {"a": torch.stack(a_s, dim=2).transpose(1, 2),  # stored (L, in, N, r)
                        "b": torch.stack(b_s, dim=1)}
    return {"layers": layers}


def num_adapters(stack: dict) -> int:
    "N of a stacked tree (axis 1 of any factor)."
    return next(iter(stack["layers"].values()))["a"].shape[1]


def layer_slice(stack: dict | None, lidx: int) -> dict | None:
    """Layer ``lidx`` of a stacked tree, ``{name: {"a": (N, in, r), "b": (N,
    r, out)}}`` (views), or None without adapters."""
    if stack is None:
        return None
    return {name: {"a": ab["a"][lidx], "b": ab["b"][lidx]} for name, ab in stack["layers"].items()}


def delta_multi(x: torch.Tensor, ml: dict | None, name: str, sel: torch.Tensor):
    """Each row's own adapter's contribution to projection ``name`` -> x's
    shape with ``out`` features in x's dtype, or None when the projection
    has no adapter. ``x`` is (B, in) or (B, S, in); ``ml`` one layer of a
    stacked tree (:func:`layer_slice`); ``sel`` the (B, N) one-hot selector,
    whose all-zero row (the base model) gives exactly 0.

    Every adapter's ``x @ a`` runs in the adapter's dtype as one product
    with the (in, N * r) matrix of all N (a view of the stack in
    :func:`serving_layout`; another layout is copied each call), the
    selector zeroes the other adapters' rank columns, and one product with
    ``b`` over the N * r rank rows sums the row's adapter alone: each row
    gets its adapter's ``(x @ a) @ b`` (up to fp32 summation order; the JAX
    package's einsums compute all N and then select), without JAX's (rows,
    N, out) intermediate."""
    if ml is None or name not in ml:
        return None
    a, b = ml[name]["a"], ml[name]["b"]  # (N, in, r), (N, r, out)
    n, fan_in, r = a.shape
    lead = x.shape[:-1]  # (B,) or (B, S)
    y = x.reshape(-1, fan_in).to(a.dtype) @ a.transpose(0, 1).reshape(fan_in, n * r)  # (M, N * r)
    w = sel.to(a.dtype).view(sel.shape[0], *([1] * (len(lead) - 1)), n, 1)
    z = y.view(*lead, n, r) * w  # the row's adapter kept, the others' rank columns zero
    d = z.view(-1, n * r) @ b.reshape(n * r, b.shape[-1])
    return d.view(*lead, b.shape[-1]).to(x.dtype)


def adapter_onehot(idx, n: int, device: torch.device | str | None = None) -> torch.Tensor:
    """(B,) adapter ids (-1: the base model) -> (B, N) fp32 one-hot
    selector. A tensor is compared on its own device; a list or array on
    the host, then copied to ``device`` (default: the CPU) at once."""
    if torch.is_tensor(idx):
        idx = idx.to(torch.int32)
        return (idx[:, None] == torch.arange(n, device=idx.device, dtype=torch.int32)[None, :]).float()
    onehot = np.asarray(idx, np.int32)[:, None] == np.arange(n, dtype=np.int32)[None, :]
    return torch.from_numpy(onehot.astype(np.float32)).to("cpu" if device is None else device)
