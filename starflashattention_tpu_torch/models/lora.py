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
is a leaf that ``jax.grad`` differentiates too). Multi-LoRA serving
(``stack_adapters``, ``delta_multi``, ``adapter_onehot``) is not ported
(ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import torch

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
