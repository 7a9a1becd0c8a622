"""Weight-only INT8 / FP8 matmul — twin of the JAX ``ops/quant_matmul.py``.

``quant_matmul(x, w, scale, layer=, out_dtype=)`` computes
``x @ (w[layer] * scale[layer])`` with fp32 accumulation. On CUDA tensors it
launches ``csrc/quant_matmul.cu`` (which replaces the TPU kernel
``_qmm_kernel``): the layer is a pointer offset into the (L, H, O) stack and
the 8-bit weights are converted in registers, never into a dequantized copy.
On CPU tensors it runs :func:`quant_matmul_plain`.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.ops import _build

_SIGNATURES = {
    "quant_matmul": [_build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
                     _build.I, _build.I, _build.I, _build.P],
}
_WEIGHT_DTYPES = (torch.int8, torch.float8_e4m3fn)
SMALL_M_MAX = 64  # rows up to which csrc/quant_matmul.cu runs its small-M kernel


def _stack(w, scale, layer):
    if w.dim() == 2:
        return w[None], scale[None], 0
    if layer is None:
        raise ValueError("layer index required for stacked (L, H, O) weights")
    return w, scale, int(layer)


def quant_matmul_plain(x, w, scale, *, layer=None, out_dtype=None):
    """Plain PyTorch version: upcast the layer's weights, fp32 matmul, scale."""
    w, scale, layer = _stack(w, scale, layer)
    y = torch.matmul(x.float(), w[layer].float()) * scale[layer].float()
    return y.to(out_dtype or torch.float32)


def quant_matmul(
    x: torch.Tensor,  # (M, H) activations
    w: torch.Tensor,  # (H, O) or (L, H, O) int8 / float8_e4m3fn
    scale: torch.Tensor,  # (O,) or (L, O) fp32 per-output-channel scales
    *,
    layer: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ dequant(w[layer])`` -> (M, O) in ``out_dtype`` (default fp32)."""
    if w.dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"quant_matmul takes int8/fp8 weights, got {w.dtype}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, scale, layer=layer, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    w, scale, layer = _stack(w, scale, layer)
    n_layers, h, o = w.shape
    m = x.shape[0]
    out_dtype = out_dtype or torch.float32
    if x.dim() != 2 or x.shape[1] != h:
        raise ValueError(f"x {tuple(x.shape)} does not match weights {tuple(w.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 activations, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if h % 32 or o % 32:
        raise ValueError(f"the CUDA kernel needs H and O multiples of 32, got H={h}, O={o}")
    if not (w.is_contiguous() and scale.is_contiguous()) or scale.dtype != torch.float32:
        raise ValueError("weights and fp32 scales must be contiguous")
    if scale.shape != (n_layers, o):
        raise ValueError(f"scale {tuple(scale.shape)} does not match weights {tuple(w.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range for {n_layers} layers")
    if w.data_ptr() % 16:
        raise ValueError("weights must be 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: the kernel loads 16 bytes at a time
        x = x.clone()
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    lib = _build.load("quant_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.quant_matmul(
            _build.ptr(x),
            _build.P(w.data_ptr() + layer * h * o),  # this layer's (H, O) slice
            _build.P(scale.data_ptr() + layer * o * 4),
            _build.ptr(out), m, h, o,
            int(w.dtype == torch.float8_e4m3fn), int(out_dtype == torch.bfloat16),
            _build.stream_ptr(x.device),
        )
    _build.check(lib, err, "quant_matmul")
    quant_matmul.launches += 1
    if m > SMALL_M_MAX:
        quant_matmul.launches_tiled += 1
    return out


quant_matmul.launches = 0  # every launch
quant_matmul.launches_tiled = 0  # those that took the tiled (prefill-row) kernel
