"""Fused quantized SwiGLU MLP — twin of the JAX ``ops/fused_mlp.py``.

``fused_mlp(x, w1, s1, w2, s2, layer=)`` computes
``act(x @ dq(w1[layer])) @ dq(w2[layer])`` -> (B, H) fp32 with int8 or fp8
weights: ``gu = (x @ w1) * s1`` in fp32, ``act = silu(gate) * up`` rounded
to x's dtype, ``out = (act @ w2) * s2`` in fp32. On CUDA tensors it is one
launch of ``csrc/fused_mlp.cu`` (replaces the TPU kernel
``_fused_mlp_kernel``): both weights stream back to back in one kernel,
the two phases split by a grid-wide barrier; on CPU tensors it runs the
plain twin :func:`fused_mlp_plain`. ``block_h`` / ``block_o`` are the TPU
kernel's tiling, accepted for the JAX signature; the result does not depend
on them. Each launch counts once in ``fused_mlp.launches``.

As in the JAX package, nothing in ``models/llama`` calls it: the serving
MLP is two ``quant_matmul`` calls with ``silu * up`` between them.

The kernel's barrier is a counter in device memory that each call leaves as
it found it; calls on one stream are ordered, so back-to-back calls never
share it (or their ``act`` scratch) at once. Calls on several streams of
one card at the same time are not supported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from starflashattention_tpu_torch.ops import _build

_SIGNATURES = {"fused_mlp": [_build.P] * 8 + [_build.I] * 5 + [_build.P]}
_WEIGHT_DTYPES = (torch.int8, torch.float8_e4m3fn)
_X_DTYPES = (torch.bfloat16, torch.float32)
_BARRIERS: dict[int, torch.Tensor] = {}  # device index -> the kernel's barrier counter


def _stack(w1, s1, w2, s2, layer):
    """2-D weights as a stack of one layer, or the stacks and the layer."""
    if w1.dim() == 2:
        return w1[None], s1[None], w2[None], s2[None], 0
    if layer is None:
        raise ValueError("layer index required for stacked (L, ...) weights")
    return w1, s1, w2, s2, int(layer)


def fused_mlp_plain(x, w1, s1, w2, s2, *, layer=None, block_h: int = 512, block_o: int = 1024):
    """Plain PyTorch version: fp32 matmuls of the upcast weights, the
    activation rounded to x's dtype between them."""
    del block_h, block_o
    w1, s1, w2, s2, layer = _stack(w1, s1, w2, s2, layer)
    gu = torch.matmul(x.float(), w1[layer].float()) * s1[layer].float()
    inter = gu.shape[-1] // 2
    act = (F.silu(gu[:, :inter]) * gu[:, inter:]).to(x.dtype)
    return torch.matmul(act.float(), w2[layer].float()) * s2[layer].float()


def _barrier(device: torch.device) -> torch.Tensor:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    bar = _BARRIERS.get(idx)
    if bar is None:
        bar = _BARRIERS[idx] = torch.zeros(4, dtype=torch.int32, device=device)  # 16 bytes, aligned
    return bar


def fused_mlp(
    x: torch.Tensor,  # (B, H) activations, bf16 or fp32
    w1: torch.Tensor,  # (H, 2I) or (L, H, 2I) int8 / float8_e4m3fn: [gate | up] columns
    s1: torch.Tensor,  # (2I,) or (L, 2I) fp32 per-output-channel scales
    w2: torch.Tensor,  # (I, H) or (L, I, H)
    s2: torch.Tensor,  # (H,) or (L, H)
    *,
    layer: int | None = None,
    block_h: int = 512,
    block_o: int = 1024,
) -> torch.Tensor:
    """``silu(x @ dq(w1)[:, :I]) * (x @ dq(w1)[:, I:]) @ dq(w2)`` -> (B, H)
    fp32, kernel K13 (see the module doc)."""
    if w1.dtype not in _WEIGHT_DTYPES or w2.dtype != w1.dtype:
        raise ValueError(f"fused_mlp takes int8 / fp8 weights of one dtype, got {w1.dtype} and {w2.dtype}")
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, s1, w2, s2, layer=layer, block_h=block_h, block_o=block_o)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    w1, s1, w2, s2, layer = _stack(w1, s1, w2, s2, layer)
    if x.dim() != 2 or x.dtype not in _X_DTYPES:
        raise ValueError(f"fused_mlp: x must be (B, H) bf16 or fp32, got {tuple(x.shape)} {x.dtype}")
    b, h = x.shape
    n_layers, _, two_i = w1.shape
    inter = two_i // 2
    if w1.shape[1] != h or two_i % 2 or w2.shape != (n_layers, inter, h):
        raise ValueError(f"fused_mlp: x {tuple(x.shape)}, w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} "
                         "do not match")
    if s1.shape != (n_layers, two_i) or s2.shape != (n_layers, h):
        raise ValueError(f"fused_mlp: scales {tuple(s1.shape)} / {tuple(s2.shape)} do not match the weights")
    if h % 64 or inter % 64:
        raise ValueError(f"the CUDA kernel needs H and I multiples of 64, got H={h}, I={inter}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"fused_mlp: layer {layer} out of range for {n_layers} layers")
    if not all(t.is_contiguous() for t in (w1, s1, w2, s2)) or {s1.dtype, s2.dtype} != {torch.float32}:
        raise ValueError("fused_mlp: weights and fp32 scales must be contiguous")
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("fused_mlp: weights must be 16-byte aligned")
    x = x.contiguous()
    out = torch.empty((b, h), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    act = torch.empty((b, inter), dtype=x.dtype, device=x.device)  # phase 1's output, phase 2's input
    per_w1, per_w2 = h * two_i, inter * h  # bytes a layer (8-bit weights)
    lib = _build.load("fused_mlp", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.fused_mlp(
            _build.ptr(x), _build.P(w1.data_ptr() + layer * per_w1), _build.P(s1.data_ptr() + layer * two_i * 4),
            _build.P(w2.data_ptr() + layer * per_w2), _build.P(s2.data_ptr() + layer * h * 4),
            _build.ptr(act), _build.ptr(out), _build.ptr(_barrier(x.device)), b, h, inter,
            int(x.dtype == torch.bfloat16), int(w1.dtype == torch.float8_e4m3fn), _build.stream_ptr(x.device),
        )
    _build.check(lib, err, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
