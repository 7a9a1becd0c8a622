"""Fused quantized SwiGLU MLP — twin of the JAX ``ops/fused_mlp.py``.

``fused_mlp(x, w1, s1, w2, s2, layer=)`` computes
``act(x @ dq(w1[layer])) @ dq(w2[layer])`` -> (B, H) fp32 with int8 or fp8
weights: ``gu = (x @ w1) * s1`` in fp32, ``act = silu(gate) * up`` rounded
to x's dtype, ``out = (act @ w2) * s2`` in fp32. On CUDA tensors it is one
launch of ``csrc/fused_mlp.cu`` (replaces the TPU kernel
``_fused_mlp_kernel``): both weights stream back to back in one kernel,
the two phases split by a grid-wide barrier; on CPU tensors it runs the
plain twin :func:`fused_mlp_plain`. With bf16 x each phase is K4's
split-K matmul (``csrc/qmm_split_k.cuh``) on :func:`split_plan`'s grid:
phase 1's bands pair 64 gate columns with their 64 up columns
(:func:`band_columns`) and write ``act``, phase 2 splits I over blocks;
the splits' partials go to ``ops/quant_matmul``'s split-K workspace. fp32
x runs the CUDA-core form (its ``act`` is fp32). ``block_h`` / ``block_o`` are the TPU
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
from starflashattention_tpu_torch.ops import quant_matmul as qmm
from starflashattention_tpu_torch.utils.device import sm_count

_SIGNATURES = {"fused_mlp": [_build.P] * 11 + [_build.I] * 8 + [_build.P]}
_WEIGHT_DTYPES = (torch.int8, torch.float8_e4m3fn)
_X_DTYPES = (torch.bfloat16, torch.float32)
_BARRIERS: dict[int, torch.Tensor] = {}  # device index -> the fp32-x kernel's barrier counter
_READY: dict[int, dict] = {}  # device index -> the bf16-x kernel's band flags and the last epoch


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


def split_plan(b: int, h: int, inter: int, sms: int = 132) -> dict:
    """The bf16-x kernel's grid for ``b`` rows at hidden ``h`` and
    intermediate ``inter``: x in ``row_tiles`` tiles of ``rows`` (8, 16, 32
    or 64: ``quant_matmul.small_m_rows``), and for each phase ``(bands,
    splits, split)`` from ``quant_matmul.small_m_grid`` on the SM count:
    phase 1 (``gate_up``) multiplies K = h by 2 ``inter`` columns in bands of
    128 (:func:`band_columns`), phase 2 (``down``) K = ``inter`` by ``h``.
    Depends on the shapes and the SM count only."""
    m = min(b, qmm.SMALL_M_MAX)
    return {"rows": qmm.small_m_rows(m), "row_tiles": -(-b // qmm.small_m_rows(m)),
            "gate_up": qmm.small_m_grid(m, h, 2 * inter, sms=sms), "down": qmm.small_m_grid(m, inter, h, sms=sms)}


def band_columns(band: int, inter: int) -> list[int]:
    """The w1 columns of phase-1 band ``band``, in the band's order (warp w
    owns positions 16 w .. 16 w + 15, ``quant_matmul.small_m_fragment``
    maps them to registers): 64 gate columns from 64 ``band``, then the 64
    up columns ``inter`` on, so the band's last block holds both halves of
    its 64 activations."""
    half = qmm.SMALL_M_BAND // 2
    c0 = band * half
    return list(range(c0, c0 + half)) + list(range(inter + c0, inter + c0 + half))


def _barrier(device: torch.device) -> torch.Tensor:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    bar = _BARRIERS.get(idx)
    if bar is None:
        bar = _BARRIERS[idx] = torch.zeros(4, dtype=torch.int32, device=device)  # 16 bytes, aligned
    return bar


def _ready(device: torch.device, flags: int) -> tuple[torch.Tensor, int]:
    """The bf16-x kernel's phase-1 band flags (at least ``flags``) and a new
    epoch: a value no earlier call wrote to them, which the call's bands set
    and its phase 2 waits for."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    r = _READY.get(idx)
    if r is None or r["flags"].numel() < flags:
        r = _READY[idx] = {"flags": torch.zeros(flags, dtype=torch.int32, device=device), "epoch": 0}
    r["epoch"] += 1
    return r["flags"], r["epoch"]


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
    part = arrivals = ready = None
    split1 = split2 = epoch = 0
    if x.dtype == torch.bfloat16:
        plan = split_plan(b, h, inter, sm_count(x.device))
        (bands1, splits1, split1), (bands2, splits2, split2) = plan["gate_up"], plan["down"]
        # phase 1's slots, then phase 2's: the phases overlap in time
        part, arrivals = qmm._small_m_workspace(
            x.device, plan["row_tiles"] * (bands1 * splits1 + bands2 * splits2) * plan["rows"] * qmm.SMALL_M_BAND,
            plan["row_tiles"] * (bands1 + bands2))
        ready, epoch = _ready(x.device, plan["row_tiles"] * bands1)
    per_w1, per_w2 = h * two_i, inter * h  # bytes a layer (8-bit weights)
    lib = _build.load("fused_mlp", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.fused_mlp(
            _build.ptr(x), _build.P(w1.data_ptr() + layer * per_w1), _build.P(s1.data_ptr() + layer * two_i * 4),
            _build.P(w2.data_ptr() + layer * per_w2), _build.P(s2.data_ptr() + layer * h * 4),
            _build.ptr(act), _build.ptr(out), _build.ptr(_barrier(x.device)),
            *(None if t is None else _build.ptr(t) for t in (part, arrivals, ready)),
            epoch, b, h, inter, split1, split2, int(x.dtype == torch.bfloat16), int(w1.dtype == torch.float8_e4m3fn),
            _build.stream_ptr(x.device),
        )
    _build.check(lib, err, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
