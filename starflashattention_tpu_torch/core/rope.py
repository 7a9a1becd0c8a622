"""Rotary position embeddings (RoPE) — twin of the JAX ``core/rope.py``.

``half`` rotates (x[i], x[i + D/2]) pairs (the HF-Llama convention, the
default); ``interleaved`` rotates adjacent pairs (x[2i], x[2i+1]).
"""

from __future__ import annotations

import math

import torch


def llama3_scaled_inv_freq(
    inv_freq: torch.Tensor,
    factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> torch.Tensor:
    """Llama-3.1 frequency warping (HF ``rope_type="llama3"``)."""
    wavelen = 2.0 * math.pi / inv_freq
    low_wl = original_max_position / low_freq_factor
    high_wl = original_max_position / high_freq_factor
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    out = torch.where(wavelen > low_wl, inv_freq / factor, inv_freq)
    return torch.where((wavelen <= low_wl) & (wavelen >= high_wl), mid, out)


def rope_table(
    max_seq_len: int,
    rotary_dim: int,
    base: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    scaling: tuple | None = None,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables shaped ``(max_seq_len, rotary_dim // 2)``;
    ``freq(i) = pos / base**(2i / rotary_dim)``.

    ``scaling``: ``("llama3", factor, low, high, original_max_position)``,
    ``("linear", factor)`` or ``("longrope", original_max_position,
    target_max_position, short_factors, long_factors)`` — the same tuples
    the JAX package takes. The tables are computed in fp32 on the CPU (as
    the JAX reference computes them) and then moved to ``device``.
    """
    if rotary_dim % 2:
        raise ValueError(f"rotary_dim must be even, got {rotary_dim}")
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32) / rotary_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32), exps)
    mscale = 1.0
    if scaling is not None:
        kind = scaling[0]
        if kind == "llama3":
            inv_freq = llama3_scaled_inv_freq(inv_freq, *scaling[1:])
        elif kind == "linear":
            inv_freq = inv_freq / float(scaling[1])
        elif kind == "longrope":
            _, orig_max, target_max, short_f, long_f = scaling
            for name, f in (("short", short_f), ("long", long_f)):
                if len(f) != rotary_dim // 2:
                    raise ValueError(
                        f"longrope {name}_factors length {len(f)} != "
                        f"rotary_dim/2 ({rotary_dim // 2})"
                    )
            long_regime = target_max > orig_max
            factors = long_f if long_regime else short_f
            inv_freq = inv_freq / torch.tensor(factors, dtype=torch.float32)
            if long_regime:
                mscale = math.sqrt(
                    1.0 + math.log(target_max / orig_max) / math.log(orig_max)
                )
        else:
            raise ValueError(
                f"unknown rope scaling {kind!r} (supported: llama3, linear, longrope)"
            )
    pos = torch.arange(max_seq_len, dtype=torch.float32)
    angles = pos[:, None] * inv_freq[None, :]
    cos = (torch.cos(angles) * mscale).to(dtype)
    sin = (torch.sin(angles) * mscale).to(dtype)
    return cos.to(device), sin.to(device)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    style: str = "half",
) -> torch.Tensor:
    """Rotate the leading ``2 * cos_table.shape[-1]`` features of ``x``
    (``(..., D)``) by ``positions`` (broadcastable to ``x.shape[:-1]``; a
    leading-batch ``(B,)`` array broadcasts over the head dims). Positions
    must lie below the table length: torch raises where JAX would clamp."""
    half = cos_table.shape[-1]
    rot = 2 * half
    d = x.shape[-1]
    if rot > d:
        raise ValueError(f"rotary_dim {rot} exceeds head_dim {d}")
    if style not in ("half", "interleaved"):
        raise ValueError(f"unknown rope style: {style!r}")
    positions = torch.as_tensor(positions, device=x.device).long()
    if positions.dim() < x.dim() - 1:
        positions = positions.reshape(
            tuple(positions.shape) + (1,) * (x.dim() - 1 - positions.dim())
        )
    cos = cos_table[positions].float()
    sin = sin_table[positions].float()

    xr = x[..., :rot].float()
    if style == "half":
        x1, x2 = xr[..., :half], xr[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rotated = torch.stack(
            [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
        ).reshape(xr.shape)
    rotated = rotated.to(x.dtype)
    if rot == d:
        return rotated
    return torch.cat([rotated, x[..., rot:]], dim=-1)
