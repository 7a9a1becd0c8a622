"""Ulysses-style sequence parallelism — twin of the JAX
``parallel/ulysses.py``.

The second context-parallel strategy beside the ring (``parallel/ring.py``):
one tiled all-to-all per tensor (:func:`parallel.comm.all_to_all`)
re-shards [sequence-sharded, all heads] -> [head-sharded, whole sequence],
K5 (``ops.flash_prefill``) or the differentiable ``ops.flash_bwd.
flash_attention`` (K5 forward, K12 backward) runs on the rank's H/n heads
over the whole sequence with no communication inside the softmax, and one
all-to-all brings the output back to sequence sharding.

GQA: cutting the Hq axis into n chunks keeps each query head with its KV
head (chunk i holds q heads [i Hq/n, (i+1) Hq/n) and kv heads [i Hkv/n,
(i+1) Hkv/n)), which needs n | Hkv (:func:`_check_heads`); beyond that, use
the ring.

Layout contract: rank i of the axis passes rows ``[i * C, (i + 1) * C)`` of
q, k and v, all heads (the ring's contiguous layout), and the GLOBAL
``lengths``; it gets back its (B, Hq, C, D) output rows. With
``differentiable`` the all-to-alls carry gradients (their transposes are
all-to-alls with the dimensions swapped).
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.ops.flash_bwd import flash_attention
from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill
from starflashattention_tpu_torch.parallel import comm


def _check_heads(hq: int, hkv: int, n: int) -> None:
    if hkv % n:
        raise ValueError(
            f"Ulysses needs the axis size ({n}) to divide num_kv_heads "
            f"({hkv}) — use ring attention (parallel/ring.py) beyond that"
        )
    assert hq % hkv == 0


def ulysses_attention(
    q: torch.Tensor,  # (B, Hq, S/n, D) — this rank's sequence chunk, ALL heads
    k: torch.Tensor,  # (B, Hkv, S/n, D)
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,  # (B,) GLOBAL valid lengths
    *,
    axis_name,  # parallel.mesh.Axis: the sequence axis
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    sinks: int = 0,
    differentiable: bool = False,
) -> torch.Tensor:
    """Sequence-parallel attention through head/sequence all-to-alls over
    ``axis_name``: the (B, Hq, S/n, D) output chunk of this rank.
    ``differentiable=True`` runs the local attention through
    ``flash_attention`` (training) and the all-to-alls with gradients."""
    axis = axis_name
    n = axis.size
    b, hq, c, d = q.shape
    hkv = k.shape[1]
    _check_heads(hq, hkv, n)
    if lengths is None:
        lengths = torch.full((b,), n * c, dtype=torch.int32, device=q.device)
    a2a = comm.all_to_all_grad if differentiable else comm.all_to_all
    # [seq-sharded, all heads] -> [head-sharded, full seq]
    q2, k2, v2 = (a2a(x, axis, 1, 2) for x in (q, k, v))
    fn = flash_attention if differentiable else flash_prefill
    o2 = fn(q2, k2, v2, torch.as_tensor(lengths, device=q.device), causal=causal, sm_scale=sm_scale,
            window=window, sinks=sinks)
    # back: [head-sharded, full seq] -> [seq-sharded, all heads]
    return a2a(o2, axis, 2, 1)


def make_ulysses_prefill(
    mesh,
    *,
    seq_axis: str = "model",
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    sinks: int = 0,
):
    """``fn(q, k, v, lengths) -> o`` on this rank's contiguous chunk over
    ``mesh.axis(seq_axis)`` — the drop-in alternative to
    :func:`parallel.ring.make_ring_prefill` where the fabric is good at
    all-to-alls (forward only)."""
    axis = mesh.axis(seq_axis)

    @torch.no_grad()
    def fn(q, k, v, lengths):
        return ulysses_attention(q, k, v, lengths, axis_name=axis, causal=causal, sm_scale=sm_scale,
                                 window=window, sinks=sinks)

    return fn
