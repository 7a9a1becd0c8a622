"""Per-request token sampling: temperature / top-k / top-p / min-p —
twin of the JAX ``core/sampling.py``.

- **Per-slot parameters.** One (B,) tensor each of temperature, top_k,
  top_p, min_p and seed, so one decode loop serves any mix of greedy and
  sampled requests.
- **A pure function of (seed, absolute position, logits).** The JAX
  package draws its Gumbel noise from ``fold_in(PRNGKey(seed), position)``,
  which PyTorch cannot reproduce. The port keeps the property that makes
  preemption and replay exact instead: the noise of vocab entry ``i`` for
  the token at position ``p`` is a counter-based integer hash of
  ``(seed, p, i)``, computed with plain tensor ops on the logits' device (no
  host sync, no per-row ``torch.Generator``). A resumed request re-draws
  every token bit for bit.
- **Gumbel-max over a thresholded vocab.** Top-k, top-p and min-p all
  reduce to "keep scaled logits >= a per-row threshold", read from one
  descending sort (:func:`keep_mask`); the draw is
  ``argmax(masked + gumbel)``.

Greedy rows (temperature <= 0) return exactly ``argmax``: the first
maximum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Host-side per-request sampling controls (``serving.Request``).

    temperature <= 0 means greedy; top_k <= 0 means no top-k cut; top_p >= 1
    means no nucleus cut; min_p <= 0 means no min-p cut (min_p keeps tokens
    whose probability is >= min_p times the most likely token's). ``seed``
    makes the request's whole trajectory deterministic.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def state_arrays(params_list: list[SamplingParams]) -> dict[str, np.ndarray]:
    """Pack per-slot SamplingParams into (B,) numpy arrays (the seed as
    int64: torch has no general uint32)."""
    return {
        "temperature": np.array([p.temperature for p in params_list], np.float32),
        "top_k": np.array([p.top_k for p in params_list], np.int32),
        "top_p": np.array([p.top_p for p in params_list], np.float32),
        "min_p": np.array([p.min_p for p in params_list], np.float32),
        "seed": np.array([p.seed & 0xFFFFFFFF for p in params_list], np.int64),
    }


def state_tensors(params_list: list[SamplingParams], device) -> dict[str, torch.Tensor]:
    """:func:`state_arrays` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in state_arrays(params_list).items()}


# ----------------------------------------------------------------- noise

_MASK32 = 0xFFFFFFFF
# Odd multipliers below 2**31, so a 32-bit value times one stays inside
# int64 (the hash runs on int64 tensors holding 32-bit values).
_MUL1 = 0x7FEB352D
_MUL2 = 0x6B43A9B5


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of 32-bit values (xorshift-multiply rounds) held in an
    int64 tensor."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _MASK32
    return x ^ (x >> 16)


def gumbel_noise(seed: torch.Tensor, position: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) float32 standard Gumbel noise, a pure function of each row's
    (seed, position) and the vocab index."""
    dev = position.device
    seed = seed.to(device=dev, dtype=torch.int64) & _MASK32
    pos = position.to(torch.int64) & _MASK32
    k1 = _mix32(_mix32(seed ^ 0x2545F491) ^ pos)
    k2 = _mix32(k1 ^ 0x5BD1E995)
    idx = torch.arange(vocab, device=dev, dtype=torch.int64)
    bits = _mix32(_mix32(idx[None, :] ^ k1[:, None]) ^ k2[:, None])
    u = ((bits >> 9).to(torch.float32) + 0.5) * 2.0**-23  # in (0, 1), exact in f32
    return -torch.log(-torch.log(u))


# ----------------------------------------------------------------- thresholds


def keep_mask(logits: torch.Tensor, state: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The thresholded vocab of every row -> (scaled logits (B, V) f32,
    keep (B, V) bool): the JAX package's top-k / top-p / min-p rule
    (core/sampling.py:100-125) on ``logits / temperature``."""
    v = logits.shape[-1]
    logits = logits.float()
    temperature = state["temperature"].float()
    top_k = state["top_k"].to(torch.int64)
    top_p = state["top_p"].float()
    min_p = state.get("min_p")
    min_p = torch.zeros_like(top_p) if min_p is None else min_p.float()

    sampled_row = temperature > 0.0
    safe_t = torch.where(sampled_row, temperature, torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, v), torch.full_like(top_k, v))
    thresh_k = sorted_desc.gather(1, (k - 1)[:, None])
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # a token is kept iff the mass BEFORE it is still < top_p (always keeps
    # the first token, even for top_p == 0)
    keep = (cum - probs) < top_p[:, None]
    num_keep = keep.sum(dim=-1).clamp(min=1)
    thresh_p = sorted_desc.gather(1, (num_keep - 1)[:, None])
    thresh = torch.maximum(thresh_k, thresh_p)
    # min-p: prob >= min_p * p_max  <=>  scaled >= scaled_max + log(min_p)
    thresh_m = torch.where(
        min_p > 0.0,
        sorted_desc[:, 0] + torch.log(min_p.clamp(min=1e-37)),
        torch.full_like(min_p, -float("inf")),
    )[:, None]
    thresh = torch.maximum(thresh, thresh_m)
    return scaled, scaled >= thresh


def sample_tokens(logits: torch.Tensor, state: dict, position: torch.Tensor) -> torch.Tensor:
    """Draw one token per row -> (B,) int32 on the logits' device.

    Rows with temperature <= 0 return exactly ``argmax(logits)``. Sampled
    rows apply temperature and the top-k / top-p / min-p cuts and draw by
    Gumbel-max with noise keyed on (seed, position)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled, keep = keep_mask(logits, state)
    masked = torch.where(keep, scaled, torch.full_like(scaled, -float("inf")))
    noise = gumbel_noise(state["seed"], position, logits.shape[-1])
    sampled = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return torch.where(state["temperature"] > 0.0, sampled, greedy)
