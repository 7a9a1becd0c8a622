"""Prompt-lookup drafting for speculative decoding — twin of the JAX
``core/drafting.py``.

Draft tokens are proposed by n-gram matching against each sequence's own
token history (prompt + everything generated so far): a handful of
vectorized compares on the device, with no ``.item()`` and no host sync, so
a speculative round (``models/llama.spec_decode_multi``) reads nothing back
until its end. The clamps are the JAX package's, copied exactly.

The history functions are functional (they return a new tensor), as in the
JAX package: the speculative step keeps the old history for inactive rows.
"""

from __future__ import annotations

import torch


def _match_pos(history: torch.Tensor, length: torch.Tensor, n: int) -> torch.Tensor:
    """Most recent earlier occurrence of the trailing ``n``-gram -> (B,)
    int32 window-start position, -1 when none exists."""
    b, s_hist = history.shape
    n_pos = s_hist - n + 1
    match = torch.ones((b, n_pos), dtype=torch.bool, device=history.device)
    for j in range(n):
        idx = torch.clamp(length - n + 1 + j, 0, s_hist - 1)
        key_j = history.gather(1, idx[:, None].long())  # (B, 1)
        match &= history[:, j:n_pos + j] == key_j
    pos = torch.arange(n_pos, dtype=torch.int32, device=history.device)[None, :]
    # exclude the key's own occurrence (p == length - n + 1) and anything
    # later; windows that would cross `length` are excluded with it
    valid = pos < (length - n + 1)[:, None]
    return torch.where(match & valid, pos, torch.full_like(pos, -1)).amax(dim=1)


def propose_drafts(history: torch.Tensor, length: torch.Tensor, pending: torch.Tensor, *,
                   num_draft: int, ngram: int = 2) -> torch.Tensor:
    """Propose ``num_draft`` continuation tokens per sequence -> (B, k) int32.

    ``history[b, p]`` is the token at absolute position ``p``; positions
    ``0 .. length[b]`` are valid (the caller writes ``pending`` at position
    ``length`` first). Longest-match backoff: the trailing ``ngram``-gram is
    tried first, then shorter keys down to one token. With no match at any
    length the draft repeats ``pending``."""
    length = length.to(torch.int32)
    b = history.shape[0]
    best_p = torch.full((b,), -1, dtype=torch.int32, device=history.device)
    best_n = torch.zeros((b,), dtype=torch.int32, device=history.device)
    for n in range(ngram, 0, -1):
        p_n = _match_pos(history, length, n)
        take = (best_p < 0) & (p_n >= 0)
        best_p = torch.where(take, p_n, best_p)
        best_n = torch.where(take, torch.full_like(best_n, n), best_n)
    found = best_p >= 0
    s_hist = history.shape[1]
    steps = torch.arange(num_draft, dtype=torch.int32, device=history.device)[None, :]
    idx = torch.clamp(best_p[:, None] + best_n[:, None] + steps, 0, s_hist - 1)
    draft = history.gather(1, idx.long())  # (B, k)
    return torch.where(found[:, None], draft, pending.to(history.dtype)[:, None])


def write_token(history: torch.Tensor, pos: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """``history[b, pos[b]] = tok[b]`` (position clamped) -> new history."""
    s_hist = history.shape[1]
    pos = torch.clamp(pos.to(torch.int32), 0, s_hist - 1)
    return history.scatter(1, pos[:, None].long(), tok.to(history.dtype)[:, None])


def write_block(history: torch.Tensor, pos: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """``history[b, pos[b] + j] = toks[b, j]`` (start clamped so the block
    fits) -> new history."""
    s_hist = history.shape[1]
    t = toks.shape[1]
    pos = torch.clamp(pos.to(torch.int32), 0, s_hist - t)
    idx = pos[:, None].long() + torch.arange(t, device=history.device)[None, :]
    return history.scatter(1, idx, toks.to(history.dtype))
