"""Sanitizers for ``debug_validate=True`` engines — twin of the JAX
``utils/sanitize.py``.

1. **Numeric faults**: a NaN/Inf from a bad checkpoint or an overflowing
   scale propagates through argmax as plausible-looking tokens.
   :func:`check_finite` is the tripwire.
2. **Page-table races**: the paged pool is shared and indexed by host-built
   page tables. Two live sequences on one physical page would each read the
   other's KV. :func:`check_page_table` finds aliasing, out-of-range ids and
   null-page entries before a decode round consumes the table;
   :func:`check_append_window` checks that a fixed-size round's appends stay
   inside the cache.

Host-side numpy plus one scalar readback per tensor; never on the hot path.
"""

from __future__ import annotations

import numpy as np
import torch


class NumericFault(RuntimeError):
    """A tensor tree contains NaN/Inf where finite values are required."""


class PageTableRace(RuntimeError):
    """Two live sequences alias the same physical KV page (or a table entry
    is out of range / the null page) — appends would cross-corrupt."""


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree, name: str = "tree") -> None:
    """Raise :class:`NumericFault` naming every float tensor leaf with
    NaN/Inf (one boolean read back per leaf)."""
    bad = [path for path, leaf in _leaves(tree)
           if torch.is_tensor(leaf) and leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise NumericFault(f"{name}: non-finite values in {bad}")


def check_page_table(
    table: np.ndarray,
    lengths: np.ndarray,
    page_size: int,
    num_pages: int,
    active: np.ndarray | None = None,
    shard_of: np.ndarray | None = None,
    shared_ok: set[int] | frozenset[int] | None = None,
    reclaimed_below: np.ndarray | None = None,
) -> None:
    """Validate a host page table (num_slots, pages_per_seq) against the
    allocator's invariants. For each active slot the first
    ``ceil(length / page_size)`` entries must be in ``[1, num_pages)`` and
    unique across live slots of one pool shard, except pages in
    ``shared_ok`` (refcounted prefix-cache pages, never appended into). A
    null entry at index j < ``reclaimed_below[slot]`` is a reclaimed
    out-of-window page and legal. Raises :class:`PageTableRace` listing every
    violation."""
    table = np.asarray(table)
    lengths = np.asarray(lengths)
    n_slots = table.shape[0]
    if active is None:
        active = lengths > 0
    if shard_of is None:
        shard_of = np.zeros((n_slots,), np.int64)
    violations: list[str] = []
    owner: dict[tuple[int, int], int] = {}  # (shard, page) -> slot
    for slot in range(n_slots):
        if not active[slot] or lengths[slot] <= 0:
            continue
        used = -(-int(lengths[slot]) // page_size)
        if used > table.shape[1]:
            violations.append(
                f"slot {slot}: length {int(lengths[slot])} needs {used} pages "
                f"> table width {table.shape[1]}")
            used = table.shape[1]
        for j in range(used):
            page = int(table[slot, j])
            if page == 0:
                if reclaimed_below is not None and j < int(reclaimed_below[slot]):
                    continue
                violations.append(f"slot {slot}: live entry {j} is the null page 0")
                continue
            if not (0 < page < num_pages):
                violations.append(f"slot {slot}: entry {j} = {page} out of range [1, {num_pages})")
                continue
            if shared_ok is not None and page in shared_ok:
                continue
            key = (int(shard_of[slot]), page)
            if key in owner and owner[key] != slot:
                violations.append(
                    f"page {page} (shard {key[0]}) aliased by slots "
                    f"{owner[key]} and {slot} — cross-sequence KV corruption")
            else:
                owner[key] = slot
    if violations:
        raise PageTableRace("; ".join(violations))


def check_append_window(lengths: np.ndarray, steps: int, max_seq_len: int) -> None:
    """Raise if one fixed-size decode round's appends (``steps`` per slot
    from ``lengths``) would run past ``max_seq_len``."""
    lengths = np.asarray(lengths)
    over = np.nonzero(lengths + steps > max_seq_len)[0]
    if over.size:
        raise PageTableRace(
            f"slots {over.tolist()}: length + round size {steps} exceeds "
            f"cache capacity {max_seq_len} — appends would clamp onto live KV rows")
