"""Automatic prefix caching: content-addressed reuse of full KV pages — the
port's own copy of the JAX ``serving/prefix_cache.py``.

Serving workloads repeat prompt prefixes constantly (system prompts, few-shot
preambles, retried requests, preempted-and-resumed requests). Because the
paged pool already decouples a sequence's logical positions from physical
pages (cache/paged.py), a full page whose *entire token prefix* matches an
earlier request's can be shared by pointing both page tables at the same
physical page — no KV is recomputed and no data moves. This module is the
host-side store that makes that safe:

- **Chain keys.** Page ``i`` is addressed by ``H(key_{i-1} || tokens of page
  i)`` — a match at page ``i`` certifies the ENTIRE prefix (same tokens, same
  absolute positions, hence bit-identical KV: RoPE is position-keyed and
  greedy/sampled decoding never writes inside a full page again; appends only
  land at ``lengths``, which lies beyond every shared page).

- **Refcounts + LRU.** A page is pinned while any live slot references it;
  at refcount 0 it stays RESIDENT (warm) on an LRU list and is only handed
  back to the allocator when the pool is under pressure
  (PagedEngine._grow → evict_lru) — the paged analog of cache/tiered
  memory. Ownership: pages enter the store via
  ``SeqPagePool.seq_release_prefix`` (detached from the writing slot's
  handle, which keeps only its private tail) and leave it only through
  ``evict_lru`` → ``free_raw``.

- **Adapter salt.** Under multi-LoRA serving a page's KV depends on the
  request's adapter (its ``wqkv`` delta), so the chain's root is salted with
  the adapter id (-1 for the base model): a page matches only requests on
  the same adapter. The JAX package keys by tokens alone, so there a request
  on adapter 1 reuses pages written under adapter 0.

Sharing deliberately stops at ``len(prompt) // page_size`` full pages:
partially-filled pages would be appended into by their owner. Matching
additionally stops at ``(len(text) - 1) // page_size`` so every admission
still prefills >= 1 token (the engine needs last-position logits).

"""

from __future__ import annotations

import hashlib
from collections import OrderedDict


def _page_keys(tokens: list[int], page_size: int, n_pages: int, adapter: int = -1) -> list[bytes]:
    """Chain keys for the first ``n_pages`` full pages of ``tokens`` under
    ``adapter`` (-1: the base model), the root salted with it."""
    keys = []
    h = f"adapter {int(adapter)}".encode()
    for i in range(n_pages):
        chunk = tokens[i * page_size : (i + 1) * page_size]
        m = hashlib.sha1(h)
        m.update(b",".join(str(t).encode() for t in chunk))
        h = m.digest()
        keys.append(h)
    return keys


class PrefixCache:
    """Content-addressed store of full, immutable KV pages (host-side)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._page_of: dict[bytes, int] = {}  # chain key -> physical page
        self._key_of: dict[int, bytes] = {}  # physical page -> its key
        self._refs: dict[int, int] = {}  # physical page -> live references
        self._lru: OrderedDict[int, None] = OrderedDict()  # refcount-0 pages
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    # -- introspection ---------------------------------------------------------

    @property
    def resident_pages(self) -> int:
        return len(self._key_of)

    @property
    def evictable_pages(self) -> int:
        return len(self._lru)

    def resident_set(self) -> set[int]:
        """All physical pages the store owns (shared OR warm) — the sanitizer
        allowlist: these may legitimately appear in several page tables."""
        return set(self._key_of)

    # -- core ops ---------------------------------------------------------------

    def match(self, tokens: list[int], adapter: int = -1) -> tuple[list[int], int]:
        """Longest cached chain over ``tokens`` under ``adapter`` → (pages
        acquired, tokens covered). Caps at len(tokens)-1 so the caller always
        prefills >= 1 token. Acquired pages are pinned (caller must
        release())."""
        max_pages = max(len(tokens) - 1, 0) // self.page_size
        pages: list[int] = []
        for key in _page_keys(tokens, self.page_size, max_pages, adapter):
            page = self._page_of.get(key)
            if page is None:
                break
            pages.append(page)
        for p in pages:
            self._acquire(p)
        if pages:
            self.hits += 1
            self.tokens_reused += len(pages) * self.page_size
        elif max_pages > 0:
            self.misses += 1
        return pages, len(pages) * self.page_size

    def insert_run(self, tokens: list[int], start: int, avail: int, adapter: int = -1) -> int:
        """How many pages from chain index ``start`` can be adopted as a
        contiguous run of NEW keys (stops at the first already-present key —
        a concurrent identical prompt published first). Presence is checked
        key-by-key because eviction can punch holes in a stored chain."""
        if avail <= 0:
            return 0
        keys = _page_keys(tokens, self.page_size, start + avail, adapter)
        run = 0
        for key in keys[start:]:
            if key in self._page_of:
                break
            run += 1
        return run

    def insert(
        self, tokens: list[int], n_already_cached: int, new_pages: list[int], adapter: int = -1
    ) -> list[int]:
        """Register freshly-written full pages ``n_already_cached ..`` of
        ``tokens``'s prefix, written under ``adapter``. Returns the subset actually adopted (pinned for
        the caller); pages whose key is already present are NOT adopted — the
        caller keeps owning those duplicates (they stay in its handle and are
        freed with it)."""
        total = n_already_cached + len(new_pages)
        keys = _page_keys(tokens, self.page_size, total, adapter)
        adopted = []
        for key, page in zip(keys[n_already_cached:], new_pages):
            if key in self._page_of:
                continue  # concurrent duplicate — existing entry wins
            self._page_of[key] = page
            self._key_of[page] = key
            self._refs[page] = 0
            self._acquire(page)
            adopted.append(page)
        return adopted

    def release(self, pages: list[int]) -> None:
        """Drop one reference per page; refcount-0 pages become LRU-evictable
        (but stay resident and matchable until evicted)."""
        for p in pages:
            r = self._refs[p] - 1
            self._refs[p] = r
            if r == 0:
                self._lru[p] = None
                self._lru.move_to_end(p)

    def evict_lru(self, n: int) -> list[int]:
        """Forget up to ``n`` refcount-0 pages (oldest first) and return them
        — the caller hands them back to the allocator (free_raw)."""
        out = []
        while self._lru and len(out) < n:
            page, _ = self._lru.popitem(last=False)
            del self._page_of[self._key_of.pop(page)]
            del self._refs[page]
            out.append(page)
        return out

    def _acquire(self, page: int) -> None:
        self._refs[page] += 1
        self._lru.pop(page, None)
