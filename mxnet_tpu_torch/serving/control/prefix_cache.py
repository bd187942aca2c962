"""Radix-tree prefix cache over the paged KV pool.

Counterpart of ``mxnet_tpu/serving/control/prefix_cache.py``, plain Python
and the same accounting. The tree's edges are page-aligned token blocks,
each mapping to one KV page of the generator's :class:`~..generation.
kv_cache.PagePool`; a request that opens with cached blocks attaches their
pages read-only and prefills only its suffix. K/V content is a pure
function of the token prefix (causal attention, deterministic
projections), so any page whose block path matches is valid context for
any request.

* **Page-aligned blocks.** A lookup matches whole blocks only; a prompt's
  partial tail is always recomputed (sharing a partial page would let a
  writer corrupt another reader's context).
* **Refcounts, not copies.** The cache holds one pool reference per cached
  page; ``match`` takes one more per matched page on the caller's behalf,
  so a hit stays valid while the cache evicts the entry under a reader.
* **LRU + reclamation.** ``insert`` runs at sequence eviction; a bounded
  cache evicts least-recently-matched leaves first (an interior page is
  causal context for every descendant), and the engine calls
  :meth:`PrefixCache.reclaim` when admission would otherwise stall.

Thread model: ``match`` / ``insert`` / ``reclaim`` run on the generator's
scheduler thread; the lock serves ``get_stats`` / ``clear`` readers.
"""
from __future__ import annotations

import threading

__all__ = ["PrefixCache"]


class _Node:
    """One page-aligned block edge of the radix tree."""

    __slots__ = ("block", "page", "children", "parent", "last_use")

    def __init__(self, block, page, parent):
        self.block = block        # tuple of page_size token ids
        self.page = page          # the KV page holding this block
        self.children = {}        # block tuple -> _Node
        self.parent = parent
        self.last_use = 0


class PrefixCache:
    """Radix tree mapping page-aligned token prefixes to shared KV pages.

    ``capacity_pages`` bounds how many pages the cache may retain
    (0 = bounded only by the pool itself); beyond it, insertion evicts
    least-recently-matched leaves first.
    """

    def __init__(self, pool, capacity_pages=0):
        self._pool = pool
        self.page_size = int(pool.page_size)
        self.capacity_pages = int(capacity_pages)
        self._lock = threading.Lock()
        self._root = {}      # block tuple -> _Node  # guarded-by: self._lock
        self._clock = 0      # LRU clock (bumped per match/insert)  # guarded-by: self._lock
        self._pages = 0      # pages currently retained  # guarded-by: self._lock
        self._hits = 0       # guarded-by: self._lock
        self._misses = 0     # guarded-by: self._lock
        self._hit_tokens = 0  # cumulative tokens served from cache  # guarded-by: self._lock
        self._evicted = 0    # cumulative pages reclaimed  # guarded-by: self._lock
        self._insert_skips = 0  # inserts dropped for lack of evictable space  # guarded-by: self._lock

    def _blocks(self, tokens):
        page = self.page_size
        n_full = len(tokens) // page
        return [tuple(tokens[i * page:(i + 1) * page])
                for i in range(n_full)]

    # -------------------------------------------------------------- lookup
    def match(self, tokens, record=True):
        """Longest cached page-aligned prefix of ``tokens``. Returns
        ``(pages, matched_tokens)`` with one pool reference taken per
        returned page ON THE CALLER'S BEHALF (transfer them to a slot
        via ``PagePool.admit(shared_pages=...)`` or drop them with
        ``decref`` on failure) — so a concurrent eviction can never free
        a page out from under the reader.

        ``record=False`` skips the hit/miss counters (the admission
        gate's sharing-discount PROBE match, which the real match in
        the prefill path follows — counting both would double every
        pressure-path lookup). The LRU clock still bumps either way,
        which also shields a just-probed chain from the reclamation the
        probe may trigger."""
        pages = []
        with self._lock:
            self._clock += 1
            node_map, parent = self._root, None
            for block in self._blocks(tokens):
                node = node_map.get(block)
                if node is None:
                    break
                node.last_use = self._clock
                self._pool.incref(node.page)
                pages.append(node.page)
                node_map, parent = node.children, node
            matched = len(pages) * self.page_size
            if record:
                if pages:
                    self._hits += 1
                    self._hit_tokens += matched
                else:
                    self._misses += 1
        return pages, matched

    # -------------------------------------------------------------- insert
    def insert(self, tokens, slot_pages):
        """Insert the full-page blocks of ``tokens`` (a completed
        request's prompt), retaining the corresponding ``slot_pages``
        entries. Blocks already cached are LRU-bumped and keep their
        existing page (content-equivalent by determinism); new blocks
        incref the slot's page before the slot releases it. Returns the
        number of pages newly retained."""
        blocks = self._blocks(tokens)
        added = 0
        with self._lock:
            self._clock += 1
            node_map, parent = self._root, None
            for i, block in enumerate(blocks):
                node = node_map.get(block)
                if node is None:
                    if (self.capacity_pages
                            and self._pages >= self.capacity_pages
                            and not self._evict_lru_locked(
                                protect_clock=self._clock)):
                        # nothing evictable (every leaf is this
                        # insertion's own fresh path): stop here
                        self._insert_skips += 1
                        break
                    page = slot_pages[i]
                    self._pool.incref(page)
                    node = _Node(block, page, parent)
                    node_map[block] = node
                    self._pages += 1
                    added += 1
                node.last_use = self._clock
                node_map, parent = node.children, node
        return added

    # ------------------------------------------------------------ eviction
    def _leaves(self):
        # caller holds self._lock (the _locked-helper contract)
        out = []
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def _evict_lru_locked(self, protect_clock=None):
        """Drop the least-recently-matched leaf (leaves only: an
        interior page is causal context for every descendant). Returns
        True if a page was released."""
        victim = None
        for leaf in self._leaves():
            if protect_clock is not None and leaf.last_use >= protect_clock:
                continue  # this insertion's own fresh path
            if victim is None or leaf.last_use < victim.last_use:
                victim = leaf
        if victim is None:
            return False
        siblings = (victim.parent.children if victim.parent is not None
                    else self._root)
        siblings.pop(victim.block, None)
        self._pool.decref(victim.page)
        self._pages -= 1
        self._evicted += 1
        return True

    def reclaim(self, n_pages):
        """Pressure-driven reclamation: release up to ``n_pages`` cached
        references, LRU leaves first, so a pool full of cached prefixes
        never deadlocks admission. Returns how many references were
        dropped (pages actually return to the free list only when no
        active reader still holds them)."""
        dropped = 0
        with self._lock:
            while dropped < n_pages and self._evict_lru_locked():
                dropped += 1
        return dropped

    def clear(self):
        """Release every cached page reference (generator shutdown)."""
        with self._lock:
            dropped = 0
            while self._evict_lru_locked():
                dropped += 1
        return dropped

    # --------------------------------------------------------------- stats
    def __len__(self):
        with self._lock:
            return self._pages

    def get_stats(self):
        with self._lock:
            total = self._hits + self._misses
            return {"pages": self._pages,
                    "capacity_pages": self.capacity_pages,
                    "page_size": self.page_size,
                    "hits": self._hits,
                    "misses": self._misses,
                    "hit_rate": (self._hits / total) if total else 0.0,
                    "hit_tokens": self._hit_tokens,
                    "evicted_pages": self._evicted,
                    "insert_skips": self._insert_skips}
