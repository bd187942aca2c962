"""Paged KV cache: the host half of the generation engine's storage.

Counterpart of ``mxnet_tpu/serving/generation/kv_cache.py``, plain Python
and the same accounting. The device half is the engine's pair of page
pools, ``(n_layers, pool_pages, page_size, n_heads, head_dim)`` tensors
updated in place; page 0 is the trash page that inactive slots and padded
prefill rows write to, so every step keeps fixed shapes. This module is
the allocator: a LIFO free list and per-slot page lists, pages allocated on
prefill (just enough for the prompt), extended on decode (one page when a
sequence crosses a page boundary) and freed on eviction, with admission
reserving each sequence's worst case up front so an extension never
fails. Pages are reference-counted (``incref`` / ``decref`` / ``cow``), and
speculative decoding returns rejected tail pages with ``shrink``.

Occupancy is the ``generation.kv_pages_used`` gauge (and, with a byte
model, ``generation.kv_bytes_used``), refreshed on every allocation and
free, as in the JAX package.
"""
from __future__ import annotations

import threading

__all__ = ["PagePool"]


class PagePool:
    """Host-side refcounted page allocator over a device page pool.

    ``pool_pages`` counts the whole device pool including the reserved
    trash page 0, so ``capacity = pool_pages - 1`` pages are allocatable.
    All methods are thread-safe; the scheduler thread allocates/frees
    while ``get_stats`` reads.

    ``bytes_per_token``/``kv_dtype`` (optional) describe the DEVICE cost
    of one cached position — K + V across every layer and head at the
    pool's storage dtype. With them the pool reports bytes, not just page
    counts, in the ``kv_bytes_*`` stats.
    """

    def __init__(self, pool_pages, page_size, bytes_per_token=0,
                 kv_dtype=None):
        if pool_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page), "
                             "got %d" % pool_pages)
        self.page_size = int(page_size)
        self.pool_pages = int(pool_pages)
        self.bytes_per_token = int(bytes_per_token)
        self.kv_dtype = str(kv_dtype) if kv_dtype is not None else None
        self._lock = threading.Lock()
        # LIFO free list: recently-freed pages are re-used first (their
        # device tiles are warm in whatever cache hierarchy applies)
        self._free = list(range(self.pool_pages - 1, 0, -1))  # guarded-by: self._lock
        self._owned = {}   # slot -> [page ids] in position order  # guarded-by: self._lock
        self._refs = {}    # page id -> reference count (>= 1 iff allocated)  # guarded-by: self._lock
        self._reserved = 0  # worst-case pages promised to live slots  # guarded-by: self._lock
        self._peak = 0      # high-water of pages in use  # guarded-by: self._lock
        self._cow_copies = 0    # cumulative copy-on-write privatizations  # guarded-by: self._lock
        self._shared_admits = 0  # cumulative pages attached via sharing  # guarded-by: self._lock

    # ------------------------------------------------------------- queries
    @property
    def capacity(self):
        return self.pool_pages - 1

    def pages_used(self):
        with self._lock:
            return self.capacity - len(self._free)

    def pages_for(self, n_tokens):
        """Pages needed to hold ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.page_size)

    @property
    def page_bytes(self):
        """Device bytes one page occupies (0 when the pool was built
        without a byte model)."""
        return self.page_size * self.bytes_per_token

    def kv_bytes_used(self):
        """Device bytes of the pages currently allocated."""
        return self.pages_used() * self.page_bytes

    def refcount(self, page):
        with self._lock:
            return self._refs.get(page, 0)

    def can_admit(self, worst_case_tokens, shared_pages=0, cow=False):
        """Would a sequence that may grow to ``worst_case_tokens`` ever
        be starved? Admission gate: free pages minus what live slots may
        still claim must cover this sequence's worst case.
        ``shared_pages`` pages it would attach from the prefix cache
        never touch the free list; a ``cow`` privatization claims one
        extra free page beyond the worst-case model."""
        need = (self.pages_for(worst_case_tokens) - int(shared_pages)
                + (1 if cow else 0))
        with self._lock:
            return len(self._free) - self._reserved >= need

    def admission_shortfall(self, worst_case_tokens, shared_pages=0,
                            cow=False):
        """How many MORE free pages admission of this sequence needs —
        the precise amount pressure-driven prefix-cache reclamation
        should release (evicting a request's full worst case would
        needlessly destroy cached prefixes under mild pressure).
        ``shared_pages``/``cow`` mirror :meth:`can_admit`."""
        need = (self.pages_for(worst_case_tokens) - int(shared_pages)
                + (1 if cow else 0))
        with self._lock:
            return max(0, need - (len(self._free) - self._reserved))

    # ---------------------------------------------------------- allocation
    def admit(self, slot, prompt_tokens, worst_case_tokens,
              shared_pages=(), cow_last=False):
        """Allocate-on-prefill: pages for the prompt now, a reservation
        for the rest. Returns the slot's page-id list (position order).

        ``shared_pages``: prefix-cache pages covering the prompt's head,
        ONE live reference each already held by the caller (the cache's
        ``match`` increfs) — admit transfers those references to the
        slot and allocates only the remaining fresh pages.
        ``cow_last=True`` reserves one extra free page for the
        :meth:`cow` privatization the caller will perform next (the
        page-aligned full-prefix-hit case).

        Raises MemoryError when the admission gate would be violated —
        callers check :meth:`can_admit` first, so this is a bug trap;
        the caller still owns the shared references on failure."""
        shared = list(shared_pages)
        n_now = self.pages_for(prompt_tokens)
        worst = self.pages_for(worst_case_tokens)
        if len(shared) > n_now:
            raise ValueError("%d shared pages exceed the %d the prompt "
                             "occupies" % (len(shared), n_now))
        need = worst - len(shared) + (1 if cow_last else 0)
        with self._lock:
            if slot in self._owned:
                raise ValueError("slot %d already owns pages" % slot)
            for p in shared:
                if self._refs.get(p, 0) < 1:
                    raise ValueError(
                        "shared page %d has no live reference" % p)
            if len(self._free) - self._reserved < need:
                raise MemoryError(
                    "page pool overcommitted: %d free, %d reserved, "
                    "%d needed" % (len(self._free), self._reserved, need))
            fresh = [self._free.pop() for _ in range(n_now - len(shared))]
            for p in fresh:
                self._refs[p] = 1
            self._owned[slot] = shared + fresh
            self._shared_admits += len(shared)
            self._reserved += worst - n_now
            self._peak = max(self._peak, self.capacity - len(self._free))
        self._gauge()
        return list(self._owned[slot])

    def extend(self, slot):
        """Extend-on-decode: one more page for ``slot`` (its sequence
        crossed a page boundary). The admission reservation guarantees a
        free page exists. Returns the new page id."""
        with self._lock:
            if slot not in self._owned:
                raise ValueError("slot %d owns no pages" % slot)
            if not self._free:
                raise MemoryError("page pool exhausted despite admission "
                                  "reservations (accounting bug)")
            page = self._free.pop()
            self._refs[page] = 1
            self._owned[slot].append(page)
            self._reserved = max(0, self._reserved - 1)
            self._peak = max(self._peak, self.capacity - len(self._free))
        self._gauge()
        return page

    def shrink(self, slot, n_tokens):
        """Rollback-on-rejection: return ``slot``'s trailing pages not
        needed to cover ``n_tokens`` committed positions (speculative
        decoding scattered K/V for up to k draft tokens optimistically;
        a rejection leaves the tail pages holding only stale data that
        the ``lengths`` masking already hides).

        Freed pages go back to the free list and their admission
        reservation is restored (``_reserved`` += 1 each): the slot may
        still need them to reach its worst case, and restoring the
        reservation keeps :meth:`release`'s ``pages_for(worst) -
        len(pages)`` accounting exact. Trailing pages past a slot's
        committed length are always extend-claimed, never prefix-shared,
        so each carries exactly one reference; a shared tail page is an
        accounting bug and raises. Returns the number of pages freed."""
        n_freed = 0
        with self._lock:
            if slot not in self._owned:
                raise ValueError("slot %d owns no pages" % slot)
            pages = self._owned[slot]
            keep = self.pages_for(n_tokens)
            while len(pages) > keep:
                page = pages[-1]
                if self._refs.get(page, 0) != 1:
                    raise ValueError(
                        "speculative tail page %d has refcount %d, "
                        "expected 1" % (page, self._refs.get(page, 0)))
                pages.pop()
                del self._refs[page]
                self._free.append(page)
                self._reserved += 1
                n_freed += 1
        if n_freed:
            self._gauge()
        return n_freed

    def cow(self, slot, index):
        """Copy-on-write: privatize the shared page at ``index`` of
        ``slot``'s page list before a write lands in it. Returns
        ``(src_page, dst_page)`` — the caller copies the device page
        contents ``src -> dst`` (inside its compiled program) when they
        differ. A page this slot is already the sole owner of needs no
        copy (``src == dst``); a genuinely shared page is swapped for a
        fresh one (the ``admit(cow_last=True)`` gate guaranteed it) and
        the original keeps serving its other readers."""
        with self._lock:
            if slot not in self._owned:
                raise ValueError("slot %d owns no pages" % slot)
            pages = self._owned[slot]
            old = pages[index]
            if self._refs.get(old, 0) <= 1:
                return old, old  # sole owner: write in place
            if not self._free:
                raise MemoryError("no free page for copy-on-write "
                                  "(admit(cow_last=True) gate bypassed)")
            new = self._free.pop()
            self._refs[new] = 1
            self._refs[old] -= 1
            pages[index] = new
            self._cow_copies += 1
            self._peak = max(self._peak, self.capacity - len(self._free))
        self._gauge()
        return old, new

    def incref(self, page):
        """Add a reference to an allocated page (the prefix cache's
        retain; readers via ``match``/``admit`` transfer these)."""
        with self._lock:
            if self._refs.get(page, 0) < 1:
                raise ValueError("page %d is not allocated" % page)
            self._refs[page] += 1

    def decref(self, page):
        """Drop one reference; the page returns to the free list when
        the last reference drops. Returns True if the page was freed."""
        freed = False
        with self._lock:
            refs = self._refs.get(page, 0)
            if refs < 1:
                raise ValueError("decref of unallocated page %d" % page)
            if refs == 1:
                del self._refs[page]
                self._free.append(page)
                freed = True
            else:
                self._refs[page] = refs - 1
        if freed:
            self._gauge()
        return freed

    def release(self, slot, worst_case_tokens=0):
        """Free-on-eviction: drop one reference on each of ``slot``'s
        pages (pages the prefix cache or another reader still holds stay
        allocated) and drop whatever admission reservation the slot
        never claimed (``worst_case_tokens``: the same bound passed to
        :meth:`admit`). Returns the number of pages actually freed."""
        n_freed = 0
        with self._lock:
            pages = self._owned.pop(slot, None)
            if pages is None:
                # a slot that never completed admit() holds neither
                # pages nor a reservation — dropping one here would
                # steal another slot's
                return 0
            for page in reversed(pages):
                refs = self._refs.get(page, 0)
                if refs <= 1:
                    self._refs.pop(page, None)
                    self._free.append(page)
                    n_freed += 1
                else:
                    self._refs[page] = refs - 1
            # the slot's live reservation is worst-case pages minus the
            # pages it actually claimed (admit + extend both decrement)
            unused = max(0, self.pages_for(worst_case_tokens) - len(pages))
            self._reserved = max(0, self._reserved - unused)
        self._gauge()
        return n_freed

    def pages_of(self, slot):
        with self._lock:
            return list(self._owned.get(slot, ()))

    def _gauge(self):
        from ...observability import metrics

        used = self.pages_used()
        metrics.gauge("generation.kv_pages_used").set(used)
        if self.bytes_per_token:
            metrics.gauge("generation.kv_bytes_used").set(
                used * self.page_bytes)

    def assert_no_leaks(self):
        """Drain-time invariant check: every page back on the free list, no
        dangling refcounts, no slot ownership, reservation fully
        drained. Raises AssertionError with the offending accounting
        otherwise; returns self so calls chain."""
        with self._lock:
            used = self.capacity - len(self._free)
            if used or self._refs or self._owned or self._reserved:
                raise AssertionError(
                    "PagePool leak after drain: %d pages allocated, "
                    "refcounts %r, owned %r, reserved %d"
                    % (used, dict(self._refs), dict(self._owned),
                       self._reserved))
            if sorted(self._free) != list(range(1, self.pool_pages)):
                raise AssertionError(
                    "PagePool free list corrupt: %r" % sorted(self._free))
        return self

    def get_stats(self):
        with self._lock:
            used = self.capacity - len(self._free)
            shared = sum(1 for r in self._refs.values() if r > 1)
            # every reference beyond a page's first is a page some other
            # reader did NOT have to allocate+prefill — the sharing win
            extra_refs = sum(r - 1 for r in self._refs.values())
            return {"page_size": self.page_size,
                    "capacity": self.capacity,
                    "free": len(self._free),
                    "used": used,
                    "peak_used": self._peak,
                    "reserved": self._reserved,
                    "kv_dtype": self.kv_dtype,
                    "bytes_per_token": self.bytes_per_token,
                    "kv_bytes_used": used * self.page_bytes,
                    "kv_bytes_peak": self._peak * self.page_bytes,
                    "kv_bytes_capacity": self.capacity * self.page_bytes,
                    "pages_shared": shared,
                    "cow_copies": self._cow_copies,
                    "shared_admits": self._shared_admits,
                    "bytes_saved_shared": extra_refs * self.page_bytes,
                    "slots": {s: len(p) for s, p in self._owned.items()}}
