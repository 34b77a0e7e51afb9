"""Paged KV storage for the serving engine: a page pool on the device with
host-side allocation, refcounts and zero-copy sharing — port of the pool
half of ``marlin_tpu/serving/pages.py`` (the host KV tier is not ported
yet: ROADMAP Queue A1).

* The KV cache is one pool per layer, ``(n_pages + 1, PAGE, Hk, Dh)`` per
  K and V, at the 16-token page the prefix trie chunks by
  (``serving/prefix.GRAIN``); an int8 pool (``cfg.kv_quant``) adds
  ``(n_pages + 1, PAGE, Hk, 1)`` scale buffers, which travel with their
  pages (``models/quant.kv_layer_keys``).
* A batch row holds a page table (``max_len // PAGE`` entries), not KV
  rows: attention reads gather pages into the dense layout
  (``models/transformer.gather_kv_pages``) and writes scatter through the
  table, bitwise the contiguous cache.
* A prefix hit aliases pages into the new row's table (refcount bumps, no
  KV bytes move), and a store into the prefix index pins the row's own
  prefix pages: zero copy both ways.
* A page returns to the free list exactly when its last reference (a row
  table or a stored prefix) drops, so evicting a prefix that live rows
  still alias frees nothing until they retire.

Allocation is by reservation: a request's pages are counted exactly at
admission (``ceil((prompt_len + steps) / PAGE)`` less its aliased prefix
pages), so a placed request never runs out of pages mid-decode. Page 0 is
the write sink: frozen rows' fixed-point rewrites and parked mid-prefill
feeds land there through table entries of unallocated chunks; it is never
allocated, referenced, or read through a live mask.

The allocator state is read by other threads through ``summary()`` while
the stepping thread allocates and frees, so every mutation and every
scan holds ``_lock``. The device pool is written only by the stepping
thread, in place.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

from ..models import transformer as tr
from ..models.quant import kv_layer_keys
from ..obs import metrics as obs_metrics
from ..utils.hw import resolve_device

PAGE = 16  # tokens a page: the admission bucket and the trie's GRAIN

SINK_PAGE = 0  # the write sink (module docstring); never allocated


class PagePool:
    """Device page pool plus the host allocator and refcounts of the paged
    engine.

    Build it with the engine's :class:`TransformerConfig` and ``n_pages``
    usable pages; the device holds ``n_pages + 1`` (the write sink at
    index 0), on ``device`` (default ``"cuda"``)."""

    def __init__(self, cfg, n_pages: int, registry=None, device="cuda"):
        if not isinstance(n_pages, int) or isinstance(n_pages, bool) \
                or n_pages < 1:
            raise ValueError(
                f"n_pages must be an int >= 1, got {n_pages!r}")
        if cfg.max_len % PAGE:
            raise ValueError(
                f"paged KV needs max_len divisible by the page size "
                f"{PAGE}, got max_len={cfg.max_len}")
        if cfg.window:
            raise ValueError(
                "paged KV needs the dense slot==position layout "
                "(cfg.window == 0); a ring cache cannot be paged at "
                "fixed position-aligned chunks")
        self.cfg = cfg
        self.n_pages = n_pages
        self.device = resolve_device(device)
        # init_kv_cache at max_len = PAGE is exactly the page shape.
        self.pages = tr.init_kv_cache(cfg._replace(max_len=PAGE),
                                      n_pages + 1, dtype=cfg.compute_dtype,
                                      device=self.device)
        self._registry = registry
        self._free: List[int] = list(range(1, n_pages + 1))[::-1]
        self._refs: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.allocs = 0
        self.frees = 0
        self.alloc_failures = 0
        self.registry.gauge(
            "serving_kv_pages_total",
            help="usable KV pages in the paged pool (excludes the "
                 "write sink)").set(n_pages)
        with self._lock:
            self._mirror_locked()

    # -- bookkeeping --------------------------------------------------

    @property
    def registry(self):
        return self._registry if self._registry is not None \
            else obs_metrics.registry

    @property
    def page_bytes(self) -> int:
        """Device bytes of one page across every layer's K and V (and, on
        an int8 pool, their scales)."""
        return sum(layer[name][0].numel() * layer[name].element_size()
                   for layer in self.pages for name in kv_layer_keys(layer))

    @property
    def pool_bytes(self) -> int:
        return self.page_bytes * self.n_pages

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - self.n_free

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def _mirror_locked(self) -> None:
        reg = self.registry
        aliased = sum(1 for n in self._refs.values() if n >= 2)
        reg.gauge("serving_kv_pages_used",
                  help="KV pages currently referenced by a row table "
                       "or a stored prefix").set(
            self.n_pages - len(self._free))
        reg.gauge("serving_kv_pages_aliased",
                  help="KV pages with >= 2 references (shared between "
                       "rows and/or stored prefixes)").set(aliased)

    # -- allocate / reference / free ----------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` free pages (each at refcount 1), or None when the
        free list is short (no partial grant). ``n == 0`` returns []."""
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        with self._lock:
            if n > len(self._free):
                self.alloc_failures += 1
                return None
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._refs[p] = 1
            self.allocs += n
            self._mirror_locked()
        return out

    def ref(self, pages: Iterable[int]) -> None:
        """Add one reference to each live page: a prefix hit aliasing
        stored pages into a row table, or a store pinning a row's
        prefix pages into the index."""
        pages = list(pages)
        with self._lock:
            for p in pages:
                if self._refs.get(p, 0) <= 0:
                    raise RuntimeError(
                        f"ref of free/unallocated page {p} (refcount "
                        "discipline bug: aliases may only point at "
                        "live pages)")
            for p in pages:
                self._refs[p] += 1
            self._mirror_locked()

    def unref(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; a page reaching zero returns to
        the free list exactly once."""
        pages = list(pages)
        with self._lock:
            for p in pages:
                if self._refs.get(p, 0) <= 0:
                    raise RuntimeError(
                        f"unref of free page {p} (double free)")
            for p in pages:
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._free.append(p)
                    self.frees += 1
            self._mirror_locked()

    # -- observability ------------------------------------------------

    def summary(self) -> dict:
        """The page-pool ledger block, consistent at one instant."""
        with self._lock:
            return {
                "kv_pages_total": self.n_pages,
                "kv_pages_free": len(self._free),
                "kv_pages_used": self.n_pages - len(self._free),
                "kv_pages_aliased": sum(1 for n in self._refs.values()
                                        if n >= 2),
                "kv_page_refs_total": sum(self._refs.values()),
                "kv_page_bytes": self.page_bytes,
                "kv_page_allocs": self.allocs,
                "kv_page_frees": self.frees,
                "kv_page_alloc_failures": self.alloc_failures,
            }
