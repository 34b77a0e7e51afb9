"""Paged KV storage for the serving engine: a page pool on the device with
host-side allocation, refcounts and zero-copy sharing, and the host KV
tier beneath it — port of ``marlin_tpu/serving/pages.py``.

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

:class:`HostKVTier` keeps what the pool lets go in host memory: stored
prefixes the prefix index evicts (restored later by a scatter instead of a
re-prefill) and the pinned rows of preempted requests.

The allocator state is read by other threads through ``summary()`` while
the stepping thread allocates and frees, so every mutation and every
scan holds ``_lock``. The device pool is written only by the stepping
thread, in place.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models import transformer as tr
from ..models.quant import kv_layer_keys
from ..models.tp import Sharded, gather_heads, per_shard, tp_devices
from ..obs import metrics as obs_metrics

PAGE = 16  # tokens a page: the admission bucket and the trie's GRAIN

SINK_PAGE = 0  # the write sink (module docstring); never allocated


class PagePool:
    """Device page pool plus the host allocator and refcounts of the paged
    engine.

    Build it with the engine's :class:`TransformerConfig` and ``n_pages``
    usable pages; the device holds ``n_pages + 1`` (the write sink at
    index 0), on ``device`` (default ``"cuda"``). With ``cfg.tp > 1``
    ``device`` names the ``model`` axis (:func:`..models.tp.tp_devices`)
    and ``pages`` is one page tree a shard, each holding its shard's
    heads, under the one host allocator."""

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
        self.devices = tp_devices(cfg.tp, device)
        self.device = self.devices[0]

        # init_kv_cache at max_len = PAGE is exactly the page shape.
        self.pages = per_shard(
            lambda dev: tr.init_kv_cache(cfg._replace(max_len=PAGE),
                                         n_pages + 1,
                                         dtype=cfg.compute_dtype, device=dev),
            self.devices)
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
        an int8 pool, their scales), every shard's together."""
        trees = self.pages if isinstance(self.pages, Sharded) \
            else (self.pages,)
        return sum(layer[name][0].numel() * layer[name].element_size()
                   for pages in trees for layer in pages
                   for name in kv_layer_keys(layer))

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


def gather_pages_to_host(pool_pages, pages) -> Tuple[list, int]:
    """One gather of ``pages`` across every layer's K and V (and scales)
    into host memory: a list a layer of ``{name: (n, PAGE, Hk, Dh)}`` CPU
    tensors in the pool's dtype, and their bytes. On a CUDA pool the
    copies land in pinned memory and the device is synced before this
    returns, so the host may read them and the pages may be reused. A
    tensor-parallel pool (:class:`..models.tp.Sharded`) gathers each
    shard and concatenates their heads (axis 2) in rank order: the
    payload is the global head layout, the same bytes at every degree."""
    if isinstance(pool_pages, Sharded):
        parts = [gather_pages_to_host(shard, pages) for shard in pool_pages]
        return (gather_heads([p for p, _ in parts], device="cpu"),
                sum(n for _, n in parts))
    dev = pool_pages[0]["k"].device
    idx = torch.as_tensor([int(p) for p in pages], dtype=torch.long,
                          device=dev)
    cuda = dev.type == "cuda"
    payload, nbytes = [], 0
    for layer in pool_pages:
        nl = {}
        for name in kv_layer_keys(layer):
            part = layer[name].index_select(0, idx)  # a fresh tensor
            if cuda:
                host = torch.empty(part.shape, dtype=part.dtype,
                                   pin_memory=True)
                part = host.copy_(part, non_blocking=True)
            nl[name] = part
            nbytes += part.numel() * part.element_size()
        payload.append(nl)
    if cuda:
        torch.cuda.synchronize(dev)
    return payload, nbytes


# Dtypes np.savez keeps as they are; any other (bfloat16) is written as
# float32, which holds each of its values exactly.
_SAVEZ_NATIVE = frozenset((torch.float16, torch.float32, torch.float64,
                           torch.int8, torch.int16, torch.int32, torch.int64,
                           torch.uint8))


class HostKVTier:
    """Host-memory tier under the device page pool.

    When :class:`~.prefix.PagedPrefixIndex` evicts a stored prefix under
    device pressure, the entry's pages spill here (one gather) instead of
    vanishing; a later hit on the spilled prefix restores it by scattering
    the same bytes into fresh pages (:func:`.slots.restore_pages_into_pool`)
    and skips the re-prefill. ``budget_bytes`` bounds the tier, evicted
    least recently used. Payloads are CPU tensors in the pool's dtype
    (pinned on a CUDA pool).

    Prefix payloads are keyed by content (sha1 of the stored tokens as
    int32, and the length), the key the JAX package's tier computes, so
    engines sharing a ``spill_dir`` adopt each other's prefixes; the dir's
    ``.npz`` files use the JAX package's names and dtypes.

    Pinned row entries (:meth:`spill_row` / :meth:`fetch_row` /
    :meth:`drop_row`) hold a preempted decoding row's KV and tokens. They
    count against the budget but are never evicted: under pressure the
    tier drops prefixes first and otherwise refuses the spill (the engine
    then does not preempt). Rows live in memory only.

    The stepping thread spills and fetches while other threads read
    ``summary()``: every mutation and scan holds ``_lock``; the gather
    reads the device pool outside it."""

    def __init__(self, pool: PagePool, budget_bytes: Optional[int] = None,
                 registry=None, event_sink=None,
                 spill_dir: Optional[str] = None):
        if budget_bytes is not None and budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be None or >= 1, got {budget_bytes}")
        self.pool = pool
        self.budget_bytes = budget_bytes
        self._registry = registry
        self.event_sink = event_sink  # callable(kind, **fields) or None
        self.spill_dir = spill_dir
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._bytes = 0  # in-memory prefix payload bytes
        self._rows: Dict[str, dict] = {}  # pinned rows
        self._row_bytes = 0
        self._lock = threading.Lock()
        self.spills = 0
        self.restores = 0
        self.drops = 0
        self.row_spills = 0
        self.row_restores = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        with self._lock:
            self._mirror_locked()
        self.registry.histogram(
            "serving_kv_restore_seconds",
            help="host-to-device restore latency per restored prefix")

    @property
    def registry(self):
        return self._registry if self._registry is not None \
            else obs_metrics.registry

    def _mirror_locked(self) -> None:
        reg = self.registry
        reg.gauge("serving_kv_host_bytes",
                  help="bytes of spilled KV payloads resident in host "
                       "memory").set(self._bytes)
        reg.gauge("serving_kv_host_entries",
                  help="spilled prefixes resident in host memory").set(
            len(self._entries))
        reg.gauge("serving_kv_host_rows",
                  help="preempted live rows pinned in host memory").set(
            len(self._rows))
        reg.gauge("serving_kv_host_row_bytes",
                  help="bytes of pinned frozen-row payloads (counted "
                       "against the host budget, never LRU-evicted)"
                  ).set(self._row_bytes)

    def _count_drop_locked(self) -> None:
        self.drops += 1
        self.registry.counter(
            "serving_kv_host_drops_total",
            help="spilled payloads dropped from host memory under the "
                 "host budget").inc()

    def _make_room_locked(self, nbytes: int) -> bool:
        """Drop prefix payloads, least recently used first, until
        ``nbytes`` more fit the budget; False if they still do not (the
        pinned rows hold the rest)."""
        if self.budget_bytes is None:
            return True
        while (self._entries and self._bytes + self._row_bytes + nbytes
               > self.budget_bytes):
            _, ev = self._entries.popitem(last=False)
            self._bytes -= ev["nbytes"]
            self._count_drop_locked()
        return self._bytes + self._row_bytes + nbytes <= self.budget_bytes

    # -- keys ---------------------------------------------------------

    @staticmethod
    def key_for(tokens, length: int) -> str:
        """Content key of a stored prefix: sha1 of its tokens as int32
        bytes, and its length."""
        tok = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return hashlib.sha1(tok[:length].tobytes()).hexdigest() \
            + f"-{length}"

    # -- spill / fetch / drop -----------------------------------------

    def spill(self, tokens, length: int, pages):
        """Spill a stored prefix's pages to the host; returns ``(key,
        nbytes, seconds)``, or None when the payload does not fit the
        budget. The caller (the prefix index) still owns the pages and
        unrefs them only on success. With a ``spill_dir`` the payload is
        also written there."""
        t0 = time.perf_counter()
        payload, nbytes = gather_pages_to_host(self.pool.pages, pages)
        if self.budget_bytes is not None and nbytes > self.budget_bytes:
            return None
        key = self.key_for(tokens, length)
        tok = np.ascontiguousarray(np.asarray(tokens, np.int32))[:length] \
            .copy()
        if self.spill_dir:
            self._save_dir(key, tok, length, payload)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old["nbytes"]
            if not self._make_room_locked(nbytes):
                self._mirror_locked()
                return None
            self._entries[key] = {"payload": payload, "tokens": tok,
                                  "length": length, "nbytes": nbytes}
            self._bytes += nbytes
            self.spills += 1
            self.registry.counter(
                "serving_kv_spills_total",
                help="stored prefixes spilled to the host tier").inc()
            self._mirror_locked()
        dt = time.perf_counter() - t0
        if self.event_sink is not None:
            self.event_sink("spill", key=key, length=length,
                            bytes=nbytes, spill_s=round(dt, 6))
        return key, nbytes, dt

    def fetch(self, key: str):
        """``(payload, nbytes)`` of ``key`` from host memory, else from
        the spill dir; None when neither holds it."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                return ent["payload"], ent["nbytes"]
        if self.spill_dir:
            return self._load_dir(key)
        return None

    def drop(self, key: str) -> None:
        """Forget ``key``'s in-memory payload (its spill-dir file stays)."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                return
            self._bytes -= ent["nbytes"]
            self._count_drop_locked()
            self._mirror_locked()

    def _observe_restore(self, seconds: float) -> None:
        self.registry.histogram(
            "serving_kv_restore_seconds",
            help="host-to-device restore latency per restored prefix"
        ).observe(seconds)

    def record_restore(self, nbytes: int, seconds: float) -> None:
        """Account one completed prefix restore (the engine times it)."""
        with self._lock:
            self.restores += 1
        self.registry.counter(
            "serving_kv_restores_total",
            help="spilled prefixes restored into device pages").inc()
        self._observe_restore(seconds)

    # -- pinned rows (preemption, serving/sched.py) -------------------

    def spill_row(self, key: str, tokens, pages):
        """Spill a live row's pages and tokens as a pinned entry under the
        engine's freeze key (request id and freeze count). Drops prefix
        payloads for room; returns None when the pinned rows and the new
        one still exceed the budget, else ``(nbytes, seconds)``."""
        t0 = time.perf_counter()
        payload, nbytes = gather_pages_to_host(self.pool.pages, pages)
        tok = np.ascontiguousarray(np.asarray(tokens, np.int32)).copy()
        nbytes += tok.nbytes
        with self._lock:
            if key in self._rows:
                raise RuntimeError(
                    f"frozen-row key {key!r} already resident (freeze "
                    "accounting bug: one freeze, one spill)")
            if not self._make_room_locked(nbytes):
                self._mirror_locked()
                return None
            self._rows[key] = {"payload": payload, "tokens": tok,
                               "nbytes": nbytes}
            self._row_bytes += nbytes
            self.row_spills += 1
            self.registry.counter(
                "serving_kv_row_spills_total",
                help="live decoding rows frozen and spilled to the host "
                     "tier (preemption)").inc()
            self._mirror_locked()
        dt = time.perf_counter() - t0
        if self.event_sink is not None:
            self.event_sink("row_spill", key=key, bytes=nbytes,
                            spill_s=round(dt, 6))
        return nbytes, dt

    def fetch_row(self, key: str):
        """``(payload, tokens, nbytes)`` of a pinned row, or None. The
        entry stays until :meth:`drop_row`."""
        with self._lock:
            ent = self._rows.get(key)
            if ent is None:
                return None
            return ent["payload"], ent["tokens"], ent["nbytes"]

    def drop_row(self, key: str) -> None:
        """Release a pinned row: after its thaw, or when its request is
        dropped for deadline while frozen."""
        with self._lock:
            ent = self._rows.pop(key, None)
            if ent is None:
                return
            self._row_bytes -= ent["nbytes"]
            self._mirror_locked()

    def record_row_restore(self, nbytes: int, seconds: float) -> None:
        """Account one completed thaw."""
        with self._lock:
            self.row_restores += 1
        self.registry.counter(
            "serving_kv_row_restores_total",
            help="frozen rows restored into device pages (preemption "
                 "resume)").inc()
        self._observe_restore(seconds)

    # -- adoption (spill_dir) -----------------------------------------

    def probe(self, prompt) -> Tuple[Optional[str], int]:
        """The longest spilled prefix of ``prompt`` this tier holds (in
        memory or in the dir), at page granularity and at most
        floor16(len - 1) long: ``(key, hit_len)`` or ``(None, 0)``."""
        tok = np.ascontiguousarray(np.asarray(prompt, np.int32))
        limit = ((int(tok.shape[0]) - 1) // PAGE) * PAGE
        for length in range(limit, 0, -PAGE):
            key = self.key_for(tok, length)
            with self._lock:
                if key in self._entries:
                    return key, length
            if self.spill_dir and os.path.exists(self._path(key)):
                return key, length
        return None, 0

    # -- spill_dir files ----------------------------------------------

    def _path(self, key: str) -> str:
        return os.path.join(self.spill_dir, f"{key}.npz")

    def _save_dir(self, key: str, tokens: np.ndarray, length: int,
                  payload: list) -> None:
        data = {"tokens": tokens, "length": np.int64(length)}
        for li, layer in enumerate(payload):
            for name, t in layer.items():
                if t.dtype not in _SAVEZ_NATIVE:
                    t = t.to(torch.float32)
                data[f"l{li}_{name}"] = t.numpy()
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **data)
        os.replace(tmp, self._path(key))  # atomic for concurrent readers

    def _load_dir(self, key: str):
        """A dir payload as the file holds it (a bfloat16 pool's in
        float32: the restore casts back)."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        payload, nbytes = [], 0
        layers = self.pool.pages[0] if isinstance(self.pool.pages, Sharded) \
            else self.pool.pages
        with np.load(path) as data:
            for li, pool_layer in enumerate(layers):
                nl = {}
                for name in kv_layer_keys(pool_layer):
                    arr = data[f"l{li}_{name}"]
                    nl[name] = torch.from_numpy(arr)
                    nbytes += arr.nbytes
                payload.append(nl)
        return payload, nbytes

    # -- observability ------------------------------------------------

    def summary(self) -> dict:
        """The host-tier ledger block, consistent at one instant."""
        with self._lock:
            return {
                "host_entries": len(self._entries),
                "host_bytes": self._bytes,
                "host_rows": len(self._rows),
                "host_row_bytes": self._row_bytes,
                "host_budget_bytes": self.budget_bytes,
                "spills": self.spills,
                "restores": self.restores,
                "row_spills": self.row_spills,
                "row_restores": self.row_restores,
                "host_drops": self.drops,
                "spill_dir": self.spill_dir,
            }
