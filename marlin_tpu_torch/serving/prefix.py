"""Shared-prefix KV reuse: a host-side radix trie over 16-token chunks,
over either a bounded device pool of donor KV rows (:class:`PrefixCache`,
the contiguous engine's copy-based surface) or the paged engine's page
pool (:class:`PagedPrefixIndex`, zero copy) — port of
``marlin_tpu/serving/prefix.py``.

* The trie is keyed on GRAIN = 16-token chunks, so a hit length is always
  a multiple of 16 and aligned with the engine's chunked admission.
* :class:`PrefixCache` keeps stored prefixes in ``pool_rows`` rows of a
  second KV cache on the device, evicted least recently used, with
  per-row refcounts so a donor row cannot be evicted while a copy out of
  it is in flight. :func:`copy_kv_rows` moves a row prefix in place.
* :class:`PagedPrefixIndex` stores a prefix by pinning the admitted row's
  own pages and answers a hit with a page list to alias: no device work
  either way. With a host tier (serving/pages.HostKVTier) an evicted
  entry the index alone holds spills to the host and stays in the trie,
  to be restored by a later hit instead of re-prefilled.

Bit-exactness: the chunked admission path computes positions in tiles of
one fixed shape (``models/transformer._tiles``), so a stored prefix holds
exactly the bits a cold admission would compute for the same tokens, and a
copied (or aliased) prefix plus a tail is bitwise a cold chunked admission:
hits change the schedule, never the output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import transformer as tr
from ..models.quant import kv_layer_keys
from ..obs import metrics as obs_metrics
from ..utils.hw import resolve_device

GRAIN = 16  # trie chunk and hit-length granularity: the admission bucket


@torch.no_grad()
def copy_kv_rows(dst, src, dst_row: int, src_row: int, length: int):
    """Copy KV slots [0, length) of row ``src_row`` of cache ``src`` into
    row ``dst_row`` of cache ``dst``, in place (the JAX package donated
    ``dst``); returns ``dst``. An int8 cache's scale buffers move with
    their slots (``models/quant.kv_layer_keys``)."""
    for dl, sl in zip(dst, src):
        for name in kv_layer_keys(dl):
            buf = dl[name]
            buf[dst_row, :length] = sl[name][src_row, :length].to(buf.dtype)
    return dst


def _floor_grain(n: int) -> int:
    return (n // GRAIN) * GRAIN


class _TrieNode:
    """One radix-trie node: children keyed by the next 16-token chunk's
    bytes; ``rows`` = the members whose stored prefix passes through this
    node (pool rows for :class:`PrefixCache`, entry ids for
    :class:`PagedPrefixIndex`)."""

    __slots__ = ("children", "rows")

    def __init__(self):
        self.children: Dict[bytes, "_TrieNode"] = {}
        self.rows: set = set()


# The one copy of the trie machinery, shared by both prefix surfaces.

def _trie_chunks(tokens: np.ndarray, length: int):
    for d in range(length // GRAIN):
        yield tokens[d * GRAIN:(d + 1) * GRAIN].tobytes()


def _trie_descend(root: _TrieNode, prompt: np.ndarray, limit: int,
                  member_ok=None):
    """Walk ``root`` along ``prompt``'s 16-chunks up to ``limit`` tokens;
    returns ``(node, depth)`` of the deepest node holding members
    (``(None, 0)`` on a miss): the one walk lookup and store dedup share.
    ``member_ok`` filters the members that count (the paged index counts
    its resident entries)."""
    node = root
    best, best_depth = None, 0
    for d in range(limit // GRAIN):
        node = node.children.get(prompt[d * GRAIN:(d + 1) * GRAIN]
                                 .tobytes())
        if node is None:
            break
        live = node.rows if member_ok is None else \
            any(member_ok(m) for m in node.rows)
        if live:
            best, best_depth = node, (d + 1) * GRAIN
    return best, best_depth


def _trie_insert(root: _TrieNode, tokens: np.ndarray, length: int,
                 member) -> None:
    node = root
    for key in _trie_chunks(tokens, length):
        node = node.children.setdefault(key, _TrieNode())
        node.rows.add(member)


def _trie_remove(root: _TrieNode, tokens: np.ndarray, length: int,
                 member) -> None:
    """Remove ``member`` from its path, pruning emptied branches so the
    trie stays O(stored tokens)."""
    node = root
    path = []
    for key in _trie_chunks(tokens, length):
        path.append((node, key))
        node = node.children[key]
        node.rows.discard(member)
    for parent, key in reversed(path):
        child = parent.children[key]
        if not child.rows and not child.children:
            del parent.children[key]


def _as_tokens(prompt) -> np.ndarray:
    # One dtype for the trie keys, whatever the caller passed.
    return np.ascontiguousarray(np.asarray(prompt, np.int64))


class PrefixCache:
    """Host prefix trie plus a bounded device KV pool, LRU-evicted, with
    refcounts.

    Build it with the engine's :class:`TransformerConfig` (pool rows must
    match the engine's cache rows) on the engine's ``device`` (default
    ``"cuda"``), and attach it with ``ServingEngine(...,
    prefix_cache=...)``. Device memory is exactly ``pool_rows`` cache
    rows. The counters (``hits``, ``misses``, ``stores``,
    ``store_skips``, ``evictions``, ``reclaimed_tokens``) feed the
    engine's ledger; stores, evictions and pool occupancy also go to the
    metrics registry: an explicit ``registry``, else the first attaching
    engine's."""

    def __init__(self, cfg, pool_rows: int = 8, registry=None,
                 device="cuda"):
        if pool_rows < 1:
            raise ValueError(f"pool_rows must be >= 1, got {pool_rows}")
        self.cfg = cfg
        self.pool_rows = pool_rows
        self.device = resolve_device(device)
        self.pool = tr.init_kv_cache(cfg, pool_rows, dtype=cfg.compute_dtype,
                                     device=self.device)
        self._registry = registry
        self._free: List[int] = list(range(pool_rows))[::-1]
        self._root = _TrieNode()
        self._len: Dict[int, int] = {}        # row -> stored prefix length
        self._tokens: Dict[int, np.ndarray] = {}  # row -> stored tokens
        self._refs: Dict[int, int] = {}       # row -> in-flight copies
        self._used: Dict[int, int] = {}       # row -> LRU clock stamp
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.store_skips = 0
        self.evictions = 0
        self.reclaimed_tokens = 0

    # -- bookkeeping --------------------------------------------------

    @property
    def registry(self):
        return self._registry if self._registry is not None \
            else obs_metrics.registry

    @property
    def rows_used(self) -> int:
        return self.pool_rows - len(self._free)

    def stored_len(self, row: int) -> int:
        return self._len.get(row, 0)

    def refcount(self, row: int) -> int:
        return self._refs.get(row, 0)

    def _touch(self, row: int) -> None:
        self._clock += 1
        self._used[row] = self._clock

    # -- refcounts ----------------------------------------------------

    def acquire(self, row: int) -> None:
        """Pin ``row`` against eviction while a copy out of it is in
        flight; pair with :meth:`release`."""
        if row not in self._len:
            raise KeyError(f"pool row {row} holds no prefix")
        self._refs[row] = self._refs.get(row, 0) + 1

    def release(self, row: int) -> None:
        n = self._refs.get(row, 0)
        if n <= 0:
            raise RuntimeError(f"release of unacquired pool row {row}")
        self._refs[row] = n - 1

    # -- lookup / load ------------------------------------------------

    def lookup(self, prompt) -> Tuple[Optional[int], int]:
        """Longest stored prefix of ``prompt`` at 16-token granularity:
        ``(pool_row, hit_len)`` or ``(None, 0)``. The hit is capped at
        floor16(prompt_len - 1): the admission still computes the last
        prompt position, whose logits give the first token. Counts the
        hit or miss and touches the donor's LRU stamp."""
        prompt = _as_tokens(prompt)
        node, hit = _trie_descend(self._root, prompt,
                                  _floor_grain(int(prompt.shape[0]) - 1))
        row = None
        if hit:
            row = max(node.rows, key=lambda r: self._used.get(r, 0))
            self.hits += 1
            self.reclaimed_tokens += hit
            self._touch(row)
        else:
            self.misses += 1
        return row, hit

    def load_into(self, cache, dst_row: int, row: int, length: int):
        """Copy stored slots [0, length) of pool row ``row`` into row
        ``dst_row`` of the engine ``cache``, in place; returns the cache.
        The donor is pinned around the copy."""
        if length % GRAIN or length < GRAIN:
            raise ValueError(f"length must be a positive multiple of "
                             f"{GRAIN}, got {length}")
        if self._len.get(row, 0) < length:
            raise ValueError(
                f"pool row {row} holds {self._len.get(row, 0)} slots, "
                f"asked for {length} (evicted under the caller?)")
        self.acquire(row)
        try:
            copy_kv_rows(cache, self.pool, dst_row, row, length)
        finally:
            self.release(row)
        return cache

    # -- store / evict ------------------------------------------------

    def _evictable(self) -> Optional[int]:
        """LRU row with no in-flight copies, or None."""
        rows = [r for r in self._len if self._refs.get(r, 0) == 0]
        if not rows:
            return None
        return min(rows, key=lambda r: self._used.get(r, 0))

    def _evict(self, row: int) -> None:
        _trie_remove(self._root, self._tokens[row], self._len[row], row)
        del self._tokens[row], self._len[row]
        self._used.pop(row, None)
        self._refs.pop(row, None)
        self._free.append(row)
        self.evictions += 1
        self.registry.counter("serving_prefix_evictions_total").inc()

    def store_from(self, cache, src_row: int, prompt) -> int:
        """Store ``prompt``'s longest 16-aligned prefix from row
        ``src_row`` of the engine ``cache`` into the pool; returns the
        stored length (0 when skipped).

        The engine calls it right after an admission's final chunk, when
        the row holds the chunk path's K/V for the whole prompt. Skips a
        prefix already covered at least as deep, and a store with every
        pool row pinned; evicts the LRU row when the pool is full."""
        prompt = _as_tokens(prompt)
        length = _floor_grain(int(prompt.shape[0]))
        if length == 0:
            return 0
        _, covered = _trie_descend(self._root, prompt, length)
        if covered >= length:
            self.store_skips += 1
            return 0
        if self._free:
            row = self._free.pop()
        else:
            row = self._evictable()
            if row is None:  # every row pinned by in-flight copies
                self.store_skips += 1
                return 0
            self._evict(row)
            row = self._free.pop()
        copy_kv_rows(self.pool, cache, row, src_row, length)
        tokens = prompt[:length].copy()
        _trie_insert(self._root, tokens, length, row)
        self._len[row] = length
        self._tokens[row] = tokens
        self._touch(row)
        self.stores += 1
        self.registry.counter("serving_prefix_stores_total").inc()
        self.registry.gauge("serving_prefix_pool_rows_used").set(
            self.rows_used)
        return length

    # -- observability ------------------------------------------------

    def summary(self) -> dict:
        """Hit traffic, pool state and reclaim."""
        total = self.hits + self.misses
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_rate": round(self.hits / total, 4) if total else 0.0,
            "prefix_reclaimed_prefill_tokens": self.reclaimed_tokens,
            "prefix_stores": self.stores,
            "prefix_store_skips": self.store_skips,
            "prefix_evictions": self.evictions,
            "prefix_pool_rows_used": self.rows_used,
            "prefix_pool_rows": self.pool_rows,
        }


class _PrefixEntry:
    """One stored prefix of the paged index: its tokens, 16-aligned
    length, and the pool pages holding its K/V (one index reference
    each; per-page refcounts in ``PagePool`` arbitrate lifetime).

    ``state`` is ``"resident"`` (pages on the device) or ``"spilled"``
    (``pages == ()``, the payload in the host tier under ``host_key``); a
    restore makes it resident again (:meth:`PagedPrefixIndex.rebind`)."""

    __slots__ = ("entry_id", "tokens", "length", "pages", "state",
                 "host_key")

    def __init__(self, entry_id: int, tokens: np.ndarray, length: int,
                 pages: Tuple[int, ...], state: str = "resident",
                 host_key: Optional[str] = None):
        self.entry_id = entry_id
        self.tokens = tokens
        self.length = length
        self.pages = pages
        self.state = state
        self.host_key = host_key


class PagedPrefixIndex:
    """The radix trie mapped to page lists: the paged engine's prefix
    surface (serving/pages.py).

    The trie, GRAIN and LRU of :class:`PrefixCache`, with no device side:
    a store pins the admitted row's own prefix pages (one reference each),
    a hit hands the admission a page list to alias into its table, so
    ``admission_copy_bytes == 0`` by construction. Eviction drops the
    index's references; pages that live rows still alias stay allocated
    until those rows retire. Hit, miss and reclaim counters move in
    :meth:`record`, once the engine has placed the admission (a lookup
    whose reservation fails is retried later and must not count twice).

    ``host_tier`` (a :class:`~.pages.HostKVTier`): an evicted entry whose
    pages only the index holds spills there and stays in the trie as
    ``"spilled"``; :meth:`lookup_candidates` offers it to the engine,
    which restores it into fresh pages and :meth:`rebind` s it."""

    def __init__(self, pool, registry=None, host_tier=None):
        self.pool = pool
        self._registry = registry
        self.host_tier = host_tier
        self._root = _TrieNode()   # rows-sets hold entry ids here
        self._entries: Dict[int, _PrefixEntry] = {}
        self._used: Dict[int, int] = {}   # entry id -> LRU clock stamp
        self._clock = 0
        self._next_id = 0
        self.stored_tokens = 0
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.store_skips = 0
        self.evictions = 0
        self.reclaimed_tokens = 0
        self.spills = 0
        self.restores = 0
        self.adoptions = 0
        self._n_spilled = 0

    @property
    def registry(self):
        return self._registry if self._registry is not None \
            else obs_metrics.registry

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    def _touch(self, entry_id: int) -> None:
        self._clock += 1
        self._used[entry_id] = self._clock

    def _is_resident(self, eid: int) -> bool:
        return self._entries[eid].state == "resident"

    # -- lookup / account ---------------------------------------------

    def lookup(self, prompt):
        """Longest RESIDENT stored prefix of ``prompt`` at GRAIN
        granularity: ``(page_list, hit_len)`` or ``(None, 0)``, capped at
        floor16(prompt_len - 1) as :meth:`PrefixCache.lookup` is. Touches
        the entry's LRU stamp; counts nothing (:meth:`record` does)."""
        prompt = _as_tokens(prompt)
        node, hit = _trie_descend(self._root, prompt,
                                  _floor_grain(int(prompt.shape[0]) - 1),
                                  member_ok=self._is_resident)
        if not hit:
            return None, 0
        eid = max((e for e in node.rows if self._is_resident(e)),
                  key=lambda e: self._used.get(e, 0))
        self._touch(eid)
        return self._entries[eid].pages[:hit // GRAIN], hit

    def lookup_candidates(self, prompt):
        """Both hit arms of one prompt: ``(res_pages, res_hit,
        spilled_eid, spilled_hit)``. The resident arm is :meth:`lookup`;
        the spilled arm is the longest spilled entry whose whole length
        lies within the prompt's hit limit (a restore rebinds a whole
        entry). Touches only the resident arm."""
        res_pages, res_hit = self.lookup(prompt)
        prompt = _as_tokens(prompt)
        limit = _floor_grain(int(prompt.shape[0]) - 1)
        eid, sp_hit = None, 0
        for e, entry in self._entries.items():
            if (entry.state == "spilled" and sp_hit < entry.length
                    and entry.length <= limit
                    and np.array_equal(prompt[:entry.length],
                                       entry.tokens)):
                eid, sp_hit = e, entry.length
        return res_pages, res_hit, eid, sp_hit

    def record(self, hit_len: int) -> None:
        """Account one placed admission's lookup outcome."""
        if hit_len:
            self.hits += 1
            self.reclaimed_tokens += hit_len
        else:
            self.misses += 1

    # -- store / evict ------------------------------------------------

    def store(self, prompt, pages) -> int:
        """Pin ``prompt``'s 16-aligned prefix into the index by
        referencing the admitted row's own pages (``pages`` covers chunks
        [0, floor16(prompt_len) / GRAIN) of its table). No device work;
        returns the stored length (0 when a resident entry already covers
        it). Spilled entries the new one covers are forgotten."""
        prompt = _as_tokens(prompt)
        length = _floor_grain(int(prompt.shape[0]))
        if length == 0:
            return 0
        _, covered = _trie_descend(self._root, prompt, length,
                                   member_ok=self._is_resident)
        if covered >= length:
            self.store_skips += 1
            return 0
        page_list = tuple(int(p) for p in pages)[:length // GRAIN]
        if len(page_list) != length // GRAIN:
            raise ValueError(
                f"store of {length} tokens needs {length // GRAIN} "
                f"pages, got {len(page_list)}")
        self.pool.ref(page_list)  # one index reference per page
        eid = self._next_id
        self._next_id += 1
        tokens = prompt[:length].copy()
        _trie_insert(self._root, tokens, length, eid)
        self._entries[eid] = _PrefixEntry(eid, tokens, length, page_list)
        self.stored_tokens += length
        self._touch(eid)
        self.stores += 1
        self.registry.counter("serving_prefix_stores_total").inc()
        self._mirror_entries()
        stale = [e for e, ent in self._entries.items()
                 if ent.state == "spilled" and ent.length <= length
                 and np.array_equal(tokens[:ent.length], ent.tokens)]
        for e in stale:
            self._remove(e)
        return length

    def _mirror_entries(self) -> None:
        self.registry.gauge("serving_prefix_entries").set(
            len(self._entries))
        self.registry.gauge(
            "serving_prefix_spilled_entries",
            help="stored prefixes parked in the host tier").set(
            self._n_spilled)

    def _remove(self, eid: int) -> None:
        """Forget ``eid``: its trie path, entry and LRU stamp, and what it
        holds (page references, or its host payload if spilled)."""
        entry = self._entries.pop(eid)
        _trie_remove(self._root, entry.tokens, entry.length, eid)
        self._used.pop(eid, None)
        self.stored_tokens -= entry.length
        if entry.state == "spilled":
            self._n_spilled -= 1
            if self.host_tier is not None:
                self.host_tier.drop(entry.host_key)
        else:
            self.pool.unref(entry.pages)
        self._mirror_entries()

    def _evict(self, eid: int) -> None:
        """LRU eviction under device pressure. With a host tier, a
        resident entry whose pages only the index holds (each at refcount
        1) spills: its pages free and it stays in the trie, spilled. Any
        other entry is forgotten."""
        entry = self._entries[eid]
        tier = self.host_tier
        if (tier is not None and entry.state == "resident"
                and all(self.pool.refcount(p) == 1 for p in entry.pages)):
            spilled = tier.spill(entry.tokens, entry.length, entry.pages)
            if spilled is not None:
                self.pool.unref(entry.pages)
                entry.pages = ()
                entry.state = "spilled"
                entry.host_key = spilled[0]
                self.spills += 1
                self._n_spilled += 1
                self._count_eviction()
                self._mirror_entries()
                return
        self._remove(eid)
        self._count_eviction()

    def _count_eviction(self) -> None:
        self.evictions += 1
        self.registry.counter("serving_prefix_evictions_total").inc()

    def evict_lru(self) -> bool:
        """Evict the least recently used entry; False when empty."""
        if not self._entries:
            return False
        self._evict(min(self._entries, key=lambda e: self._used.get(e, 0)))
        return True

    def evict_until_free(self, n_pages: int) -> None:
        """Evict LRU resident entries until the pool has ``n_pages`` free
        pages or none is left (evicting an entry that live rows still
        alias frees nothing at once; spilled entries hold no pages)."""
        while self.pool.n_free < n_pages:
            resident = [e for e, ent in self._entries.items()
                        if ent.state == "resident"]
            if not resident:
                break
            self._evict(min(resident, key=lambda e: self._used.get(e, 0)))

    # -- the host tier's transitions ----------------------------------

    def rebind(self, eid: int, pages) -> None:
        """Finish a restore: the engine scattered the spilled payload into
        fresh ``pages`` (the row's); pin them for the index (one
        reference each, as a store does) and mark the entry resident."""
        entry = self._entries[eid]
        if entry.state != "spilled":
            raise RuntimeError(
                f"rebind of entry {eid} in state {entry.state!r}")
        page_list = tuple(int(p) for p in pages)
        if len(page_list) != entry.length // GRAIN:
            raise ValueError(
                f"rebind of {entry.length} tokens needs "
                f"{entry.length // GRAIN} pages, got {len(page_list)}")
        self.pool.ref(page_list)
        entry.pages = page_list
        entry.state = "resident"
        self.restores += 1
        self._n_spilled -= 1
        self._touch(eid)
        self._mirror_entries()

    def host_key_of(self, eid: int) -> Optional[str]:
        """The host tier's key of a spilled entry's payload."""
        return self._entries[eid].host_key

    def forget(self, eid: int) -> None:
        """Drop a spilled entry whose payload is gone (the host budget
        dropped it): the hit was not real."""
        if eid in self._entries:
            self._remove(eid)

    def adopt(self, tokens, length: int, host_key: str):
        """Register a spilled entry for a payload this index did not
        compute (another engine's, in a shared spill dir); returns its
        id, or None when an entry already covers the prefix as deep."""
        tokens = _as_tokens(tokens)[:length].copy()
        _, covered = _trie_descend(self._root, tokens, length)
        if covered >= length:
            return None
        eid = self._next_id
        self._next_id += 1
        _trie_insert(self._root, tokens, length, eid)
        self._entries[eid] = _PrefixEntry(
            eid, tokens, length, (), state="spilled", host_key=host_key)
        self.stored_tokens += length
        self._touch(eid)
        self.adoptions += 1
        self._n_spilled += 1
        self._mirror_entries()
        return eid

    # -- observability ------------------------------------------------

    def summary(self) -> dict:
        """Scalar-only ledger block."""
        total = self.hits + self.misses
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_rate": round(self.hits / total, 4) if total else 0.0,
            "prefix_reclaimed_prefill_tokens": self.reclaimed_tokens,
            "prefix_stores": self.stores,
            "prefix_store_skips": self.store_skips,
            "prefix_evictions": self.evictions,
            "prefix_entries": len(self._entries),
            "prefix_stored_tokens": self.stored_tokens,
            "prefix_spilled_entries": self._n_spilled,
            "prefix_spills": self.spills,
            "prefix_restores": self.restores,
            "prefix_adoptions": self.adoptions,
        }
