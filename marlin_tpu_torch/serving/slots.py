"""Slot management and the admission prefills — port of
``marlin_tpu/serving/slots.py``.

A slot is one row of the live batch: one row of every KV-cache layer (or a
page table, in paged mode), one row of the token buffer, one entry of the
engine's fill/target state. :func:`prefill_into_row` admits a request into
a free row in one shot: it prefills the prompt through the flash kernel and
writes the row's K/V and tokens IN PLACE (the JAX package donated the
cache and buffer for the same effect). :func:`prefill_chunk_into_row` and
:func:`prefill_chunk_into_row_paged` admit one chunk at a time through the
model's chunk path (plain cached attention, no flash kernel), the
discipline the prefix cache and paged sharing are bitwise exact on.
:func:`restore_pages_into_pool` and :func:`restore_row_tokens` put back
what the host KV tier kept: a spilled prefix, or a preempted row. On an
int8 cache (``cfg.kv_quant``) every admission quantizes the prompt's K/V
per vector as it writes them (after the flash kernel, in the one-shot
path), and the scale buffers move with their slots
(``models/quant.kv_layer_keys``).

The prompt is padded to the 16-token bucket (:func:`pad_prompt_len`).
Causality keeps the real rows independent of the pad: a real query never
attends a pad key (their weight is exactly 0), and the pad slots of the
cache are dead state that decode overwrites before any live read (decode
at position p writes slot p before attending it and masks slots > p).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models import transformer as tr
from ..models.quant import kv_layer_keys
from ..models.tp import Sharded
from ..utils.split import pad_to_multiple

ADMISSION_BUCKET = 16


def pad_prompt_len(prompt_len: int) -> int:
    """The padded admission length of a prompt: its 16-token bucket."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    return -(-prompt_len // ADMISSION_BUCKET) * ADMISSION_BUCKET


def _write_row_tokens(buf, row: int, prompt, prompt_len: int, first):
    """The admission token-buffer contract, in place: row ``row`` of
    ``buf`` becomes the real prompt in [0, prompt_len), zeros past it
    (wiping the previous occupant), and the first generated token at
    ``prompt_len`` — the layout retirement reads."""
    buf[row] = 0
    buf[row, :prompt_len] = prompt[:prompt_len]
    buf[row, prompt_len] = first


@torch.no_grad()
def prefill_into_row(params, cache, buf, row: int, prompt, cfg,
                     temperature: float = 0.0,
                     generator: Optional[torch.Generator] = None):
    """Prefill one request and swap it into batch row ``row``, in place.

    ``cache`` and ``buf`` (the engine's live state) are updated in place;
    ``row`` must be free. ``prompt`` is the (prompt_len,) token tensor on
    the engine's device. Returns ``(filled_row, first)``: the row's fill
    count (prompt_len + 1, the first token already in the buffer) and
    that token (a 0-d tensor)."""
    params = tr._cast_params(params, cfg)  # no-op once the engine cast
    padded = pad_to_multiple(prompt, 0, ADMISSION_BUCKET)
    x = _prefill_blocks(params, cache, row, padded, cfg)
    return _admit_first(params, x, buf, row, prompt, temperature, generator)


def _prefill_blocks(params, cache, row: int, padded, cfg):
    """The one-shot admission's model half: the padded prompt (P,) through
    every block (the flash prefill), each layer's K/V written into row
    ``row`` of ``cache`` in place. Returns the hidden states (1, P, D).
    Under tensor parallelism this is the part each shard runs
    (serving/tp.py)."""
    p = padded.shape[0]
    x = tr._embed_prefix(params, padded[None], cfg)  # (1, P, D)

    def put(buf, val):
        buf[row, :p] = val[0].to(buf.dtype)

    for layer, bp in zip(cache, params["blocks"]):
        x, k, v = tr._block(bp, x, cfg, return_kv=True)
        tr._put_kv(layer, k, v, put, bool(cfg.kv_quant))
    return x


def _admit_first(params, x, buf, row: int, prompt, temperature: float,
                 generator):
    """The one-shot admission's epilogue, run once: the first token from
    the logits at the last REAL position (causality makes that hidden
    state independent of the pad), then the row's token buffer. Returns
    ``(filled_row, first)``."""
    prompt_len = int(prompt.shape[0])
    h = tr._layer_norm(params["ln_f"], x[0, prompt_len - 1:prompt_len])
    first = tr._sample(tr._readout(params, h), temperature, generator)[0]
    _write_row_tokens(buf, row, prompt, prompt_len, first)
    return prompt_len + 1, first


def _row_cache(cache, row: int):
    """Row ``row`` of every layer of a contiguous cache, as (1, T, Hk, Dh)
    views (writes land in the cache)."""
    return [{name: layer[name][row:row + 1] for name in kv_layer_keys(layer)}
            for layer in cache]


def _chunk_first(logits, buf, row: int, prompt, prompt_len: int,
                 temperature: float, generator, final: bool):
    """A chunked admission's epilogue, run once: on the final chunk the
    first token from ``logits`` and the row's token buffer; None before
    it."""
    if not final:
        return None
    first = tr._sample(logits, temperature, generator)[0]
    _write_row_tokens(buf, row, prompt, prompt_len, first)
    return first


@torch.no_grad()
def prefill_chunk_into_row(params, cache, buf, row: int, chunk, start: int,
                           chunk_len: int, prompt, prompt_len: int, cfg,
                           temperature: float = 0.0,
                           generator: Optional[torch.Generator] = None,
                           final: bool = False):
    """One admission-prefill CHUNK into batch row ``row``, in place: K/V of
    prompt positions [start, start + chunk_len) through
    :func:`..models.transformer.prefill_chunk`, against the row's own
    cache, which must already hold [0, start) (earlier chunks, or a
    prefix-cache copy). ``chunk`` may be padded past ``chunk_len`` (the
    pad's K/V land in dead slots).

    ``final=False``: K/V only; returns None. ``final=True`` (the chunk
    reaching ``prompt_len``): also samples the first token from the logits
    at ``prompt_len - 1`` and rewrites the row's whole token buffer (the
    prompt, zeros past it, the first token at ``prompt_len``), as
    :func:`prefill_into_row` does; returns that token (a 0-d tensor).

    Any chunk split of a prompt, and any prefix copy plus tail, writes the
    same cache bits and samples from the same logits (transformer._tiles).
    """
    logits, _ = tr.prefill_chunk(params, _row_cache(cache, row), chunk[None],
                                 start, cfg, last=chunk_len - 1)
    return _chunk_first(logits, buf, row, prompt, prompt_len, temperature,
                        generator, final)


@torch.no_grad()
def prefill_chunk_into_row_paged(params, pool, buf, row: int, table, chunk,
                                 start: int, chunk_len: int, prompt,
                                 prompt_len: int, cfg,
                                 temperature: float = 0.0,
                                 generator: Optional[torch.Generator] = None,
                                 final: bool = False):
    """:func:`prefill_chunk_into_row` through the row's page ``table``
    ((max_len // PAGE,) page ids) into the shared page pool (the per-layer
    page buffers, written in place); ``row`` addresses only the token
    buffer. The pages of [0, start) must already hold their K/V (earlier
    chunks, or aliased prefix pages). Same ``final`` contract and return
    value."""
    logits, _ = tr.prefill_chunk_paged(params, pool, table[None],
                                       chunk[None], start, cfg,
                                       last=chunk_len - 1)
    return _chunk_first(logits, buf, row, prompt, prompt_len, temperature,
                        generator, final)


@torch.no_grad()
def restore_pages_into_pool(pool, payload, pages):
    """Scatter a host payload (``HostKVTier``'s gather: a list a layer of
    ``{name: (n, PAGE, Hk, Dh)}`` CPU tensors) into ``pages`` of the
    device ``pool``, in place; returns the pool. No arithmetic: the bytes
    land as they were gathered, cast only back to the pool's dtype where
    a file held them wider (a bfloat16 pool's payload read from the spill
    dir). Int8 scales move with their pages. From pinned memory the copy
    is asynchronous: the caller syncs before reading a clock or dropping
    the payload. A tensor-parallel pool (:class:`..models.tp.Sharded`,
    one page tree a shard) takes the payload in the global head layout
    (axis 2) and scatters each shard its heads."""
    if isinstance(pool, Sharded):
        tp = len(pool)
        for r, shard in enumerate(pool):
            restore_pages_into_pool(shard, [
                {name: t.narrow(2, r * (t.shape[2] // tp), t.shape[2] // tp)
                 for name, t in part.items()} for part in payload], pages)
        return pool
    dev = pool[0]["k"].device
    idx = torch.as_tensor([int(p) for p in pages], dtype=torch.long,
                          device=dev)
    for layer, part in zip(pool, payload):
        for name in kv_layer_keys(layer):
            buf = layer[name]
            buf.index_copy_(0, idx, part[name].to(dev, non_blocking=True)
                            .to(buf.dtype))
    return pool


@torch.no_grad()
def restore_row_tokens(buf, row: int, tokens):
    """Write a thawed request's saved tokens (its row's [0, filled)) back
    into row ``row`` of the token buffer, zeros past them, in place;
    returns the buffer."""
    tokens = torch.as_tensor(tokens)
    buf[row] = 0
    buf[row, :tokens.shape[0]] = tokens.to(buf.device, buf.dtype)
    return buf


class SlotManager:
    """Host-side request -> batch-row bookkeeping: which rows are free and
    who occupies the rest. Guarantees the engine never admits into a live
    row and never double-frees."""

    def __init__(self, batch: int):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.batch = batch
        self._free: List[int] = list(range(batch))[::-1]  # pop() -> row 0
        self._owner: List[Optional[int]] = [None] * batch

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_occupied(self) -> int:
        return self.batch - len(self._free)

    def owner_of(self, row: int) -> Optional[int]:
        return self._owner[row]

    def occupied_rows(self) -> List[int]:
        return [r for r, o in enumerate(self._owner) if o is not None]

    def acquire(self, request_id: int) -> int:
        if not self._free:
            raise RuntimeError("no free slot (scheduler bug: admission "
                               "must check n_free first)")
        row = self._free.pop()
        self._owner[row] = request_id
        return row

    def release(self, row: int) -> None:
        if self._owner[row] is None:
            raise RuntimeError(f"double free of slot {row}")
        self._owner[row] = None
        self._free.append(row)
