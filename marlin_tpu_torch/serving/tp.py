"""Tensor-parallel serving entry points — port of
``marlin_tpu/serving/tp.py``.

The JAX package wraps each of the engine's jitted round and admission
bodies in ``jit(shard_map(...))`` over the ``model`` axis, with the
driver state (token buffer, fills, page tables, key streams) replicated,
so every device takes the same trips and samples the same token. The
port's engine runs its rounds on the host, so only the MODEL calls run
sharded here (:func:`..models.tp.run_shards`, params column-sharded and
the cache or page pool head-sharded): ``decode_chunk`` and
``decode_chunk_paged`` (which the engine's four round loops call: plain,
paged, speculative, speculative paged), the block loop of the one-shot
admission, and ``prefill_chunk`` / ``prefill_chunk_paged`` of the chunked
admissions. Sampling, the token buffer, tables, fills, slots and the
scheduler run once, on shard 0's logits, which every shard holds whole:
a request's generator is drawn from exactly as at tp 1, so the
bit-exactness of gather mode carries from one forward to whole serving
rounds.

Each entry point takes the arguments of the tp 1 function it stands for,
with params and cache (or pool) as :class:`..models.tp.Sharded` trees;
:data:`SINGLE` and :data:`SHARDED` are the engine's two dispatch tables.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models import tp as mtp
from ..models import transformer as tr
from ..utils.split import pad_to_multiple
from . import slots


@torch.no_grad()
def decode_chunk(params, cache, tokens, pos, cfg):
    """:func:`..models.transformer.decode_chunk` on every shard: (logits
    (B, C, vocab) from shard 0, cache updated in place)."""
    logits = mtp.run_shards(
        lambda p, c, t, q: tr.decode_chunk(p, c, t, q, cfg)[0],
        params, cache, tokens, pos)[0]
    return logits, cache


@torch.no_grad()
def decode_chunk_paged(params, pool, tables, tokens, pos, cfg):
    """:func:`..models.transformer.decode_chunk_paged` on every shard:
    (logits from shard 0, pool updated in place)."""
    logits = mtp.run_shards(
        lambda p, pl, tb, t, q: tr.decode_chunk_paged(p, pl, tb, t, q,
                                                      cfg)[0],
        params, pool, tables, tokens, pos)[0]
    return logits, pool


@torch.no_grad()
def prefill_into_row(params, cache, buf, row: int, prompt, cfg,
                     temperature: float = 0.0,
                     generator: Optional[torch.Generator] = None):
    """:func:`.slots.prefill_into_row`: the block loop (the flash prefill
    at the local heads) on every shard, the first token and the buffer
    write once."""
    padded = pad_to_multiple(prompt, 0, slots.ADMISSION_BUCKET)
    x = mtp.run_shards(
        lambda p, c, t: slots._prefill_blocks(tr._cast_params(p, cfg), c,
                                              row, t, cfg),
        params, cache, padded)[0]
    return slots._admit_first(tr._cast_params(params[0], cfg), x, buf, row,
                              prompt, temperature, generator)


@torch.no_grad()
def prefill_chunk_into_row(params, cache, buf, row: int, chunk, start: int,
                           chunk_len: int, prompt, prompt_len: int, cfg,
                           temperature: float = 0.0,
                           generator: Optional[torch.Generator] = None,
                           final: bool = False):
    """:func:`.slots.prefill_chunk_into_row`: the chunk on every shard's
    row, the first token (on the final chunk) once."""
    logits = mtp.run_shards(
        lambda p, c, ch: tr.prefill_chunk(p, slots._row_cache(c, row),
                                          ch[None], start, cfg,
                                          last=chunk_len - 1)[0],
        params, cache, chunk)[0]
    return slots._chunk_first(logits, buf, row, prompt, prompt_len,
                              temperature, generator, final)


@torch.no_grad()
def prefill_chunk_into_row_paged(params, pool, buf, row: int, table, chunk,
                                 start: int, chunk_len: int, prompt,
                                 prompt_len: int, cfg,
                                 temperature: float = 0.0,
                                 generator: Optional[torch.Generator] = None,
                                 final: bool = False):
    """:func:`.slots.prefill_chunk_into_row_paged`: the chunk through the
    row's table on every shard's pool, the first token once."""
    logits = mtp.run_shards(
        lambda p, pl, tb, ch: tr.prefill_chunk_paged(
            p, pl, tb[None], ch[None], start, cfg, last=chunk_len - 1)[0],
        params, pool, table, chunk)[0]
    return slots._chunk_first(logits, buf, row, prompt, prompt_len,
                              temperature, generator, final)


class EntryPoints(NamedTuple):
    """The engine's model calls, one discipline a field."""

    decode: Callable
    decode_paged: Callable
    prefill: Callable
    chunk: Callable
    chunk_paged: Callable


# tp == 1: the functions the engine called before tensor parallelism.
SINGLE = EntryPoints(tr.decode_chunk, tr.decode_chunk_paged,
                     slots.prefill_into_row, slots.prefill_chunk_into_row,
                     slots.prefill_chunk_into_row_paged)

# tp > 1: the sharded counterparts above.
SHARDED = EntryPoints(decode_chunk, decode_chunk_paged, prefill_into_row,
                      prefill_chunk_into_row, prefill_chunk_into_row_paged)
