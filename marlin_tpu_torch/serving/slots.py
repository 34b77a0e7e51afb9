"""Slot management and the one-shot admission prefill — port of the
default-discipline half of ``marlin_tpu/serving/slots.py``.

A slot is one row of the live batch: one row of every KV-cache layer, one
row of the token buffer, one entry of the engine's fill/target state.
:func:`prefill_into_row` admits a request into a free row: it prefills the
prompt through the flash kernel and writes the row's K/V and tokens IN
PLACE (the JAX package donated the cache and buffer for the same effect).

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
    prompt_len = int(prompt.shape[0])
    padded = pad_to_multiple(prompt, 0, ADMISSION_BUCKET)
    p = padded.shape[0]
    x = tr._embed_prefix(params, padded[None], cfg)  # (1, P, D)
    for layer, bp in zip(cache, params["blocks"]):
        x, k, v = tr._block(bp, x, cfg, return_kv=True)
        layer["k"][row, :p] = k[0]
        layer["v"][row, :p] = v[0]
    # Logits at the last REAL position; causality makes that hidden
    # state independent of the pad.
    h = tr._layer_norm(params["ln_f"], x[0, prompt_len - 1:prompt_len])
    first = tr._sample(tr._readout(params, h), temperature, generator)[0]
    _write_row_tokens(buf, row, prompt, prompt_len, first)
    return prompt_len + 1, first


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
