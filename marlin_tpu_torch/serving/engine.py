"""Continuous-batching serving engine — port of
``marlin_tpu/serving/engine.py``: FIFO admission, greedy or temperature
sampling, ``eos_id`` and deadlines, in three admission disciplines.

* Default: one-shot admission prefill through the flash kernel
  (:func:`.slots.prefill_into_row`) into a contiguous per-row KV cache.
* ``prefill_chunk=N``: chunked admission (:func:`.slots.
  prefill_chunk_into_row`), Sarathi-style: a prompt is prefilled in
  16-aligned chunks, at most ``prefill_chunks_per_round`` per round, so a
  long cold prompt spreads over rounds instead of stalling the live rows.
  ``prefix_cache=PrefixCache(...)`` (serving/prefix.py) rides on it: a
  hit copies the donor's K/V rows and prefills only the tail.
* ``kv_pages=N``: paged KV (serving/pages.py): the cache is a pool of
  16-token pages and a row holds a page table; pages are reserved whole
  at admission; with ``prefix_sharing`` (the default) a hit aliases the
  stored prefix's pages into the new row's table, zero copy.

The chunked and paged disciplines attend through the plain cached
attention, in prefill tiles of one fixed shape (models/transformer._tiles),
which makes any chunk split bitwise exact: prefix cache on == off,
sharing on == off and paged == contiguous, token for token.

Decode runs in bounded ROUNDS of at most ``round_steps`` iterations over
the whole batch; between rounds the engine retires finished rows and
admits queued requests into the freed rows. Within a round every row
feeds its last token at its own position (``decode_chunk``, or
``decode_chunk_paged``, at C=1 with per-row positions); rows that reach
their target or emit ``eos_id`` freeze, and a frozen row re-feeds its
last token at its last position — a fixed point that writes only dead
state. A row still being prefilled rides through rounds frozen, its feed
parked at the buffer's last slot (dead by the write-before-read rule).
The loop's exit test is one device-to-host copy of the (B,) ``done``
flags per iteration; JAX ran the same loop as a ``lax.while_loop`` on the
device.

``spec_draft_lens=(...)`` makes every round speculative
(:meth:`ServingEngine._spec_round_loop`): each iteration drafts
``draft_len - 1`` tokens a live row from its own history
(prompt lookup), verifies every row's chunk in one ``decode_chunk`` and
advances each row by its own accepted count. The draft length moves
within the set between rounds by the measured acceptance
(``cost_model.pick_draft_len``) unless ``spec_adaptive=False``. Decode
steps and verify chunks run in tiles of one shape
(``models/transformer.DECODE_TILE``), so greedy speculative output is
bitwise the non-speculative engine's. int8 params
(``models/quant.quantize_params_int8``) and the int8 KV cache
(``cfg.kv_quant``) serve through every discipline.

Sampling at ``temperature > 0`` draws each request's tokens from its own
``torch.Generator``, seeded from (engine seed, request id) and advanced
only on the request's live iterations (live verify chunks under
speculation), so sampled outputs do not depend on batch composition or
arrival pattern.

``host_kv_bytes`` / ``host_kv_dir`` put a host KV tier (serving/pages.
HostKVTier) under a paged engine's prefix index: a stored prefix evicted
under page pressure spills to host memory (and to the dir), and a later
hit longer than the resident one by ``restore_min_tokens`` restores its
bytes into fresh pages instead of re-prefilling them. ``scheduler=``
(serving/sched.Scheduler) orders admission by priority class, deadline and
quota; on a paged engine with a tier it also preempts: at a round boundary
an urgent request may freeze a lower-class decoding row, spill its pages,
tokens and sampling generator to the tier, and thaw it later, after which
the row decodes as if it had never stopped. Tokens stay a function of
(prompt, steps, seed, request id): tier on == off and preempted ==
uninterrupted, bitwise.

``cfg.tp > 1`` serves every discipline above tensor-parallel (serving/
tp.py): the params are permuted and column-sharded over the ``model``
axis that ``device`` names (models/tp.tp_devices: ``"cuda"`` is the first
``tp`` cards, ``"cpu"`` ``tp`` CPU shards, ``("cuda:0",) * tp`` every
shard on one card), the cache or page pool holds one shard's heads a
shard, and every model call runs on all shards while sampling and the
host state run once. Tokens are bitwise those of tp 1 (gather mode).
The contiguous ``prefix_cache`` stays tp 1 only.

Supervised restart (serving/frontend.py): :meth:`ServingEngine.
spawn_successor` builds a fresh engine that continues this one's serving
lifetime after a crash (the same params, knobs, seed and ``stats``
ledger, fresh device state), and :meth:`ServingEngine.requeue` takes the
crashed engine's requests back in request-id order. ``_retired_pending``
holds the requests a step resolved until it returns them, and
``_admitting_rid`` names the request whose own admission work is running,
so a crash there blames that request alone.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import tp as mtp
from ..models import transformer as tr
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.runlog import RunLog
from ..utils import cost_model as cm
from ..utils.split import pad_to_multiple
from . import faults
from . import tp as stp
from .pages import PAGE, SINK_PAGE, HostKVTier, PagePool
from .prefix import PagedPrefixIndex, PrefixCache
from .queue import AdmissionQueue, Request
from .sched import FrozenRow, Scheduler
from .slots import (ADMISSION_BUCKET, SlotManager, pad_prompt_len,
                    restore_pages_into_pool, restore_row_tokens)
from .stats import EngineStats

@dataclasses.dataclass
class _PrefillJob:
    """One in-flight chunked admission: the host cursor of a prompt being
    prefilled into its claimed row across rounds, starting past any
    prefix hit."""

    req: Request
    row: int
    prompt: torch.Tensor  # (prompt_len,) on the engine's device
    pos: int            # next uncovered prompt position (16-aligned)
    hit_len: int        # prefix hit this admission started from
    gen: Optional[torch.Generator]  # the request's sampling stream
    start_round: int
    chunks: int = 0
    done: bool = False


def request_seed(seed: int, request_id: int) -> int:
    """The seed of request ``request_id``'s sampling generator: a pure
    function of (engine seed, request id)."""
    digest = hashlib.sha256(f"{int(seed)}:{int(request_id)}".encode())
    return int.from_bytes(digest.digest()[:8], "little") >> 1


class ServingEngine:
    """Continuous-batching engine: ``submit`` -> ``step``/``run``.

    Owns the device state (KV cache, token buffer) and the host
    scheduling state (queue, slots, per-request records). ``batch`` is
    the static row count; the queue absorbs everything beyond it.
    ``params`` (and a ``prefix_cache``) must live on ``device`` (default
    ``"cuda"``; with ``cfg.tp > 1`` on its first shard's device); the
    cache, or the page pool, is allocated there (a shard's on each shard's
    device)."""

    def __init__(self, params, cfg, batch: int = 8, round_steps: int = 8,
                 max_pending: int = 64, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 tracer=None, runlog: Optional[RunLog] = None,
                 metrics_registry=None,
                 stats: Optional[EngineStats] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 prefill_chunks_per_round: int = 2,
                 kv_pages: Optional[int] = None,
                 prefix_sharing: bool = True,
                 spec_draft_lens: Optional[tuple] = None,
                 spec_ngram: int = 2, spec_adaptive: bool = True,
                 host_kv_bytes: Optional[int] = None,
                 host_kv_dir: Optional[str] = None,
                 restore_min_tokens: Optional[int] = None,
                 scheduler: Optional[Scheduler] = None,
                 device="cuda"):
        tr.validate_tp(cfg)
        self.tp = int(cfg.tp)
        if self.tp > 1 and prefix_cache is not None:
            raise NotImplementedError(
                "tp > 1 composes with the PAGED prefix surface "
                "(kv_pages + prefix_sharing); the contiguous PrefixCache "
                "pool is not sharded")
        if cfg.window:
            raise NotImplementedError(
                "serving needs the dense slot==position cache "
                "(cfg.window == 0): a ring cache cannot host per-row "
                "admission overwrites (see decode_chunk)")
        if cfg.n_experts:
            raise NotImplementedError(
                "serving decodes through decode_chunk, which does not "
                "fit the MoE router's (T, D) batch contract")
        if cfg.sequence_parallel:
            raise NotImplementedError(
                "sequence-parallel decode is not meaningful; shard the "
                "batch instead")
        if round_steps < 1:
            raise ValueError(f"round_steps must be >= 1, got {round_steps}")
        # Admission discipline. Paged KV and the prefix cache run on the
        # chunked admission (the bitwise-stable substrate), so either one
        # defaults prefill_chunk; the paged engine shares prefixes through
        # its own pool, so PrefixCache (the contiguous engine's copy-based
        # surface) is refused beside it.
        if kv_pages is not None:
            if prefix_cache is not None:
                raise ValueError(
                    "kv_pages and prefix_cache are mutually exclusive: "
                    "the paged engine shares prefixes through its own "
                    "page pool (prefix_sharing=True, the default); "
                    "PrefixCache is the contiguous-row engine's copy-"
                    "based surface")
            if prefill_chunk is None:
                prefill_chunk = 32
        elif not prefix_sharing:
            raise ValueError(
                "prefix_sharing applies to the PAGED engine "
                "(kv_pages=...); disable the contiguous engine's "
                "copy-based sharing by omitting prefix_cache instead")
        if prefix_cache is not None and prefill_chunk is None:
            prefill_chunk = 32
        # The host KV tier spills and restores the paged prefix index's
        # pages, so it needs kv_pages with prefix_sharing.
        self.host_kv = host_kv_bytes is not None or host_kv_dir is not None
        if self.host_kv and (kv_pages is None or not prefix_sharing):
            raise ValueError(
                "host_kv_bytes/host_kv_dir need the paged prefix index "
                "(kv_pages=... with prefix_sharing=True): the host "
                "tier spills/restores stored prefix pages")
        if restore_min_tokens is not None and not self.host_kv:
            raise ValueError(
                "restore_min_tokens without host_kv_bytes/host_kv_dir "
                "configures nothing")
        self.host_kv_bytes = host_kv_bytes
        self.host_kv_dir = host_kv_dir
        # Restore a spilled hit only when it beats the resident hit by at
        # least this many tokens (cost_model's crossover).
        self.restore_min_tokens = (
            int(restore_min_tokens) if restore_min_tokens is not None
            else cm.KV_RESTORE_MIN_TOKENS_DEFAULT)
        if prefill_chunk is not None and (prefill_chunk < 16
                                          or prefill_chunk % 16):
            raise ValueError(
                f"prefill_chunk must be a multiple of 16 (the admission "
                f"bucket), got {prefill_chunk}")
        if prefill_chunks_per_round < 1:
            raise ValueError(
                f"prefill_chunks_per_round must be >= 1, got "
                f"{prefill_chunks_per_round}")
        # Speculative rounds: the set of draft lengths the adaptive policy
        # moves within (the JAX engine compiles one executable a member).
        self.spec = spec_draft_lens is not None
        if self.spec:
            lens = tuple(sorted({int(c) for c in spec_draft_lens}))
            if not lens:
                raise ValueError("spec_draft_lens must be non-empty")
            if lens[0] < 2:
                raise ValueError(
                    f"every spec draft_len must be >= 2 (1 token of "
                    f"draft + the verify correction), got {lens[0]}")
            if spec_ngram < 1:
                raise ValueError(
                    f"spec_ngram must be >= 1, got {spec_ngram}")
            if lens[-1] >= cfg.max_len:
                raise ValueError(
                    f"max spec draft_len {lens[-1]} must be < max_len "
                    f"{cfg.max_len}")
            self.spec_draft_lens = lens
        else:
            self.spec_draft_lens = ()
        self.spec_ngram = int(spec_ngram)
        self.spec_adaptive = bool(spec_adaptive)
        # Verify-window overhang: a live row's chunk may write up to
        # draft_len_max - 1 slots past its target, so submit tightens the
        # extent check and paged admission reserves the extra slots.
        self._spec_overhang = (self.spec_draft_lens[-1] - 1) if self.spec \
            else 0
        # The draft length the next round runs: the smallest until
        # acceptance evidence accumulates.
        self._draft_len = self.spec_draft_lens[0] if self.spec else None
        if prefix_cache is not None and prefix_cache.cfg != cfg:
            raise ValueError(
                "prefix_cache was built for a different TransformerConfig; "
                "its pool rows would not be shape/quantization-compatible "
                "with this engine's cache")
        # The model axis (one device at tp 1); driver state lives on the
        # first shard's device.
        self.devices = mtp.tp_devices(self.tp, device)
        self.device = self.devices[0]
        if tr.params_device(params) != self.device:
            raise ValueError(
                f"params live on {tr.params_device(params)}, the engine on "
                f"{self.device}")
        if prefix_cache is not None and prefix_cache.device != self.device:
            raise ValueError(
                f"prefix_cache lives on {prefix_cache.device}, the engine "
                f"on {self.device}")
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.round_steps = round_steps
        self.prefill_chunk = prefill_chunk
        self.prefill_chunks_per_round = prefill_chunks_per_round
        self.prefix_cache = prefix_cache
        self.kv_pages = kv_pages
        self.paged = kv_pages is not None
        self.prefix_sharing = bool(prefix_sharing)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self._seed = int(seed)
        # Cast once: every later _cast_params on the serving path is a
        # no-op (the JAX entry points re-cast inside each compile). No
        # grad, here and in step(): params may require grad (after
        # make_train_step), and serving must build no graph from them.
        # Under TP the run params are the permuted, sharded copy;
        # self.params keeps the original tree (the permutation is not
        # idempotent).
        with torch.no_grad():
            self._run_params = tr._cast_params(params, cfg)
            if self.tp > 1:
                self._run_params = mtp.tp_shard_params(
                    self._run_params, cfg, self.devices)
        # The model calls of every discipline (serving/tp.py): tp 1's
        # functions, or their sharded counterparts.
        self._fns = stp.SHARDED if self.tp > 1 else stp.SINGLE
        # A scheduler orders the queue; without one every path below is
        # the FIFO engine's. A request dropped for deadline while frozen
        # still holds a pinned host row: _release_expired frees it.
        self.scheduler = scheduler
        self.queue = AdmissionQueue(max_pending=max_pending,
                                    scheduler=scheduler)
        self.queue.on_expire = self._release_expired
        self.slots = SlotManager(batch)
        self.tracer = tracer if tracer is not None else obs_trace.tracer
        self.runlog = runlog if runlog is not None else RunLog()
        self.metrics = metrics_registry if metrics_registry is not None \
            else obs_metrics.registry
        # A successor inherits its crashed predecessor's ledger
        # (spawn_successor): one serving lifetime's totals span every
        # engine incarnation.
        self.stats = stats if stats is not None else EngineStats(
            batch=batch, cfg=cfg, registry=self.metrics)
        if prefix_cache is not None and prefix_cache._registry is None:
            # The cache's store/evict series land beside this engine's
            # hit/miss mirrors (first attaching engine wins).
            prefix_cache._registry = self.metrics
        self._next_id = 0
        self.round_idx = 0
        # Matrix-service quanta the frontend driver ran since the last
        # round event (serving/jobs.py): stamped on the next one, so a
        # round whose slice went to a matrix job is no stall in the log.
        self._matrix_quanta = 0
        self._decode_flops, _ = cm.decode_step_cost(cfg, batch)
        # Speculative rounds are priced per verify chunk, one constant a
        # draft length.
        self._spec_flops = {c: cm.spec_round_cost(cfg, batch, c)[0]
                            for c in self.spec_draft_lens}
        # Pending + active requests only; finished ones are handed back
        # by step()/run() and dropped here.
        self.requests: Dict[int, Request] = {}
        # Makes id allocation + queue submit + dict insert one unit for
        # concurrent submitters; everything else runs on the stepping thread.
        self._submit_lock = threading.Lock()
        self._drain_reported = False
        # The supervisor's crash ledger (serving/frontend.py): requests this
        # step resolved (retired or expired) that it has not returned yet,
        # delivered by the supervisor if the step dies first.
        self._retired_pending: List[Request] = []
        # Crash blame: the request whose own admission work (prefill, prefix
        # copy or alias, restore, thaw, freeze) runs now; None during
        # batch-wide work. Set before a fault site and cleared only on
        # success, so a crash leaves it readable.
        self._admitting_rid: Optional[int] = None
        # In-flight chunked admissions (row -> job); empty in the one-shot
        # discipline.
        self._prefilling: Dict[int, _PrefillJob] = {}
        # Device state, updated in place by admission and decode. Free
        # rows sit at filled=1 over a zero buffer so their frozen feed
        # (token 0 at position 0) is well-defined dead state. In paged
        # mode the contiguous cache is replaced by the page pool plus
        # host-side page tables (row r: chunk index -> pool page; chunks
        # not reserved point at the write sink).
        if self.paged:
            self._cache = None
            self.page_pool = PagePool(cfg, kv_pages, registry=self.metrics,
                                      device=self.devices)
            self.host_tier = HostKVTier(
                self.page_pool, budget_bytes=host_kv_bytes,
                registry=self.metrics, event_sink=self._host_tier_event,
                spill_dir=host_kv_dir) if self.host_kv else None
            self.prefix_index = PagedPrefixIndex(
                self.page_pool, registry=self.metrics,
                host_tier=self.host_tier) if self.prefix_sharing else None
            self._tables = np.full((batch, cfg.max_len // PAGE), SINK_PAGE,
                                   np.int64)
            self._row_pages: Dict[int, List[int]] = {}  # row -> held refs
            # Slack slots in each reservation's last page: the numerator
            # of the round's fragmentation gauge.
            self._row_slack: Dict[int, int] = {}
            # The tier's totals at the last round event (its deltas).
            self._host_spills0 = 0
            self._host_restores0 = 0
        else:
            self.page_pool = None
            self.prefix_index = None
            self.host_tier = None
            # One shard's heads a shard under TP.
            self._cache = mtp.per_shard(
                lambda dev: tr.init_kv_cache(cfg, batch,
                                             dtype=cfg.compute_dtype,
                                             device=dev), self.devices)
        self.stats.page_pool = self.page_pool
        self._buf = torch.zeros((batch, cfg.max_len), dtype=torch.long,
                                device=self.device)
        self._filled = np.ones((batch,), np.int64)
        self._target = np.zeros((batch,), np.int64)
        self._active = np.zeros((batch,), bool)
        self._gens: List[Optional[torch.Generator]] = [None] * batch
        # Preemption needs the scheduler (who), paged KV (page-granular
        # freeze) and the tier (where the frozen bytes wait). A scheduler
        # on any other engine only orders admission.
        self._can_preempt = (scheduler is not None and self.paged
                             and self.host_tier is not None
                             and scheduler.max_preempts_per_round > 0)
        if scheduler is not None and scheduler.metrics is None:
            scheduler.metrics = self.metrics
        self._n_preempts = 0   # freezes, lifetime
        self._n_resumes = 0    # thaws, lifetime
        self._preempts0 = 0    # their totals at the last round event
        self._resumes0 = 0
        self._preempt_budget = 0  # freezes this round may still make
        self.runlog.emit("engine_start", batch=batch,
                         round_steps=round_steps,
                         prefill_chunk=prefill_chunk,
                         max_pending=max_pending, max_len=cfg.max_len,
                         prefix_cache=prefix_cache is not None,
                         kv_pages=kv_pages,
                         host_kv_bytes=host_kv_bytes,
                         host_kv_dir=host_kv_dir,
                         prefix_sharing=self.paged and self.prefix_sharing,
                         spec_draft_lens=(list(self.spec_draft_lens)
                                          if self.spec else None),
                         spec_ngram=self.spec_ngram if self.spec else None,
                         sched=scheduler is not None,
                         sched_classes=([c.name for c in scheduler.by_rank]
                                        if scheduler is not None else None),
                         tp_degree=self.tp,
                         tp_mode=cfg.tp_mode if self.tp > 1 else None,
                         device=str(self.device))

    # -- submission ---------------------------------------------------

    def submit(self, prompt, steps: int,
               deadline_rounds: Optional[int] = None,
               deadline_s: Optional[float] = None,
               request_id: Optional[int] = None,
               tenant: Optional[str] = None,
               sched_class: Optional[str] = None) -> int:
        """Queue one generation request; returns its request id. Raises
        ``QueueFull`` (backpressure), ``QueueClosed`` (draining), or
        ValueError for a request the cache cannot hold. Thread-safe.

        ``request_id`` replaces the engine's next id (it must not be in
        use); the request's sampling stream derives from it. ``tenant`` is
        an opaque label; ``sched_class`` names a class of the scheduler
        (which it needs; an unknown name raises before anything is
        queued). Neither moves a token."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        s = int(prompt.shape[0])
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if s + steps + self._spec_overhang > self.cfg.max_len:
            # A speculative row's last chunk may write draft_len_max - 1
            # slots past its target; those slots must exist.
            extra = (f" + draft overhang {self._spec_overhang}"
                     if self._spec_overhang else "")
            raise ValueError(
                f"prompt {s} + steps {steps}{extra} exceeds max_len "
                f"{self.cfg.max_len}")
        if self.spec and s < self.spec_ngram:
            raise ValueError(
                f"prompt length {s} < spec_ngram {self.spec_ngram}: "
                f"the prompt-lookup drafter needs at least one full "
                f"n-gram of committed history")
        if pad_prompt_len(s) > self.cfg.max_len:
            raise ValueError(
                f"padded prompt {pad_prompt_len(s)} exceeds max_len "
                f"{self.cfg.max_len}")
        n_pages = self._pages_needed(s, steps)
        if self.paged and n_pages > self.kv_pages:
            # Hopeless even against an empty pool: fail now, not by
            # queueing forever.
            raise ValueError(
                f"request needs {n_pages} KV pages > pool size "
                f"{self.kv_pages} (prompt {s} + steps {steps} + overhang "
                f"{self._spec_overhang} at {PAGE} tokens/page)")
        if sched_class is not None and self.scheduler is None:
            raise ValueError(
                f"sched_class {sched_class!r} needs a scheduler "
                "(ServingEngine(scheduler=...)); this engine admits "
                "FIFO")
        cls_name = (self.scheduler.resolve(sched_class).name
                    if self.scheduler is not None else "")
        now = time.perf_counter()
        with self._submit_lock:
            if request_id is None:
                rid = self._next_id
            else:
                rid = int(request_id)
                if rid < 0:
                    raise ValueError(
                        f"request_id must be >= 0, got {rid}")
                if rid in self.requests:
                    raise ValueError(f"request_id {rid} already in use")
            req = Request(
                request_id=rid, prompt=prompt, steps=int(steps),
                deadline_rounds=deadline_rounds,
                deadline_time=(now + deadline_s
                               if deadline_s is not None else None),
                submit_round=self.round_idx, submit_time=now,
                tenant=str(tenant) if tenant else "default",
                sched_class=cls_name)
            with self.tracer.span("serving.submit",
                                  request_id=req.request_id):
                self.queue.submit(req)  # raises before anything registers
            # max: an explicit id pulls the counter past itself.
            self._next_id = max(self._next_id, rid + 1)
            self.requests[rid] = req
        self.metrics.counter("serving_submitted_total").inc()
        self.metrics.gauge("serving_queue_depth").set(len(self.queue))
        self.runlog.emit("submit", request_id=rid, prompt_len=s,
                         steps=int(steps), round=self.round_idx,
                         queue_depth=len(self.queue),
                         **({"sched_class": cls_name} if cls_name else {}))
        return rid

    def close(self) -> None:
        """Graceful drain: no new submits; ``run`` finishes queued work."""
        self.queue.close()

    def _host_tier_event(self, kind: str, **fields) -> None:
        """The host tier's runlog sink: its events carry the round."""
        self.runlog.emit(kind, round=self.round_idx, **fields)

    def _sync_device(self) -> None:
        """Wait for the devices' queued work (a restore's copies, into
        every shard's pages under TP) before a clock is read."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _pages_needed(self, prompt_len: int, steps: int) -> int:
        """A paged request's whole page complement: its prompt, steps and
        the speculative write overhang, so a placed request never runs
        out mid-decode and a verify chunk never writes through a page it
        does not own."""
        return -(-(prompt_len + steps + self._spec_overhang) // PAGE)

    # -- admission ----------------------------------------------------

    def _request_generator(self, req: Request) -> Optional[torch.Generator]:
        if self.temperature <= 0.0:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(request_seed(self._seed, req.request_id))
        return gen

    def _drop_expired(self, expired: List[Request]) -> None:
        for req in expired:
            self.stats.record_timeout(req)
            self.runlog.emit("timeout", request_id=req.request_id,
                             round=self.round_idx,
                             deadline_rounds=req.deadline_rounds,
                             wait_s=req.finish_time - req.submit_time)
            with self._submit_lock:
                self.requests.pop(req.request_id, None)
            self._retired_pending.append(req)  # crash-safe until returned

    def _activate_row(self, req: Request, row: int,
                      gen: Optional[torch.Generator]) -> None:
        """Shared admission epilogue: the row's prompt K/V and first token
        are in place; arm it for decode and record the ledger."""
        s = req.prompt_len
        self._filled[row] = s + 1
        self._target[row] = s + req.steps
        self._active[row] = True
        self._gens[row] = gen
        req.row = row
        req.admit_round = self.round_idx
        req.admit_time = time.perf_counter()
        req.status = "active"
        self.stats.record_admission(req)
        if self.scheduler is not None:
            # First admission only (a thaw does not come here).
            self.scheduler.note_admitted(
                req, req.admit_start_time - req.submit_time)

    def _release_expired(self, req: Request) -> None:
        """The queue's ``on_expire`` hook: a request dropped for deadline
        while frozen releases its pinned host row."""
        fz = req.frozen
        if fz is not None and self.host_tier is not None:
            self.host_tier.drop_row(fz.host_key)
            req.frozen = None

    def _admit(self) -> List[Request]:
        """Fill free rows from the queue, FIFO; returns the requests
        dropped for deadline on the way. One-shot flash admission by
        default, chunked with ``prefill_chunk`` set."""
        if self.prefill_chunk is None:
            return self._admit_oneshot()
        return self._admit_chunked()

    def _admit_oneshot(self) -> List[Request]:
        """Each admission one flash prefill."""
        expired: List[Request] = []
        while self.slots.n_free:
            faults.check("admission_pop", round_idx=self.round_idx)
            req, dropped = self._pop_ready()
            expired.extend(dropped)
            if req is None:
                break
            req.admit_start_time = time.perf_counter()
            row = self.slots.acquire(req.request_id)
            gen = self._request_generator(req)
            prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                     device=self.device)
            t0 = time.perf_counter()
            self._admitting_rid = req.request_id
            faults.check("prefill_chunk", round_idx=self.round_idx,
                         request_id=req.request_id)
            with self.tracer.span("serving.admit",
                                  request_id=req.request_id, row=row,
                                  prompt_len=req.prompt_len):
                self._fns.prefill(self._run_params, self._cache,
                                  self._buf, row, prompt, self.cfg,
                                  temperature=self.temperature,
                                  generator=gen)
            self._admitting_rid = None
            req.prefill_s += time.perf_counter() - t0
            self.stats.calibration.record(
                "prefill", cm.admission_cost(self.cfg, req.prompt_len)[0],
                req.prefill_s)
            self._activate_row(req, row, gen)
            self.runlog.emit(
                "admit", request_id=req.request_id, row=row,
                round=self.round_idx, prompt_len=req.prompt_len,
                wait_rounds=self.round_idx - req.submit_round,
                queue_depth=len(self.queue))
        self._drop_expired(expired)
        return expired

    # -- preemption (serving/sched.py) --------------------------------

    def _class_occupancy(self) -> Dict[str, int]:
        """Active and mid-prefill rows a class: the quotas' count."""
        occ: Dict[str, int] = {}
        with self._submit_lock:
            for row in self.slots.occupied_rows():
                req = self.requests.get(self.slots.owner_of(row))
                if req is not None and req.sched_class:
                    occ[req.sched_class] = occ.get(req.sched_class, 0) + 1
        return occ

    def _pop_ready(self):
        """The admission loops' pop, with the class occupancy when a
        scheduler orders the queue."""
        occ = self._class_occupancy() if self.scheduler is not None \
            else None
        return self.queue.pop_ready(self.round_idx, occupancy=occ)

    def _pick_victim(self, requester_rank: int) -> Optional[Request]:
        """The row to freeze for a requester of ``requester_rank``, or
        None. Candidates are active decoding rows with work left (a
        mid-prefill row's KV is incomplete); the scheduler orders them and
        its cost gate prices each freeze against letting the row finish."""
        cands = []
        with self._submit_lock:
            for row in self.slots.occupied_rows():
                if row in self._prefilling:
                    continue
                req = self.requests.get(self.slots.owner_of(row))
                if req is None or not self._active[row]:
                    continue
                remaining = int(self._target[row] - self._filled[row])
                if remaining <= 0:
                    continue  # retiring at this boundary anyway
                cands.append((req, remaining))
        ordered = self.scheduler.victim_order(cands, requester_rank)
        for req, remaining in ordered:
            if self.scheduler.preempt_gate(
                    self.cfg, int(self._filled[req.row]), remaining):
                return req
        self.scheduler.note_preempt_abort(
            "cost_gate" if ordered else "no_victim")
        return None

    def _preempt_one(self, requester_rank: int) -> bool:
        """Pick and freeze one victim; spends one of the round's freezes
        on success."""
        victim = self._pick_victim(requester_rank)
        if victim is None or not self._preempt_row(victim):
            return False
        self._preempt_budget -= 1
        return True

    def _preempt_for_urgent(self) -> None:
        """Slot pressure: while the batch is full and a ``can_preempt``
        class heads its queue, freeze victims (within the round's
        budget). Page pressure is handled in ``_admit_chunked``."""
        while self._preempt_budget > 0 and self.slots.n_free == 0:
            cand = self.queue.peek_urgent()
            if cand is None:
                return
            if not self._preempt_one(
                    self.scheduler.classes[cand.sched_class].rank):
                return

    def _preempt_row(self, req: Request) -> bool:
        """Freeze one active decoding row at this round boundary and spill
        it to the host tier. The residue is what a bitwise resume needs:
        the row's whole page complement (live KV [0, filled - 1) and dead
        slots that come back byte for byte), its tokens [0, filled), its
        sampling generator and its cursors (sched.FrozenRow). Returns
        False, the row untouched, when the tier refuses the spill."""
        row = req.row
        f = int(self._filled[row])
        host_key = f"row-{req.request_id}-{req.preempt_count}"
        # Blamed before the fault site: a crash here leaves the row whole
        # and the victim replays from scratch.
        self._admitting_rid = req.request_id
        faults.check("preempt_spill", round_idx=self.round_idx,
                     request_id=req.request_id)
        with self.tracer.span("serving.preempt", request_id=req.request_id,
                              row=row, filled=f):
            tokens = self._buf[row, :f].cpu().numpy()
            pages = list(self._row_pages[row])
            spilled = self.host_tier.spill_row(host_key, tokens, pages)
        self._admitting_rid = None
        if spilled is None:
            self.scheduler.note_preempt_abort("host_budget")
            return False
        nbytes, spill_s = spilled
        frozen = FrozenRow(host_key=host_key, filled=f,
                           target=int(self._target[row]),
                           gen=self._gens[row], n_pages=len(pages),
                           nbytes=nbytes, preempt_round=self.round_idx)
        self._release_row(row)
        self._filled[row] = 1  # a free row's parked feed
        req.frozen = frozen
        req.row = -1
        req.status = "preempted"
        req.preempt_count += 1
        self._n_preempts += 1
        self.stats.record_preempt(req)
        self.scheduler.note_preempt(req)
        # Back into its class heap under its original sequence: it
        # resumes ahead of later arrivals of its class.
        self.queue.push_front(req)
        self.runlog.emit("preempt", request_id=req.request_id, row=row,
                         round=self.round_idx, filled=f,
                         pages=len(pages), bytes=nbytes,
                         spill_s=round(spill_s, 6))
        return True

    def _thaw_frozen(self, req: Request) -> bool:
        """Resume a preempted request: reserve its page complement again,
        scatter the pinned payload into it, restore the token row, the
        cursors and the generator. Returns False, nothing claimed, under
        page pressure (the caller requeues it)."""
        fz: FrozenRow = req.frozen
        need = fz.n_pages
        if self.page_pool.n_free < need and self.prefix_index is not None:
            self.prefix_index.evict_until_free(need)
        fresh = self.page_pool.alloc(need)
        if fresh is None:
            return False
        fetched = self.host_tier.fetch_row(fz.host_key)
        if fetched is None:
            self.page_pool.unref(fresh)
            raise RuntimeError(
                f"frozen-row payload {fz.host_key!r} missing for request "
                f"{req.request_id} (pinned entries cannot be evicted — "
                "refcount/drop discipline bug)")
        payload, tokens, nbytes = fetched
        # admit_start_time stays: the request was admitted once, and the
        # frozen wait falls inside its decode phase.
        row = self.slots.acquire(req.request_id)
        self._admitting_rid = req.request_id
        faults.check("kv_restore", round_idx=self.round_idx,
                     request_id=req.request_id)
        t0 = time.perf_counter()
        with self.tracer.span("serving.thaw", request_id=req.request_id,
                              row=row, filled=fz.filled):
            restore_pages_into_pool(self.page_pool.pages, payload, fresh)
            restore_row_tokens(self._buf, row, tokens)
            self._sync_device()
        dt = time.perf_counter() - t0
        self._admitting_rid = None
        table = self._tables[row]
        table[:] = SINK_PAGE
        table[:need] = fresh
        self._row_pages[row] = [int(p) for p in fresh]
        self._row_slack[row] = need * PAGE - (req.prompt_len + req.steps)
        self._filled[row] = fz.filled
        self._target[row] = fz.target
        self._gens[row] = fz.gen
        self._active[row] = True
        req.row = row
        req.status = "active"
        req.frozen = None
        self.host_tier.drop_row(fz.host_key)
        self.host_tier.record_row_restore(nbytes, dt)
        req.restores += 1
        self._n_resumes += 1
        self.stats.record_resume(req)
        self.scheduler.note_resume(req)
        self.runlog.emit("resume", request_id=req.request_id, row=row,
                         round=self.round_idx, filled=fz.filled,
                         pages=need, bytes=nbytes,
                         frozen_rounds=self.round_idx - fz.preempt_round,
                         restore_s=round(dt, 6))
        return True

    # -- chunked admission --------------------------------------------

    def _admit_chunked(self) -> List[Request]:
        """Claim free rows for queued requests (taking any prefix hit as
        a row copy, a page alias or a host-tier restore, and thawing
        preempted ones), then advance every in-flight prefill by up to
        ``prefill_chunks_per_round`` chunks. A preempting engine first
        frees rows for urgent requests."""
        expired: List[Request] = []
        if self._can_preempt:
            self._preempt_budget = self.scheduler.max_preempts_per_round
            self._preempt_for_urgent()
        while self.slots.n_free:
            faults.check("admission_pop", round_idx=self.round_idx)
            req, dropped = self._pop_ready()
            expired.extend(dropped)
            if req is None:
                break
            if not self._start_prefill(req):
                # Page pressure: the reservation does not fit even after
                # evicting stored prefixes. Back to the queue's head; an
                # urgent request may first free pages by a freeze and
                # retry at once, else retirements free pages and the
                # next round retries.
                self.queue.push_front(req)
                if self._can_preempt and self._preempt_budget > 0:
                    spec = self.scheduler.classes[req.sched_class]
                    if spec.can_preempt and self._preempt_one(spec.rank):
                        continue
                break
        for row, job in sorted(self._prefilling.items()):
            for _ in range(self.prefill_chunks_per_round):
                self._advance_chunk(job)
                if job.done:
                    break
            if job.done:
                with self._submit_lock:  # debug_snapshot reads it
                    del self._prefilling[row]
                self._finish_admission(job)
        self._drop_expired(expired)
        return expired

    def _reserve_pages(self, req: Request):
        """Paged placement: resolve the prefix hit and reserve the
        request's whole page complement (:meth:`_pages_needed`), aliased
        prefix pages first and fresh pages for the rest. With a host tier
        a spilled hit (found here, or adopted from a shared spill dir)
        longer than the resident one by ``restore_min_tokens`` is fetched
        instead: then nothing is aliased, every page is fresh and the
        first hit / PAGE of them receive the payload in
        :meth:`_bind_row_pages`. Returns ``(alias_pages, hit_len,
        fresh_pages, restore)`` (``restore`` None on the resident path),
        or None when the pool cannot fit it even after evicting stored
        prefixes."""
        entry_pages, hit, restore = None, 0, None
        if self.prefix_index is not None and self.host_tier is not None:
            entry_pages, hit, sp_eid, sp_hit = \
                self.prefix_index.lookup_candidates(req.prompt)
            if sp_eid is None and self.host_tier.spill_dir:
                key, plen = self.host_tier.probe(req.prompt)
                if plen and self.prefix_index.adopt(
                        req.prompt, plen, key) is not None:
                    sp_eid, sp_hit = \
                        self.prefix_index.lookup_candidates(req.prompt)[2:]
            if sp_eid is not None and sp_hit >= hit + self.restore_min_tokens:
                fetched = self.host_tier.fetch(
                    self.prefix_index.host_key_of(sp_eid))
                if fetched is None:
                    # The budget dropped the payload: the hit is not real.
                    self.prefix_index.forget(sp_eid)
                else:
                    # Fetched before the eviction below, which cannot
                    # drop it now.
                    payload, nbytes = fetched
                    entry_pages, hit = None, sp_hit
                    restore = {"eid": sp_eid, "hit": sp_hit,
                               "payload": payload, "nbytes": nbytes}
        elif self.prefix_index is not None:
            entry_pages, hit = self.prefix_index.lookup(req.prompt)
        aliased = bool(hit) and restore is None
        need = self._pages_needed(req.prompt_len, req.steps) \
            - (hit // PAGE if aliased else 0)
        if aliased:
            # Pin the aliased pages first: the eviction below may drop the
            # very entry this hit resolved to.
            self.page_pool.ref(entry_pages)
        if self.page_pool.n_free < need and self.prefix_index is not None:
            self.prefix_index.evict_until_free(need)
        fresh = self.page_pool.alloc(need)
        if fresh is None:
            if aliased:
                self.page_pool.unref(entry_pages)
            return None
        return (list(entry_pages) if aliased else []), hit, fresh, restore

    def _bind_row_pages(self, req: Request, row: int, alias_pages,
                        hit: int, fresh, restore=None) -> None:
        """Write the claimed row's page table: the aliased prefix pages
        for chunks [0, hit / PAGE), fresh pages up to the reservation,
        the write sink beyond it. On the resident path no KV byte moves.
        On a restore the first hit / PAGE fresh pages first receive the
        spilled payload (one scatter; its bytes are the tier's to count,
        not ``admission_copy_bytes``) and are pinned into the index."""
        n_total = self._pages_needed(req.prompt_len, req.steps)
        if restore is not None:
            res_pages = [int(p) for p in fresh[:restore["hit"] // PAGE]]
            # A crash mid-restore leaves torn pool and index state that
            # the successor's fresh pool and tier discard wholesale.
            self._admitting_rid = req.request_id
            faults.check("kv_restore", round_idx=self.round_idx,
                         request_id=req.request_id)
            t0 = time.perf_counter()
            with self.tracer.span("serving.kv_restore",
                                  request_id=req.request_id, row=row,
                                  hit_len=restore["hit"]):
                restore_pages_into_pool(self.page_pool.pages,
                                        restore["payload"], res_pages)
                self._sync_device()
            dt = time.perf_counter() - t0
            self.prefix_index.rebind(restore["eid"], res_pages)
            self.host_tier.record_restore(restore["nbytes"], dt)
            req.restores += 1
            self._host_tier_event(
                "restore", request_id=req.request_id,
                length=restore["hit"], bytes=restore["nbytes"],
                restore_s=round(dt, 6))
            self._admitting_rid = None
        elif hit:
            # The contiguous copy's fault site, at the aliasing here: a
            # crash leaves the aliased pages pinned with no owning row.
            self._admitting_rid = req.request_id
            faults.check("prefix_copy", round_idx=self.round_idx,
                         request_id=req.request_id)
            self._admitting_rid = None
        held = [int(p) for p in alias_pages] + [int(p) for p in fresh]
        table = self._tables[row]
        table[:] = SINK_PAGE
        table[:n_total] = held
        self._row_pages[row] = held
        self._row_slack[row] = n_total * PAGE - (req.prompt_len
                                                + req.steps)

    def _start_prefill(self, req: Request) -> bool:
        """Claim a row and start a chunked admission, or thaw a preempted
        request. Returns False, with nothing claimed, when the paged
        reservation cannot be placed."""
        if req.frozen is not None:
            return self._thaw_frozen(req)
        hit = 0
        if self.paged:
            placed = self._reserve_pages(req)
            if placed is None:
                return False
            alias_pages, hit, fresh, restore = placed
            req.admit_start_time = time.perf_counter()
            row = self.slots.acquire(req.request_id)
            self._bind_row_pages(req, row, alias_pages, hit, fresh,
                                 restore=restore)
            if self.prefix_index is not None:
                self.prefix_index.record(hit)
                self.stats.record_prefix_lookup(hit, req.prompt_len)
                # A paged hit admits by writing a page table: 0 bytes.
                self.stats.record_admission_copy(0, zero_copy=bool(hit))
        else:
            req.admit_start_time = time.perf_counter()
            row = self.slots.acquire(req.request_id)
            if self.prefix_cache is not None:
                hit_row, hit = self.prefix_cache.lookup(req.prompt)
                if hit:
                    self._copy_prefix(req, row, hit_row, hit)
                self.stats.record_prefix_lookup(hit, req.prompt_len)
        self._arm_prefill_job(req, row, hit)
        return True

    def _copy_prefix(self, req: Request, row: int, hit_row: int,
                     hit: int) -> None:
        """A contiguous prefix hit: the donor's slots [0, hit) land in the
        claimed row as one in-place copy."""
        t0 = time.perf_counter()
        self._admitting_rid = req.request_id
        faults.check("prefix_copy", round_idx=self.round_idx,
                     request_id=req.request_id)
        with self.tracer.span("serving.prefix_copy",
                              request_id=req.request_id, row=row,
                              hit_len=hit):
            self.prefix_cache.load_into(self._cache, row, hit_row, hit)
        self._admitting_rid = None
        req.prefix_copy_s = time.perf_counter() - t0
        # The copy's bytes: the admission cost at tail 0 is exactly its
        # read and write traffic.
        copy_bytes = cm.admission_cost(
            self.cfg, hit, hit_len=hit,
            param_itemsize=self._cache[0]["k"].element_size())[1]
        self.stats.calibration.record("copy", copy_bytes, req.prefix_copy_s)
        self.stats.record_admission_copy(copy_bytes)

    def _arm_prefill_job(self, req: Request, row: int, hit: int) -> None:
        """Shared chunked arming: park the row's frozen feed and record
        the job. A mid-prefill row rides through decode rounds frozen, and
        its fixed-point rewrite lands at slot ``filled - 1``; the free-row
        default (filled = 1) would put it at slot 0, which the chunks have
        made live. The buffer's last slot is dead instead (decode writes
        position max_len - 1 before the only step that can attend it)."""
        self._filled[row] = self.cfg.max_len
        job = _PrefillJob(
            req=req, row=row,
            prompt=torch.as_tensor(req.prompt, dtype=torch.long,
                                   device=self.device),
            pos=hit, hit_len=hit, gen=self._request_generator(req),
            start_round=self.round_idx)
        with self._submit_lock:  # debug_snapshot reads it
            self._prefilling[row] = job
        self.runlog.emit("prefill_start", request_id=req.request_id,
                         row=row, round=self.round_idx,
                         prompt_len=req.prompt_len, prefix_hit_len=hit)

    def _advance_chunk(self, job: _PrefillJob) -> None:
        """Prefill the job's next chunk (padded to its 16-bucket)."""
        req = job.req
        s = req.prompt_len
        c0 = job.pos
        c1 = min(c0 + self.prefill_chunk, s)
        seg = pad_to_multiple(job.prompt[c0:c1], 0, ADMISSION_BUCKET)
        final = c1 == s
        t0 = time.perf_counter()
        self._admitting_rid = req.request_id
        faults.check("prefill_chunk", round_idx=self.round_idx,
                     request_id=req.request_id)
        with self.tracer.span("serving.admit_chunk",
                              request_id=req.request_id, row=job.row,
                              start=c0, chunk_len=c1 - c0, final=final):
            if self.paged:
                table = torch.as_tensor(self._tables[job.row],
                                        device=self.device)
                self._fns.chunk_paged(
                    self._run_params, self.page_pool.pages, self._buf,
                    job.row, table, seg, c0, c1 - c0, job.prompt, s,
                    self.cfg, temperature=self.temperature,
                    generator=job.gen, final=final)
            else:
                self._fns.chunk(
                    self._run_params, self._cache, self._buf, job.row, seg,
                    c0, c1 - c0, job.prompt, s, self.cfg,
                    temperature=self.temperature, generator=job.gen,
                    final=final)
        self._admitting_rid = None
        dt = time.perf_counter() - t0
        req.prefill_s += dt
        # The [c0, c1) wedge: the admission model at prompt c1, hit c0.
        self.stats.calibration.record(
            "prefill", cm.admission_cost(self.cfg, c1, hit_len=c0)[0], dt)
        job.pos = c1
        job.chunks += 1
        job.done = final

    def _finish_admission(self, job: _PrefillJob) -> None:
        req, row = job.req, job.row
        self._activate_row(req, row, job.gen)
        if self.prefix_index is not None:
            # Zero-copy store: pin the row's own prefix pages.
            self.prefix_index.store(
                req.prompt, self._tables[row][:req.prompt_len // PAGE])
        elif self.prefix_cache is not None:
            # The row holds the chunk path's K/V for the whole prompt:
            # store its 16-aligned prefix for later admissions to copy.
            self.prefix_cache.store_from(self._cache, row, req.prompt)
        self.runlog.emit(
            "admit", request_id=req.request_id, row=row,
            round=self.round_idx, prompt_len=req.prompt_len,
            wait_rounds=self.round_idx - req.submit_round,
            prefill_rounds=self.round_idx - job.start_round + 1,
            chunks=job.chunks, prefix_hit_len=job.hit_len,
            queue_depth=len(self.queue))

    # -- the decode round ---------------------------------------------

    def _sample_rows(self, logits, done_host: np.ndarray):
        """Next token per row: greedy argmax, or each live row from its
        own request's generator (a frozen row's stream does not advance;
        its sample is discarded by the caller)."""
        nxt = torch.argmax(logits, dim=-1)
        if self.temperature > 0.0:
            for r in np.flatnonzero(~done_host):
                nxt[r] = tr._sample(logits[r:r + 1], self.temperature,
                                    self._gens[r])[0]
        return nxt

    def _decode_fn(self):
        """The round's decode step, ``(tokens (B, C), pos (B,)) -> logits
        (B, C, vocab)`` (C = 1, or the draft length), over the cache or
        the page pool (tables pushed once: pages are reserved at
        admission, so a round never allocates)."""
        if self.paged:
            tables = torch.as_tensor(self._tables, device=self.device)
            return lambda tok, pos: self._fns.decode_paged(
                self._run_params, self.page_pool.pages, tables, tok, pos,
                self.cfg)[0]
        return lambda tok, pos: self._fns.decode(
            self._run_params, self._cache, tok, pos, self.cfg)[0]

    def _round_loop(self, done0: np.ndarray):
        """One bounded decode round over the whole batch (the JAX
        package's ``_decode_round_impl``/``_round_loop``). Returns host
        copies ``(filled, done, iters, live)`` with ``live`` the per-row
        count of live iterations. The cache (or pool) and token buffer
        are updated in place."""
        dev = self.device
        decode = self._decode_fn()
        rows = torch.arange(self.batch, device=dev)
        filled = torch.as_tensor(self._filled, device=dev)
        target = torch.as_tensor(self._target, device=dev)
        tok = self._buf[rows, filled - 1]
        # Freeze at entry: a row admitted already at target (steps == 1)
        # or whose last token is eos must not decode.
        done = torch.as_tensor(done0, device=dev) | (filled >= target)
        if self.eos_id is not None:
            done = done | (tok == self.eos_id)
        live = torch.zeros(self.batch, dtype=torch.long, device=dev)
        iters = 0
        while iters < self.round_steps:
            done_host = done.cpu().numpy()  # the one host sync per step
            if done_host.all():
                break
            logits = decode(tok[:, None], filled - 1)
            nxt = self._sample_rows(logits[:, 0], done_host)
            nxt = torch.where(done, tok, nxt)
            # Frozen rows rewrite their last token in place (dead, fixed
            # point); live rows append at ``filled`` (< target <= L).
            self._buf[rows, torch.where(done, filled - 1, filled)] = nxt
            live += (~done).long()
            filled = torch.where(done, filled, filled + 1)
            done = done | (filled >= target)
            if self.eos_id is not None:
                done = done | (nxt == self.eos_id)
            tok = nxt
            iters += 1
        return (filled.cpu().numpy(), done.cpu().numpy(), iters,
                live.cpu().numpy())

    def _spec_round_loop(self, done0: np.ndarray, draft_len: int):
        """One bounded SPECULATIVE round (the JAX package's
        ``_spec_round_loop``): each iteration drafts a (B, C) chunk a row
        (``transformer._prompt_lookup_draft``, history-masked so a draft
        reads only the row's own committed tokens), verifies the whole
        batch in one decode call and advances each live row by its own
        count. Returns host copies ``(filled, done, iters, live, drafted,
        accepted)``; ``iters`` counts verify chunks.

        * Frozen rows draft the repeat-last chunk at base ``min(filled -
          1, total - C)`` (a row parked at ``filled == max_len`` mid
          prefill writes in bounds); base's rewrite is a fixed point and
          the rest lands past the row's output span or is rewritten
          before it is read.
        * A live row commits ``adv = min(m + 1, eos_cut, target -
          filled)``: the accepted drafts plus the correction (or the
          sampled bonus), cut after an emitted eos, clamped at target.
        * Sampling runs ``transformer._spec_emit`` on each live row from
          its request's generator; frozen rows draw nothing.
        * The ledger: a live chunk adds C - 1 to ``drafted`` and ``adv -
          1`` to ``accepted``, so ``emitted == 1 + live_iters +
          spec_accepted`` a request."""
        dev = self.device
        decode = self._decode_fn()
        buf = self._buf
        total = buf.shape[1]
        rows = torch.arange(self.batch, device=dev)
        cols = torch.arange(draft_len, device=dev)
        filled = torch.as_tensor(self._filled, device=dev)
        target = torch.as_tensor(self._target, device=dev)
        done = torch.as_tensor(done0, device=dev)
        live = torch.zeros(self.batch, dtype=torch.long, device=dev)
        drafted = torch.zeros_like(live)
        accepted = torch.zeros_like(live)
        iters = 0
        while iters < self.round_steps:
            tok = buf[rows, filled - 1]
            # Freeze at entry, as the one-token round: at-target rows and
            # rows whose last token is eos must not decode.
            done = done | (filled >= target)
            if self.eos_id is not None:
                done = done | (tok == self.eos_id)
            done_host = done.cpu().numpy()  # the one host sync a chunk
            if done_host.all():
                break
            chunk = tr._prompt_lookup_draft(buf, filled, done, draft_len,
                                            self.spec_ngram,
                                            mask_history=True)
            base = torch.clamp(filled - 1, max=total - draft_len)
            logits = decode(chunk, base).to(torch.float32)
            emit, m = tr._greedy_accept(logits, chunk)
            if self.temperature > 0.0:
                lp = torch.log_softmax(logits / self.temperature, dim=-1)
                for r in np.flatnonzero(~done_host):
                    emit[r], m[r] = tr._spec_emit(lp[r], chunk[r, 1:],
                                                  self._gens[r])
            adv = m + 1
            if self.eos_id is not None:
                is_eos = emit == self.eos_id
                cut = torch.where(is_eos.any(dim=1),
                                  torch.argmax(is_eos.to(torch.int8), dim=1)
                                  + 1, draft_len)
                adv = torch.minimum(adv, cut)
            adv = torch.where(done, 0, torch.minimum(adv, target - filled))
            emit = torch.where(done[:, None], tok[:, None], emit)
            start = torch.where(done, base, filled)
            buf[rows[:, None], start[:, None] + cols] = emit
            live += (~done).long()
            drafted += torch.where(done, 0, draft_len - 1)
            accepted += torch.where(done, 0, adv - 1)
            filled = filled + adv
            done = done | (filled >= target)
            iters += 1
        if self.eos_id is not None:
            # An eos committed on the round's last chunk retires now.
            done = done | (buf[rows, filled - 1] == self.eos_id)
        return (filled.cpu().numpy(), done.cpu().numpy(), iters,
                live.cpu().numpy(), drafted.cpu().numpy(),
                accepted.cpu().numpy())

    def _retire(self, filled: np.ndarray, done: np.ndarray) -> List[Request]:
        """Free finished rows and extract their outputs (eos-padded past
        the emitted span, as ``generate`` returns them)."""
        finished: List[Request] = []
        rows = [r for r in self.slots.occupied_rows()
                if done[r] and self._active[r]]
        if not rows:
            return finished
        with self.tracer.span("serving.retire", rows=len(rows)):
            buf_host = self._buf.cpu().numpy()
        with self._submit_lock:
            owners = {row: self.requests[self.slots.owner_of(row)]
                      for row in rows}
        for row in rows:
            req = owners[row]
            s = req.prompt_len
            out = buf_host[row, s:s + req.steps].copy()
            emitted = min(int(filled[row]) - s, req.steps)
            if self.eos_id is not None and emitted < req.steps:
                out[emitted:] = self.eos_id
            req.tokens = out
            req.emitted = emitted
            req.status = "done"
            req.finish_round = self.round_idx
            req.finish_time = time.perf_counter()
            self._release_row(row)
            self.stats.record_completion(req)
            self.runlog.emit(
                "complete", request_id=req.request_id, row=row,
                emitted=req.emitted, live_iters=req.live_iters,
                submit_t=req.submit_time, admit_t=req.admit_time,
                finish_t=req.finish_time,
                rounds=req.finish_round - req.admit_round + 1,
                phases={k: round(v, 6) for k, v in req.phases().items()})
            with self._submit_lock:
                del self.requests[req.request_id]
            self._retired_pending.append(req)  # crash-safe until returned
            finished.append(req)
        return finished

    def _release_row(self, row: int) -> None:
        """Free a retiring or frozen row: its slot, its decode state and,
        paged, every page reference it held (aliased prefix pages and
        private ones; pages a store pinned stay live). The table goes back
        to the sink, so the free row's frozen feed stays dead."""
        self._active[row] = False
        self._target[row] = 0
        self._gens[row] = None
        self.slots.release(row)
        if self.paged:
            self.page_pool.unref(self._row_pages.pop(row))
            self._row_slack.pop(row, None)
            self._tables[row] = SINK_PAGE

    @torch.no_grad()
    def step(self) -> List[Request]:
        """One scheduling round: admit into free rows, decode one bounded
        round, retire finished rows. Returns the requests that finished
        (or timed out) this round."""
        admitted0 = self.stats.n_admitted
        t_round0 = time.perf_counter()
        with self.tracer.span("serving.round", round=self.round_idx):
            expired = self._admit()
            # Free and mid-prefill rows are inactive: frozen all round.
            done0 = ~self._active | (self._filled >= self._target)
            t_dec0 = time.perf_counter()
            faults.check("decode_round", round_idx=self.round_idx)
            # The draft length this round runs (the adaptive pick below
            # sets the next round's).
            c_used = self._draft_len
            with self.tracer.span("serving.decode_round",
                                  occupied=self.slots.n_occupied):
                if self.spec:
                    filled, done, iters, live, drafted, accepted = \
                        self._spec_round_loop(done0, c_used)
                else:
                    filled, done, iters, live = self._round_loop(done0)
            filled = faults.corrupt("decode_round", filled,
                                    round_idx=self.round_idx)
            decode_s = time.perf_counter() - t_dec0
            if iters:
                flops = self._spec_flops[c_used] if self.spec \
                    else self._decode_flops
                self.stats.calibration.record("decode", iters * flops,
                                              decode_s)
            self._filled = np.array(filled, np.int64)
            # Every legal row sits in [1, max_len]; anything else means
            # the device round-trip cannot be trusted.
            if ((self._filled < 1)
                    | (self._filled > self.cfg.max_len)).any():
                raise faults.EngineStateCorrupt(
                    f"round {self.round_idx}: fetched filled counters "
                    f"outside [1, {self.cfg.max_len}]: "
                    f"{self._filled.tolist()}")
            with self._submit_lock:
                for row in self.slots.occupied_rows():
                    req = self.requests[self.slots.owner_of(row)]
                    req.live_iters += int(live[row])
                    if self.spec:
                        req.spec_drafted += int(drafted[row])
                        req.spec_accepted += int(accepted[row])
            occupied = self.slots.n_occupied
            self.stats.record_round(self.round_idx, iters,
                                    occupied=occupied,
                                    live_iters=int(live.sum()))
            spec_fields = self._spec_fields(drafted, accepted, c_used) \
                if self.spec else {}
            finished = self._retire(self._filled, done)
        self.metrics.gauge("serving_queue_depth").set(len(self.queue))
        live_sum = int(live.sum())
        if self.scheduler is not None:
            self.scheduler.mirror_queued()
        faults.check("runlog_emit", round_idx=self.round_idx)
        self.runlog.emit(
            "round", round=self.round_idx, iters=iters, occupied=occupied,
            live_iters=live_sum,
            admitted=self.stats.n_admitted - admitted0,
            retired=len(finished), expired=len(expired),
            prefilling=len(self._prefilling),
            queue_depth=len(self.queue),
            wasted_row_iters=iters * self.batch - live_sum,
            round_s=round(time.perf_counter() - t_round0, 6),
            decode_s=round(decode_s, 6),
            drift_decode=round(self.stats.calibration.drift("decode"), 4),
            **self._page_fields(), **spec_fields, **self._sched_fields(),
            **self._take_matrix_quanta())
        self.round_idx += 1
        # Ownership passes out through the return: nothing is left for a
        # crash to strand.
        self._retired_pending = []
        return expired + finished

    def note_matrix_quanta(self, n: int) -> None:
        """Driver-thread hook (``EngineFrontend``): credit ``n`` matrix
        quanta to the next round event."""
        self._matrix_quanta += int(n)

    def _take_matrix_quanta(self) -> dict:
        mq, self._matrix_quanta = self._matrix_quanta, 0
        return {"matrix_quanta": mq} if mq else {}

    def _spec_fields(self, drafted: np.ndarray, accepted: np.ndarray,
                     c_used: int) -> dict:
        """Record a speculative round's acceptance, pick the next round's
        draft length from the acceptance EWMA (``spec_adaptive``), and
        return the round event's spec fields."""
        d_sum = int(drafted.sum())
        a_sum = int(accepted.sum())
        if d_sum:
            self.stats.record_spec_round(d_sum, a_sum, c_used)
            if self.spec_adaptive:
                self._draft_len = cm.pick_draft_len(
                    self.stats.spec_accept_rate(), self.spec_draft_lens,
                    self.cfg, self.batch)
        return dict(draft_len=c_used, spec_drafted=d_sum,
                    spec_accepted=a_sum,
                    accept_rate=round(a_sum / d_sum, 4) if d_sum else 0.0)

    def _page_fields(self) -> dict:
        """The round event's page ledger (paged engines): occupancy and
        aliasing from the pool, and internal fragmentation, the slack
        slots of each reservation's last page over the slots of the used
        pages (mirrored as a gauge)."""
        if not self.paged:
            return {}
        ps = self.page_pool.summary()
        used = ps["kv_pages_used"]
        frag = sum(self._row_slack.values()) / (PAGE * used) if used \
            else 0.0
        self.metrics.gauge(
            "serving_kv_page_fragmentation",
            help="unusable slack slots / slots in used KV pages").set(
            round(frag, 4))
        out = dict(pages_used=used, pages_free=ps["kv_pages_free"],
                   pages_aliased=ps["kv_pages_aliased"],
                   page_fragmentation=round(frag, 4))
        if self.host_tier is not None:
            # The tier's spills and restores since the last round event.
            ts = self.host_tier.summary()
            out.update(spills=ts["spills"] - self._host_spills0,
                       restores=ts["restores"] - self._host_restores0,
                       host_bytes=ts["host_bytes"],
                       host_entries=ts["host_entries"])
            self._host_spills0 = ts["spills"]
            self._host_restores0 = ts["restores"]
        return out

    def _sched_fields(self) -> dict:
        """The round event's freezes and thaws since the last one, and
        the bytes of pinned rows (scheduler engines)."""
        if self.scheduler is None:
            return {}
        out = dict(preempts=self._n_preempts - self._preempts0,
                   resumes=self._n_resumes - self._resumes0)
        self._preempts0 = self._n_preempts
        self._resumes0 = self._n_resumes
        if self.host_tier is not None:
            out["host_row_bytes"] = self.host_tier.summary()[
                "host_row_bytes"]
        return out

    def run(self, max_rounds: int = 10_000) -> List[Request]:
        """Step until the queue and every slot are empty; returns every
        request finished along the way. On a closed queue the empty exit
        is terminal: one ``drain_complete`` event carries the final
        ledger and the run log is flushed. Exceeding ``max_rounds``
        raises RuntimeError with the finished requests attached as
        ``err.finished``."""
        out: List[Request] = []
        rounds = 0
        while len(self.queue) or self.slots.n_occupied:
            if rounds >= max_rounds:
                err = RuntimeError(
                    f"run() exceeded max_rounds={max_rounds} with "
                    f"{len(self.queue)} queued / {self.slots.n_occupied} "
                    f"active ({len(out)} finished requests attached as "
                    "err.finished)")
                err.finished = out
                raise err
            out.extend(self.step())
            rounds += 1
        self._seal_drain()
        return out

    def _seal_drain(self) -> None:
        """Once the queue is closed and it and the slots are empty, emit
        the terminal ``drain_complete`` event (the final ledger attached)
        and flush the run log, exactly once. Shared by :meth:`run` and the
        frontend's driver loop, which steps the engine itself; a no-op
        while work remains or the queue is open."""
        if (not self.queue.closed or self._drain_reported
                or len(self.queue) or self.slots.n_occupied):
            return
        self._drain_reported = True
        self.runlog.emit("drain_complete", round=self.round_idx,
                         ledger=self.stats.summary())
        self.runlog.flush()

    def drain(self, max_rounds: int = 10_000) -> List[Request]:
        """Graceful drain in one call: ``close()`` then ``run()``."""
        self.close()
        return self.run(max_rounds=max_rounds)

    # -- supervised restart (serving/frontend.py) ----------------------

    def spawn_successor(self) -> "ServingEngine":
        """A fresh engine that continues this one's serving lifetime after
        a crash: the same params, config, knobs and seed (so every
        request's sampling stream, seeded from its id, replays), the same
        tracer, run log, registry and ``stats`` ledger, and device state
        built from scratch: a fresh cache or page pool and prefix index, a
        fresh host tier (a ``host_kv_dir``'s files survive and are adopted
        again), a fresh ``PrefixCache`` of the same size, a scheduler with
        the same policy and empty heaps. A TP engine's successor derives
        its sharded run params from ``self.params`` again. Id allocation,
        the round index (one past the crashed round) and the adaptive
        draft length carry over; a closed queue stays closed. It reads
        only host values of this engine, so it may follow
        :meth:`release` (the supervisor's order: one incarnation's device
        state at a time)."""
        pc = self.prefix_cache
        new_pc = None if pc is None else PrefixCache(
            self.cfg, pool_rows=pc.pool_rows, registry=pc._registry,
            device=self.device)
        eng = ServingEngine(
            self.params, self.cfg, batch=self.batch,
            round_steps=self.round_steps,
            max_pending=self.queue.max_pending,
            temperature=self.temperature, eos_id=self.eos_id,
            seed=self._seed, tracer=self.tracer, runlog=self.runlog,
            metrics_registry=self.metrics, stats=self.stats,
            prefill_chunk=self.prefill_chunk, prefix_cache=new_pc,
            prefill_chunks_per_round=self.prefill_chunks_per_round,
            kv_pages=self.kv_pages, prefix_sharing=self.prefix_sharing,
            spec_draft_lens=self.spec_draft_lens if self.spec else None,
            spec_ngram=self.spec_ngram, spec_adaptive=self.spec_adaptive,
            host_kv_bytes=self.host_kv_bytes, host_kv_dir=self.host_kv_dir,
            restore_min_tokens=(self.restore_min_tokens if self.host_kv
                                else None),
            scheduler=(self.scheduler.spawn_successor()
                       if self.scheduler is not None else None),
            device=self.devices if self.tp > 1 else self.device)
        eng._next_id = self._next_id
        eng.round_idx = self.round_idx + 1
        if self.spec:
            # The shared ledger holds the acceptance EWMA it was picked by.
            eng._draft_len = self._draft_len
        if self.queue.closed:
            eng.queue.close()
        return eng

    def release(self) -> None:
        """Drop this engine's device state and its storage layers: the
        cache or page pool, the token buffer, the run params, the prefix
        index, host tier, the prefix cache's pool, the generators and the
        in-flight prefill jobs. The supervisor calls it on a crashed
        engine before it builds the successor, so a recovery never holds
        two caches (the crash's traceback still refers to the engine).
        The engine cannot step afterwards, nor can its ``PrefixCache``;
        :meth:`spawn_successor` still works."""
        with self._submit_lock:
            self._prefilling = {}
        self._cache = None
        self._buf = None
        self._run_params = None
        self._gens = [None] * self.batch
        if self.stats.page_pool is self.page_pool:  # the shared ledger's
            self.stats.page_pool = None
        self.page_pool = None
        self.prefix_index = None
        self.host_tier = None
        if self.prefix_cache is not None:
            self.prefix_cache.pool = None

    def requeue(self, reqs: List[Request],
                crash_time: Optional[float] = None) -> int:
        """Take back a crashed predecessor's requests in request-id
        order, each reset to pristine ``pending`` (``Request.
        reset_for_requeue``) with its id, deadlines and submit stamp, past
        the backpressure cap (``AdmissionQueue.restore``). Returns the
        count."""
        now = crash_time if crash_time is not None else time.perf_counter()
        ordered = sorted(reqs, key=lambda r: r.request_id)
        with self._submit_lock:
            for req in ordered:
                req.reset_for_requeue(now)
                self.queue.restore(req)
                self.requests[req.request_id] = req
        for req in ordered:
            self.stats.record_recovery(req)
            self.runlog.emit("recover", request_id=req.request_id,
                             round=self.round_idx,
                             crash_count=req.crash_count,
                             requeues=req.requeues,
                             recovery_s=round(req.recovery_s, 6))
        self.metrics.gauge("serving_queue_depth").set(len(self.queue))
        return len(ordered)

    # -- debug introspection (any thread) -------------------------------

    def debug_snapshot(self) -> dict:
        """The engine's state now: occupancy, queue depth, requests,
        in-flight prefills, the stats and calibration ledgers and the
        storage summaries. Any thread: the shared dicts are read under
        ``_submit_lock``; the scalars may lag by a round."""
        with self._submit_lock:
            requests = {
                int(rid): {"status": req.status, "row": req.row,
                           "prompt_len": req.prompt_len,
                           "steps": req.steps}
                for rid, req in self.requests.items()}
            prefilling = [
                {"request_id": job.req.request_id, "row": row,
                 "pos": job.pos, "prompt_len": job.req.prompt_len,
                 "hit_len": job.hit_len, "chunks": job.chunks,
                 "start_round": job.start_round}
                for row, job in self._prefilling.items()]
        out = {
            "round": self.round_idx,
            "batch": self.batch,
            "round_steps": self.round_steps,
            "tp_degree": self.tp,
            "tp_mode": self.cfg.tp_mode if self.tp > 1 else None,
            "occupied": self.slots.n_occupied,
            "queue_depth": len(self.queue),
            "queue_closed": self.queue.closed,
            "requests": requests,
            "prefilling": prefilling,
            "stats": self.stats.summary(),
            "cost_model_drift": self.stats.calibration.summary(),
        }
        if self.spec:
            out["spec"] = {
                "draft_lens": list(self.spec_draft_lens),
                "draft_len": self._draft_len,
                "ngram": self.spec_ngram,
                "adaptive": self.spec_adaptive,
                "accept_rate": round(self.stats.spec_accept_rate(), 4),
            }
        if self.prefix_cache is not None:
            out["prefix_pool"] = self.prefix_cache.summary()
        if self.page_pool is not None:
            out["kv_pages"] = self.page_pool.summary()
            if self.prefix_index is not None:
                out["prefix_index"] = self.prefix_index.summary()
            if self.host_tier is not None:
                out["host_tier"] = dict(
                    self.host_tier.summary(),
                    restore_min_tokens=self.restore_min_tokens)
        return out

    def debug_request(self, request_id: int) -> Optional[dict]:
        """One request's timeline: a live one's phases so far, or a
        finished one's record from the stats ledger's completion window;
        None for an unknown id (or one fallen out of the window)."""
        with self._submit_lock:
            req = self.requests.get(request_id)
            if req is not None:
                return {"request_id": req.request_id,
                        "status": req.status, "row": req.row,
                        "prompt_len": req.prompt_len, "steps": req.steps,
                        "live_iters": req.live_iters,
                        "phases": req.phases(),
                        "age_s": time.perf_counter() - req.submit_time}
        for rec in reversed(self.stats.completed_snapshot()):
            if rec["request_id"] == request_id:
                return dict(rec)
        return None

    def debug_sched(self) -> Optional[dict]:
        """The scheduler's state: its class table, the rows a class
        holds, lifetime freezes and thaws, every request frozen now and
        the tier's pinned rows. None on a FIFO engine."""
        if self.scheduler is None:
            return None
        out = self.scheduler.summary()
        out["occupancy"] = self._class_occupancy()
        out["can_preempt"] = self._can_preempt
        out["preempts"] = self._n_preempts
        out["resumes"] = self._n_resumes
        frozen = []
        with self._submit_lock:
            for req in self.requests.values():
                fz = req.frozen
                if fz is None:
                    continue
                frozen.append({
                    "request_id": req.request_id,
                    "sched_class": req.sched_class,
                    "tenant": req.tenant,
                    "filled": fz.filled, "target": fz.target,
                    "pages": fz.n_pages, "bytes": fz.nbytes,
                    "preempt_round": fz.preempt_round,
                    "preempt_count": req.preempt_count})
        out["frozen"] = sorted(frozen, key=lambda d: d["request_id"])
        if self.host_tier is not None:
            ts = self.host_tier.summary()
            out["host_rows"] = ts["host_rows"]
            out["host_row_bytes"] = ts["host_row_bytes"]
        return out
