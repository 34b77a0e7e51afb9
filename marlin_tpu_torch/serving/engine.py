"""Continuous-batching serving engine — port of
``marlin_tpu/serving/engine.py`` in its default discipline: a contiguous
per-row KV cache, one-shot admission prefill through the flash kernel
(:func:`.slots.prefill_into_row`), FIFO admission, greedy or temperature
sampling, ``eos_id`` and deadlines.

Decode runs in bounded ROUNDS of at most ``round_steps`` iterations over
the whole batch; between rounds the engine retires finished rows and
admits queued requests into the freed rows. Within a round every row
feeds its last token at its own position (``decode_chunk`` at C=1 with
per-row positions); rows that reach their target or emit ``eos_id``
freeze, and a frozen row re-feeds its last token at its last position —
a fixed point that writes only dead state. The loop's exit test is one
device-to-host copy of the (B,) ``done`` flags per iteration; JAX ran the
same loop as a ``lax.while_loop`` on the device.

Sampling at ``temperature > 0`` draws each request's tokens from its own
``torch.Generator``, seeded from (engine seed, request id) and advanced
only on the request's live iterations, so sampled outputs do not depend
on batch composition or arrival pattern.

Options of the JAX engine outside this discipline (chunked admission,
the prefix cache, paged KV, speculative rounds, the host KV tier, the
scheduler, tensor parallelism) raise ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import transformer as tr
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.runlog import RunLog
from ..utils import cost_model as cm
from ..utils.hw import resolve_device
from . import faults
from .queue import AdmissionQueue, Request
from .slots import SlotManager, pad_prompt_len, prefill_into_row
from .stats import EngineStats

# The JAX engine's other options, with their defaults: any other value
# selects a discipline this port does not carry yet (ROADMAP Queue A1).
_UNPORTED_OPTIONS = {
    "prefill_chunk": (None, "chunked admission"),
    "prefix_cache": (None, "the prefix cache"),
    "prefill_chunks_per_round": (2, "chunked admission"),
    "kv_pages": (None, "paged KV"),
    "prefix_sharing": (True, "paged prefix sharing"),
    "spec_draft_lens": (None, "speculative rounds"),
    "spec_ngram": (2, "speculative rounds"),
    "spec_adaptive": (True, "speculative rounds"),
    "host_kv_bytes": (None, "the host KV tier"),
    "host_kv_dir": (None, "the host KV tier"),
    "restore_min_tokens": (None, "the host KV tier"),
    "scheduler": (None, "SLO scheduling (serving/sched.py)"),
    "stats": (None, "the supervised restart surface"),
}


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
    ``params`` must live on ``device`` (default ``"cuda"``)."""

    def __init__(self, params, cfg, batch: int = 8, round_steps: int = 8,
                 max_pending: int = 64, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 tracer=None, runlog: Optional[RunLog] = None,
                 metrics_registry=None, device="cuda", **options):
        for name, value in options.items():
            if name not in _UNPORTED_OPTIONS:
                raise TypeError(
                    f"ServingEngine got an unexpected option {name!r}")
            default, what = _UNPORTED_OPTIONS[name]
            if value != default:
                raise NotImplementedError(
                    f"ServingEngine({name}={value!r}): {what} is not "
                    f"ported to marlin_tpu_torch yet (ROADMAP Queue A1)")
        if cfg.tp > 1:
            raise NotImplementedError(
                "tensor-parallel serving (serving/tp.py) is not ported to "
                "marlin_tpu_torch yet (ROADMAP Queue A1)")
        tr.check_ported(cfg)
        if cfg.window:
            raise NotImplementedError(
                "serving needs the dense slot==position cache "
                "(cfg.window == 0): a ring cache cannot host per-row "
                "admission overwrites (see decode_chunk)")
        if round_steps < 1:
            raise ValueError(f"round_steps must be >= 1, got {round_steps}")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.round_steps = round_steps
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self._seed = int(seed)
        # Cast once: every later _cast_params on the serving path is a
        # no-op (the JAX entry points re-cast inside each compile). No
        # grad, here and in step(): params may require grad (after
        # make_train_step), and serving must build no graph from them.
        with torch.no_grad():
            self._run_params = tr._cast_params(params, cfg)
        self.queue = AdmissionQueue(max_pending=max_pending)
        self.slots = SlotManager(batch)
        self.tracer = tracer if tracer is not None else obs_trace.tracer
        self.runlog = runlog if runlog is not None else RunLog()
        self.metrics = metrics_registry if metrics_registry is not None \
            else obs_metrics.registry
        self.stats = EngineStats(batch=batch, cfg=cfg,
                                 registry=self.metrics)
        self._next_id = 0
        self.round_idx = 0
        self._decode_flops, _ = cm.decode_step_cost(cfg, batch)
        # Pending + active requests only; finished ones are handed back
        # by step()/run() and dropped here.
        self.requests: Dict[int, Request] = {}
        # Makes id allocation + queue submit + dict insert one unit for
        # concurrent submitters; everything else runs on the stepping thread.
        self._submit_lock = threading.Lock()
        self._drain_reported = False
        # Device state, updated in place by admission and decode. Free
        # rows sit at filled=1 over a zero buffer so their frozen feed
        # (token 0 at position 0) is well-defined dead state.
        self._cache = tr.init_kv_cache(cfg, batch, dtype=cfg.compute_dtype,
                                       device=self.device)
        self._buf = torch.zeros((batch, cfg.max_len), dtype=torch.long,
                                device=self.device)
        self._filled = np.ones((batch,), np.int64)
        self._target = np.zeros((batch,), np.int64)
        self._active = np.zeros((batch,), bool)
        self._gens: List[Optional[torch.Generator]] = [None] * batch
        self.runlog.emit("engine_start", batch=batch,
                         round_steps=round_steps, max_pending=max_pending,
                         max_len=cfg.max_len, device=str(self.device))

    # -- submission ---------------------------------------------------

    def submit(self, prompt, steps: int,
               deadline_rounds: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue one generation request; returns its request id. Raises
        ``QueueFull`` (backpressure), ``QueueClosed`` (draining), or
        ValueError for a request the cache cannot hold. Thread-safe."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        s = int(prompt.shape[0])
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if s + steps > self.cfg.max_len:
            raise ValueError(
                f"prompt {s} + steps {steps} exceeds max_len "
                f"{self.cfg.max_len}")
        if pad_prompt_len(s) > self.cfg.max_len:
            raise ValueError(
                f"padded prompt {pad_prompt_len(s)} exceeds max_len "
                f"{self.cfg.max_len}")
        now = time.perf_counter()
        with self._submit_lock:
            rid = self._next_id
            req = Request(
                request_id=rid, prompt=prompt, steps=int(steps),
                deadline_rounds=deadline_rounds,
                deadline_time=(now + deadline_s
                               if deadline_s is not None else None),
                submit_round=self.round_idx, submit_time=now)
            with self.tracer.span("serving.submit",
                                  request_id=req.request_id):
                self.queue.submit(req)  # raises before anything registers
            self._next_id = rid + 1
            self.requests[rid] = req
        self.metrics.counter("serving_submitted_total").inc()
        self.metrics.gauge("serving_queue_depth").set(len(self.queue))
        self.runlog.emit("submit", request_id=rid, prompt_len=s,
                         steps=int(steps), round=self.round_idx,
                         queue_depth=len(self.queue))
        return rid

    def close(self) -> None:
        """Graceful drain: no new submits; ``run`` finishes queued work."""
        self.queue.close()

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

    def _admit_oneshot(self) -> List[Request]:
        """Fill free rows from the queue, FIFO, each with one flash
        prefill; returns the requests dropped for deadline on the way."""
        expired: List[Request] = []
        while self.slots.n_free:
            faults.check("admission_pop", round_idx=self.round_idx)
            req, dropped = self.queue.pop_ready(self.round_idx)
            expired.extend(dropped)
            if req is None:
                break
            req.admit_start_time = time.perf_counter()
            row = self.slots.acquire(req.request_id)
            gen = self._request_generator(req)
            prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                     device=self.device)
            t0 = time.perf_counter()
            faults.check("prefill_chunk", round_idx=self.round_idx,
                         request_id=req.request_id)
            with self.tracer.span("serving.admit",
                                  request_id=req.request_id, row=row,
                                  prompt_len=req.prompt_len):
                prefill_into_row(self._run_params, self._cache, self._buf,
                                 row, prompt, self.cfg,
                                 temperature=self.temperature,
                                 generator=gen)
            req.prefill_s += time.perf_counter() - t0
            self.stats.calibration.record(
                "prefill", cm.admission_cost(self.cfg, req.prompt_len)[0],
                req.prefill_s)
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
            self.runlog.emit(
                "admit", request_id=req.request_id, row=row,
                round=self.round_idx, prompt_len=s,
                wait_rounds=self.round_idx - req.submit_round,
                queue_depth=len(self.queue))
        self._drop_expired(expired)
        return expired

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

    def _round_loop(self, done0: np.ndarray):
        """One bounded decode round over the whole batch (the JAX
        package's ``_decode_round_impl``/``_round_loop``). Returns host
        copies ``(filled, done, iters, live)`` with ``live`` the per-row
        count of live iterations. The cache and token buffer are updated
        in place."""
        dev = self.device
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
            logits, _ = tr.decode_chunk(self._run_params, self._cache,
                                        tok[:, None], filled - 1, self.cfg)
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
            self._active[row] = False
            self._target[row] = 0
            self._gens[row] = None
            self.slots.release(row)
            self.stats.record_completion(req)
            self.runlog.emit(
                "complete", request_id=req.request_id, row=row,
                emitted=req.emitted, live_iters=req.live_iters,
                rounds=req.finish_round - req.admit_round + 1,
                phases={k: round(v, 6) for k, v in req.phases().items()})
            with self._submit_lock:
                del self.requests[req.request_id]
            finished.append(req)
        return finished

    @torch.no_grad()
    def step(self) -> List[Request]:
        """One scheduling round: admit into free rows, decode one bounded
        round, retire finished rows. Returns the requests that finished
        (or timed out) this round."""
        admitted0 = self.stats.n_admitted
        t_round0 = time.perf_counter()
        with self.tracer.span("serving.round", round=self.round_idx):
            expired = self._admit_oneshot()
            done0 = ~self._active | (self._filled >= self._target)
            t_dec0 = time.perf_counter()
            faults.check("decode_round", round_idx=self.round_idx)
            with self.tracer.span("serving.decode_round",
                                  occupied=self.slots.n_occupied):
                filled, done, iters, live = self._round_loop(done0)
            filled = faults.corrupt("decode_round", filled,
                                    round_idx=self.round_idx)
            decode_s = time.perf_counter() - t_dec0
            if iters:
                self.stats.calibration.record(
                    "decode", iters * self._decode_flops, decode_s)
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
            occupied = self.slots.n_occupied
            self.stats.record_round(self.round_idx, iters,
                                    occupied=occupied,
                                    live_iters=int(live.sum()))
            finished = self._retire(self._filled, done)
        self.metrics.gauge("serving_queue_depth").set(len(self.queue))
        live_sum = int(live.sum())
        faults.check("runlog_emit", round_idx=self.round_idx)
        self.runlog.emit(
            "round", round=self.round_idx, iters=iters, occupied=occupied,
            live_iters=live_sum,
            admitted=self.stats.n_admitted - admitted0,
            retired=len(finished), expired=len(expired),
            queue_depth=len(self.queue),
            wasted_row_iters=iters * self.batch - live_sum,
            round_s=round(time.perf_counter() - t_round0, 6),
            decode_s=round(decode_s, 6),
            drift_decode=round(self.stats.calibration.drift("decode"), 4))
        self.round_idx += 1
        return expired + finished

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
        if self.queue.closed and not self._drain_reported:
            self._drain_reported = True
            self.runlog.emit("drain_complete", round=self.round_idx,
                             ledger=self.stats.summary())
            self.runlog.flush()
        return out

    def drain(self, max_rounds: int = 10_000) -> List[Request]:
        """Graceful drain in one call: ``close()`` then ``run()``."""
        self.close()
        return self.run(max_rounds=max_rounds)
