"""Single-process tensor parallelism over a ``model`` axis of shards —
port of ``marlin_tpu/models/tp.py``.

The JAX package runs the forward *body* under ``shard_map`` over a named
``model`` mesh axis: every device executes the same Python at the LOCAL
extents (``cfg.tp_heads`` / ``cfg.tp_kv_heads`` / ``cfg.tp_ff``), and the
only communication is the collective inside
:func:`.transformer._tp_out`. The port keeps that design in one process:
the ``model`` axis is a tuple of torch devices (:func:`tp_devices`), a
tensor-parallel tree is one tree a shard (:class:`Sharded`), and
:func:`run_shards` runs the UNCHANGED body on every shard, one thread a
shard (as ``torch.nn.parallel.parallel_apply`` does), the shards taking
turns in rank order from one collective to the next. A thread-local
shard context (:func:`current_shard`) gives ``_tp_out`` its collectives,
the counterpart of shard_map's named axis: they concatenate or sum in
rank order, with a timeout on every wait.

Why single-process: the point of this path is bit-exactness (TP = N must
give the TP = 1 bytes), and one card can hold several shards only when
one process owns them (NCCL refuses two ranks on one GPU).
``device=("cuda:0",) * tp`` puts every shard on one card, which checks
the bits but buys no speed.

Parameter layout (gather mode), as the JAX package's ``param_specs``:

====================  ===================  ==========================
leaf                  split                note
====================  ===================  ==========================
wqkv                  columns              PERMUTED so each shard
                                           holds whole heads
                                           ``[q_i | k_i | v_i]``
wo, w1, w2            columns              contiguous column blocks
b1                    rows (1-D)           rides with w1's columns
b2, lns, embed, pos   replicated           bias added post-gather
====================  ===================  ==========================

int8 params shard as ``{"q8", "s8"}`` pairs: block-weight scales are
per-OUTPUT-column ``(1, cols)``, so q8 and s8 travel together and local
dequantization is bit-equal to slicing the globally dequantized matrix.
In psum mode only wo/w2 change: q8 row-sharded, s8 replicated.

KV caches and page pools hold one shard's heads a shard (``init_kv_cache``
sizes them at ``cfg.tp_kv_heads``), the head axis being axis 2 of every
leaf; :func:`shard_cache` and :func:`gather_heads` move between that and
the global layout.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..parallel.shards import shard_devices
from . import transformer as tr
from .quant import is_quantized

# The tensor-parallel axis's name, as the JAX package names its mesh axis.
AXIS = "model"

# Seconds a shard waits for its turn before the run fails (every other
# shard's work up to the next collective comes first).
BARRIER_TIMEOUT_S = 300.0


class Sharded(tuple):
    """One tree a shard of the ``model`` axis, in rank order, with the
    devices the shards live on (``.devices``)."""

    def __new__(cls, trees, devices):
        obj = super().__new__(cls, trees)
        obj.devices = tuple(torch.device(d) for d in devices)
        if len(obj) != len(obj.devices):
            raise ValueError(
                f"{len(obj)} shard trees for {len(obj.devices)} devices")
        return obj


def tp_devices(tp: int, device="cuda") -> tuple:
    """The ``model`` axis's devices for degree ``tp``, the counterpart of
    the JAX package's ``tp_mesh``: :func:`..parallel.shards.shard_devices`
    (a single ``"cuda"`` is ``tp`` cards, a single ``"cpu"`` ``tp`` CPU
    shards, a sequence is taken as given: ``("cuda:0",) * tp`` puts every
    shard on one card)."""
    return shard_devices(tp, device, what="tp")


def qkv_permutation(cfg: tr.TransformerConfig) -> np.ndarray:
    """Column permutation taking the packed ``[Q | K | V]`` wqkv layout to
    per-shard blocks ``[q_0|k_0|v_0 | q_1|k_1|v_1 | ...]`` so a contiguous
    column split hands shard ``i`` whole query heads
    ``[i*H/tp, (i+1)*H/tp)`` plus their matching KV-head group: grouped
    attention then needs no communication."""
    d = cfg.d_model
    dh = d // cfg.n_heads
    hk = cfg.kv_heads
    q_cols = np.arange(cfg.n_heads * dh)
    k_cols = cfg.n_heads * dh + np.arange(hk * dh)
    v_cols = (cfg.n_heads + hk) * dh + np.arange(hk * dh)
    hl, hkl = cfg.tp_heads, cfg.tp_kv_heads
    parts = []
    for i in range(cfg.tp):
        parts.append(q_cols[i * hl * dh:(i + 1) * hl * dh])
        parts.append(k_cols[i * hkl * dh:(i + 1) * hkl * dh])
        parts.append(v_cols[i * hkl * dh:(i + 1) * hkl * dh])
    return np.concatenate(parts)


# Split axes of param_specs: None replicates, 0 splits rows (or a 1-D
# vector), 1 splits columns, QKV splits the permuted wqkv's columns.
QKV = "qkv"


def param_specs(cfg: tr.TransformerConfig, quantized: bool):
    """The split of every leaf of ``init_params``'s tree (and of its int8
    quantization), leaf for leaf: the JAX package's PartitionSpec tree,
    with an axis (or None, or :data:`QKV`) for each spec."""
    rowp = cfg.tp_mode == "psum"
    down_w = 0 if rowp else 1
    # Per-output-column scales cannot follow row-sharded q8 rows; they
    # replicate in psum mode and ride the columns in gather mode.
    down_s = None if rowp else 1

    def w(spec_w, spec_s):
        return {"q8": spec_w, "s8": spec_s} if quantized else spec_w

    ln = {"g": None, "b": None}
    blk = {"ln1": dict(ln), "ln2": dict(ln), "wqkv": w(QKV, QKV),
           "wo": w(down_w, down_s), "w1": w(1, 1), "b1": 0,
           "w2": w(down_w, down_s), "b2": None}
    specs = {"embed": w(None, None), "ln_f": dict(ln),
             "blocks": [dict(blk) for _ in range(cfg.n_layers)]}
    if not cfg.rope:
        specs["pos"] = None
    return specs


def _tree_map2(fn, tree, spec):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree, leaf for leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, spec[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map2(fn, v, s) for v, s in zip(tree, spec))
    return fn(tree, spec)


def tp_shard_params(params, cfg: tr.TransformerConfig, devices=None):
    """Permute wqkv's columns into per-shard head blocks and split every
    leaf per :func:`param_specs`: one param tree a shard, each on its
    device (``devices``, default :func:`tp_devices` of the params'
    device). Takes UNSHARDED params (the engine keeps the original tree
    and derives the run copy once). Replicated leaves are moved with
    ``.to``, so shards on the params' own device share them. Returns
    ``params`` itself at ``tp == 1``."""
    tr.validate_tp(cfg)
    if cfg.tp == 1:
        return params
    devices = tp_devices(cfg.tp, tr.params_device(params)) \
        if devices is None else tuple(devices)
    if len(devices) != cfg.tp:
        raise ValueError(f"{len(devices)} devices for tp {cfg.tp}")
    perm = torch.as_tensor(qkv_permutation(cfg))
    specs = param_specs(cfg, is_quantized(params))

    def shard(r, dev):
        def split(leaf, axis):
            if axis is None:
                return leaf.to(dev)
            if axis == QKV:
                n = perm.shape[0] // cfg.tp
                idx = perm[r * n:(r + 1) * n]
                axis = 1
            else:
                n = leaf.shape[axis] // cfg.tp
                idx = torch.arange(r * n, (r + 1) * n)
            return leaf.index_select(axis, idx.to(leaf.device)).to(dev)

        return _tree_map2(split, params, specs)

    return Sharded([shard(r, d) for r, d in enumerate(devices)], devices)


def per_shard(make: Callable, devices):
    """One tree a shard, each built by ``make(device)`` (a cache, a page
    pool): a :class:`Sharded` on a model axis of several devices, the one
    tree itself on an axis of one (tp 1)."""
    if len(devices) == 1:
        return make(devices[0])
    return Sharded([make(d) for d in devices], devices)


def shard_cache(cache, cfg: tr.TransformerConfig, devices) -> Sharded:
    """Split a KV cache or page tree in the global head layout (heads at
    axis 2 of every leaf: K/V rows, int8 scales, pages) into one tree a
    shard, each on its device."""
    tr.validate_tp(cfg)

    def split(leaf, r, dev):
        n = leaf.shape[2] // cfg.tp
        return leaf[:, :, r * n:(r + 1) * n].contiguous().to(dev)

    return Sharded([tr._tree_map(lambda leaf: split(leaf, r, d), cache)
                    for r, d in enumerate(devices)], devices)


def gather_heads(trees: Sequence, device=None):
    """The inverse of :func:`shard_cache`: one tree in the global head
    layout, each leaf the shards' leaves concatenated on axis 2 in rank
    order (on ``device``, default shard 0's)."""
    first = trees[0]
    leaves = [tr._leaves(t) for t in trees]
    out = []
    for parts in zip(*leaves):
        dev = parts[0].device if device is None else device
        out.append(torch.cat([p.to(dev) for p in parts], dim=2))
    return tr._unflatten(first, iter(out))


def replicate(tree, devices) -> Sharded:
    """One copy of ``tree`` a shard (shards on the tree's own device
    share it): driver-side state every shard reads."""
    return Sharded([tr._tree_map(lambda leaf: leaf.to(d), tree)
                    for d in devices], devices)


# -- the shard runner -------------------------------------------------------

_local = threading.local()


class ShardsOutOfStep(RuntimeError):
    """A shard reached a collective that another shard never reached (it
    returned first, or skipped it), or waited past the run's timeout."""


class _Aborted(Exception):
    """Raised in the shards still waiting when another shard failed."""


class _Run:
    """The shared state of one :func:`run_shards` call. The shards take
    turns in rank order: only the shard whose turn it is runs, up to its
    next collective (or its end), and then hands the turn on. So their
    Python never contends for the interpreter lock (with every shard
    running at once, each op's lock hand-off cost more than the op: a
    decode step of the 5.9 B-parameter TP shape took 1.4 s at TP = 4 on
    the H100), and their launches reach a device in one fixed order."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.timeout = timeout
        self.cond = threading.Condition()
        self.turn = 0
        self.seq = [0] * size  # collectives each shard has entered
        self.done = [False] * size
        self.failed = False
        # Two slot sets, alternated: a shard that runs on to the next
        # collective writes the other set, and it cannot come back to
        # this one before every shard took its turn, reading this one.
        self.slots = ([None] * size, [None] * size)

    def fail(self) -> None:
        self.failed = True
        self.cond.notify_all()

    def wait_turn(self, rank: int) -> None:
        """Block until it is ``rank``'s turn (the caller holds ``cond``)."""
        if not self.cond.wait_for(
                lambda: self.turn == rank or self.failed, self.timeout):
            self.fail()
            raise ShardsOutOfStep(
                f"tensor-parallel shard {rank} waited {self.timeout} s for "
                "its turn")
        if self.failed:
            raise _Aborted()

    def hand_on(self, rank: int) -> None:
        """Give the turn to the next shard still running (the caller holds
        ``cond``)."""
        for step in range(1, self.size + 1):
            nxt = (rank + step) % self.size
            if not self.done[nxt]:
                self.turn = nxt
                break
        self.cond.notify_all()


class ShardContext:
    """One shard's view of a :func:`run_shards` call: its ``rank``, the
    ``size`` of the axis, and the collectives. A collective publishes this
    shard's tensor and hands the turn on; when the turn comes back, every
    shard has published, and it reads them all in rank order (moved to
    this shard's device where they differ: torch orders a copy between
    two cards' current streams)."""

    def __init__(self, rank: int, run: _Run):
        self.rank = rank
        self.size = run.size
        self._run = run

    def _exchange(self, t) -> List[torch.Tensor]:
        run = self._run
        with run.cond:
            s = run.seq[self.rank]
            run.seq[self.rank] = s + 1
            run.slots[s % 2][self.rank] = t
            run.hand_on(self.rank)
            run.wait_turn(self.rank)
            behind = [r for r, n in enumerate(run.seq) if n <= s]
            if behind:
                run.fail()
                raise ShardsOutOfStep(
                    f"tensor-parallel shards out of step: shard "
                    f"{self.rank} reached collective {s}, which shards "
                    f"{behind} never reached")
            parts = list(run.slots[s % 2])
        return [p if p.device == t.device else p.to(t.device) for p in parts]

    def all_gather(self, t, dim: int):
        """Every shard's ``t`` concatenated on ``dim`` in rank order."""
        return torch.cat(self._exchange(t), dim=dim)

    def all_reduce(self, t):
        """The sum of every shard's ``t``, added in rank order."""
        parts = self._exchange(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


def current_shard() -> ShardContext:
    """The calling thread's shard context; raises outside a shard run (a
    ``cfg.tp > 1`` forward called directly instead of through
    :func:`run_shards`)."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "cfg.tp > 1 outside a shard run: call the model through "
            "models.tp (tp_forward, tp_block_outputs, run_shards) or "
            "serving.tp")
    return ctx


def _place(arg, device):
    """A replicated argument on ``device``: tensors moved there (no copy
    when they already are), anything else as it is."""
    if isinstance(arg, torch.Tensor):
        return arg.to(device)
    return arg


def run_shards(fn: Callable, *args, timeout=None) -> list:
    """``fn`` on every shard, one thread a shard (shard 0 on the calling
    thread), with the shard context set: returns the shards' results in
    rank order. A :class:`Sharded` argument hands shard ``r`` its ``r``-th
    tree; any other argument is replicated (a tensor is moved to each
    shard's device). Autograd's mode is the caller's. The shards run in
    turns (:class:`_Run`), switching at each collective.

    A failure in one shard stops the others at their next turn, and the
    caller gets that shard's own exception; shards that fall out of step
    (one returns or skips a collective the others reach) raise
    :class:`ShardsOutOfStep` at once, and a shard that waits for its turn
    longer than ``timeout`` seconds (default :data:`BARRIER_TIMEOUT_S`)
    fails the run. It never hangs and never falls back."""
    sharded = [a for a in args if isinstance(a, Sharded)]
    if not sharded:
        raise ValueError("run_shards needs a Sharded argument")
    devices = sharded[0].devices
    if any(a.devices != devices for a in sharded):
        raise ValueError("run_shards arguments live on different devices")
    if getattr(_local, "ctx", None) is not None:
        raise RuntimeError("run_shards inside a shard run")
    n = len(devices)
    run = _Run(n, BARRIER_TIMEOUT_S if timeout is None else float(timeout))
    results: list = [None] * n
    errors: list = [None] * n
    grad = torch.is_grad_enabled()

    def work(r: int) -> None:
        dev = devices[r]
        _local.ctx = ShardContext(r, run)
        try:
            with run.cond:
                run.wait_turn(r)
            guard = torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext()
            with torch.set_grad_enabled(grad), guard:
                results[r] = fn(*(a[r] if isinstance(a, Sharded)
                                  else _place(a, dev) for a in args))
        except _Aborted:
            pass
        except BaseException as e:  # re-raised in the caller below
            errors[r] = e
            with run.cond:
                run.fail()
        finally:
            _local.ctx = None
            with run.cond:
                run.done[r] = True
                if not run.failed:
                    run.hand_on(r)

    threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                name=f"tp-shard-{r}") for r in range(1, n)]
    for t in threads:
        t.start()
    work(0)
    for t in threads:
        t.join()
    own = [e for e in errors if e is not None]
    if own:
        raise own[0]
    return results


# -- whole-sequence forwards (the test surface) -----------------------------


def _block_outputs(params, tokens, cfg: tr.TransformerConfig):
    """Per-block probe: (attention residual states (B, L, S, D), block
    output states (B, L, S, D), logits): the same math as ``_block``
    with the two intermediate states exposed, so bit-exactness is pinned
    at every layer boundary, not just the logits."""
    params = tr._cast_params(params, cfg)
    x = tr._embed_prefix(params, tokens, cfg)
    b, s, _ = x.shape
    positions = (torch.arange(s, device=x.device).expand(b, s)
                 if cfg.rope else None)
    atts, outs = [], []
    for bp in params["blocks"]:
        q, k, v = tr._split_qkv(bp, x, cfg, positions=positions)
        att = tr._attend_local(q, k, v, cfg).reshape(b, s, -1)
        x = x + tr._tp_out(att, bp["wo"], cfg)
        atts.append(x)
        x = tr._mlp_residual(bp, x, cfg)
        outs.append(x)
    h = tr._layer_norm(params["ln_f"], x)
    return torch.stack(atts, 1), torch.stack(outs, 1), tr._readout(params, h)


def _tp_run(body, params, tokens, cfg: tr.TransformerConfig, device):
    """``body(params, tokens, cfg)`` at ``cfg.tp``: the plain call at tp 1,
    else on params sharded over :func:`tp_devices` of ``device`` (default
    the params' device), returning shard 0's (replicated) result."""
    tr.validate_tp(cfg)
    dev = tr.params_device(params)
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    if cfg.tp == 1:
        return body(params, tokens, cfg)
    shards = tp_shard_params(tr._cast_params(params, cfg), cfg,
                             tp_devices(cfg.tp, dev if device is None
                                        else device))
    return run_shards(lambda p, t: body(p, t, cfg), shards, tokens)[0]


@torch.no_grad()
def tp_forward(params, tokens, cfg: tr.TransformerConfig, device=None):
    """tokens (B, S) -> logits (B, S, vocab) under TP. Takes UNSHARDED
    params (sharded and permuted here); ``tp == 1`` is the plain forward.
    Bitwise equal across degrees in gather mode."""
    return _tp_run(tr.forward, params, tokens, cfg, device)


@torch.no_grad()
def tp_block_outputs(params, tokens, cfg: tr.TransformerConfig,
                     device=None):
    """(atts (B, L, S, D), mlps (B, L, S, D), logits) under TP, the
    property-test surface; the same contract as :func:`tp_forward`."""
    return _tp_run(_block_outputs, params, tokens, cfg, device)
