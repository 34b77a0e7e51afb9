"""Device mesh: port of ``marlin_tpu/mesh.py`` on ``torch.distributed``.

The JAX package's named ``jax.sharding.Mesh`` becomes a :class:`Mesh`: a
``torch.distributed.device_mesh.DeviceMesh`` over process ranks, one rank
per device (NCCL on the card, gloo on the CPU), with the axis names
``config.mesh_axis_rows``/``mesh_axis_cols`` ("mr", "mc"), plus the
process group of all its ranks. A ``jax.Array`` sharded over a mesh
becomes, on each rank, that rank's shard (a local tensor); a layout
(:func:`row_sharding` ...) is a :class:`Layout`, the mesh with one DTensor
placement per mesh dimension, the counterpart of a ``NamedSharding``.

Every rank runs the same program (SPMD). A function that communicates is
called on every rank of the mesh it works on; a function that builds
process groups (:func:`create_mesh`, :func:`submesh`, the 3-D GEMM grid)
on every rank of the default group, since creating a group is collective
over it. A rank outside a mesh holds nothing of what lives there.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .config import get_config
from .utils.hw import DeviceLike, resolve_device

_default_mesh: Optional["Mesh"] = None


class Mesh:
    """A named device mesh: ``device_mesh`` (a DeviceMesh) and ``group``,
    the process group of all its ranks (None: the default group). The JAX
    mesh's ``shape``, ``axis_names`` and ``devices`` (here the ranks, an
    ndarray of the mesh's shape) read the same."""

    def __init__(self, device_mesh: DeviceMesh, group):
        self.device_mesh = device_mesh
        self.group = group

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def devices(self) -> np.ndarray:
        return self.device_mesh.mesh.numpy()

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(int(r) for r in self.devices.flat)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def device(self) -> torch.device:
        """The torch device of this rank's shards."""
        if self.device_mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_mesh.device_type)

    @property
    def coordinate(self) -> Optional[Tuple[int, ...]]:
        """This rank's position in the mesh; None outside it."""
        c = self.device_mesh.get_coordinate()
        return None if c is None else tuple(c)

    @property
    def holds(self) -> bool:
        """Whether this rank is part of the mesh."""
        return dist.get_rank() in self.ranks

    def dim_group(self, name: str):
        """The process group along mesh dimension ``name``."""
        return self.device_mesh.get_group(name)

    def dim_index(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(
                f"mesh axes are {self.axis_names}, no axis {name!r}")
        return self.axis_names.index(name)

    def __repr__(self) -> str:
        return (f"Mesh({tuple(self.shape.items())}, "
                f"{self.device_mesh.device_type})")


class Layout(NamedTuple):
    """A mesh and one DTensor placement per mesh dimension: the
    counterpart of a ``NamedSharding``."""

    mesh: Mesh
    placements: Tuple


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: DeviceLike = "cuda") -> None:
    """Join the multi-process runtime: ``init_process_group`` over NCCL
    (``device`` "cuda", this rank's card being ``process_id`` modulo the
    card count) or gloo ("cpu"). ``coordinator_address`` is "host:port"
    or a ``tcp://``/``file://`` URL; with none, the ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) are read. Call it once per
    process before any mesh is created."""
    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda" and process_id is not None:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _ensure_process_group(dev: torch.device) -> None:
    """With no process group yet, make a one-rank one on a HashStore, so
    a single process uses the mesh API on one device."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)


def squarest_grid(n: int) -> Tuple[int, int]:
    """Factor ``n`` into the most-square (rows, cols) grid, rows >= cols."""
    best = (n, 1)
    for c in range(1, int(math.isqrt(n)) + 1):
        if n % c == 0:
            best = (n // c, c)
    return best


def _group_of(ranks: Sequence[int]):
    """The process group of ``ranks`` (the default group when they are
    all ranks); collective over the default group."""
    if sorted(ranks) == list(range(dist.get_world_size())):
        return None
    return dist.new_group(sorted(ranks))


def _build(device_type: str, ranks: Sequence[int], shape: Sequence[int],
           names: Sequence[str]) -> Mesh:
    dm = DeviceMesh(device_type,
                    torch.tensor(list(ranks), dtype=torch.int).reshape(
                        tuple(shape)),
                    mesh_dim_names=tuple(names))
    return Mesh(dm, _group_of(ranks))


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Optional[Sequence[str]] = None,
                devices: Optional[Sequence[int]] = None,
                device: DeviceLike = "cuda") -> Mesh:
    """A mesh over ``devices`` (ranks; default: every rank) with the
    given grid shape, on the card (``device="cuda"``, NCCL) unless the
    caller asks for the CPU (gloo). With no ``shape``, the squarest 2-D
    factorization of the rank count (DenseVecMatrix.scala:208-213). With
    no process group yet, a one-rank one is made first. Collective over
    the default group: every rank calls it."""
    dev = resolve_device(device)
    _ensure_process_group(dev)
    cfg = get_config()
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    names = tuple(axis_names or (cfg.mesh_axis_rows, cfg.mesh_axis_cols))
    shape = tuple(shape) if shape is not None else squarest_grid(len(ranks))
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(
            f"mesh shape {shape} does not cover {len(ranks)} devices")
    if len(names) != len(shape):
        raise ValueError(f"{len(shape)} mesh dims, axis names {names}")
    return _build(dev.type, ranks, shape, names)


_submesh_cache: dict = {}


def submesh(mesh: Mesh, n_devices: int) -> Mesh:
    """A mesh over the first ``n_devices`` ranks of ``mesh`` (squarest
    grid, same axis names): how the ``parallelism`` knob (the reference's
    ``cores``, DenseVecMatrix.scala:196) maps to hardware. Cached per
    (mesh, n); collective over the default group on first use."""
    n_avail = mesh.size
    if not 0 < n_devices <= n_avail:
        raise ValueError(f"need 1..{n_avail} devices, got {n_devices}")
    if n_devices == n_avail:
        return mesh
    key = (mesh, n_devices)
    if key not in _submesh_cache:
        _submesh_cache[key] = _build(
            mesh.device_mesh.device_type, mesh.ranks[:n_devices],
            squarest_grid(n_devices), mesh.axis_names)
    return _submesh_cache[key]


def default_mesh() -> Mesh:
    """The process-wide default mesh, created lazily over every rank on
    the card."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = create_mesh()
    return _default_mesh


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def axis_sizes(mesh: Mesh) -> Tuple[int, int]:
    """(rows-axis size, cols-axis size) of a 2-D marlin mesh."""
    cfg = get_config()
    shape = mesh.shape
    return shape[cfg.mesh_axis_rows], shape[cfg.mesh_axis_cols]


def _layout(mesh: Mesh, sharded: Dict[str, int]) -> Layout:
    """Shard(dim) on each named mesh axis of ``sharded``, Replicate on
    the rest."""
    placements = [Replicate()] * len(mesh.axis_names)
    for name, dim in sharded.items():
        placements[mesh.dim_index(name)] = Shard(dim)
    return Layout(mesh, tuple(placements))


def row_sharding(mesh: Mesh) -> Layout:
    """Rows sharded over every device (row-major over (mr, mc)), cols
    whole: ``DenseVecMatrix``'s row stripes."""
    cfg = get_config()
    return _layout(mesh, {cfg.mesh_axis_rows: 0, cfg.mesh_axis_cols: 0})


def block_sharding(mesh: Mesh) -> Layout:
    """The 2-D block layout of ``BlockMatrix``: rows over mr, cols over
    mc."""
    cfg = get_config()
    return _layout(mesh, {cfg.mesh_axis_rows: 0, cfg.mesh_axis_cols: 1})


def col_sharding(mesh: Mesh) -> Layout:
    """Columns sharded over every device, rows whole."""
    cfg = get_config()
    return _layout(mesh, {cfg.mesh_axis_rows: 1, cfg.mesh_axis_cols: 1})


def replicated_sharding(mesh: Mesh) -> Layout:
    """Every device holds all of it."""
    return _layout(mesh, {})


def vector_sharding(mesh: Mesh) -> Layout:
    """1-D chunks over every device: ``DistributedVector``'s layout."""
    cfg = get_config()
    return _layout(mesh, {cfg.mesh_axis_rows: 0, cfg.mesh_axis_cols: 0})


# ---------------------------------------------------------------------------
# Shards: what each rank holds of a tensor under a layout
# ---------------------------------------------------------------------------


def _slices_at(layout: Layout, shape: Sequence[int], coord):
    """The slice of each dim of a tensor of ``shape`` that the rank at
    mesh position ``coord`` holds under ``layout``."""
    sizes = layout.mesh.device_mesh.mesh.shape
    out = []
    for dim, extent in enumerate(shape):
        idx, n = 0, 1
        for k, p in enumerate(layout.placements):
            if isinstance(p, Shard) and p.dim == dim:
                idx, n = idx * sizes[k] + coord[k], n * sizes[k]
        if extent % n:
            raise ValueError(
                f"dim {dim} of {tuple(shape)} does not divide into {n} "
                f"shards")
        step = extent // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_slices(layout: Layout, shape: Sequence[int]):
    """This rank's slice of each dim of a tensor of ``shape`` under
    ``layout`` (None outside the mesh). A dim sharded over several mesh
    axes is cut row-major over them, in mesh order, as DTensor and the
    JAX package's ``P((mr, mc))`` cut it. Every sharded dim must divide
    by its shard count (the matrix types pad so that it does)."""
    coord = layout.mesh.coordinate
    return None if coord is None else _slices_at(layout, shape, coord)


def shard(full: torch.Tensor, layout: Layout) -> Optional[torch.Tensor]:
    """This rank's shard of ``full`` (every rank holds all of it) under
    ``layout``, contiguous and on the mesh's device; None outside the
    mesh."""
    sl = local_slices(layout, full.shape)
    if sl is None:
        return None
    return full[sl].to(layout.mesh.device).contiguous()


def _dtensor(local: torch.Tensor, layout: Layout,
             shape: Sequence[int]) -> DTensor:
    shape = tuple(shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, layout.mesh.device_mesh,
                              list(layout.placements), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def unshard(local: torch.Tensor, layout: Layout,
            shape: Sequence[int]) -> torch.Tensor:
    """The whole tensor of ``shape`` from each rank's shard ``local``,
    on every rank of the mesh: one all-gather over the mesh's ranks, each
    shard put back at its rank's slice. Collective over the mesh."""
    mesh = layout.mesh
    if mesh.size == 1 or all(isinstance(p, Replicate)
                             for p in layout.placements):
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    order = (list(range(dist.get_world_size())) if mesh.group is None
             else dist.get_process_group_ranks(mesh.group))
    devices = mesh.devices
    out = torch.empty(tuple(shape), dtype=local.dtype, device=local.device)
    for rank, part in zip(order, parts):
        coord = tuple(int(c) for c in np.argwhere(devices == rank)[0])
        out[_slices_at(layout, shape, coord)] = part
    return out


def _rank_slices(layout: Layout, shape: Sequence[int]) -> Dict[int, tuple]:
    """Every rank of the layout's mesh with its slices of ``shape``."""
    devices = layout.mesh.devices
    return {int(devices[idx]): _slices_at(layout, shape, idx)
            for idx in np.ndindex(devices.shape)}


def _overlap(a: tuple, b: tuple, shape: Sequence[int]) -> Optional[tuple]:
    """The part of slices ``a`` and ``b`` inside the logical ``shape``
    (None when empty)."""
    out = []
    for x, y, extent in zip(a, b, shape):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop, extent)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _within(region: tuple, outer: tuple) -> tuple:
    """``region`` relative to the start of ``outer``."""
    return tuple(slice(r.start - o.start, r.stop - o.start)
                 for r, o in zip(region, outer))


def redistribute(local: Optional[torch.Tensor], src: Layout,
                 src_shape: Sequence[int], dst: Layout,
                 dst_shape: Sequence[int], shape: Sequence[int],
                 dtype: torch.dtype) -> Optional[torch.Tensor]:
    """This rank's shard under ``dst`` of a tensor zero-padded to
    ``dst_shape``, from each rank's shard ``local`` under ``src`` of the
    same tensor zero-padded to ``src_shape`` (``shape`` is the logical
    extent; the meshes may differ). Shard to shard: each rank sends every
    other rank the part of its shard that lies in the other's, point to
    point, so no rank holds more than its two shards and the pieces in
    flight. A piece held by several ranks (a replicated axis) comes from
    the receiver itself when it holds it. None on a rank outside ``dst``'s
    mesh. Collective over the ranks of both meshes."""
    shape, src_shape, dst_shape = (tuple(int(s) for s in x)
                                   for x in (shape, src_shape, dst_shape))
    me = dist.get_rank()
    src_sl, dst_sl = _rank_slices(src, src_shape), _rank_slices(dst, dst_shape)
    if (src.mesh is dst.mesh and src_shape == dst_shape
            and all(src_sl[r] == dst_sl[r] for r in src_sl)):
        return local
    holders: Dict[tuple, list] = {}
    for rank, sl in src_sl.items():
        holders.setdefault(sl, []).append(rank)
    out = None
    if me in dst_sl:
        out = torch.zeros(tuple(s.stop - s.start for s in dst_sl[me]),
                          dtype=dtype, device=dst.mesh.device)
    ops, landed = [], []
    for receiver, want in dst_sl.items():
        for sl, ranks in holders.items():
            piece = _overlap(want, sl, shape)
            if piece is None:
                continue
            sender = receiver if receiver in ranks else ranks[0]
            if sender == me and receiver == me:
                out[_within(piece, want)] = local[_within(piece, sl)]
            elif sender == me:
                ops.append(dist.P2POp(dist.isend, local[_within(
                    piece, sl)].contiguous(), receiver))
            elif receiver == me:
                buf = torch.empty(tuple(s.stop - s.start for s in piece),
                                  dtype=dtype, device=out.device)
                ops.append(dist.P2POp(dist.irecv, buf, sender))
                landed.append((_within(piece, want), buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for where, buf in landed:
        out[where] = buf
    return out


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over every rank of the mesh, in place. Collective
    over the mesh."""
    if mesh.size > 1:
        dist.all_reduce(x, group=mesh.group)
    return x
