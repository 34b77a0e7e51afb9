"""The port's placement helpers (marlin_tpu_torch/parallel/layout.py)
against the JAX package's, the twin of tests/test_layout.py.

Every helper is arithmetic on a mesh's shape and rank grid, so all of it
runs here, in the pytest process, with no process group: the owner
lookups read a :class:`Grid`, which has the attributes of the port's
``Mesh`` that they read (``shape``, ``devices``, ``ranks``, ``size``),
with ranks laid out as ``create_mesh`` lays them (row-major over the
given ranks; tests/test_torch_mesh.py holds ``create_mesh`` to that). The
default (4, 2) mesh and the asymmetric 2 x 3 one are compared, each owner
(a rank in the port, a device in the JAX package) by its position in the
mesh.
"""

import jax
import numpy as np
import pytest

import marlin_tpu as mt
from marlin_tpu.parallel import layout as jl
from marlin_tpu_torch.parallel import layout as pl


class Grid:
    """The rank grid of a port ``Mesh`` over ranks 0..n-1 with the JAX
    package's axis names."""

    def __init__(self, rows, cols):
        self.shape = {"mr": rows, "mc": cols}
        self.devices = np.arange(rows * cols).reshape(rows, cols)
        self.ranks = tuple(range(rows * cols))
        self.size = rows * cols


GRIDS = {"default": Grid(4, 2), "asym": Grid(2, 3)}


@pytest.mark.parametrize("grid", [(2, 2, 2), (4, 1, 2), (1, 3, 5)])
def test_grid_seq_covers_all_cells(grid):
    m, k, n = grid
    seen = set()
    for r in range(m):
        for c in range(n):
            for kk in range(k):
                got = pl.grid_seq(pl.BlockID(r, c), m, k, n, kk)
                assert got == jl.grid_seq(jl.BlockID(r, c), m, k, n, kk)
                seen.add(got)
    assert seen == set(range(m * k * n))


@pytest.mark.parametrize("blks_by_col", [1, 3, 7])
def test_elem_op_partition(blks_by_col):
    for r in range(5):
        for c in range(blks_by_col):
            assert pl.elem_op_partition(pl.BlockID(r, c), blks_by_col) == \
                jl.elem_op_partition(jl.BlockID(r, c), blks_by_col)


def _meshes():
    return {"default": mt.default_mesh(),
            "asym": mt.create_mesh((2, 3), devices=jax.devices()[:6])}


@pytest.mark.parametrize("mesh_key", ["default", "asym"])
def test_block_owners(mesh_key):
    grid, mesh = GRIDS[mesh_key], _meshes()[mesh_key]
    devs = list(mesh.devices.flat)
    for br, bc in ((4, 2), (3, 5), (8, 8), (1, 1)):
        assert [[pl.device_for_block(i, j, br, bc, grid) for j in range(bc)]
                for i in range(br)] == \
            [[devs.index(jl.device_for_block(i, j, br, bc, mesh))
              for j in range(bc)] for i in range(br)]


@pytest.mark.parametrize("mesh_key", ["default", "asym"])
def test_row_striping(mesh_key):
    grid, mesh = GRIDS[mesh_key], _meshes()[mesh_key]
    devs = list(mesh.devices.flat)
    for n in (37, 8, 5, 64):
        assert [pl.stripe_for_row(r, n, grid) for r in range(n)] == \
            [jl.stripe_for_row(r, n, mesh) for r in range(n)]
    for n in (37, 5):
        assert [pl.device_for_row(r, n, grid) for r in range(n)] == \
            [devs.index(jl.device_for_row(r, n, mesh)) for r in range(n)]


@pytest.mark.parametrize("mesh_key", ["default", "asym"])
def test_colocation_matches_striping(mesh_key):
    grid, mesh = GRIDS[mesh_key], _meshes()[mesh_key]
    assert [[pl.colocated(r, ch, 37, 8, grid) for ch in range(8)]
            for r in range(37)] == \
        [[jl.colocated(r, ch, 37, 8, mesh) for ch in range(8)]
         for r in range(37)]
