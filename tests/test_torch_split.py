"""The port's split policy and shape helpers (marlin_tpu_torch/utils/
split.py) against the JAX package's marlin_tpu/utils/split.py: the same
grids, plans and padding for the same arguments (plain functions, so they
run here in the test process)."""

import numpy as np
import pytest
import torch

from marlin_tpu.utils import split as js
from marlin_tpu_torch.utils import split as ps

DIMS = [(1 << 20, 4, 4), (64, 64, 64), (8, 640, 8), (640, 8, 16),
        (23, 17, 29), (1000, 10, 10), (10, 1000, 10), (128, 128, 128),
        (3, 5, 7), (1, 1, 1)]


@pytest.mark.parametrize("mkn", DIMS)
@pytest.mark.parametrize("par", [1, 2, 6, 8, 16])
def test_split_method(mkn, par):
    assert ps.split_method(*mkn, par) == js.split_method(*mkn, par)


def test_split_method_rejects_no_parallelism():
    for mod in (ps, js):
        with pytest.raises(ValueError):
            mod.split_method(4, 4, 4, 0)


@pytest.mark.parametrize("mkn", DIMS)
@pytest.mark.parametrize("n_dev", [1, 2, 4, 6, 8, 12])
def test_grid_for_devices(mkn, n_dev):
    got = ps.grid_for_devices(*mkn, n_dev)
    assert got == js.grid_for_devices(*mkn, n_dev)
    assert got[0] * got[1] * got[2] == n_dev


@pytest.mark.parametrize("par", [1, 2, 3, 8, 9, 64, 1000])
def test_near_square_split(par):
    assert ps.near_square_split(par) == js.near_square_split(par)


@pytest.mark.parametrize("mkn", DIMS)
def test_is_near_square(mkn):
    assert ps.is_near_square(*mkn) == js.is_near_square(*mkn)
    assert ps.is_near_square(*mkn, tol=100.0) == js.is_near_square(
        *mkn, tol=100.0)


@pytest.mark.parametrize("x", [1, 2, 12, 97, 360, 1024])
def test_prime_factors(x):
    assert ps._prime_factors(x) == js._prime_factors(x)


@pytest.mark.parametrize("ratios", [(1.0, 2.0), (2.0, 1.0), (1.5, 1.5)])
def test_dim_to_split(ratios):
    assert ps.dim_to_split(*ratios) == js.dim_to_split(*ratios)


@pytest.mark.parametrize("starts, block", [([0, 3, 7, 10], 4),
                                           ([0, 10], 3), ([0, 1, 2, 3], 2),
                                           ([0, 5, 5, 12], 5)])
def test_reblock_plan(starts, block):
    assert ps.reblock_plan(starts, block) == js.reblock_plan(starts, block)


@pytest.mark.parametrize("shape, axis, mult", [((5, 3), 0, 4), ((5, 3), 1, 4),
                                               ((8, 3), 0, 4), ((7,), 0, 8),
                                               ((2, 3, 5), -1, 3)])
def test_pad_to_multiple(shape, axis, mult):
    import jax.numpy as jnp

    x = np.arange(float(np.prod(shape))).reshape(shape)
    got = ps.pad_to_multiple(torch.from_numpy(x), axis, mult)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(js.pad_to_multiple(jnp.asarray(x), axis,
                                                   mult)))


def test_pad_to_pads_every_dim():
    x = torch.arange(15.0).reshape(5, 3)
    got = ps.pad_to(x, (4, 2))
    assert got.shape == (8, 4)
    assert torch.equal(got[:5, :3], x) and got[5:].abs().sum() == 0
