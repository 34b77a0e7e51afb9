"""The port's mesh (marlin_tpu_torch/mesh.py, on torch.distributed's
DeviceMesh) against the JAX package's, the twin of tests/test_mesh.py.

``squarest_grid`` is a plain function and runs here. The rest runs in 8
gloo rank processes on the CPU, started once for this module and
tests/test_torch_matrix_core.py together (tests/torch_dist_worker.py,
suite "core"): mesh construction, submeshes, each layout's shard of every
rank, held slice for slice to the JAX sharding's addressable_shards on the
device at the same mesh position, and the shard-to-shard moves between
layouts, paddings and meshes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import marlin_tpu as mt
from marlin_tpu import mesh as jmesh
from marlin_tpu_torch import mesh as pmesh

import torch_dist_worker

INPUTS = torch_dist_worker.make_inputs()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_dist_worker.shared_launch("core", 8, INPUTS,
                                           tmp_path_factory)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 7, 12, 16, 64])
def test_squarest_grid(n):
    assert pmesh.squarest_grid(n) == jmesh.squarest_grid(n)


def test_default_mesh_uses_all_devices_squarest(port):
    got = port.get("default_mesh_shape")
    m = jmesh.create_mesh()
    assert got["shape"] == dict(m.shape) == {"mr": 4, "mc": 2}
    assert tuple(got["axis_sizes"]) == jmesh.axis_sizes(m)
    assert got["ranks"] == list(range(8)) and got["cached"]


def test_explicit_shape(port):
    assert tuple(port.get("explicit_shape")["axis_sizes"]) == \
        jmesh.axis_sizes(jmesh.create_mesh((2, 4)))


def test_mesh_over_four_devices(port):
    # The four ranks in it hold their mesh position; the other four none.
    got = port.get("mesh_of_four")
    m = jmesh.create_mesh((2, 2), devices=jax.devices()[:4])
    assert got["size"] == len(list(m.devices.flat)) == 4
    assert got["coords"] == [[0, 0], [0, 1], [1, 0], [1, 1]] + [None] * 4
    assert got["holds"] == [True] * 4 + [False] * 4


def test_shape_device_mismatch_raises(port):
    with pytest.raises(ValueError):
        jmesh.create_mesh((3, 2), devices=jax.devices()[:4])
    assert port.get("shape_mismatch_raises")["raised"] == "ValueError"


def test_custom_axis_names(port):
    m = jmesh.create_mesh((2, 2), axis_names=("a", "b"),
                          devices=jax.devices()[:4])
    assert port.get("custom_axis_names")["axis_names"] == list(m.axis_names)


def test_submesh(port):
    got = port.get("submeshes")
    d = jmesh.default_mesh()
    assert got["cached"] and got["whole"] and got["bad"] == "ValueError"
    assert got["s4"] == dict(jmesh.submesh(d, 4).shape)
    s6 = jmesh.submesh(d, 6)
    assert got["s6"] == dict(s6.shape)
    devs = list(d.devices.flat)
    assert got["s6_ranks"] == [devs.index(x) for x in s6.devices.flat]
    assert got["s6_holds"] == [True] * 6 + [False] * 2


@pytest.mark.parametrize("layout", list(torch_dist_worker.LAYOUT_SHAPES))
def test_layout_shards_match_the_jax_shardings(port, layout):
    # Rank r of the port's default mesh sits where device r sits in the
    # JAX package's; each holds the same slice of each dim.
    shape = torch_dist_worker.LAYOUT_SHAPES[layout]
    m = jmesh.default_mesh()
    placed = jax.device_put(jnp.zeros(shape),
                            getattr(jmesh, f"{layout}_sharding")(m))
    devs = list(m.devices.flat)
    want = [None] * len(devs)
    for s in placed.addressable_shards:
        want[devs.index(s.device)] = [
            [sl.start or 0, extent if sl.stop is None else sl.stop]
            for sl, extent in zip(s.index, shape)]
    assert port.get("layout_shards")[layout] == want


def test_round_trip_preserves_values(port):
    got = port.get("layout_round_trip")
    assert {k: got[k] for k in ("row", "block", "replicated",
                                "relayout")} == {
        "row": True, "block": True, "replicated": True, "relayout": True}
    # The JAX package's own round trip, on the same array.
    arr = INPUTS["arange48"]
    for sh in (jmesh.row_sharding(mt.default_mesh()),
               jmesh.block_sharding(mt.default_mesh())):
        np.testing.assert_array_equal(
            np.asarray(jax.device_put(jnp.asarray(arr), sh)), arr)


@pytest.mark.parametrize("move", ["row_to_block6", "row_to_col",
                                  "block6_to_replicated"])
def test_shard_to_shard_moves(port, move):
    # A 27 x 7 matrix moved point to point between layouts, paddings and
    # meshes: each rank of the destination mesh holds exactly the shard
    # that cutting the whole padded matrix gives it; the two ranks outside
    # the 2 x 3 submesh hold none.
    holders = 6 if move == "row_to_block6" else 8
    assert port.get("layout_round_trip")[move] == \
        [True] * holders + [None] * (8 - holders)
