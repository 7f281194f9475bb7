"""The port's distribution layer (gdm_torch.dist: mesh, halo, poisson,
dryrun) against gdm's gdm/dist under x64, on the CPU in float64.

gdm's mesh is one controller over devices (the conftest gives jax 8
host devices); the port's is one controller over shard slots, here all
on the CPU.  Held here:

- ``device_mesh``: slots, ``shape``, the cards spanned, CPU slots, the
  refusal of a CUDA mesh without a card; ``shard_field`` and
  ``replicate``; ``halo_pad`` against the global field's planes;
- ``banded_apply_sharded`` over 1, 3 and 7 slots against the local
  ``apply_banded`` (1e-13, gdm's test) and against gdm's own sharded
  apply (1e-13); a shard narrower than p raises gdm's ValueError;
- ``dist.poisson.solve`` in 1D and 2D at gdm's 20-cell size, both
  modes, over 1, 3 and 7 slots: invariant to the slot count (1e-12),
  gdm's iteration counts, and within 1e-12 of gdm's own solve in both
  of its modes; against the reference's poisson_02 golden (5e-6, where
  the reference is mounted, as gdm's tests/test_distributed.py);
  an unknown mode raises gdm's ValueError;
- ``dryrun_multichip(4, device="cpu")``.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gdm.dist import poisson as gdpoisson
from gdm.dist.halo import banded_apply_sharded as g_banded_apply_sharded
from gdm.dist.mesh import device_mesh as g_device_mesh
from gdm.grid import Grid as GGrid

from gdm_torch.dist import poisson as dpoisson
from gdm_torch.dist.dryrun import dryrun_multichip
from gdm_torch.dist.halo import banded_apply_sharded, halo_pad
from gdm_torch.dist.mesh import (Mesh, check_mesh, device_mesh, replicate,
                                 shard_field)
from gdm_torch.grid import Grid
from gdm_torch.ops.tensor import apply_banded
from gdm_torch.ops1d import stiffness_1d

from conftest import REFERENCE, reference_available

F64 = torch.float64
GOLDEN = os.path.join(REFERENCE, "tests", "poisson_02_gdm.mpirun=1.output")


def rhs_one(mesh, c):
    return np.ones_like(mesh[0])


def _mesh(n):
    return device_mesh(n, device="cpu")


def test_device_mesh_slots():
    m = _mesh(3)
    assert isinstance(m, Mesh) and m.shape == {"x": 3} and m.size == 3
    assert m.n_cards == 1
    assert all(d == torch.device("cpu") for d in m.devices)
    assert _mesh(None).size == 1
    assert device_mesh(2, axis="y", device="cpu").shape == {"y": 2}
    with pytest.raises(ValueError, match="at least one slot"):
        _mesh(0)


def test_cuda_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        device_mesh(2)


def test_check_mesh_refuses_other_objects():
    assert check_mesh(_mesh(2)).size == 2
    with pytest.raises(TypeError, match="device_mesh"):
        check_mesh(g_device_mesh(2))


def test_shard_field_and_replicate():
    u = torch.arange(22.0, dtype=F64).reshape(11, 2)
    blocks = shard_field(u, _mesh(3))
    assert [b.shape[0] for b in blocks] == [4, 4, 3]
    assert torch.equal(torch.cat(blocks), u)
    reps = replicate(u, _mesh(3))
    assert len(reps) == 3 and all(torch.equal(r, u) for r in reps)


@pytest.mark.parametrize("n_shards", [1, 3, 7])
def test_halo_pad_planes(n_shards):
    u = torch.as_tensor(np.random.default_rng(1).normal(size=(21, 5)))
    w = 3
    padded = halo_pad(shard_field(u, _mesh(n_shards)), w)
    glob = torch.nn.functional.pad(u, (0, 0, w, w))
    start = 0
    for blk in padded:
        n = blk.shape[0] - 2 * w
        assert torch.equal(blk, glob[start:start + n + 2 * w])
        start += n
    assert start == 21


@pytest.mark.parametrize("n_shards", [1, 3, 7])
def test_halo_banded_apply_matches_local(n_shards):
    band_np = stiffness_1d(3, 20, 1 / 20).band
    band = torch.as_tensor(band_np)
    u_np = np.random.default_rng(0).normal(size=(21, 21))
    u = torch.as_tensor(u_np)
    y_local = apply_banded(u, band, 0)
    y_dist = banded_apply_sharded(u, band, _mesh(n_shards))
    np.testing.assert_allclose(y_dist.numpy(), y_local.numpy(), atol=1e-13)
    y_gdm = np.asarray(g_banded_apply_sharded(
        jnp.asarray(u_np), jnp.asarray(band_np), g_device_mesh(n_shards)))
    np.testing.assert_allclose(y_dist.numpy(), y_gdm, atol=1e-13)


def test_narrow_shard_raises_gdm_value_error():
    band = torch.as_tensor(stiffness_1d(3, 8, 1 / 8).band)
    u = torch.ones(9, dtype=F64)
    with pytest.raises(ValueError, match="halo width 3"):
        banded_apply_sharded(u, band, _mesh(4))


@pytest.fixture(scope="module")
def poisson_runs():
    """(port solutions and infos by (dim, mode, slots), gdm's solutions
    and infos by (dim, mode)) at gdm's 20-cell size."""
    port, gdm = {}, {}
    for dim in (1, 2):
        for mode in ("auto", "shard_map"):
            args = (3, (20,) * dim, (0.0,) * dim, (1.0,) * dim)
            for n in (1, 3, 7):
                u, info = dpoisson.solve(Grid(*args), rhs_one, _mesh(n),
                                         mode=mode)
                port[dim, mode, n] = (u.numpy(), info)
            g, ginfo = gdpoisson.solve(GGrid(*args), rhs_one,
                                       g_device_mesh(3), mode=mode)
            gdm[dim, mode] = (np.asarray(g), int(ginfo["iterations"]))
    return port, gdm


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("mode", ["auto", "shard_map"])
def test_poisson02_shard_count_invariant(poisson_runs, dim, mode):
    port, _ = poisson_runs
    u1 = port[dim, mode, 1][0]
    for n in (3, 7):
        np.testing.assert_allclose(port[dim, mode, n][0], u1, atol=1e-12)
        assert port[dim, mode, n][1] == port[dim, mode, 1][1]


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("mode", ["auto", "shard_map"])
def test_poisson02_matches_gdm(poisson_runs, dim, mode):
    port, gdm = poisson_runs
    g, g_its = gdm[dim, mode]
    u, info = port[dim, mode, 3]
    assert u.shape == g.shape
    np.testing.assert_allclose(u, g, atol=1e-12)
    assert info["iterations"] == g_its


@pytest.mark.skipif(not reference_available(),
                    reason="reference goldens not mounted")
@pytest.mark.parametrize("dim", [1, 2])
def test_poisson02_golden(poisson_runs, dim):
    from test_distributed import parse_golden

    golden = parse_golden(GOLDEN)[dim - 1]
    port, _ = poisson_runs
    grid = GGrid(3, (20,) * dim, (0.0,) * dim, (1.0,) * dim)
    for n in (1, 3, 7):
        u = grid.to_reference_vector(port[dim, "shard_map", n][0])
        np.testing.assert_allclose(u, golden, atol=5e-6)


def test_poisson_unknown_mode_raises():
    g = Grid(3, (8,), (0.0,), (1.0,))
    with pytest.raises(ValueError, match="spmd"):
        dpoisson.solve(g, rhs_one, _mesh(2), mode="spmd")
    with pytest.raises(ValueError, match="spmd"):
        gdpoisson.solve(GGrid(3, (8,), (0.0,), (1.0,)), rhs_one,
                        g_device_mesh(2), mode="spmd")


def test_dryrun_multichip_cpu():
    out = dryrun_multichip(4, device="cpu")
    assert out["slots"] == 4 and out["cards"] == 1
    assert out["apply_rel_err"] <= 1e-12
    assert out["wave_0_rows"] == 13 and out["wave_0_rows_dev"] <= 1e-10
