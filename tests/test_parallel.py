"""Parallel-layer tests on a virtual 8-device CPU mesh: topology equivalence
(sharded vs single-device results, SURVEY.md §4 distributed testing plan)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from tasmania_jax.parallel import halo_exchange, make_mesh
from tasmania_jax.parallel.mesh import CartesianDecomposition, _factor_2d


class TestMesh:
    def test_factorization(self):
        assert _factor_2d(8) == (4, 2)
        assert _factor_2d(16) == (4, 4)
        assert _factor_2d(7) == (7, 1)

    def test_make_mesh(self):
        mesh = make_mesh(jax.devices()[:8])
        assert mesh.devices.shape == (4, 2)
        assert mesh.axis_names == ("x", "y")

    def test_decomposition(self):
        mesh = make_mesh(jax.devices()[:8])
        dec = CartesianDecomposition(32, 16, mesh, nb=3)
        assert (dec.bx, dec.by) == (8, 8)
        assert dec.local_shape_with_halo == (14, 14)


class TestHaloExchange:
    def _sharded_exchange(self, global_with_halos, nb, periodic):
        mesh = make_mesh(jax.devices()[:8])

        f = shard_map(
            lambda x: halo_exchange(x, nb, ("x", "y"), periodic),
            mesh=mesh,
            in_specs=P("x", "y", None),
            out_specs=P("x", "y", None),
        )
        arr = jax.device_put(
            global_with_halos, NamedSharding(mesh, P("x", "y", None))
        )
        return np.asarray(jax.jit(f)(arr))

    def test_periodic_interior_edges(self):
        """After exchange, each shard's halos hold its neighbours' interior."""
        px, py, bx, by, nb, nz = 4, 2, 8, 8, 2, 3
        rng = np.random.default_rng(0)
        # global array laid out as px*py blocks each (bx+2nb, by+2nb, nz)
        glob = rng.normal(size=(px * (bx + 2 * nb), py * (by + 2 * nb), nz))
        out = self._sharded_exchange(jnp.asarray(glob), nb, (True, True))

        sx, sy = bx + 2 * nb, by + 2 * nb
        blocks = {
            (i, j): glob[i * sx : (i + 1) * sx, j * sy : (j + 1) * sy]
            for i in range(px)
            for j in range(py)
        }
        out_blocks = {
            (i, j): out[i * sx : (i + 1) * sx, j * sy : (j + 1) * sy]
            for i in range(px)
            for j in range(py)
        }
        for i in range(px):
            for j in range(py):
                o = out_blocks[(i, j)]
                left = blocks[((i - 1) % px, j)]
                right = blocks[((i + 1) % px, j)]
                # west halo = left neighbour's high interior band (compare the
                # y-interior columns only: corner ghosts are overwritten by the
                # subsequent y-exchange, asserted in test_corner_consistency)
                jj = slice(nb, sy - nb)
                np.testing.assert_allclose(
                    o[:nb, jj], left[sx - 2 * nb : sx - nb, jj], err_msg=f"W {i},{j}"
                )
                np.testing.assert_allclose(
                    o[sx - nb :, jj], right[nb : 2 * nb, jj], err_msg=f"E {i},{j}"
                )
                # interior untouched
                np.testing.assert_allclose(
                    o[nb : sx - nb, nb : sy - nb],
                    blocks[(i, j)][nb : sx - nb, nb : sy - nb],
                )

    def test_nonperiodic_domain_edges_untouched(self):
        """Without periodicity the outermost shards keep their original halo
        values (to be filled by physical BCs)."""
        px, py, bx, by, nb, nz = 4, 2, 4, 4, 1, 2
        marker = -999.0
        glob = np.full((px * (bx + 2 * nb), py * (by + 2 * nb), nz), 1.0)
        glob[: nb] = marker  # west halo of shard (0, *)
        out = self._sharded_exchange(jnp.asarray(glob), nb, (False, False))
        np.testing.assert_allclose(out[:nb], marker)

    def test_corner_consistency(self):
        """y-exchange after x-exchange propagates corner ghosts."""
        px, py, bx, by, nb, nz = 4, 2, 8, 8, 2, 1
        rng = np.random.default_rng(1)
        glob = rng.normal(size=(px * (bx + 2 * nb), py * (by + 2 * nb), nz))
        out = self._sharded_exchange(jnp.asarray(glob), nb, (True, True))
        sx, sy = bx + 2 * nb, by + 2 * nb
        # corner halo of shard (0,0) must equal the x-exchanged band of the
        # y-neighbour (0, py-1): i.e. left-neighbour (px-1, py-1) interior corner
        diag = glob[
            (px - 1) * sx + sx - 2 * nb : (px - 1) * sx + sx - nb,
            (py - 1) * sy + sy - 2 * nb : (py - 1) * sy + sy - nb,
        ]
        np.testing.assert_allclose(out[:nb, :nb], diag)
