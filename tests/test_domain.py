"""Domain-layer tests: grids, topographies, boundaries.

Oracle style mirrors the reference's numpy-reference validation
(reference tests/domain/*, SURVEY.md §4): build small grids, check coordinates
and boundary algebra against straightforward numpy recomputation.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tasmania_jax.domain import Domain, HorizontalBoundary, PhysicalGrid
from tasmania_jax.framework.field import FieldArray


def make_grid(nx=12, ny=10, nz=4, topo="flat", topo_kwargs=None):
    return PhysicalGrid(
        (0.0, 1e4),
        nx,
        (0.0, 8e3),
        ny,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
        nz,
        topography_type=topo,
        topography_kwargs=topo_kwargs,
    )


class TestGrid:
    def test_axes(self):
        g = make_grid()
        assert g.nx == 12 and g.ny == 10 and g.nz == 4
        xv = np.asarray(g.x.data)
        assert xv.shape == (12,)
        np.testing.assert_allclose(xv[0], 0.0)
        np.testing.assert_allclose(xv[-1], 1e4)
        xu = np.asarray(g.x_at_u_locations.data)
        assert xu.shape == (13,)
        dx = float(np.asarray(g.dx.data))
        np.testing.assert_allclose(xu[1:] - xu[:-1], dx)
        zv = np.asarray(g.z.data)
        zhl = np.asarray(g.z_on_interface_levels.data)
        assert zv.shape == (4,) and zhl.shape == (5,)
        np.testing.assert_allclose(zv, 0.5 * (zhl[:-1] + zhl[1:]))
        # COSMO ordering: top -> surface
        assert zhl[0] == 400.0 and zhl[-1] == 300.0

    def test_gaussian_topography(self):
        g = make_grid(
            topo="gaussian",
            topo_kwargs={
                "max_height": FieldArray(np.asarray(1000.0), "m", ()),
                "width_x": FieldArray(np.asarray(2e3), "m", ()),
                "width_y": FieldArray(np.asarray(2e3), "m", ()),
            },
        )
        h = np.asarray(g.topography.steady_profile.data)
        assert h.shape == (12, 10)
        assert h.max() <= 1000.0 + 1e-10
        # peak near center
        imax = np.unravel_index(h.argmax(), h.shape)
        assert abs(imax[0] - 6) <= 1 and abs(imax[1] - 5) <= 1

    def test_time_dependent_topography(self):
        from datetime import timedelta

        g = make_grid(
            topo="gaussian",
            topo_kwargs={
                "max_height": FieldArray(np.asarray(1000.0), "m", ()),
                "time": timedelta(seconds=100),
            },
        )
        assert np.asarray(g.topography.profile.data).max() == 0.0
        g.update_topography(timedelta(seconds=50))
        np.testing.assert_allclose(
            np.asarray(g.topography.profile.data),
            0.5 * np.asarray(g.topography.steady_profile.data),
        )
        g.update_topography(timedelta(seconds=200))
        np.testing.assert_allclose(
            np.asarray(g.topography.profile.data),
            np.asarray(g.topography.steady_profile.data),
        )


def make_ref_state(hb, names=("phi", "phi_at_u_locations")):
    """Constant-in-time reference state over the numerical grid."""
    ni, nj, nz = hb.ni, hb.nj, hb.nz
    rng = np.random.default_rng(7)
    ref = {}
    for name in names:
        mi = ni + 1 if "at_u_locations" in name else ni
        mj = nj + 1 if "at_v_locations" in name else nj
        ref[name] = FieldArray(
            jnp.asarray(rng.normal(size=(mi, mj, nz))), "m s^-1", ("x", "y", "z")
        )
    return ref


@pytest.mark.parametrize("backend", ["numpy", "jax"])
class TestPeriodic:
    def test_roundtrip(self, backend):
        g = make_grid()
        hb = HorizontalBoundary.factory("periodic", g, 3, backend=backend)
        assert hb.ni == g.nx + 6 and hb.nj == g.ny + 6
        rng = np.random.default_rng(0)
        phi = rng.normal(size=(g.nx, g.ny, g.nz))
        if backend == "jax":
            phi = jnp.asarray(phi)
        num = hb.get_numerical_field(phi, "phi")
        assert num.shape == (g.nx + 6, g.ny + 6, g.nz)
        back = hb.get_physical_field(num, "phi")
        np.testing.assert_allclose(np.asarray(back), np.asarray(phi))

    def test_enforce_wraps(self, backend):
        g = make_grid()
        nb = 2
        hb = HorizontalBoundary.factory("periodic", g, nb, backend=backend)
        rng = np.random.default_rng(1)
        f = rng.normal(size=(g.nx + 2 * nb, g.ny + 2 * nb, g.nz))
        if backend == "jax":
            f = jnp.asarray(f)
        out = np.asarray(hb.enforce_field(f, "phi"))
        nx, ny = g.nx, g.ny
        # west ghosts equal east interior
        np.testing.assert_allclose(
            out[:nb, nb : ny + nb], out[nx - 1 : nx - 1 + nb, nb : ny + nb]
        )
        np.testing.assert_allclose(
            out[nx + nb : nx + 2 * nb, nb : ny + nb],
            out[nb + 1 : 2 * nb + 1, nb : ny + nb],
        )


class TestRelaxed:
    def test_gamma_matrix(self):
        g = make_grid(nx=20, ny=18)
        hb = HorizontalBoundary.factory("relaxed", g, 3, nr=6)
        gam = hb._gamma
        assert gam.shape == (21, 19)
        # innermost nb layers pinned
        assert gam[0, 9] == 1.0 and gam[2, 9] == 1.0
        # ramp decays
        assert gam[3, 9] == pytest.approx(1 - np.tanh(1.5))
        assert gam[5, 9] == pytest.approx(1 - np.tanh(2.5))
        assert gam[10, 9] == 0.0
        # staggered outermost pinned
        assert gam[20, 5] == 1.0

    def test_enforce(self):
        g = make_grid(nx=20, ny=18)
        hb = HorizontalBoundary.factory("relaxed", g, 3, nr=6)
        hb.reference_state = make_ref_state(hb)
        rng = np.random.default_rng(3)
        phi = jnp.asarray(rng.normal(size=(20, 18, g.nz)))
        out = np.asarray(
            hb.enforce_field(phi, field_name="phi", field_units="m s^-1")
        )
        ref = np.asarray(hb.reference_state["phi"].data)
        # pinned on edge
        np.testing.assert_allclose(out[0, 9], ref[0, 9])
        # untouched in the deep interior
        np.testing.assert_allclose(out[10, 9], np.asarray(phi)[10, 9])
        # blended at layer 4 (gamma = 1-tanh(2.0))
        gam = 1 - np.tanh(2.0)
        np.testing.assert_allclose(
            out[4, 9],
            np.asarray(phi)[4, 9] - gam * (np.asarray(phi)[4, 9] - ref[4, 9]),
        )

    def test_enforce_staggered(self):
        g = make_grid(nx=20, ny=18)
        hb = HorizontalBoundary.factory("relaxed", g, 3, nr=6)
        hb.reference_state = make_ref_state(hb)
        rng = np.random.default_rng(4)
        phi = jnp.asarray(rng.normal(size=(21, 18, g.nz)))
        out = np.asarray(
            hb.enforce_field(
                phi, field_name="phi_at_u_locations", field_units="m s^-1"
            )
        )
        ref = np.asarray(hb.reference_state["phi_at_u_locations"].data)
        np.testing.assert_allclose(out[20, 9], ref[20, 9])

    def test_set_outermost_layers(self):
        g = make_grid(nx=20, ny=18)
        hb = HorizontalBoundary.factory("relaxed", g, 3, nr=6)
        hb.reference_state = make_ref_state(hb)
        phi = jnp.zeros((21, 18, g.nz))
        out = np.asarray(
            hb.set_outermost_layers_x(
                phi, field_name="phi_at_u_locations", field_units="m s^-1"
            )
        )
        ref = np.asarray(hb.reference_state["phi_at_u_locations"].data)
        np.testing.assert_allclose(out[0], ref[0])
        np.testing.assert_allclose(out[20], ref[20])
        np.testing.assert_allclose(out[5], 0.0)


class TestIdentity:
    def test_noop(self):
        g = make_grid()
        hb = HorizontalBoundary.factory("identity", g, 3)
        phi = jnp.ones((g.nx, g.ny, g.nz))
        assert hb.enforce_field(phi, "phi") is phi
        assert hb.ni == g.nx and hb.nj == g.ny


class TestDirichlet:
    def test_enforce_zero_edges(self):
        g = make_grid()
        hb = HorizontalBoundary.factory("dirichlet", g, 2)
        phi = jnp.ones((g.nx, g.ny, g.nz))
        out = np.asarray(hb.enforce_field(phi, "phi", "m s^-1"))
        np.testing.assert_allclose(out[:2], 0.0)
        np.testing.assert_allclose(out[-2:], 0.0)
        np.testing.assert_allclose(out[2:-2, :2], 0.0)
        np.testing.assert_allclose(out[2:-2, -2:], 0.0)
        np.testing.assert_allclose(out[5, 5], 1.0)


class TestDomain:
    def test_build(self):
        d = Domain(
            (0.0, 1e4),
            12,
            (0.0, 8e3),
            10,
            FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
            4,
            horizontal_boundary_type="periodic",
            nb=3,
        )
        assert d.physical_grid.nx == 12
        assert d.numerical_grid.nx == 18
        assert d.horizontal_boundary.type == "periodic"


class TestOneD:
    def test_relaxed_1dx(self):
        g = make_grid(nx=20, ny=1)
        hb = HorizontalBoundary.factory("relaxed", g, 2, nr=4)
        assert hb.ni == 20 and hb.nj == 5
        hb.reference_state = make_ref_state(hb, names=("phi",))
        rng = np.random.default_rng(5)
        phi = jnp.asarray(rng.normal(size=(20, 5, g.nz)))
        out = np.asarray(hb.enforce_field(phi, "phi", "m s^-1"))
        ref = np.asarray(hb.reference_state["phi"].data)
        np.testing.assert_allclose(out[0, 2], ref[0, 2])
        # ghost columns replicate the innermost relaxed column
        np.testing.assert_allclose(out[:, 0], out[:, 2])
        np.testing.assert_allclose(out[:, 4], out[:, 2])

    def test_periodic_1dx(self):
        g = make_grid(nx=20, ny=1)
        hb = HorizontalBoundary.factory("periodic", g, 2)
        rng = np.random.default_rng(6)
        phi = rng.normal(size=(20, 1, g.nz))
        num = hb.get_numerical_field(phi, "phi")
        assert num.shape == (24, 5, g.nz)
        np.testing.assert_allclose(np.asarray(num[:, 0]), np.asarray(num[:, 2]))


def test_dirichlet_traced_time_core_under_jit():
    """Time-dependent Dirichlet forcing with a traced time input: the core
    returns jax arrays computed from ``t``, so a jitted loop sweeps the
    boundary values without retracing (dirichlet.py::_band)."""
    import jax
    import jax.numpy as jnp

    from tasmania_jax.domain.horizontal_boundary import HorizontalBoundary

    def core(time, grid, slice_x=None, slice_y=None, field_name=None, field_units=None):
        sx = slice_x or slice(0, grid.nx)
        sy = slice_y or slice(0, grid.ny)
        mi = (sx.stop or grid.nx) - (sx.start or 0)
        mj = (sy.stop or grid.ny) - (sy.start or 0)
        return jnp.full((mi, mj, 1), jnp.sin(time))

    grid = make_grid(8, 8, 4)
    hb = HorizontalBoundary.factory("dirichlet", grid, 2, core=core)

    traces = []

    def enforce(field, t):
        traces.append(1)
        return hb.enforce_field(field, "air_isentropic_density", "kg m^-2 K^-1", time=t)

    jitted = jax.jit(enforce)
    f = jnp.ones((8, 8, 4))
    out1 = jitted(f, 0.5)
    out2 = jitted(f, 1.5)
    assert len(traces) == 1  # no retrace for a new time
    np.testing.assert_allclose(np.asarray(out1)[0, :, 0], np.sin(0.5), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out2)[-1, :, 0], np.sin(1.5), rtol=1e-6)
    # interior untouched
    np.testing.assert_allclose(np.asarray(out1)[2:-2, 2:-2], 1.0)
