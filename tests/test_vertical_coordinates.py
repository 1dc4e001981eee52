"""Vertical-coordinate grid tests: metric-term sanity and terrain decay."""

from datetime import timedelta

import numpy as np
import pytest

from tasmania_jax.domain.grids import GalChen3d, SLEVE3d, Sigma3d
from tasmania_jax.framework.field import FieldArray


TOPO = {
    "max_height": FieldArray(np.asarray(800.0), "m", ()),
    "width_x": FieldArray(np.asarray(2e4), "m", ()),
    "width_y": FieldArray(np.asarray(2e4), "m", ()),
}


def make(cls, domain_z, nz, z_interface=None, **kwargs):
    return cls(
        (0.0, 1e5), 11, (0.0, 1e5), 11, domain_z, nz,
        z_interface=z_interface,
        topography_type="gaussian", topography_kwargs=TOPO,
        **kwargs,
    )


class TestGalChen:
    def test_terrain_decay(self):
        g = make(
            GalChen3d,
            FieldArray(np.array([10000.0, 0.0]), "m", ("z",)),
            20,
        )
        z_hl = np.asarray(g.height_on_interface_levels.data)
        # at the surface, height equals terrain
        np.testing.assert_allclose(
            z_hl[:, :, -1], np.asarray(g.topography.profile.data), atol=1e-8
        )
        # at the top (z=z_F), flat
        assert np.ptp(z_hl[:, :, 0]) < 1e-8
        # monotone decreasing with k (COSMO ordering top->surface)
        assert (np.diff(z_hl, axis=2) < 0).all()
        # reference pressure increases downward
        p = np.asarray(g.reference_pressure_on_interface_levels.data)
        assert (np.diff(p, axis=2) > 0).all()

    def test_update_topography_recomputes(self):
        topo = dict(TOPO)
        topo["time"] = timedelta(seconds=100)
        g = GalChen3d(
            (0.0, 1e5), 11, (0.0, 1e5), 11,
            FieldArray(np.array([10000.0, 0.0]), "m", ("z",)), 20,
            topography_type="gaussian", topography_kwargs=topo,
        )
        z0 = np.asarray(g.height_on_interface_levels.data)[:, :, -1].max()
        g.update_topography(timedelta(seconds=100))
        z1 = np.asarray(g.height_on_interface_levels.data)[:, :, -1].max()
        assert z0 == 0.0 and z1 > 700.0


class TestSLEVE:
    def test_decay_scales(self):
        g = make(
            SLEVE3d,
            FieldArray(np.array([10000.0, 0.0]), "m", ("z",)),
            20,
            niter=5,
        )
        z_hl = np.asarray(g.height_on_interface_levels.data)
        np.testing.assert_allclose(
            z_hl[:, :, -1], np.asarray(g.topography.profile.data), atol=1e-8
        )
        assert np.ptp(z_hl[:, :, 0]) < 1e-8
        # SLEVE decays terrain influence faster than Gal-Chen mid-atmosphere
        gc = make(GalChen3d, FieldArray(np.array([10000.0, 0.0]), "m", ("z",)), 20)
        z_gc = np.asarray(gc.height_on_interface_levels.data)
        k_mid = 10
        assert np.ptp(z_hl[:, :, k_mid]) < np.ptp(z_gc[:, :, k_mid])


class TestSigma:
    def test_sigma_profile(self):
        g = make(
            Sigma3d,
            FieldArray(np.array([0.2, 1.0]), "1", ("z",)),
            20,
        )
        p = np.asarray(g.reference_pressure_on_interface_levels.data)
        assert (np.diff(p, axis=2) > 0).all()
        z_hl = np.asarray(g.height_on_interface_levels.data)
        assert (np.diff(z_hl, axis=2) < 0).all()
        # over the mountain the surface pressure is lower
        ps = p[:, :, -1]
        assert ps[5, 5] < ps[0, 0]

    def test_invalid_sigma_raises(self):
        with pytest.raises(AssertionError):
            make(Sigma3d, FieldArray(np.array([0.2, 0.9]), "1", ("z",)), 10)
