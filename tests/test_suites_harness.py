"""Exercise the reusable suites with a concrete component oracle."""

import numpy as np

from tasmania_jax.framework.core_components import DiagnosticComponent, TendencyComponent

from suites import ComponentTestSuite, DomainSuite


class Doubler(DiagnosticComponent):
    @property
    def input_properties(self):
        return {"phi": {"dims": ("x", "y", "z"), "units": "m"}}

    @property
    def diagnostic_properties(self):
        return {"psi": {"dims": ("x", "y", "z"), "units": "m"}}

    def array_call(self, state):
        return {"psi": 2.0 * state["phi"]}


class DoublerSuite(ComponentTestSuite):
    def reference_call(self, raw):
        return {"psi": 2.0 * raw["phi"]}


class Decay(TendencyComponent):
    @property
    def input_properties(self):
        return {"phi": {"dims": ("x", "y", "z"), "units": "m"}}

    @property
    def tendency_properties(self):
        return {"phi": {"dims": ("x", "y", "z"), "units": "m s^-1"}}

    def array_call(self, state):
        return {"phi": -0.5 * state["phi"]}, {}


class DecaySuite(ComponentTestSuite):
    def reference_call(self, raw):
        return {"phi": -0.5 * raw["phi"]}, {}


def test_diagnostic_suite():
    ds = DomainSuite(np.random.default_rng(0))
    DoublerSuite(ds, Doubler(ds.domain, "numerical")).run_diagnostic()


def test_tendency_suite():
    ds = DomainSuite(np.random.default_rng(1))
    DecaySuite(ds, Decay(ds.domain, "numerical")).run_tendency()


# --------------------------------------------------------------------------- #
# harness axes: backend sweep, out-buffer merge/accumulate semantics           #
# --------------------------------------------------------------------------- #

import pytest

from suites import BACKENDS


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("with_out", [False, True])
def test_diagnostic_suite_axes(backend, with_out):
    ds = DomainSuite(np.random.default_rng(10), backend=backend)
    DoublerSuite(ds, Doubler(ds.domain, "numerical")).run_diagnostic(
        with_out=with_out
    )


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("with_out", [False, True])
def test_tendency_suite_axes(backend, with_out):
    ds = DomainSuite(np.random.default_rng(11), backend=backend)
    DecaySuite(ds, Decay(ds.domain, "numerical")).run_tendency(
        with_out=with_out
    )


def test_tendency_overwrite_flag():
    """overwrite_tendencies=True replaces the pre-filled buffer instead of
    accumulating (core_components.merge_tendencies)."""
    ds = DomainSuite(np.random.default_rng(12))
    comp = Decay(ds.domain, "numerical")
    state = {"phi": ds.random_field("phi", "m", 0.5, 2.0)}
    buf = {"phi": ds.random_field("phi", "m s^-1", -9.0, -8.0)}
    tends, _ = comp(
        state, out_tendencies=buf, overwrite_tendencies={"phi": True}
    )
    np.testing.assert_allclose(
        np.asarray(tends["phi"].data),
        -0.5 * np.asarray(state["phi"].data),
        atol=1e-12,
    )
