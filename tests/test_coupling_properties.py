"""Property-based tests of the coupling property-derivation logic
(reference ``framework/concurrent_coupling_utils.py:48,169,428``): hypothesis
generates random component property sets; the derived input/tendency/
diagnostic properties and the overwrite flags must satisfy the union/
threading invariants of the reference implementation.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from tasmania_jax.domain import Domain
from tasmania_jax.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_jax.framework.core_components import (
    DiagnosticComponent,
    TendencyComponent,
)
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.utils.exceptions import PropertyError

hyp_settings = settings(
    deadline=None,
    max_examples=25,
    suppress_health_check=(HealthCheck.too_slow, HealthCheck.data_too_large),
)

DIMS = ("x", "y", "z")
NAMES = [f"f{i}" for i in range(6)]


def _domain():
    return Domain(
        (0.0, 1e5), 9, (0.0, 1e5), 9,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 4,
        horizontal_boundary_type="identity", nb=3,
    )


_DOMAIN = _domain()
_SHAPE = (9, 9, 4)


class SynthTendency(TendencyComponent):
    """Tendency component with declared random property sets."""

    def __init__(self, inputs, tendencies, diagnostics):
        super().__init__(_DOMAIN, "numerical")
        self._in = {n: {"dims": DIMS, "units": "kg"} for n in inputs}
        self._tn = {n: {"dims": DIMS, "units": "kg s^-1"} for n in tendencies}
        self._dg = {n: {"dims": DIMS, "units": "kg"} for n in diagnostics}

    @property
    def input_properties(self):
        return self._in

    @property
    def tendency_properties(self):
        return self._tn

    @property
    def diagnostic_properties(self):
        return self._dg

    def array_call(self, state):
        tends = {n: jnp.ones(_SHAPE) for n in self._tn}
        diags = {n: 2.0 * jnp.ones(_SHAPE) for n in self._dg}
        return tends, diags


class SynthDiagnostic(DiagnosticComponent):
    def __init__(self, inputs, diagnostics):
        super().__init__(_DOMAIN, "numerical")
        self._in = {n: {"dims": DIMS, "units": "kg"} for n in inputs}
        self._dg = {n: {"dims": DIMS, "units": "kg"} for n in diagnostics}

    @property
    def input_properties(self):
        return self._in

    @property
    def diagnostic_properties(self):
        return self._dg

    def array_call(self, state):
        return {n: 3.0 * jnp.ones(_SHAPE) for n in self._dg}


comp_strategy = st.tuples(
    st.lists(st.sampled_from(NAMES), max_size=3, unique=True),  # inputs
    st.lists(st.sampled_from(NAMES), max_size=3, unique=True),  # tendencies
    st.lists(st.sampled_from(NAMES), max_size=2, unique=True),  # diagnostics
)


@hyp_settings
@given(specs=st.lists(comp_strategy, min_size=1, max_size=4))
def test_serial_input_derivation_excludes_threaded_diagnostics(specs):
    comps = [SynthTendency(*s) for s in specs]
    cc = ConcurrentCoupling(*comps, execution_policy="serial")

    # reference semantics: an input is external iff no earlier component
    # provides it as a diagnostic
    expected = {}
    available = set()
    for inputs, _, diags in specs:
        for n in inputs:
            if n not in available and n not in expected:
                expected[n] = True
        available |= set(diags)
    assert set(cc.input_properties) == set(expected)

    # tendency properties are the union
    expected_t = set().union(*(set(t) for _, t, _ in specs)) if specs else set()
    assert set(cc.tendency_properties) == expected_t

    # diagnostics are the union
    expected_d = set().union(*(set(d) for _, _, d in specs)) if specs else set()
    assert set(cc.diagnostic_properties) == expected_d


@hyp_settings
@given(specs=st.lists(comp_strategy, min_size=1, max_size=4))
def test_asparallel_inputs_are_the_plain_union(specs):
    comps = [SynthTendency(*s) for s in specs]
    cc = ConcurrentCoupling(*comps, execution_policy="as_parallel")
    expected = set().union(*(set(i) for i, _, _ in specs)) if specs else set()
    assert set(cc.input_properties) == expected


@hyp_settings
@given(specs=st.lists(comp_strategy, min_size=1, max_size=4))
def test_overwrite_flags_mark_first_producer(specs):
    comps = [SynthTendency(*s) for s in specs]
    cc = ConcurrentCoupling(*comps)
    seen = set()
    for (_, tends, _), flags in zip(specs, cc.overwrite_tendencies):
        for n in tends:
            assert flags[n] == (n not in seen), (n, seen)
            seen.add(n)


@hyp_settings
@given(specs=st.lists(comp_strategy, min_size=1, max_size=3))
def test_execution_matches_declared_properties(specs):
    """Calling the serial coupling with exactly input_properties-many fields
    must produce exactly the declared tendency/diagnostic keys, with summed
    tendencies for repeated producers."""
    comps = [SynthTendency(*s) for s in specs]
    cc = ConcurrentCoupling(*comps, execution_policy="serial")

    state = {
        n: FieldArray(jnp.zeros(_SHAPE), "kg", DIMS) for n in cc.input_properties
    }
    tends, diags = cc(state, 1.0)
    tends.pop("time", None)
    diags.pop("time", None)
    assert set(tends) == set(cc.tendency_properties)
    assert set(diags) == set(cc.diagnostic_properties)
    # each producer contributes 1.0 per tendency
    producers = {}
    for _, tn, _ in specs:
        for n in tn:
            producers[n] = producers.get(n, 0) + 1
    for n, cnt in producers.items():
        np.testing.assert_allclose(np.asarray(tends[n].data), float(cnt))


def test_incompatible_units_raise():
    a = SynthTendency(["f0"], ["f1"], [])
    b = SynthTendency(["f0"], ["f1"], [])
    b._in["f0"]["units"] = "m s^-1"  # clash with a's kg
    with pytest.raises(PropertyError):
        ConcurrentCoupling(a, b, enable_checks=True)


def test_diagnostic_threading_in_serial_execution():
    """A diagnostic produced by component 1 feeds component 2's input and is
    not part of the coupling's external inputs."""
    a = SynthDiagnostic(["f0"], ["f1"])
    b = SynthTendency(["f1"], ["f2"], [])
    cc = ConcurrentCoupling(a, b, execution_policy="serial")
    assert set(cc.input_properties) == {"f0"}
    state = {"f0": FieldArray(jnp.zeros(_SHAPE), "kg", DIMS)}
    tends, diags = cc(state, 1.0)
    assert "f2" in tends and "f1" in diags
