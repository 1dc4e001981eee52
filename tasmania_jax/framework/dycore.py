"""Abstract multi-stage dynamical-core driver.

JAX re-design of reference ``src/tasmania/framework/dycore.py:59``:
the stage loop (``:455-462``), per-stage ``call`` (``:464-720``) with fast
tendency/diagnostic hooks, and the raw-array stage interface
(``stage_array_call``, ``:722``).  Functional: one ``__call__`` maps
(state, slow_tendencies, dt) -> new state; under ``jax.jit`` the whole
multi-stage loop unrolls into a single device program and XLA reuses/donates
buffers — the reference's preallocated stage-output machinery is unnecessary.

Substepping — scaffolded but dead in the reference (``dycore.py:590-592``
raises ``NotImplementedError``) — is *implemented* here, following the
reference's commented design (``dycore.py:594-680``): per stage, the subset of
variables named by ``substep_output_properties`` is re-advanced by
``int(substep_fractions[stage] * substeps)`` substeps of ``dt / substeps``,
with the superfast tendency component evaluated before and the superfast
diagnostic component after every substep.
"""

from __future__ import annotations

import abc
from datetime import timedelta
from typing import Any, Dict, Mapping, Optional, Tuple

from tasmania_jax.framework.base_components import DomainComponent
from tasmania_jax.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_jax.framework.core_components import merge_tendencies
from tasmania_jax.framework.dict_operator import DictOperator
from tasmania_jax.framework.field import (
    FieldArray,
    ensure_timedelta_seconds,
    field_dims,
    get_array_dict,
)
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.timer import Timer

PropertyDict = Mapping[str, Mapping[str, Any]]


class DynamicalCore(DomainComponent, StencilFactory, abc.ABC):
    def __init__(
        self,
        domain,
        fast_tendency_component=None,
        fast_diagnostic_component=None,
        substeps: int = 0,
        superfast_tendency_component=None,
        superfast_diagnostic_component=None,
        *,
        enable_checks: bool = True,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        DomainComponent.__init__(self, domain, "numerical")
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self._enable_checks = enable_checks
        self._dict_op = DictOperator()

        wrap = lambda c: (
            None
            if c is None
            else (c if isinstance(c, ConcurrentCoupling) else ConcurrentCoupling(c))
        )
        self.fast_tendency_component = wrap(fast_tendency_component)
        self.fast_diagnostic_component = wrap(fast_diagnostic_component)
        self.substeps = int(substeps)
        self.superfast_tendency_component = wrap(superfast_tendency_component)
        self.superfast_diagnostic_component = wrap(superfast_diagnostic_component)

    # -- abstract stage interface ------------------------------------------------ #
    @property
    @abc.abstractmethod
    def stage_input_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def stage_tendency_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def stage_output_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def stages(self) -> int:
        ...

    @abc.abstractmethod
    def stage_array_call(
        self,
        stage: int,
        raw_state: Mapping[str, Any],
        raw_tendencies: Mapping[str, Any],
        timestep: float,
    ) -> Dict[str, Any]:
        """Raw stage step: arrays in declared units -> raw stepped arrays."""

    # -- substep interface (reference ``dycore.py:277-355,751``; defaults
    # disable substepping, mirroring the reference's `len(...) == 0` gate) ------ #
    @property
    def substep_input_properties(self) -> PropertyDict:
        """Variables the substep step reads (reference ``dycore.py:277``)."""
        return {}

    @property
    def substep_tendency_properties(self) -> PropertyDict:
        """Tendencies the substep step may consume (reference ``:297``)."""
        return {}

    @property
    def substep_output_properties(self) -> PropertyDict:
        """Variables the substep step re-advances; empty disables substepping
        (reference ``:317,576``)."""
        return {}

    @property
    def substep_fractions(self):
        """Per-stage fraction of ``substeps`` to run (reference ``:334``)."""
        return tuple(1.0 for _ in range(self.stages))

    def substep_array_call(
        self,
        stage: int,
        substep: int,
        raw_state: Mapping[str, Any],
        raw_stage_state: Mapping[str, Any],
        raw_substep_state: Mapping[str, Any],
        raw_tendencies: Mapping[str, Any],
        timestep: float,
    ) -> Dict[str, Any]:
        """One substep (reference commented design ``dycore.py:652-660``):
        ``raw_state`` is the timestep-start state, ``raw_stage_state`` the
        output of ``stage_array_call``, ``raw_substep_state`` the latest
        substepped values; ``timestep`` is the FULL dt (divide by
        ``self.substeps`` for the substep increment)."""
        raise NotImplementedError(
            "substeps > 0 with non-empty substep_output_properties requires "
            "the subclass to implement substep_array_call"
        )

    # -- public properties (derived) --------------------------------------------- #
    @property
    def input_properties(self) -> PropertyDict:
        props = dict(self.stage_input_properties)
        for comp in (self.fast_tendency_component, self.superfast_tendency_component):
            if comp is not None:
                for name, p in comp.input_properties.items():
                    props.setdefault(name, dict(p))
        for name, p in self.substep_input_properties.items():
            props.setdefault(name, dict(p))
        return props

    @property
    def input_tendency_properties(self) -> PropertyDict:
        return dict(self.stage_tendency_properties)

    @property
    def output_properties(self) -> PropertyDict:
        props = dict(self.stage_output_properties)
        fdc = self.fast_diagnostic_component
        if fdc is not None:
            for name, p in fdc.diagnostic_properties.items():
                props.setdefault(name, dict(p))
        return props

    # -- execution ---------------------------------------------------------------- #
    def __call__(
        self,
        state: Mapping[str, Any],
        tendencies: Mapping[str, Any],
        timestep,
        *,
        out_state: Optional[Mapping[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Advance ``state`` one timestep (reference ``dycore.py:383``)."""
        dt = ensure_timedelta_seconds(timestep)
        tmp_state = dict(state)
        fast_tends_carry: Dict[str, Any] = {}
        for stage in range(self.stages):
            tmp_state, fast_tends_carry = self._stage_call(
                stage, dt, state, tendencies, tmp_state, fast_tends_carry
            )
        if "time" in state:
            tmp_state["time"] = state["time"] + timedelta(seconds=dt)
        return tmp_state

    def _stage_call(
        self,
        stage: int,
        dt: float,
        state: Mapping[str, Any],
        slow_tendencies: Mapping[str, Any],
        tmp_state: Dict[str, Any],
        fdc_tendencies: Mapping[str, Any],
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """One stage (reference ``dycore.py:464``): merge slow+fast tendencies,
        run the fast tendency component on the provisional state, step, then run
        the fast diagnostic component on the stage output."""
        # slow tendencies + tendencies from the previous stage's fast
        # diagnostic component
        fast_tends: Dict[str, Any] = {
            k: v for k, v in slow_tendencies.items() if k != "time"
        }
        fast_tends = merge_tendencies(fast_tends, fdc_tendencies, None)

        ftc = self.fast_tendency_component
        if ftc is not None:
            with Timer.timing("call_fast_tendency_component"):
                fast_tends, ftc_diags = ftc(
                    tmp_state, timedelta(seconds=dt), out_tendencies=fast_tends
                )
                tmp_state = self._dict_op.update(tmp_state, ftc_diags)

        # raw extraction (unit conversion at the boundary)
        raw_state = get_array_dict(tmp_state, self.stage_input_properties)
        if "time" in tmp_state:
            raw_state["time"] = tmp_state["time"]
        if "topography_height" in tmp_state:
            th = tmp_state["topography_height"]
            raw_state["topography_height"] = (
                th.to_units("m").data if isinstance(th, FieldArray) else th
            )
        raw_tends = get_array_dict(
            {k: v for k, v in fast_tends.items() if k in self.stage_tendency_properties},
            {
                k: p
                for k, p in self.stage_tendency_properties.items()
                if k in fast_tends
            },
        )

        with Timer.timing("stage"):
            raw_out = self.stage_array_call(stage, raw_state, raw_tends, dt)

        # wrap + carry over non-stepped variables (incl. the per-stage time a
        # scheme-aware stepper may have set)
        stage_state: Dict[str, Any] = dict(tmp_state)
        if "time" in raw_out:
            stage_state["time"] = raw_out["time"]
        for name, arr in raw_out.items():
            if name == "time":
                continue
            props = self.stage_output_properties.get(name, {})
            stage_state[name] = FieldArray(
                arr, props.get("units", "1"), field_dims(name)
            )

        # substepping (reference commented design ``dycore.py:594-680``)
        if self.substeps > 0 and len(self.substep_output_properties) > 0:
            with Timer.timing("substeps"):
                stage_state = self._substep_loop(
                    stage, dt, state, raw_out, tmp_state, stage_state
                )

        # fast diagnostic component on the stage output
        new_fdc_tends: Dict[str, Any] = {}
        fdc = self.fast_diagnostic_component
        if fdc is not None:
            with Timer.timing("call_fast_diagnostic_component"):
                new_fdc_tends, fdc_diags = fdc(stage_state, timedelta(seconds=dt))
                stage_state = self._dict_op.update(stage_state, fdc_diags)
            new_fdc_tends.pop("time", None)

        return stage_state, new_fdc_tends

    def _substep_loop(
        self,
        stage: int,
        dt: float,
        state: Mapping[str, Any],
        raw_stage_state: Mapping[str, Any],
        stage_input_state: Mapping[str, Any],
        stage_state: Dict[str, Any],
    ) -> Dict[str, Any]:
        """Re-advance the ``substep_output_properties`` variables from their
        stage-input values in ``int(frac * substeps)`` forward substeps of
        ``dt / substeps`` each, driving the superfast components per substep
        (completes the reference's dead scaffold, ``dycore.py:613-680``)."""
        frac = 1.0 if self.stages == 1 else self.substep_fractions[stage]
        # truncating, may be 0 for early stages (reference scaffold semantics,
        # ``dycore.py:613``): with n == 0 the loop body never runs and the
        # substepped variables keep their stage-input values via the copy-back
        n = int(frac * self.substeps)

        raw_state = get_array_dict(
            {k: v for k, v in state.items() if k in self.substep_input_properties},
            {k: p for k, p in self.substep_input_properties.items() if k in state},
        )

        # substepped variables restart from the stage-input state; everything
        # else carries the stage output
        out_state: Dict[str, Any] = dict(stage_state)
        for name in self.substep_output_properties:
            if name in stage_input_state:
                out_state[name] = stage_input_state[name]

        stc = self.superfast_tendency_component
        sdc = self.superfast_diagnostic_component
        sub_td = timedelta(seconds=dt / self.substeps)

        for substep in range(n):
            tends: Mapping[str, Any] = {}
            if stc is not None:
                tends, diags = stc(out_state, sub_td)
                out_state = self._dict_op.update(out_state, diags)

            raw_substep_state = get_array_dict(out_state, self.substep_input_properties)
            raw_tends = get_array_dict(
                {k: v for k, v in tends.items() if k in self.substep_tendency_properties},
                {
                    k: p
                    for k, p in self.substep_tendency_properties.items()
                    if k in tends
                },
            )

            raw_sub_out = self.substep_array_call(
                stage, substep, raw_state, raw_stage_state, raw_substep_state, raw_tends, dt
            )
            for name, arr in raw_sub_out.items():
                props = self.substep_output_properties.get(name, {})
                out_state[name] = FieldArray(
                    arr, props.get("units", "1"), field_dims(name)
                )

            if sdc is not None:
                _, sdc_diags = sdc(out_state, sub_td)
                out_state = self._dict_op.update(out_state, sdc_diags)

        for name in self.substep_output_properties:
            if name in out_state:
                stage_state[name] = out_state[name]
        return stage_state
