"""Time steppers wrapping tendency components: FE / RK2 / RK2SA / RK3WS,
plus the sequential-tendency variants.

JAX re-design of reference ``src/tasmania/framework/steppers.py:45,142``
and ``framework/subclasses/{tendency_steppers,sequential_tendency_steppers}/``.
The RK stage loops are unrolled at trace time; the dict algebra (``fma``,
``sts_rk2_0``, ``sts_rk3ws_0``) is pytree arithmetic that XLA fuses with the
tendency evaluation — the whole stepper traces into one device program.

Stage algebra (verified against the reference implementations):

* FE     : out  = x + dt·f(x)                                    (``forward_euler.py:55-83``)
* RK2    : x₁ = x + dt/2·f(x);  out = x + dt·f(x₁)               (``rk2.py``)
* RK2SA  : same as RK2 but returns stage-2 diagnostics           (``rk2sa.py``)
* RK3WS  : x₁ = x + dt/3·f(x); x₂ = x + dt/2·f(x₁);
           out = x + dt·f(x₂)                                    (``rk3ws.py:61-160``)
* STS-FE : out = x' + dt·f(x)
* STS-RK2: x₁ = ½(x + x' + dt·f(x));  out = x' + dt·f(x₁)
* STS-RK3WS: x₁ = (2x + x' + dt·f(x))/3; x₂ = ½(x + x' + dt·f(x₁));
           out = x' + dt·f(x₂)          (x' = provisional state)
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Optional, Tuple

from tasmania_jax.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_jax.framework.dict_operator import DictOperator
from tasmania_jax.framework.field import ensure_timedelta_seconds
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.utils.units import strip_per_second

PropertyDict = Dict[str, Dict[str, Any]]


class _StepperBase:
    """Shared scaffolding for both stepper families."""

    def __init__(
        self,
        *args,
        execution_policy: str = "serial",
        enforce_horizontal_boundary: bool = False,
        enable_checks: bool = True,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
        **kwargs,
    ) -> None:
        if len(args) == 1 and isinstance(args[0], ConcurrentCoupling):
            self._coupling = args[0]
        else:
            self._coupling = ConcurrentCoupling(
                *args,
                execution_policy=execution_policy,
                enable_checks=enable_checks,
                backend=backend,
                backend_options=backend_options,
                storage_options=storage_options,
            )
        self._dict_op = DictOperator()

        # properties (mirrors sympl TendencyStepper property derivation)
        self.diagnostic_properties = dict(self._coupling.diagnostic_properties)
        cin = self._coupling.input_properties
        self.output_properties: PropertyDict = {}
        for name, tprops in self._coupling.tendency_properties.items():
            units = (
                cin[name]["units"]
                if name in cin
                else strip_per_second(tprops.get("units", "s^-1"))
            )
            self.output_properties[name] = {
                **{k: v for k, v in tprops.items() if k != "units"},
                "units": units,
            }
        self.input_properties: PropertyDict = dict(cin)
        for name, props in self.output_properties.items():
            self.input_properties.setdefault(name, dict(props))
        self.provisional_input_properties: PropertyDict = dict(self.output_properties)

        # boundary enforcement hook (reference ``steppers.py:117-135``)
        self._enforce_hb = False
        self._hb = None
        if enforce_horizontal_boundary:
            hb = self._coupling.horizontal_boundary
            if hb is not None:
                self._hb = hb
                self._enforce_hb = True

    @property
    def prognostic(self) -> ConcurrentCoupling:
        return self._coupling

    def get_increment(self, state, timestep):
        """(tendencies, diagnostics) of the wrapped coupling."""
        return self._coupling(state, timestep)

    # -- helpers ----------------------------------------------------------------- #
    def _post_stage(self, state, stepped, frac_dt: timedelta):
        """Apply BCs, rebuild a complete stage state, advance its time."""
        if self._enforce_hb:
            stepped = self._hb.enforce(
                stepped, field_names=tuple(self.output_properties.keys())
            )
        stage_state = dict(state)
        stage_state.update(stepped)
        if "time" in state:
            stage_state["time"] = state["time"] + frac_dt
        return stepped, stage_state


class TendencyStepper(_StepperBase):
    """Factory base: ``TendencyStepper.factory("rk3ws", *components)``
    (reference ``steppers.py:45``)."""

    registry: Dict[str, type] = {}

    def __call__(self, state, timestep) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Step ``state`` by ``timestep``; returns (diagnostics, new_state)."""
        dt = ensure_timedelta_seconds(timestep)
        td = timedelta(seconds=dt)
        diagnostics, out_state = self._call(state, dt, td)
        if "time" in state:
            out_state["time"] = state["time"] + td
        return diagnostics, out_state

    def _call(self, state, dt: float, td: timedelta):
        raise NotImplementedError

    @staticmethod
    def factory(scheme: str, *args, **kwargs) -> "TendencyStepper":
        return factorize(scheme, TendencyStepper, args, kwargs)


class SequentialTendencyStepper(_StepperBase):
    """Steppers receiving a (current, provisional) state pair
    (reference ``steppers.py:142``)."""

    registry: Dict[str, type] = {}

    def __call__(
        self, state, prv_state, timestep
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        dt = ensure_timedelta_seconds(timestep)
        td = timedelta(seconds=dt)
        diagnostics, out_state = self._call(state, prv_state, dt, td)
        if "time" in state:
            out_state["time"] = state["time"] + td
        return diagnostics, out_state

    def _call(self, state, prv_state, dt: float, td: timedelta):
        raise NotImplementedError

    @staticmethod
    def factory(scheme: str, *args, **kwargs) -> "SequentialTendencyStepper":
        return factorize(scheme, SequentialTendencyStepper, args, kwargs)


# ------------------------------------------------------------------------------ #
# tendency steppers                                                              #
# ------------------------------------------------------------------------------ #


@factor_register("forward_euler")
class ForwardEuler(TendencyStepper):
    name = "forward_euler"

    def _call(self, state, dt, td):
        k1, diagnostics = self.get_increment(state, td)
        out = self._dict_op.fma(state, k1, dt, self.output_properties)
        out, _ = self._post_stage(state, out, td)
        return diagnostics, out


@factor_register("rk2")
class RK2(TendencyStepper):
    name = "rk2"

    def _call(self, state, dt, td):
        k1, diagnostics = self.get_increment(state, td)
        s1 = self._dict_op.fma(state, k1, 0.5 * dt, self.output_properties)
        _, stage1 = self._post_stage(state, s1, td / 2)

        k2, _ = self.get_increment(stage1, td)
        out = self._dict_op.fma(state, k2, dt, self.output_properties)
        out, _ = self._post_stage(state, out, td)
        return diagnostics, out


@factor_register("rk2sa")
class RK2SA(TendencyStepper):
    """RK2 returning the *second*-stage diagnostics (ad-hoc for
    KesslerSaturationAdjustmentDiagnostic, reference ``rk2sa.py``)."""

    name = "rk2sa"

    def _call(self, state, dt, td):
        k1, _ = self.get_increment(state, td)
        s1 = self._dict_op.fma(state, k1, 0.5 * dt, self.output_properties)
        _, stage1 = self._post_stage(state, s1, td / 2)

        k2, diagnostics = self.get_increment(stage1, td)
        out = self._dict_op.fma(state, k2, dt, self.output_properties)
        out, _ = self._post_stage(state, out, td)
        return diagnostics, out


@factor_register("rk3ws")
class RK3WS(TendencyStepper):
    """Wicker–Skamarock three-stage RK (Doms & Baldauf 2015)."""

    name = "rk3ws"

    def _call(self, state, dt, td):
        k1, diagnostics = self.get_increment(state, td)
        s1 = self._dict_op.fma(state, k1, dt / 3.0, self.output_properties)
        _, stage1 = self._post_stage(state, s1, td / 3)

        k2, _ = self.get_increment(stage1, td)
        s2 = self._dict_op.fma(state, k2, 0.5 * dt, self.output_properties)
        _, stage2 = self._post_stage(state, s2, td / 2)

        k3, _ = self.get_increment(stage2, td)
        out = self._dict_op.fma(state, k3, dt, self.output_properties)
        out, _ = self._post_stage(state, out, td)
        return diagnostics, out


# ------------------------------------------------------------------------------ #
# sequential-tendency steppers                                                   #
# ------------------------------------------------------------------------------ #


@factor_register("forward_euler")
class ForwardEulerSTS(SequentialTendencyStepper):
    name = "forward_euler"

    def _call(self, state, prv_state, dt, td):
        k1, diagnostics = self.get_increment(state, td)
        out = self._dict_op.fma(prv_state, k1, dt, self.output_properties)
        out, _ = self._post_stage(state, out, td)
        return diagnostics, out


@factor_register("rk2")
class RK2STS(SequentialTendencyStepper):
    name = "rk2"

    def _call(self, state, prv_state, dt, td):
        k1, diagnostics = self.get_increment(state, td)
        s1 = self._dict_op.sts_rk2_0(dt, state, prv_state, k1, self.output_properties)
        _, stage1 = self._post_stage(state, s1, td / 2)

        k2, _ = self.get_increment(stage1, td)
        out = self._dict_op.fma(prv_state, k2, dt, self.output_properties)
        out, _ = self._post_stage(state, out, td)
        return diagnostics, out


@factor_register("rk3ws")
class RK3WSSTS(SequentialTendencyStepper):
    name = "rk3ws"

    def _call(self, state, prv_state, dt, td):
        k1, diagnostics = self.get_increment(state, td)
        s1 = self._dict_op.sts_rk3ws_0(dt, state, prv_state, k1, self.output_properties)
        _, stage1 = self._post_stage(state, s1, td / 3)

        k2, _ = self.get_increment(stage1, td)
        s2 = self._dict_op.sts_rk2_0(dt, state, prv_state, k2, self.output_properties)
        _, stage2 = self._post_stage(state, s2, td / 2)

        k3, _ = self.get_increment(stage2, td)
        out = self._dict_op.fma(prv_state, k3, dt, self.output_properties)
        out, _ = self._post_stage(state, out, td)
        return diagnostics, out
