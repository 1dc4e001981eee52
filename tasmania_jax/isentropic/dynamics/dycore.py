"""The (moist) isentropic dynamical core.

JAX re-design of reference ``src/tasmania/isentropic/dynamics/dycore.py:55``:
per stage — diagnose water-constituent densities (moist), semi-implicit
prognostic step, lateral BC enforcement, vertical (Rayleigh) damping, velocity
diagnosis from momenta, staggered outermost-layer setting
(``stage_array_call_dry`` ``:641-721``, ``_moist`` ``:723-843``).

Note on smoothing options: the reference accepts ``smooth*`` constructor
options but its current stage calls never apply them (dead options; smoothing
is provided by the separate ``IsentropicHorizontalSmoothing`` physics
component).  The same options are accepted and ignored here for behavioural
parity.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from tasmania_jax.dwarfs.diagnostics import HorizontalVelocity, WaterConstituent
from tasmania_jax.dwarfs.vertical_damping import VerticalDamping
from tasmania_jax.framework.dycore import DynamicalCore
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.isentropic.dynamics.prognostic import IsentropicPrognostic
from tasmania_jax.utils.array import get_namespace

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
DIMS_U = ("x_at_u_locations", "y", "z")
DIMS_V = ("x", "y_at_v_locations", "z")


class IsentropicDynamicalCore(DynamicalCore):
    def __init__(
        self,
        domain,
        fast_tendency_component=None,
        fast_diagnostic_component=None,
        substeps: int = 0,
        superfast_tendency_component=None,
        superfast_diagnostic_component=None,
        moist: bool = False,
        time_integration_scheme: str = "forward_euler_si",
        horizontal_flux_scheme: str = "upwind",
        time_integration_properties: Optional[Dict[str, Any]] = None,
        damp: bool = True,
        damp_at_every_stage: bool = True,
        damp_type: str = "rayleigh",
        damp_depth: int = 15,
        damp_max: float = 0.0002,
        smooth: bool = True,
        smooth_at_every_stage: bool = True,
        smooth_type: str = "first_order",
        smooth_coeff: float = 0.03,
        smooth_coeff_max: float = 0.24,
        smooth_damp_depth: int = 10,
        smooth_moist: bool = False,
        smooth_moist_at_every_stage: bool = True,
        smooth_moist_type: str = "first_order",
        smooth_moist_coeff: float = 0.03,
        smooth_moist_coeff_max: float = 0.24,
        smooth_moist_damp_depth: int = 10,
        *,
        enable_checks: bool = True,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__(
            domain,
            fast_tendency_component=fast_tendency_component,
            fast_diagnostic_component=fast_diagnostic_component,
            substeps=substeps,
            superfast_tendency_component=superfast_tendency_component,
            superfast_diagnostic_component=superfast_diagnostic_component,
            enable_checks=enable_checks,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )
        self._moist = moist
        self._damp = damp
        self._damp_at_every_stage = damp_at_every_stage

        ti_kwargs = dict(time_integration_properties or {})
        self._prognostic = IsentropicPrognostic.factory(
            time_integration_scheme,
            horizontal_flux_scheme,
            domain,
            moist,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
            **ti_kwargs,
        )

        if damp:
            self._damper = VerticalDamping.factory(
                damp_type,
                self.grid,
                damp_depth,
                damp_max,
                "s",
                backend=backend,
                backend_options=backend_options,
                storage_options=storage_options,
            )
        self._velocity_components = HorizontalVelocity(
            self.grid,
            staggering=True,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )
        if moist:
            self._water_constituent = WaterConstituent(
                self.grid,
                clipping=True,
                backend=backend,
                backend_options=backend_options,
                storage_options=storage_options,
            )
        # per-timestep "now" capture for the damper (reference dycore ``:647-670``)
        self._damp_now: Dict[str, Any] = {}

    # -- properties ------------------------------------------------------------ #
    @property
    def stages(self) -> int:
        return self._prognostic.stages

    @property
    def stage_input_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "montgomery_potential": {"dims": DIMS, "units": "m^2 s^-2"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "x_velocity_at_u_locations": {"dims": DIMS_U, "units": "m s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_velocity_at_v_locations": {"dims": DIMS_V, "units": "m s^-1"},
        }
        if self._moist:
            props[mfwv] = {"dims": DIMS, "units": "g g^-1"}
            props[mfcw] = {"dims": DIMS, "units": "g g^-1"}
            props[mfpw] = {"dims": DIMS, "units": "g g^-1"}
        return props

    @property
    def stage_tendency_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1 s^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }
        if self._moist:
            props[mfwv] = {"dims": DIMS, "units": "g g^-1 s^-1"}
            props[mfcw] = {"dims": DIMS, "units": "g g^-1 s^-1"}
            props[mfpw] = {"dims": DIMS, "units": "g g^-1 s^-1"}
        return props

    @property
    def stage_output_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "x_velocity_at_u_locations": {"dims": DIMS_U, "units": "m s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_velocity_at_v_locations": {"dims": DIMS_V, "units": "m s^-1"},
        }
        if self._moist:
            props[mfwv] = {"dims": DIMS, "units": "g g^-1"}
            props[mfcw] = {"dims": DIMS, "units": "g g^-1"}
            props[mfpw] = {"dims": DIMS, "units": "g g^-1"}
        return props

    @property
    def output_properties(self):
        # the new Montgomery potential is NOT produced by the stage; a
        # diagnostic component (fast_diagnostic_component or external
        # IsentropicDiagnostics) refreshes it — parity with the reference.
        return super().output_properties

    # -- stage ------------------------------------------------------------------ #
    def stage_array_call(self, stage, raw_state, raw_tendencies, timestep):
        if self._moist:
            return self._stage_moist(stage, raw_state, raw_tendencies, timestep)
        return self._stage_dry(stage, raw_state, raw_tendencies, timestep)

    def _ref_raw(self, name: str, units: str):
        ref = self.horizontal_boundary.reference_state[name]
        return ref.to_units(units).data

    def _stage_dry(self, stage, raw_state, raw_tendencies, timestep):
        """reference ``dycore.py:641-721``"""
        hb = self.horizontal_boundary

        if self._damp and stage == 0:
            self._damp_now = {
                "s": raw_state["air_isentropic_density"],
                "su": raw_state["x_momentum_isentropic"],
                "sv": raw_state["y_momentum_isentropic"],
            }

        out = self._prognostic.stage_call(stage, timestep, raw_state, raw_tendencies)

        out = hb.enforce_raw(
            out,
            field_properties={
                k: v for k, v in self.stage_output_properties.items() if k in out
            },
        )

        s_new = out["air_isentropic_density"]
        su_new = out["x_momentum_isentropic"]
        sv_new = out["y_momentum_isentropic"]

        if self._damp and (self._damp_at_every_stage or stage == self.stages - 1):
            s_ref = self._ref_raw("air_isentropic_density", "kg m^-2 K^-1")
            su_ref = self._ref_raw("x_momentum_isentropic", "kg m^-1 K^-1 s^-1")
            sv_ref = self._ref_raw("y_momentum_isentropic", "kg m^-1 K^-1 s^-1")
            s_new = self._damper(timestep, self._damp_now["s"], s_new, s_ref)
            su_new = self._damper(timestep, self._damp_now["su"], su_new, su_ref)
            sv_new = self._damper(timestep, self._damp_now["sv"], sv_new, sv_ref)
            out["air_isentropic_density"] = s_new
            out["x_momentum_isentropic"] = su_new
            out["y_momentum_isentropic"] = sv_new

        u_new, v_new = self._velocity_components.get_velocity_components(
            s_new, su_new, sv_new
        )
        u_new = hb.set_outermost_layers_x(
            u_new, "x_velocity_at_u_locations", "m s^-1", time=None
        )
        v_new = hb.set_outermost_layers_y(
            v_new, "y_velocity_at_v_locations", "m s^-1", time=None
        )
        out["x_velocity_at_u_locations"] = u_new
        out["y_velocity_at_v_locations"] = v_new
        return out

    def _stage_moist(self, stage, raw_state, raw_tendencies, timestep):
        """reference ``dycore.py:723-843``"""
        hb = self.horizontal_boundary
        wc = self._water_constituent

        if self._damp and stage == 0:
            self._damp_now = {
                "s": raw_state["air_isentropic_density"],
                "su": raw_state["x_momentum_isentropic"],
                "sv": raw_state["y_momentum_isentropic"],
            }

        # water mass fractions -> densities (reference ``:766-774``) happens
        # INSIDE the prognostic step, fused by XLA into the flux stencil: the
        # input sq fields never materialize
        out = self._prognostic.stage_call(
            stage, timestep, raw_state, raw_tendencies
        )

        s_new = out["air_isentropic_density"]
        sqv_new = out.pop("isentropic_density_of_water_vapor")
        sqc_new = out.pop("isentropic_density_of_cloud_liquid_water")
        sqr_new = out.pop("isentropic_density_of_precipitation_water")

        # densities -> mass fractions (reference ``:798-806``)
        out[mfwv] = wc.get_mass_fraction_of_water_constituent_in_air(s_new, sqv_new)
        out[mfcw] = wc.get_mass_fraction_of_water_constituent_in_air(s_new, sqc_new)
        out[mfpw] = wc.get_mass_fraction_of_water_constituent_in_air(s_new, sqr_new)

        out = hb.enforce_raw(
            out,
            field_properties={
                k: v for k, v in self.stage_output_properties.items() if k in out
            },
        )
        s_new = out["air_isentropic_density"]
        su_new = out["x_momentum_isentropic"]
        sv_new = out["y_momentum_isentropic"]

        if self._damp and (self._damp_at_every_stage or stage == self.stages - 1):
            s_ref = self._ref_raw("air_isentropic_density", "kg m^-2 K^-1")
            su_ref = self._ref_raw("x_momentum_isentropic", "kg m^-1 K^-1 s^-1")
            sv_ref = self._ref_raw("y_momentum_isentropic", "kg m^-1 K^-1 s^-1")
            s_new = self._damper(timestep, self._damp_now["s"], s_new, s_ref)
            su_new = self._damper(timestep, self._damp_now["su"], su_new, su_ref)
            sv_new = self._damper(timestep, self._damp_now["sv"], sv_new, sv_ref)
            out["air_isentropic_density"] = s_new
            out["x_momentum_isentropic"] = su_new
            out["y_momentum_isentropic"] = sv_new

        u_new, v_new = self._velocity_components.get_velocity_components(
            s_new, su_new, sv_new
        )
        u_new = hb.set_outermost_layers_x(
            u_new, "x_velocity_at_u_locations", "m s^-1", time=None
        )
        v_new = hb.set_outermost_layers_y(
            v_new, "y_velocity_at_v_locations", "m s^-1", time=None
        )
        out["x_velocity_at_u_locations"] = u_new
        out["y_velocity_at_v_locations"] = v_new
        return out
