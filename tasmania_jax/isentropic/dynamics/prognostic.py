"""Prognostic (stage) schemes of the isentropic dynamical core.

JAX re-design of reference
``src/tasmania/isentropic/dynamics/prognostic.py:54`` and
``subclasses/prognostics/{forward_euler_si,centered_si,rk3ws_si}.py``:
semi-implicit schemes treating horizontal advection explicitly and the
pressure-gradient (Montgomery) term implicitly with off-centering ``eps``.
Each stage: flux-form step of density (+ water species) → lateral BC on the
stepped density → Montgomery recomputation (cumsum scan) → momentum step with
``(1−eps)·s_now·∇mtg_now + eps·s_new·∇mtg_new``
(reference ``rk3ws_si.py:105-231``, step stencils
``subclasses/prognostics/utils.py:44,138``).

Functional: ``stage_call`` maps raw dicts to a new raw dict; the stage-0 "now"
capture mirrors the reference's pointers and is trace-safe (all stages trace
within one jitted dycore call).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from tasmania_jax.framework.base_components import DomainComponent
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.isentropic.dynamics.diagnostics import IsentropicDiagnostics
from tasmania_jax.isentropic.dynamics.horizontal_fluxes import (
    IsentropicMinimalHorizontalFlux,
)
from tasmania_jax.utils.array import get_namespace

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"


def _paste_interior(base, interior, nb, xp):
    """base with the (nb..-nb, nb..-nb) horizontal window replaced."""
    sl = (slice(nb, base.shape[0] - nb), slice(nb, base.shape[1] - nb))
    if xp is np:
        out = np.array(base, copy=True)
        out[sl] = interior
        return out
    return base.at[sl].set(interior)


class IsentropicPrognostic(DomainComponent, StencilFactory):
    """ABC + factory (reference ``prognostic.py:54``)."""

    registry = {}

    def __init__(
        self,
        horizontal_flux_scheme: str,
        domain,
        moist: bool,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
        **kwargs,
    ) -> None:
        DomainComponent.__init__(self, domain, "numerical")
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self._moist = moist
        self._hflux = IsentropicMinimalHorizontalFlux.factory(
            horizontal_flux_scheme, backend=backend
        )
        g = self.grid
        hb = self.horizontal_boundary
        # invariant nb >= flux extent (reference ``prognostic.py:117-130``)
        assert hb.nb >= self._hflux.extent, (
            f"nb={hb.nb} must be >= flux extent {self._hflux.extent}"
        )
        assert g.nx >= 2 * hb.nb + 1 and g.ny >= 2 * hb.nb + 1

        # semi-implicit parameters (reference ``rk3ws_si.py:66-69``)
        pt = kwargs.get("pt", 0.0)
        if hasattr(pt, "to_units"):
            pt = float(np.asarray(pt.to_units("Pa").data))
        self._pt = float(pt)
        self._eps = float(kwargs.get("eps", 0.5))
        assert 0.0 <= self._eps <= 1.0, "off-centering eps must be in [0, 1]"

        self._diagnostics = IsentropicDiagnostics(
            self.grid,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )

        # "now" pointers captured at stage 0
        self._now: Dict[str, Any] = {}

    @property
    def stages(self) -> int:
        raise NotImplementedError

    @property
    def substep_fractions(self):
        raise NotImplementedError

    @staticmethod
    def factory(time_integration_scheme: str, horizontal_flux_scheme: str, domain, moist, **kwargs):
        return factorize(
            time_integration_scheme,
            IsentropicPrognostic,
            (horizontal_flux_scheme, domain, moist),
            kwargs,
        )

    # -- shared stage machinery ------------------------------------------------- #
    def _grid_spacings(self) -> Tuple[float, float]:
        dx = float(np.asarray(self.grid.dx.to_units("m").data))
        dy = float(np.asarray(self.grid.dy.to_units("m").data))
        return dx, dy

    def _flux_div(self, flux_x, flux_y, nb: int, dx: float, dy: float):
        """Flux divergence on the interior window (cells nb..n-nb); flux index
        of face f is f - extent (see horizontal_fluxes.py index convention)."""
        e = self._hflux.extent
        nxc = flux_x.shape[0] + 2 * e - 1  # number of cells
        nyc = flux_y.shape[1] + 2 * e - 1
        ip = slice(nb - e + 1, nb - e + 1 + (nxc - 2 * nb))
        im = slice(nb - e, nb - e + (nxc - 2 * nb))
        jp = slice(nb - e + 1, nb - e + 1 + (nyc - 2 * nb))
        jm = slice(nb - e, nb - e + (nyc - 2 * nb))
        jin = slice(nb, nyc - nb)
        iin = slice(nb, nxc - nb)
        return (flux_x[ip, jin] - flux_x[im, jin]) / dx + (
            flux_y[iin, jp] - flux_y[iin, jm]
        ) / dy

    # -- comm/compute overlap (distributed path) -------------------------------- #
    def _use_bands(self, shape) -> bool:
        """Interior/edge band split for explicit comm/compute overlap
        (SURVEY.md §2.8): active under a DistributedBoundary whose halo
        exchange assembles by concatenation — the interior band's inputs are
        pure slices of the pre-exchange core, so XLA schedules the interior
        stencil concurrently with the ppermutes; the four edge bands alone
        wait for the halos."""
        nb = self.horizontal_boundary.nb
        return (
            getattr(self.horizontal_boundary, "overlap_bands", False)
            and self._backend != "numpy"
            and shape[0] > 4 * nb
            and shape[1] > 4 * nb
        )

    def _banded_regions(self, Lx: int, Ly: int, nb: int):
        """((r0, r1, c0, c1) windows: x-low, x-high, y-low, y-high bands +
        interior — disjoint, covering the nb-inset computational domain."""
        return (
            (nb, 2 * nb, nb, Ly - nb),
            (Lx - 2 * nb, Lx - nb, nb, Ly - nb),
            (2 * nb, Lx - 2 * nb, nb, 2 * nb),
            (2 * nb, Lx - 2 * nb, Ly - 2 * nb, Ly - nb),
            (2 * nb, Lx - 2 * nb, 2 * nb, Ly - 2 * nb),
        )

    def _assemble_banded(self, xp, phi_now, pieces, nb):
        """phi_now with the five band updates pasted in, assembled by
        concatenation (pure dataflow — no scatter)."""
        Lx, Ly = phi_now.shape[0], phi_now.shape[1]
        xlo, xhi, ylo, yhi, mid = pieces
        middle = xp.concatenate(
            [
                phi_now[2 * nb : Lx - 2 * nb, :nb],
                ylo,
                mid,
                yhi,
                phi_now[2 * nb : Lx - 2 * nb, Ly - nb :],
            ],
            axis=1,
        )
        row_lo = xp.concatenate(
            [phi_now[nb : 2 * nb, :nb], xlo, phi_now[nb : 2 * nb, Ly - nb :]],
            axis=1,
        )
        row_hi = xp.concatenate(
            [
                phi_now[Lx - 2 * nb : Lx - nb, :nb],
                xhi,
                phi_now[Lx - 2 * nb : Lx - nb, Ly - nb :],
            ],
            axis=1,
        )
        return xp.concatenate(
            [phi_now[:nb], row_lo, middle, row_hi, phi_now[Lx - nb :]], axis=0
        )

    def _div_window(self, phi_int, u_int, v_int, r0, r1, c0, c1, dx, dy):
        """Flux divergence of cells [r0:r1, c0:c1) from the e-haloed input
        windows (bitwise the same arithmetic as the full-array path)."""
        e = self._hflux.extent
        ph = phi_int[r0 - e : r1 + e, c0 - e : c1 + e]
        uu = u_int[r0 - e : r1 + e + 1, c0 - e : c1 + e]
        vv = v_int[r0 - e : r1 + e, c0 - e : c1 + e + 1]
        return self._flux_div(
            self._hflux.flux_x(uu, ph), self._hflux.flux_y(vv, ph), e, dx, dy
        )

    def _step_density_and_water(self, dt, state, tendencies, s_now_dict):
        """First stencil: step s (+ sqv, sqc, sqr)
        (reference ``utils.py:44`` ``step_forward_euler``).

        Moist inputs arrive as MASS FRACTIONS (the dycore no longer
        materializes the input densities, reference ``dycore.py:766-774``):
        ``sq = clip(s·q)`` is formed here, an expression XLA fuses into the
        flux stencil.  Outputs are the stepped densities."""
        nb = self.horizontal_boundary.nb
        dx, dy = self._grid_spacings()
        xp = get_namespace(state["air_isentropic_density"])

        s_int = state["air_isentropic_density"]
        s_now = s_now_dict["air_isentropic_density"]
        u_int = state["x_velocity_at_u_locations"]
        v_int = state["y_velocity_at_v_locations"]
        iin = slice(nb, s_int.shape[0] - nb)
        jin = slice(nb, s_int.shape[1] - nb)

        def clip_pos(x):
            return xp.where(x > 0.0, x, xp.zeros_like(x))

        out: Dict[str, Any] = {}

        sq_of = (
            ("isentropic_density_of_water_vapor", mfwv),
            ("isentropic_density_of_cloud_liquid_water", mfcw),
            ("isentropic_density_of_precipitation_water", mfpw),
        )

        hb = self.horizontal_boundary

        use_bands = self._use_bands(s_int.shape)

        def step_one(name, phi_now, phi_int, tnd, scale_by_s):
            if use_bands:
                # interior/edge band split: the interior band's input windows
                # slice the pre-exchange core (see _use_bands), so it computes
                # concurrently with the halo ppermutes
                def upd(r0, r1, c0, c1):
                    rhs = self._div_window(
                        phi_int, u_int, v_int, r0, r1, c0, c1, dx, dy
                    )
                    if tnd is not None:
                        t = tnd[r0:r1, c0:c1]
                        rhs = rhs - (
                            s_int[r0:r1, c0:c1] * t if scale_by_s else t
                        )
                    return phi_now[r0:r1, c0:c1] - dt * rhs

                pieces = [
                    upd(*w)
                    for w in self._banded_regions(
                        phi_now.shape[0], phi_now.shape[1], nb
                    )
                ]
                out = self._assemble_banded(xp, phi_now, pieces, nb)
                return hb.restrict_stencil_output(out, base=phi_now, nb=nb)
            fx = self._hflux.flux_x(u_int, phi_int)
            fy = self._hflux.flux_y(v_int, phi_int)
            div = self._flux_div(fx, fy, nb, dx, dy)
            rhs = div
            if tnd is not None:
                src = s_int[iin, jin] * tnd[iin, jin] if scale_by_s else tnd[iin, jin]
                rhs = rhs - src
            interior = phi_now[iin, jin] - dt * rhs
            out = _paste_interior(phi_now, interior, nb, xp)
            # distributed: keep phi_now on cells within nb of the GLOBAL edge
            # (the cells the single-device stencil never writes); identity on
            # a single device
            return hb.restrict_stencil_output(out, base=phi_now, nb=nb)

        out["air_isentropic_density"] = step_one(
            "s",
            s_now,
            s_int,
            tendencies.get("air_isentropic_density"),
            False,
        )
        if self._moist:
            for sq_name, q_name in sq_of:
                out[sq_name] = step_one(
                    sq_name,
                    clip_pos(s_now * s_now_dict[q_name]),
                    clip_pos(s_int * state[q_name]),
                    tendencies.get(q_name),
                    True,
                )
        return out

    def _step_momentum(self, dt, state, tendencies, s_now_dict, s_new, mtg_new):
        """Second stencil: momenta with semi-implicit pressure gradient
        (reference ``utils.py:138`` ``step_forward_euler_momentum``)."""
        nb = self.horizontal_boundary.nb
        dx, dy = self._grid_spacings()
        eps = self._eps
        xp = get_namespace(s_new)

        s_now = s_now_dict["air_isentropic_density"]
        mtg_now = s_now_dict["montgomery_potential"]
        su_now = s_now_dict["x_momentum_isentropic"]
        sv_now = s_now_dict["y_momentum_isentropic"]
        u_int = state["x_velocity_at_u_locations"]
        v_int = state["y_velocity_at_v_locations"]
        su_int = state["x_momentum_isentropic"]
        sv_int = state["y_momentum_isentropic"]
        su_tnd = tendencies.get("x_momentum_isentropic")
        sv_tnd = tendencies.get("y_momentum_isentropic")

        nx, ny = s_new.shape[0], s_new.shape[1]
        iin = slice(nb, nx - nb)
        jin = slice(nb, ny - nb)
        ip1 = slice(nb + 1, nx - nb + 1)
        im1 = slice(nb - 1, nx - nb - 1)
        jp1 = slice(nb + 1, ny - nb + 1)
        jm1 = slice(nb - 1, ny - nb - 1)

        div_su = self._flux_div(
            self._hflux.flux_x(u_int, su_int), self._hflux.flux_y(v_int, su_int), nb, dx, dy
        )
        div_sv = self._flux_div(
            self._hflux.flux_x(u_int, sv_int), self._hflux.flux_y(v_int, sv_int), nb, dx, dy
        )

        pgx = (1.0 - eps) * s_now[iin, jin] * (
            mtg_now[ip1, jin] - mtg_now[im1, jin]
        ) / (2.0 * dx) + eps * s_new[iin, jin] * (
            mtg_new[ip1, jin] - mtg_new[im1, jin]
        ) / (2.0 * dx)
        pgy = (1.0 - eps) * s_now[iin, jin] * (
            mtg_now[iin, jp1] - mtg_now[iin, jm1]
        ) / (2.0 * dy) + eps * s_new[iin, jin] * (
            mtg_new[iin, jp1] - mtg_new[iin, jm1]
        ) / (2.0 * dy)

        su_rhs = div_su + pgx
        if su_tnd is not None:
            su_rhs = su_rhs - su_tnd[iin, jin]
        sv_rhs = div_sv + pgy
        if sv_tnd is not None:
            sv_rhs = sv_rhs - sv_tnd[iin, jin]

        su_new = _paste_interior(su_now, su_now[iin, jin] - dt * su_rhs, nb, xp)
        sv_new = _paste_interior(sv_now, sv_now[iin, jin] - dt * sv_rhs, nb, xp)
        hb = self.horizontal_boundary
        su_new = hb.restrict_stencil_output(su_new, base=su_now, nb=nb)
        sv_new = hb.restrict_stencil_output(sv_new, base=sv_now, nb=nb)
        return su_new, sv_new

    def _step_momentum_banded(self, dt, state, tendencies, s_now_dict, s_new, hs):
        """Momentum step in interior/edge bands for comm/compute overlap.

        The Montgomery potential is recomputed per band window from the
        window's density columns — column-local, so bitwise identical to the
        full-array scan — which keeps the interior band's inputs pure slices
        of the pre-exchange core: it schedules concurrently with the density
        halo exchange, while only the four edge bands (and their one-column
        Montgomery halos) wait for the collectives."""
        nb = self.horizontal_boundary.nb
        dx, dy = self._grid_spacings()
        eps = self._eps
        xp = get_namespace(s_new)

        s_now = s_now_dict["air_isentropic_density"]
        mtg_now = s_now_dict["montgomery_potential"]
        su_now = s_now_dict["x_momentum_isentropic"]
        sv_now = s_now_dict["y_momentum_isentropic"]
        u_int = state["x_velocity_at_u_locations"]
        v_int = state["y_velocity_at_v_locations"]
        su_int = state["x_momentum_isentropic"]
        sv_int = state["y_momentum_isentropic"]
        su_tnd = tendencies.get("x_momentum_isentropic")
        sv_tnd = tendencies.get("y_momentum_isentropic")
        if hs is None:
            # static topography: window the grid's host-side profile
            hs = self._diagnostics._hs(xp, s_new.dtype, None)[:, :, 0]

        def upd(r0, r1, c0, c1):
            # montgomery on the (r±1, c±1)-haloed window of the stepped density
            s_w = s_new[r0 - 1 : r1 + 1, c0 - 1 : c1 + 1]
            hs_w = hs[r0 - 1 : r1 + 1, c0 - 1 : c1 + 1]
            mtg_w = self._diagnostics.get_montgomery_potential(
                s_w, self._pt, hs=hs_w
            )
            m = r1 - r0
            n = c1 - c0
            cc = (slice(1, 1 + m), slice(1, 1 + n))
            cp1 = (slice(2, 2 + m), slice(1, 1 + n))
            cm1 = (slice(0, m), slice(1, 1 + n))
            rp1 = (slice(1, 1 + m), slice(2, 2 + n))
            rm1 = (slice(1, 1 + m), slice(0, n))
            w = (slice(r0, r1), slice(c0, c1))
            wp1x = (slice(r0 + 1, r1 + 1), slice(c0, c1))
            wm1x = (slice(r0 - 1, r1 - 1), slice(c0, c1))
            wp1y = (slice(r0, r1), slice(c0 + 1, c1 + 1))
            wm1y = (slice(r0, r1), slice(c0 - 1, c1 - 1))

            pgx = (1.0 - eps) * s_now[w] * (
                mtg_now[wp1x] - mtg_now[wm1x]
            ) / (2.0 * dx) + eps * s_w[cc] * (
                mtg_w[cp1] - mtg_w[cm1]
            ) / (2.0 * dx)
            pgy = (1.0 - eps) * s_now[w] * (
                mtg_now[wp1y] - mtg_now[wm1y]
            ) / (2.0 * dy) + eps * s_w[cc] * (
                mtg_w[rp1] - mtg_w[rm1]
            ) / (2.0 * dy)

            su_rhs = (
                self._div_window(su_int, u_int, v_int, r0, r1, c0, c1, dx, dy)
                + pgx
            )
            sv_rhs = (
                self._div_window(sv_int, u_int, v_int, r0, r1, c0, c1, dx, dy)
                + pgy
            )
            if su_tnd is not None:
                su_rhs = su_rhs - su_tnd[w]
            if sv_tnd is not None:
                sv_rhs = sv_rhs - sv_tnd[w]
            return su_now[w] - dt * su_rhs, sv_now[w] - dt * sv_rhs

        windows = self._banded_regions(s_new.shape[0], s_new.shape[1], nb)
        pieces = [upd(*w) for w in windows]
        su_new = self._assemble_banded(xp, su_now, [p[0] for p in pieces], nb)
        sv_new = self._assemble_banded(xp, sv_now, [p[1] for p in pieces], nb)
        hb = self.horizontal_boundary
        su_new = hb.restrict_stencil_output(su_new, base=su_now, nb=nb)
        sv_new = hb.restrict_stencil_output(sv_new, base=sv_now, nb=nb)
        return su_new, sv_new

    def _si_stage(self, dt: float, state, tendencies) -> Dict[str, Any]:
        """One semi-implicit stage from the captured "now" state."""
        hb = self.horizontal_boundary
        out = self._step_density_and_water(dt, state, tendencies, self._now)
        # lateral BC on stepped density (reference ``rk3ws_si.py:183-189``)
        out["air_isentropic_density"] = hb.enforce_field(
            out["air_isentropic_density"],
            "air_isentropic_density",
            "kg m^-2 K^-1",
            time=None,
        )
        s_new = out["air_isentropic_density"]
        if self._use_bands(s_new.shape):
            # overlapped path: Montgomery is recomputed per band window inside
            # the banded momentum step (column-local scan — bitwise identical)
            su_new, sv_new = self._step_momentum_banded(
                dt, state, tendencies, self._now, s_new,
                state.get("topography_height"),
            )
        else:
            # Montgomery from the stepped density (reference
            # ``rk3ws_si.py:193-196``); the state may carry the
            # (time-dependent) topography as a traced input
            mtg_new = self._diagnostics.get_montgomery_potential(
                s_new, self._pt, hs=state.get("topography_height")
            )
            su_new, sv_new = self._step_momentum(
                dt, state, tendencies, self._now, s_new, mtg_new
            )
        out["x_momentum_isentropic"] = su_new
        out["y_momentum_isentropic"] = sv_new
        return out

    def _capture_now(self, state) -> None:
        names = [
            "air_isentropic_density",
            "montgomery_potential",
            "x_momentum_isentropic",
            "y_momentum_isentropic",
        ]
        if self._moist:
            # mass fractions: the densities sq0 = clip(s0·q0) are re-formed
            # per stage inside the density step (never materialized)
            names += [mfwv, mfcw, mfpw]
        self._now = {n: state[n] for n in names}

    def stage_call(self, stage: int, timestep: float, state, tendencies) -> Dict[str, Any]:
        raise NotImplementedError


@factor_register("forward_euler_si")
class ForwardEulerSI(IsentropicPrognostic):
    """Single-stage semi-implicit scheme
    (reference ``subclasses/prognostics/forward_euler_si.py:37``)."""

    @property
    def stages(self) -> int:
        return 1

    @property
    def substep_fractions(self):
        return 1.0

    def stage_call(self, stage, timestep, state, tendencies):
        self._capture_now(state)
        return self._si_stage(timestep, state, tendencies or {})


@factor_register("centered_si")
class CenteredSI(IsentropicPrognostic):
    """Placeholder parity with the reference's stub
    (reference ``subclasses/prognostics/centered_si.py:27`` defines only the
    class/name; selecting it raises on use there as well)."""

    @property
    def stages(self) -> int:
        raise NotImplementedError("centered_si is a stub in the reference too")

    @property
    def substep_fractions(self):
        raise NotImplementedError

    def stage_call(self, stage, timestep, state, tendencies):
        raise NotImplementedError


@factor_register("rk3ws_si")
class RK3WSSI(IsentropicPrognostic):
    """Three-stage semi-implicit Wicker–Skamarock RK
    (reference ``subclasses/prognostics/rk3ws_si.py:37``): per-stage dt =
    dt/3, dt/2, dt (``:115-124``)."""

    @property
    def stages(self) -> int:
        return 3

    @property
    def substep_fractions(self):
        return (1.0 / 3.0, 0.5, 1.0)

    def stage_call(self, stage, timestep, state, tendencies):
        if stage == 0:
            self._capture_now(state)
        frac = self.substep_fractions[stage]
        return self._si_stage(frac * timestep, state, tendencies or {})
