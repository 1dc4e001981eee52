"""Hypothesis strategy library: random domains, grids, boundaries, fields and
model states.

JAX counterpart of the reference's strategy library
(reference ``tests/strategies.py:347,459,487,569,1169,1637`` — ``st_physical_grid``,
``st_horizontal_boundary``, ``st_domain``, ``st_raw_field``,
``st_isentropic_state_f``, ``st_burgers_state``): the same capability — every
suite-style test draws a random domain/boundary/state — expressed against this
framework's ``Domain``/``FieldArray`` API.  Random *values* come from a drawn
seed + ``default_rng`` (shrinkable through the seed, and orders of magnitude
faster to generate than element-wise array strategies).
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional, Tuple

import numpy as np
from hypothesis import strategies as hyp_st

import jax.numpy as jnp

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray, field_shape

#: backends every backend-parameterized suite runs over (the reference's
#: numpy/gt4py axis becomes numpy-oracle vs jax)
BACKENDS = ("numpy", "jax")


@hyp_st.composite
def st_rng(draw) -> np.random.Generator:
    return np.random.default_rng(draw(hyp_st.integers(0, 2**32 - 1)))


@hyp_st.composite
def st_physical_grid_args(
    draw,
    nx_range: Tuple[int, int] = (7, 24),
    ny_range: Tuple[int, int] = (7, 24),
    nz_range: Tuple[int, int] = (2, 8),
):
    """(domain_x, nx, domain_y, ny, domain_z, nz) constructor arguments."""
    nx = draw(hyp_st.integers(*nx_range))
    ny = draw(hyp_st.integers(*ny_range))
    nz = draw(hyp_st.integers(*nz_range))
    x0 = draw(hyp_st.floats(-1e6, 1e6))
    dx = draw(hyp_st.floats(1e2, 1e5))
    y0 = draw(hyp_st.floats(-1e6, 1e6))
    dy = draw(hyp_st.floats(1e2, 1e5))
    ztop = draw(hyp_st.floats(330.0, 500.0))
    zsurf = draw(hyp_st.floats(270.0, 320.0))
    return (
        (x0, x0 + dx * (nx - 1)),
        nx,
        (y0, y0 + dy * (ny - 1)),
        ny,
        FieldArray(np.array([ztop, zsurf]), "K", ("z",)),
        nz,
    )


@hyp_st.composite
def st_domain(
    draw,
    nx_range: Tuple[int, int] = (7, 24),
    ny_range: Tuple[int, int] = (7, 24),
    nz_range: Tuple[int, int] = (2, 8),
    boundary_types: Tuple[str, ...] = ("identity", "periodic", "relaxed", "dirichlet"),
    nb_range: Tuple[int, int] = (1, 3),
    topography_types: Tuple[str, ...] = ("flat",),
    backend: str = "jax",
) -> Domain:
    """A random Domain: grid extents, boundary type + nb (+nr), topography
    (reference ``st_domain``, ``tests/strategies.py:487``)."""
    args = draw(st_physical_grid_args(nx_range, ny_range, nz_range))
    nx, ny = args[1], args[3]
    nb = draw(hyp_st.integers(*nb_range))
    hb_type = draw(hyp_st.sampled_from(boundary_types))
    hb_kwargs = {}
    if hb_type == "relaxed":
        nr_hi = min(8, nx // 2, ny // 2)
        nb = min(nb, nr_hi)
        hb_kwargs["nr"] = draw(hyp_st.integers(max(nb, 1), nr_hi))
    topo = draw(hyp_st.sampled_from(topography_types))
    topo_kwargs = None
    if topo == "gaussian":
        topo_kwargs = {
            "max_height": FieldArray(
                np.asarray(draw(hyp_st.floats(1.0, 1000.0))), "m", ()
            ),
            "width_x": FieldArray(np.asarray(draw(hyp_st.floats(1e3, 1e5))), "m", ()),
            "width_y": FieldArray(np.asarray(draw(hyp_st.floats(1e3, 1e5))), "m", ()),
        }
    return Domain(
        *args,
        horizontal_boundary_type=hb_type,
        nb=nb,
        horizontal_boundary_kwargs=hb_kwargs,
        topography_type=topo,
        topography_kwargs=topo_kwargs,
        backend=backend,
    )


@hyp_st.composite
def st_raw_field(
    draw,
    shape: Tuple[int, ...],
    lo: float = -1e3,
    hi: float = 1e3,
    backend: str = "jax",
    dtype=np.float64,
):
    """A random raw array of ``shape`` in [lo, hi) (reference ``st_raw_field``,
    ``tests/strategies.py:569``)."""
    rng = draw(st_rng())
    data = rng.uniform(lo, hi, size=shape).astype(dtype)
    return np.asarray(data) if backend == "numpy" else jnp.asarray(data)


@hyp_st.composite
def st_state(draw, grid, properties, lo: float = 0.5, hi: float = 2.0, backend="jax"):
    """A state dict matching a component's declared ``properties``."""
    state = {"time": datetime(2000, 1, 1, draw(hyp_st.integers(0, 23)))}
    for name, props in properties.items():
        shape = field_shape(name, (grid.nx, grid.ny, grid.nz))
        data = draw(st_raw_field(shape, lo, hi, backend=backend))
        state[name] = FieldArray(data, props["units"], props.get("dims", ("x", "y", "z")))
    return state


@hyp_st.composite
def st_isentropic_state(
    draw,
    grid,
    moist: bool = False,
    precipitation: bool = False,
    backend: str = "jax",
    u_range: Tuple[float, float] = (-30.0, 30.0),
    v_range: Tuple[float, float] = (-10.0, 10.0),
    n_range: Tuple[float, float] = (0.005, 0.02),
):
    """A balanced isentropic state from randomly-drawn Brunt–Väisälä frequency,
    background flow and humidity (reference ``st_isentropic_state_f``,
    ``tests/strategies.py:1169``) — built through the production state factory
    so hydrostatic/velocity consistency holds by construction."""
    from tasmania_jax.isentropic import (
        get_isentropic_state_from_brunt_vaisala_frequency,
    )

    state = get_isentropic_state_from_brunt_vaisala_frequency(
        grid,
        datetime(2000, 1, 1, draw(hyp_st.integers(0, 23))),
        FieldArray(np.asarray(draw(hyp_st.floats(*u_range))), "m s^-1", ()),
        FieldArray(np.asarray(draw(hyp_st.floats(*v_range))), "m s^-1", ()),
        FieldArray(np.asarray(draw(hyp_st.floats(*n_range))), "s^-1", ()),
        moist=moist,
        precipitation=precipitation,
        relative_humidity=draw(hyp_st.floats(0.1, 0.95)),
        backend=backend,
    )
    return state


@hyp_st.composite
def st_burgers_state(draw, grid, backend: str = "jax"):
    """A random Burgers velocity state (reference ``st_burgers_state``,
    ``tests/strategies.py:1637``)."""
    shape = (grid.nx, grid.ny, 1)
    u = draw(st_raw_field(shape, -10.0, 10.0, backend=backend))
    v = draw(st_raw_field(shape, -10.0, 10.0, backend=backend))
    return {
        "time": datetime(2000, 1, 1),
        "x_velocity": FieldArray(u, "m s^-1", ("x", "y", "z")),
        "y_velocity": FieldArray(v, "m s^-1", ("x", "y", "z")),
    }


@hyp_st.composite
def st_timedelta(draw, lo: float = 0.1, hi: float = 120.0) -> timedelta:
    return timedelta(seconds=draw(hyp_st.floats(lo, hi)))


@hyp_st.composite
def st_horizontal_boundary(draw, grid, types=("identity", "periodic", "relaxed")):
    """A boundary over an existing physical grid (reference
    ``st_horizontal_boundary``, ``tests/strategies.py:459``)."""
    from tasmania_jax.domain.horizontal_boundary import HorizontalBoundary

    hb_type = draw(hyp_st.sampled_from(types))
    nb_hi = max(1, min(3, grid.nx // 2 - 1, grid.ny // 2 - 1))
    nb = draw(hyp_st.integers(1, nb_hi))
    kwargs = {}
    if hb_type == "relaxed":
        kwargs["nr"] = draw(
            hyp_st.integers(nb, max(nb, min(8, grid.nx // 2, grid.ny // 2)))
        )
    return HorizontalBoundary.factory(hb_type, grid, nb, **kwargs)


# --------------------------------------------------------------------------- #
# staggered fields & out-buffers (reference ``tests/strategies.py:569,1724``)  #
# --------------------------------------------------------------------------- #

#: staggering suffix pool used by ``field_shape``/``field_dims`` name inference
STAGGER_SUFFIXES = (
    "",
    "_at_u_locations",
    "_at_v_locations",
    "_on_interface_levels",
)


@hyp_st.composite
def st_staggered_field_name(draw, base: str = "phi") -> str:
    """A field name carrying a randomly-drawn staggering suffix, so shape
    inference (``framework/field.py:97``) is exercised on every axis."""
    return base + draw(hyp_st.sampled_from(STAGGER_SUFFIXES))


@hyp_st.composite
def st_staggered_field(
    draw,
    grid,
    base: str = "phi",
    units: str = "m s^-1",
    lo: float = -1e2,
    hi: float = 1e2,
    backend: str = "jax",
):
    """(name, FieldArray) at a drawn staggering on ``grid`` — the staggered
    raw-field axis of the reference's ``st_raw_field``."""
    from tasmania_jax.framework.field import field_dims, field_shape

    name = draw(st_staggered_field_name(base))
    shape = field_shape(name, (grid.nx, grid.ny, grid.nz))
    data = draw(st_raw_field(shape, lo, hi, backend=backend))
    return name, FieldArray(data, units, field_dims(name))


@hyp_st.composite
def st_out_buffers(
    draw,
    grid,
    properties,
    backend: str = "jax",
    with_sentinel: bool = True,
):
    """Pre-allocated output dict for a component's ``out=`` path (reference
    out-buffer strategies ``tests/strategies.py:1724-1791``): every declared
    field pre-filled with junk in a drawn range (so stale values are visible if
    a component fails to overwrite), plus an unrelated sentinel entry whose
    survival checks the merge semantics."""
    from tasmania_jax.framework.field import field_dims, field_shape

    junk_lo = draw(hyp_st.floats(-1e6, -1e3))
    out = {}
    if with_sentinel:
        sdata = draw(st_raw_field((2, 2), 0.0, 1.0, backend=backend))
        out["__sentinel__"] = FieldArray(sdata, "1", ("x", "y"))
    for name, props in properties.items():
        shape = field_shape(name, (grid.nx, grid.ny, grid.nz))
        data = draw(
            st_raw_field(shape, junk_lo, junk_lo + 1.0, backend=backend)
        )
        out[name] = FieldArray(
            data, props["units"], props.get("dims", field_dims(name))
        )
    return out


# --------------------------------------------------------------------------- #
# topographies & vertical coordinates                                          #
# --------------------------------------------------------------------------- #


@hyp_st.composite
def st_topography(draw, types: Tuple[str, ...] = ("flat", "gaussian", "schaer")):
    """(type, kwargs) for ``Topography.factory``: drawn mountain shape,
    height, widths, centering, and optional linear growth time (reference
    ``domain/topography.py:106-117`` time-growth semantics)."""
    topo = draw(hyp_st.sampled_from(types))
    kwargs = {}
    if topo in ("gaussian", "schaer"):
        kwargs["max_height"] = FieldArray(
            np.asarray(draw(hyp_st.floats(1.0, 2000.0))), "m", ()
        )
        kwargs["width_x"] = FieldArray(
            np.asarray(draw(hyp_st.floats(5e3, 1e5))), "m", ()
        )
        kwargs["width_y"] = FieldArray(
            np.asarray(draw(hyp_st.floats(5e3, 1e5))), "m", ()
        )
    if draw(hyp_st.booleans()):
        kwargs["time"] = timedelta(
            seconds=draw(hyp_st.floats(60.0, 3600.0))
        )
    return topo, kwargs


@hyp_st.composite
def st_vertical_coordinate_grid(
    draw,
    kinds: Tuple[str, ...] = ("sigma", "sleve", "gal_chen"),
    nx_range: Tuple[int, int] = (5, 12),
    ny_range: Tuple[int, int] = (5, 12),
    nz_range: Tuple[int, int] = (3, 8),
):
    """A terrain-following metric grid with a drawn vertical coordinate
    (reference ``domain/subclasses/grids/{sigma,sleve,gal_chen}.py``) over a
    drawn mountain."""
    from tasmania_jax.domain.grids.vertical_coordinates import (
        GalChen3d,
        Sigma3d,
        SLEVE3d,
    )

    kind = draw(hyp_st.sampled_from(kinds))
    cls = {"sigma": Sigma3d, "sleve": SLEVE3d, "gal_chen": GalChen3d}[kind]
    nx = draw(hyp_st.integers(*nx_range))
    ny = draw(hyp_st.integers(*ny_range))
    nz = draw(hyp_st.integers(*nz_range))
    topo, topo_kwargs = draw(st_topography())
    if kind == "sigma":
        # sigma = p/p_s in (0, 1], increasing top -> surface
        domain_z = FieldArray(
            np.array([draw(hyp_st.floats(0.1, 0.5)), 1.0]), "1", ("z",)
        )
    else:
        # height-based coordinates: z_top -> 0 at the surface
        domain_z = FieldArray(
            np.array([draw(hyp_st.floats(8e3, 1.5e4)), 0.0]), "m", ("z",)
        )
    return cls(
        (0.0, 1e4 * (nx - 1)),
        nx,
        (0.0, 1e4 * (ny - 1)),
        ny,
        domain_z,
        nz,
        topography_type=topo,
        topography_kwargs=topo_kwargs,
    )


# --------------------------------------------------------------------------- #
# component-property & fake-component strategies                               #
# --------------------------------------------------------------------------- #

#: unit pool with nontrivial conversions (exercises the units layer at the
#: component boundary the way sympl's DataArray conversions did)
UNIT_POOL = ("m s^-1", "km hr^-1", "m s^-2", "K", "Pa", "kg m^-2", "1", "g kg^-1")


@hyp_st.composite
def st_field_properties(
    draw,
    n_range: Tuple[int, int] = (1, 4),
    bases: Tuple[str, ...] = ("phi", "psi", "chi", "xi"),
    staggered: bool = True,
):
    """A random component property dict: field names (optionally staggered),
    units drawn from a conversion-rich pool."""
    from tasmania_jax.framework.field import field_dims

    n = draw(hyp_st.integers(*n_range))
    picks = draw(
        hyp_st.lists(
            hyp_st.sampled_from(bases), min_size=n, max_size=n, unique=True
        )
    )
    props = {}
    for base in picks:
        name = draw(st_staggered_field_name(base)) if staggered else base
        props[name] = {
            "dims": field_dims(name),
            "units": draw(hyp_st.sampled_from(UNIT_POOL)),
        }
    return props


@hyp_st.composite
def st_linear_tendency_components(
    draw,
    domain,
    n_range: Tuple[int, int] = (1, 3),
    field_name: str = "phi",
    units: str = "m s^-1",
    backend: str = "jax",
):
    """N TendencyComponents, each contributing ``a_i * phi`` (coefficients
    drawn), sharing one prognostic field — the algebra the coupler laws
    (tendency summation, serial-vs-parallel policies) quantify over."""
    from tasmania_jax.framework import TendencyComponent

    class Linear(TendencyComponent):
        def __init__(self, dom, a, **kw):
            super().__init__(dom, "numerical", **kw)
            self.a = a

        @property
        def input_properties(self):
            return {field_name: {"dims": ("x", "y", "z"), "units": units}}

        @property
        def tendency_properties(self):
            return {field_name: {"dims": ("x", "y", "z"), "units": units + " s^-1"}}

        def array_call(self, state):
            return {field_name: self.a * state[field_name]}, {}

    n = draw(hyp_st.integers(*n_range))
    coeffs = [
        draw(
            hyp_st.floats(
                -1.0, 1.0, allow_subnormal=False
            )
        )
        for _ in range(n)
    ]
    return [Linear(domain, a, backend=backend) for a in coeffs], coeffs


# --------------------------------------------------------------------------- #
# physically-plausible columns (microphysics / column-machinery oracles)       #
# --------------------------------------------------------------------------- #


@hyp_st.composite
def st_atmosphere_column(
    draw,
    shape: Tuple[int, int, int],
    backend: str = "jax",
):
    """(rho, h_on_interface_levels, qr): monotone-decreasing-with-height
    density and interface heights plus a sparse non-negative rain field — the
    input manifold sedimentation/fall-velocity formulas are defined on."""
    nx, ny, nz = shape
    rng = draw(st_rng())
    rho_s = draw(hyp_st.floats(0.8, 1.3))
    rho = (
        rho_s
        * np.exp(-np.linspace(8.0, 0.0, nz) / 8.0)[None, None, :]
        * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, size=shape))
    )
    ztop = draw(hyp_st.floats(8e3, 1.5e4))
    h = np.sort(
        rng.uniform(0.0, ztop, size=(nx, ny, nz + 1)), axis=-1
    )[..., ::-1].copy()
    h[..., -1] = 0.0
    qr = rng.uniform(0.0, 1e-3, size=shape)
    qr[rng.uniform(size=shape) < draw(hyp_st.floats(0.2, 0.8))] = 0.0
    wrap = (lambda a: np.asarray(a)) if backend == "numpy" else jnp.asarray
    return wrap(rho), wrap(h), wrap(qr)


@hyp_st.composite
def st_mesh_shape(draw, n_devices: int = 8) -> Tuple[int, int]:
    """A random 2-D factorization of ``n_devices`` (topology-sweep axis of the
    distributed tests)."""
    shapes = [
        (px, n_devices // px)
        for px in range(1, n_devices + 1)
        if n_devices % px == 0
    ]
    return draw(hyp_st.sampled_from(shapes))


@hyp_st.composite
def st_timestep(draw, lo: float = 0.1, hi: float = 60.0) -> float:
    """Timestep in float seconds (NOT timedelta: microsecond quantization
    would poison 1e-11-rtol oracle comparisons)."""
    return draw(hyp_st.floats(lo, hi, allow_subnormal=False))


@hyp_st.composite
def st_domain_suite(
    draw,
    boundary_types: Tuple[str, ...] = ("identity", "periodic", "relaxed", "dirichlet"),
    backends: Tuple[str, ...] = BACKENDS,
    nx_range: Tuple[int, int] = (8, 18),
    ny_range: Tuple[int, int] = (8, 18),
    nz_range: Tuple[int, int] = (2, 6),
    nb_range: Tuple[int, int] = (1, 3),
):
    """A :class:`tests.suites.DomainSuite` whose domain, boundary type/width,
    and backend are ALL hypothesis-drawn (the conversion of the suite harness
    from fixed seeds to property-based draws, VERDICT r3 item 6)."""
    from suites import DomainSuite

    backend = draw(hyp_st.sampled_from(backends))
    hb_type = draw(hyp_st.sampled_from(boundary_types))
    nx = draw(hyp_st.integers(*nx_range))
    ny = draw(hyp_st.integers(*ny_range))
    nz = draw(hyp_st.integers(*nz_range))
    nb = draw(hyp_st.integers(*nb_range))
    kwargs = {}
    if hb_type == "relaxed":
        kwargs["nr"] = draw(
            hyp_st.integers(max(nb, 2), max(nb, 2, min(8, nx // 2, ny // 2)))
        )
    rng = np.random.default_rng(draw(hyp_st.integers(0, 2**32 - 1)))
    return DomainSuite(
        rng,
        nx_range=(nx, nx + 1),
        ny_range=(ny, ny + 1),
        nz_range=(nz, nz + 1),
        boundary_type=hb_type,
        nb=nb,
        boundary_kwargs=kwargs,
        backend=backend,
    )


@hyp_st.composite
def st_splitting_schemes(draw, n_range: Tuple[int, int] = (1, 3)):
    """A drawn list of (scheme, substeps) time-integration choices for the
    splitting couplers (reference ``TimeIntegrationOptions`` usage in
    ``driver_namelist_*.py``)."""
    n = draw(hyp_st.integers(*n_range))
    return [
        (
            draw(hyp_st.sampled_from(("forward_euler", "rk2", "rk3ws"))),
            draw(hyp_st.integers(1, 3)),
        )
        for _ in range(n)
    ]


@hyp_st.composite
def st_units_pair(draw):
    """(units_a, units_b, factor) with units_b = scaled spelling of units_a —
    the conversion-law axis of the units layer."""
    base, alt, factor = draw(
        hyp_st.sampled_from(
            [
                ("m", "km", 1e-3),
                ("m s^-1", "km hr^-1", 3.6),
                ("Pa", "hPa", 1e-2),
                ("kg m^-2", "g cm^-2", 0.1),
                ("g g^-1", "g kg^-1", 1e3),
                ("K", "K", 1.0),
            ]
        )
    )
    return base, alt, factor


@hyp_st.composite
def st_state_dict_pair(
    draw,
    shape: Tuple[int, ...] = (5, 4, 3),
    names: Tuple[str, ...] = ("phi", "psi"),
    units: str = "m",
    backend: str = "jax",
):
    """Two states over the same fields (same units), for DictOperator laws."""
    a = {"time": datetime(2000, 1, 1)}
    b = {"time": datetime(2000, 1, 1)}
    for n in names:
        a[n] = FieldArray(
            draw(st_raw_field(shape, -2.0, 2.0, backend=backend)), units,
            ("x", "y", "z"),
        )
        b[n] = FieldArray(
            draw(st_raw_field(shape, -2.0, 2.0, backend=backend)), units,
            ("x", "y", "z"),
        )
    return a, b


@hyp_st.composite
def st_thomas_system(
    draw,
    shape: Tuple[int, int, int] = (4, 3, 8),
    backend: str = "jax",
):
    """(a, b, c, d): a random strictly diagonally-dominant tridiagonal
    system per column — the well-posed input manifold of the ``thomas``
    stencil (reference ``isentropic/physics/implicit_vertical_advection.py``
    Crank–Nicolson setup, whose diagonal is 1 + O(dt·w/dz) and always
    dominant).  Off-diagonals drawn in [-1, 1], diagonal = |a| + |c| + margin."""
    rng = draw(st_rng())
    nx, ny, nz = shape
    a = rng.uniform(-1.0, 1.0, size=shape)
    c = rng.uniform(-1.0, 1.0, size=shape)
    a[..., 0] = 0.0
    c[..., -1] = 0.0
    margin = draw(hyp_st.floats(0.1, 2.0))
    sign = np.where(rng.uniform(size=shape) < 0.5, -1.0, 1.0)
    b = sign * (np.abs(a) + np.abs(c) + margin)
    d = rng.uniform(-10.0, 10.0, size=shape)
    wrap = (lambda x: np.asarray(x)) if backend == "numpy" else jnp.asarray
    return wrap(a), wrap(b), wrap(c), wrap(d)
