"""Comm/compute overlap of the distributed step (SURVEY.md §2.8: halo exchange
"overlapped with interior compute"; VERDICT round-1 item 2).

Mechanism under test: halo exchanges assemble by CONCATENATION
(``parallel/halo.py::_assemble``) and the prognostic splits its stencils into
an interior band + four edge bands (``prognostic.py::_use_bands``).  The
interior band's inputs are pure slices of the pre-exchange core, which XLA's
slice-of-concatenate simplification turns into direct reads of the local
block — so the interior stencil carries NO data dependency on the ppermutes
and schedules concurrently with them.  Verified here at the optimized-HLO
level (dependency reachability) and bitwise (banded == full-window path).
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.parallel.halo import halo_exchange

DIMS3 = ("x", "y", "z")


def _dep_on_collective(hlo: str, n_outputs: int):
    """For each root-tuple operand of the optimized HLO, whether its
    transitive producer set contains a collective-permute."""
    defs = {}
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w\.\-]+) = .*", line)
        if m:
            defs[m.group(1)] = line

    def deps(name, seen):
        if name in seen or name not in defs:
            return seen
        seen.add(name)
        for op in re.findall(r"%([\w\.\-]+)", defs[name].split("=", 1)[1]):
            deps(op, seen)
        return seen

    roots = [n for n, l in defs.items() if "ROOT" in l and "tuple" in l]
    ops = re.findall(r"%([\w\.\-]+)", defs[roots[-1]].split("=", 1)[1])
    return [
        any("collective-permute" in defs.get(x, "") for x in deps(op, set()))
        for op in ops[:n_outputs]
    ]


def test_interior_consumer_has_no_collective_dependency():
    """slice(concat(recv_lo, core, recv_hi)) inside the core simplifies to a
    slice of the pre-exchange block: interior compute does not wait for the
    exchange; halo-touching compute does."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    nb = 3

    def local(f):
        ex = halo_exchange(f, nb, ("x", "y"), (False, False))
        interior = ex[2 * nb : -2 * nb, 2 * nb : -2 * nb] * 2.0
        edge = ex[nb - 2 : 2 * nb, nb : -nb] * 3.0  # touches halo rows
        return interior, edge

    fn = jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P("x", "y"),),
            out_specs=(P("x", "y"), P("x", "y")),
        )
    )
    f = jnp.arange(64 * 32, dtype=jnp.float32).reshape(64, 32)
    hlo = fn.lower(f).compile().as_text()
    dep_interior, dep_edge = _dep_on_collective(hlo, 2)
    assert not dep_interior, (
        "interior band must not depend on the halo collectives"
    )
    assert dep_edge, "edge band must consume the exchanged halos"


@pytest.mark.parametrize("moist", [False, True])
def test_banded_prognostic_bitwise_equals_full_path(moist):
    """The interior/edge band split computes the same stencil arithmetic on
    sub-windows: outputs are bitwise identical to the full-window path."""
    from tasmania_jax.domain import Domain
    from tasmania_jax.isentropic.dynamics.prognostic import IsentropicPrognostic

    nx, ny, nz = 21, 19, 4
    nb = 3
    domain = Domain(
        (0.0, 2e4), nx, (0.0, 2e4), ny,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="identity", nb=nb,
    )
    rng = np.random.default_rng(7)
    state = {
        "air_isentropic_density": jnp.asarray(rng.uniform(50, 100, (nx, ny, nz))),
        "montgomery_potential": jnp.asarray(rng.uniform(1e5, 3e5, (nx, ny, nz))),
        "x_momentum_isentropic": jnp.asarray(rng.uniform(-500, 500, (nx, ny, nz))),
        "y_momentum_isentropic": jnp.asarray(rng.uniform(-500, 500, (nx, ny, nz))),
        "x_velocity_at_u_locations": jnp.asarray(rng.uniform(-20, 20, (nx + 1, ny, nz))),
        "y_velocity_at_v_locations": jnp.asarray(rng.uniform(-20, 20, (nx, ny + 1, nz))),
    }
    if moist:
        for q in (
            "mass_fraction_of_water_vapor_in_air",
            "mass_fraction_of_cloud_liquid_water_in_air",
            "mass_fraction_of_precipitation_water_in_air",
        ):
            state[q] = jnp.asarray(rng.uniform(0, 1e-2, (nx, ny, nz)))

    def run(overlap):
        prog = IsentropicPrognostic.factory(
            "rk3ws_si", "fifth_order_upwind", domain, moist,
            pt=FieldArray(np.asarray(100.0), "Pa", ()), eps=0.5, backend="jax",
        )
        # the flag the DistributedBoundary sets; forced here on the plain
        # boundary to isolate the band arithmetic
        prog.horizontal_boundary.overlap_bands = overlap
        out = dict(state)
        for stage in range(3):
            res = prog.stage_call(stage, 4.0, out, {})
            out.update(res)
        return res

    a = run(False)
    b = run(True)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(
            np.asarray(a[k]), np.asarray(b[k]), err_msg=k
        )
