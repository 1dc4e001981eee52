"""What ``chip_smoke.py`` and ``bench.py`` do off the card: refuse a CPU,
read the ``nvidia-smi`` line, place the compile cache, compare against the
reference, run the four-card phase on virtual CPU devices, and start without
the optional packages.  The ``gpu``-marked tests run both scripts on a GPU
and skip elsewhere."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tasmania_jax.utils import device  # noqa: E402


class _Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    env.pop("XLA_FLAGS", None)
    return env


# -- device check -------------------------------------------------------------- #


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(device.NoGPUError, match="needs a GPU"):
        device.require_gpu()


def test_require_gpu_reports_the_card():
    devs = [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * 4
    assert device.require_gpu(devs) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
    }


@pytest.mark.parametrize("line,expected", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("NVIDIA H100 80GB HBM3, 500.00 W\n", ("NVIDIA H100 80GB HBM3", "500.00 W")),
    ("NVIDIA H100, PCIe, 350.00 W", ("NVIDIA H100, PCIe", "350.00 W")),
])
def test_parse_nvidia_smi(line, expected):
    assert device.parse_nvidia_smi(line) == expected


@pytest.mark.parametrize("line", ["", "NVIDIA H100 80GB HBM3", ", 700 W", "H100,"])
def test_parse_nvidia_smi_rejects(line):
    with pytest.raises(ValueError):
        device.parse_nvidia_smi(line)


# -- compile cache --------------------------------------------------------------- #


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_the_environment(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv(device.CACHE_ENV, str(tmp_path / "env_cache"))
    jax.config.update("jax_compilation_cache_dir", None)
    assert device.configure_compile_cache() == str(tmp_path / "env_cache")
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the env itself


def test_compile_cache_defaults_into_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    path = device.configure_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


# -- reference comparison -------------------------------------------------------- #


def _fields(scale=1.0, **override):
    rng = np.random.default_rng(0)
    out = {n: scale * (1.0 + rng.random((4, 3, 2))) for n in chip_smoke.PROGNOSTICS}
    out.update(override)
    return out


def test_relative_errors_are_shares_of_the_field_max():
    ref = _fields()
    out = {k: v * (1 + 1e-6) for k, v in ref.items()}
    errs = chip_smoke.relative_errors(ref, out)
    assert set(errs) == set(chip_smoke.PROGNOSTICS)
    assert all(0 < e <= 1e-6 for e in errs.values())
    chip_smoke.check_errors("ok", errs, 1e-5)


def test_check_errors_fails_over_the_limit():
    ref = _fields()
    out = dict(ref, air_isentropic_density=ref["air_isentropic_density"] * 1.01)
    with pytest.raises(chip_smoke.SmokeFailure, match="air_isentropic_density"):
        chip_smoke.check_errors("bad", chip_smoke.relative_errors(ref, out), 1e-5)


def test_check_errors_fails_on_nan():
    ref = _fields()
    bad = ref["x_momentum_isentropic"].copy()
    bad[0, 0, 0] = np.nan
    out = dict(ref, x_momentum_isentropic=bad)
    with pytest.raises(chip_smoke.SmokeFailure, match="x_momentum_isentropic"):
        chip_smoke.check_errors("nan", chip_smoke.relative_errors(ref, out), 1e-5)


def test_relative_errors_scale_map():
    """The meridional fields are measured against the zonal field's max."""
    ref = _fields(y_momentum_isentropic=np.full((4, 3, 2), 1e-4))
    out = dict(ref, y_momentum_isentropic=ref["y_momentum_isentropic"] + 1e-6)
    own = chip_smoke.relative_errors(ref, out)["y_momentum_isentropic"]
    zonal = chip_smoke.relative_errors(ref, out, scales=chip_smoke.F32_SCALES)[
        "y_momentum_isentropic"
    ]
    assert own == pytest.approx(1e-2)
    assert zonal < 1e-5


def test_relative_errors_refuse_a_shape_mismatch():
    ref = _fields()
    out = dict(ref, x_velocity_at_u_locations=np.ones((5, 3, 2)))
    with pytest.raises(chip_smoke.SmokeFailure, match="shape"):
        chip_smoke.relative_errors(ref, out)


def test_tolerances_are_ordered():
    assert chip_smoke.TOL_F64 < chip_smoke.TOL_F32 < chip_smoke.TOL_FOUR_CARDS


# -- the phases, at a tiny size on the CPU ----------------------------------------- #


def test_four_cards_phase_on_virtual_devices(capsys):
    devs = jax.devices()
    assert len(devs) >= 4, "conftest gives the CPU 8 virtual devices"
    chip_smoke.phase_four_cards(devs[:4], bx=12, by=12, nz=6, nsteps=2)
    out = capsys.readouterr().out
    assert "DistributedModel: 17 field(s), each on devices" in out
    assert "spmd vs one card air_isentropic_density: 0.000e+00" in out


def test_reference_phase_at_a_tiny_size():
    ref = chip_smoke.phase_reference_f32(nsteps=2, nx=13, nz=6)
    chip_smoke.phase_reference_f64(ref, nsteps=2, nx=13, nz=6)
    assert isinstance(ref["air_isentropic_density"], np.ndarray)


# -- off the card, the scripts fail -------------------------------------------------- #


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_a_gpu(script):
    res = subprocess.run(
        [sys.executable, script], cwd=REPO, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert "NoGPUError" in res.stderr
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert "ModuleNotFoundError" in res.stderr
    assert res.stdout == ""


def test_main_path_runs_without_optional_packages():
    """orbax, h5py and matplotlib may be missing where the card is: the
    flagship path must neither import nor need them."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("orbax", "h5py", "matplotlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import chip_smoke
from drivers.driver_namelist_sus import main
res = main(["--fused-loop", "--nx", "13", "--nz", "6", "--niter", "2"])
assert res["umax"] == res["umax"]
bad = [m for m in sys.modules if m.split(".")[0] in ("orbax", "h5py", "matplotlib")]
assert not bad, bad
print("clean")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")


# -- on the card ------------------------------------------------------------------------ #


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=gpu,
        capture_output=True, text=True, timeout=1200,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    last = _last_json(res.stdout)
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_bench_on_gpu(gpu):
    res = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, env=gpu,
        capture_output=True, text=True, timeout=1200,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    last = _last_json(res.stdout)
    assert last["value"] > 0 and last["device"]["platform"] == "gpu"
