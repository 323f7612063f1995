"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size through
the same code the GPU run takes, and the script's refusal to report
success anywhere but on a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

from tpu_multigrid import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TINY = ["--L", "32", "--nlevels", "2", "--null-iters", "40"]


@pytest.fixture
def cpu_peak(monkeypatch):
    """A stand-in peak for the CPU so the byte-rate report can run."""
    monkeypatch.setitem(profiling.DEVICE_PEAKS, "cpu", profiling.DevicePeak(
        hbm_bytes_per_s=1e11, l2_bytes=1, source="test stand-in"))


def _phase(name, tmp_path):
    if name == "flagship_cli":
        s = chip_smoke.phase_flagship_cli(str(tmp_path), TINY,
                                          expect_cycles=None)
        assert s["converged"] and s["resmag"] < 1e-6
    elif name == "flagship_ir":
        s = chip_smoke.phase_flagship_ir(str(tmp_path), TINY)
        assert s["resmag"] < 1e-12
    elif name == "level0":
        out = chip_smoke.phase_level0(L=64, reps=2, copy_bytes=2**20)
        assert out["rel_err_residual"] <= chip_smoke.LEVEL0_TOL
        assert out["links residual"]["bytes_per_s"] > 0
    elif name == "four":
        out = chip_smoke.phase_four(L=32, nlevels=2, null_iters=20,
                                    ens_L=16, ens_B=4, ens_cycles=6)
        assert out["iters"] == out["ref_iters"]


@pytest.mark.parametrize("name", ["flagship_cli", "flagship_ir", "level0",
                                  "four"])
def test_phase_rehearsal(name, tmp_path, cpu_peak):
    _phase(name, tmp_path)


def test_flagship_cycle_check_rejects_a_mismatch(tmp_path):
    with pytest.raises(chip_smoke.PhaseError, match="cycles, CPU gives"):
        chip_smoke.phase_flagship_cli(str(tmp_path), TINY,
                                      expect_cycles=1000)


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_main_fails_without_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_main_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_level0_on_gpu(gpu_device):
    """The compiled level-0 links path against the dense reference on
    the card (run: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu)."""
    out = chip_smoke.phase_level0(L=1024, reps=5)
    assert out["rel_err_smoother"] <= chip_smoke.LEVEL0_TOL
