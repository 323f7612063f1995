"""Unit tests for bench.py's result assembly and headline selection, and
for the peak table and streaming rule it shares with profiling.py.

bench.py is a script, but these helpers are pure functions of their
arguments — import it and exercise them with no accelerator.
"""
import os
import subprocess
import sys

import pytest

from tpu_multigrid import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
L2 = profiling.DEVICE_PEAKS[H100].l2_bytes


@pytest.fixture
def bench():
    sys.path.insert(0, ROOT)
    import bench as b
    return b


@pytest.mark.parametrize("kind,known", [
    (H100, True), ("cpu", False), ("TPU v5 lite", False),
    ("NVIDIA A100-SXM4-80GB", False)])
def test_peak_table_lookup(kind, known):
    """The H100 is in the table with its data-sheet bandwidth; any other
    kind raises instead of borrowing another device's peak."""
    if known:
        peak = profiling.device_peak(kind)
        assert peak.hbm_bytes_per_s == 3.35e12
        assert "data sheet" in peak.source
    else:
        with pytest.raises(ValueError, match="no published peaks"):
            profiling.device_peak(kind)


@pytest.mark.parametrize("nbytes,streams", [
    (4 * L2, True), (4 * L2 - 1, False), (L2, False),
    (800 * 2**20, True)])
def test_streaming_threshold_is_4x_l2(nbytes, streams):
    """Only working sets of at least 4x the 50 MB L2 get a roofline
    share; smaller sets may be served from L2 and report bytes/s only."""
    share = profiling.roofline_share(nbytes, 1e-3, H100)
    assert (share is not None) == streams
    if streams:
        assert share == pytest.approx(nbytes / 1e-3 / 3.35e12)


def test_stencil_result_regime_labels(bench):
    """Streaming paths carry a roofline share, small ones None; both
    report bytes/s."""
    out = bench._stencil_result(2048, 2, H100, {"xla": 4e-4},
                                {"xla": int(800e6)})
    assert 0 < out["roofline_share"] < 1.0
    assert out["achieved_bytes_per_s"] == pytest.approx(800e6 / 4e-4)
    out2 = bench._stencil_result(128, 2, H100, {"xla": 1e-5},
                                 {"xla": int(3e6)})
    assert out2["roofline_share"] is None
    assert out2["achieved_bytes_per_s"] == pytest.approx(3e6 / 1e-5)


def test_stencil_result_headline_from_best_streaming_path(bench):
    # the links-only path is faster on nnz/s but its 100 MB set is below
    # 4x L2; the headline stays the streaming path with a roofline share
    out = bench._stencil_result(
        2048, 2, H100, {"xla": 4e-4, "xla_u": 1e-4},
        {"xla": int(800e6), "xla_u": int(100e6)})
    assert out["best_path"] == "xla"
    assert out["paths"]["xla_u"]["roofline_share"] is None
    # nothing streams: the highest nnz/s path
    out2 = bench._stencil_result(
        128, 2, H100, {"xla": 1e-5, "xla_u": 3e-6},
        {"xla": int(3e6), "xla_u": int(8e5)})
    assert out2["best_path"] == "xla_u"


def test_stencil_result_headline_best_fraction_not_best_nnz(bench):
    """Among streaming paths the headline is the best roofline share, not
    the best nnz/s: nnz/s across operator representations is not
    comparable (the links-only form moves ~4x fewer bytes)."""
    out = bench._stencil_result(
        4096, 2, H100, {"xla_u": 1.0e-3, "xla": 1.2e-3},
        {"xla_u": int(805e6), "xla": int(3.2e9)})
    assert out["best_path"] == "xla"
    assert out["paths"]["xla_u"]["nnz_per_s"] > out["nnz_per_s"]


def test_headline_line(bench):
    ok = bench._headline(bench._stencil_result(
        2048, 2, H100, {"xla": 4e-4}, {"xla": int(800e6)}))
    assert ok["metric"] == "wilson_stencil_spmv_nnz_per_s"
    assert ok["device_kind"] == H100 and ok["vs_baseline"] > 0
    bad = bench._headline({"error": "rc=1"})
    assert bad["value"] == 0.0 and bad["vs_baseline"] is None


def test_bench_parent_stays_off_jax():
    """The parent process runs phases as children and never imports JAX,
    so only one JAX process holds the card at a time."""
    code = "import sys, bench; print('jax' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
