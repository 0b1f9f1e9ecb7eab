"""Device-facing plumbing that runs on the CPU: the peak table, the primitive
calibration guard, the compile-cache location, the profiler-trace
reduction, and chip_smoke.py's refusal to run without a GPU."""

import gzip
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from spmm_tpu.ops import roofline
from spmm_tpu.utils import compile_cache, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_peak_table_resolves_h100():
    spec = roofline.chip_spec("NVIDIA H100 80GB HBM3")
    assert spec.hbm_gbps == 3350.0
    assert (spec.flops_f32, spec.flops_tf32, spec.flops_bf16) == (67e12, 495e12, 989e12)
    assert "data sheet" in spec.source
    # web-Google SpMM at k=128 is bandwidth-bound on it
    rl = roofline.spmm_roofline(5_105_039, 916_428, 916_428, 128, chip=spec)
    assert rl.t_sol_s == rl.t_bandwidth_s > rl.t_compute_s


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "AMD Instinct MI300X", ""])
def test_peak_table_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no peak rates"):
        roofline.chip_spec(kind)


def test_detect_chip_refuses_the_cpu_backend():
    with pytest.raises(ValueError, match="no peak rates"):
        roofline.detect_chip()
    with pytest.raises(ValueError):
        roofline.spmm_roofline(10, 10, 10, 4)  # no chip given: detected


def _write_calibration(tmp_path, monkeypatch, device):
    p = tmp_path / "rates.json"
    p.write_text(json.dumps({
        "_device": device, "row_gather_rows_s": 1e9, "scatter_elems_s": 2e9,
        "scalar_gather_s": 3e9, "sort_batched_s": 4e9, "sort_global_s": 5e8,
        "elementwise_gbs": 2e12, "row_gather_curve": [[1e6, 2e9], [1e9, 1e9]],
    }))
    monkeypatch.setattr(roofline.MeasuredRates, "calibration_path",
                        staticmethod(lambda: str(p)))


def test_measured_rates_load_checks_the_device(tmp_path, monkeypatch):
    monkeypatch.setattr(roofline.MeasuredRates, "calibration_path",
                        staticmethod(lambda: str(tmp_path / "missing.json")))
    with pytest.raises(FileNotFoundError):
        roofline.MeasuredRates.load("NVIDIA H100 80GB HBM3")
    _write_calibration(tmp_path, monkeypatch, "NVIDIA H100 80GB HBM3")
    with pytest.raises(ValueError, match="captured on"):
        roofline.MeasuredRates.load()  # the running device is the CPU
    r = roofline.MeasuredRates.load("NVIDIA H100 80GB HBM3")
    assert r.scatter_elems_s == 2e9
    assert r.row_gather_rate(1e6) == 2e9 and r.row_gather_rate(1e12) == 1e9
    assert 1e9 < r.row_gather_rate(3e7) < 2e9  # log-log interpolation
    # nnz/gather rate + the (m, k) output written and read once
    t = roofline.spmm_attainable(1_000_000, 1000, 128, r)
    assert t == pytest.approx(1e6 / 1e9 + 2 * 1000 * 128 * 4 / 2e12)


def test_compile_cache_respects_the_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read().split()


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """A small trace recorded on the CPU backend."""
    import glob

    f = jax.jit(lambda x: jnp.sort(x * 2.0) + 1.0)
    x = jnp.arange(4096.0)
    f(x).block_until_ready()
    d = str(tmp_path_factory.mktemp("trace"))
    with jax.profiler.trace(d):
        f(x).block_until_ready()
    (path,) = glob.glob(os.path.join(d, "plugins/profile/*/*.trace.json.gz"))
    with gzip.open(path) as fh:
        return json.load(fh)


def test_trace_reduction_picks_the_device_plane_by_platform(cpu_trace):
    evs = profiling.device_events(cpu_trace, "cpu")
    assert evs and all("hlo_op" in e["args"] for e in evs)
    p = profiling.reduce_trace(cpu_trace, "cpu")
    names = {o.name for o in p.ops}
    assert any("sort" in n for n in names), names
    assert p.total_device_ms == pytest.approx(sum(o.ms for o in p.ops))
    # the same trace has no GPU plane: that is an error, not an empty profile
    with pytest.raises(ValueError, match="no gpu device events"):
        profiling.device_events(cpu_trace, "gpu")
    with pytest.raises(ValueError, match="no device-plane rule"):
        profiling.device_events(cpu_trace, "rocm")


def test_trace_reduction_gpu_plane():
    """The GPU plane as the H100's traces lay it out: one process per card
    with stream lines whose kernels name their HLO op; host events and the
    other planes are left out."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 7,
         "args": {"name": "Stream #13(Memset,Compute)"}},
    ]
    ev = [
        {"ph": "X", "pid": 1, "tid": 1, "name": "python", "dur": 99},
        {"ph": "X", "pid": 2, "tid": 7, "name": "loop_add_fusion", "dur": 6,
         "args": {"hlo_op": "loop_add_fusion"}},
        {"ph": "X", "pid": 2, "tid": 7, "name": "void cub::DeviceRadixSort", "dur": 3,
         "args": {"hlo_op": "custom-call.1"}},
        {"ph": "X", "pid": 2, "tid": 7, "name": "void cub::DeviceRadixSort", "dur": 2,
         "args": {"hlo_op": "custom-call.1"}},
        {"ph": "X", "pid": 2, "tid": 7, "name": "Memset 3", "dur": 1, "args": {}},
    ]
    p = profiling.reduce_trace({"traceEvents": meta + ev}, "gpu")
    assert [(o.name, o.ms) for o in p.ops] == [
        ("loop_add_fusion", 0.006), ("custom-call.1", 0.005), ("Memset 3", 0.001)
    ]


def test_chip_smoke_refuses_the_cpu():
    """chip_smoke.py exits non-zero and prints no result line when JAX finds
    no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


@pytest.mark.gpu
def test_the_card_has_peak_rates():
    spec = roofline.detect_chip()
    assert spec.hbm_gbps > 0 and spec.flops_f32 > 0


@pytest.mark.gpu
def test_profile_fn_reads_the_gpu_plane():
    """On the card: a traced product yields device op rows from the GPU
    plane, and their total is positive."""
    f = jax.jit(lambda x: jnp.sort(x * 2.0) + 1.0)
    p = profiling.profile_fn(f, jnp.arange(1 << 20, dtype=jnp.float32))
    assert p.ops and p.total_device_ms > 0
