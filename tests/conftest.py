"""Test configuration: an 8-device virtual CPU mesh for JAX by default.

Without JAX_PLATFORMS set, tests run on the CPU and multi-device sharding
paths run on xla_force_host_platform_device_count=8 virtual CPU devices.
Tests that need a GPU carry the `gpu` marker and skip unless JAX's first
device is one (run them with JAX_PLATFORMS=cuda pytest -m gpu).
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
extra = []
if "xla_force_host_platform_device_count" not in flags:
    extra.append("--xla_force_host_platform_device_count=8")
if "xla_cpu_max_isa" not in flags:
    # Pre-FMA ISA: XLA CPU otherwise contracts fp32 mul+add into FMAs, which
    # breaks bit-exact parity with the (SSE2-built) reference decoder.
    extra.append("--xla_cpu_max_isa=SSE4_2")
os.environ["XLA_FLAGS"] = (flags + " " + " ".join(extra)).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


# ---------------------------------------------------------------------------
# Two-tier suite: the device-kernel tests are jit-compile-dominated (each
# costs 10-400 s on one CPU core) and auto-mark as `slow`.  The core tier
# (`pytest -m "not slow"`) covers every codec/container/host path; the FULL
# suite stays the CI default.
# ---------------------------------------------------------------------------
_SLOW_MODULES = frozenset({
    "test_hca_unpack_device", "test_pack_device", "test_hfr_device",
    "test_native_sanitize",
})
_SLOW_TESTS = (
    "test_adx_encode_fixpoint_matches_scan",
    "test_adx_encode_fixpoint_segmented_long_tone",
    "test_adx_encode_batch_device_byte_parity",
    "test_adx_device_pipeline_unpack_exact",
    "test_adx_batch_sharded_mesh",
    "test_decode_batch_sharded_pallas_engines",
    "test_decode_batch_single_stream_sp_mesh",
    "test_decode_batch_host_engine_matches_device",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: jit-compile-heavy device-kernel test; core tier "
        "deselects these with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (run on the card with "
        "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu)")


@pytest.fixture()
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time, never
    at import or collection)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.nodeid.split("::", 1)[0].rsplit("/", 1)[-1]
        name = item.name.split("[", 1)[0]
        if mod.removesuffix(".py") in _SLOW_MODULES or name in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


# ---------------------------------------------------------------------------
# Reference oracle: the compiled PyCriCodecs C++ extension (built out-of-tree
# in /tmp/refbuild). Tests that need bit-exact ground truth use this fixture
# and skip gracefully when it is unavailable.
# ---------------------------------------------------------------------------
_ORACLE_PATH = "/tmp/refbuild"


def _load_oracle():
    if _ORACLE_PATH not in sys.path:
        sys.path.insert(0, _ORACLE_PATH)
    try:
        import CriCodecs  # noqa: F401
        return CriCodecs
    except ImportError:
        return None


@pytest.fixture(scope="session")
def oracle():
    mod = _load_oracle()
    if mod is None:
        pytest.skip("reference CriCodecs oracle not built")
    return mod


def make_sine_pcm16(samples, channels=1, sample_rate=48000, freq=440.0, amp=0.5, seed=0):
    """Deterministic sine+noise PCM16 test signal, interleaved."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sample_rate
    out = np.zeros((samples, channels), dtype=np.float64)
    for c in range(channels):
        out[:, c] = (amp * np.sin(2 * np.pi * (freq * (c + 1)) * t)
                     + 0.02 * rng.standard_normal(samples))
    return np.clip(out * 32767.0, -32768, 32767).astype(np.int16).reshape(-1)


@pytest.fixture()
def sine_wav():
    from pycricodecs_tpu.utils.wav import write_wav

    def _make(samples=4096, channels=1, sample_rate=48000, looping=False,
              loop_start=0, loop_end=0, seed=0):
        pcm = make_sine_pcm16(samples, channels, sample_rate, seed=seed)
        return write_wav(pcm, channels, sample_rate, looping=looping,
                         loop_start=loop_start, loop_end=loop_end)

    return _make


@pytest.fixture(scope="session")
def oracle_py():
    """The reference pure-Python package (containers oracle)."""
    _load_oracle()
    if "/root/reference" not in sys.path:
        sys.path.insert(0, "/root/reference")
    try:
        import PyCriCodecs  # noqa: F401
        return PyCriCodecs
    except Exception:
        pytest.skip("reference PyCriCodecs package unavailable")
