"""The engine table: one engine per (codec, stage) and platform, read
outside jit; the platform is injected here."""
import pytest

from pycricodecs_tpu import backend, parallel


@pytest.mark.parametrize("key,gpu,cpu", [
    (("hca", "decode"), "device", "host"),
    (("hca", "encode_pack"), "device", "host"),
    (("ahx", "decode"), "device", "host"),
])
def test_engine_table(key, gpu, cpu):
    assert backend.engine(*key, "gpu") == gpu
    assert backend.engine(*key, "cpu") == cpu


def test_engine_defaults_to_the_jax_platform():
    assert backend.platform() == "cpu"
    assert backend.engine("hca", "decode") == "host"


def test_backend_rejects_other_platforms():
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.engine("hca", "decode", "rocm")


def test_ahx_decode_batch_follows_the_table(monkeypatch):
    """device=None takes the table's choice: with the GPU's entry the AHX
    bank runs the device synthesis (1-LSB contract), with the CPU's the
    float64 host path (exact against device=False)."""
    import numpy as np

    from pycricodecs_tpu.models.ahx import AHX
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.conftest import make_sine_pcm16

    blob = AHX.encode(write_wav(make_sine_pcm16(11025, 1, 22050, seed=3), 1,
                                22050), bitrate_kbps=96)
    host = parallel.ahx_decode_batch([blob], device=False)
    assert parallel.ahx_decode_batch([blob]) == host
    monkeypatch.setitem(backend.ENGINES[("ahx", "decode")], "cpu", "device")
    dev = parallel.ahx_decode_batch([blob])
    x = np.frombuffer(dev[0][44:], "<i2").astype(int)
    y = np.frombuffer(host[0][44:], "<i2").astype(int)
    assert x.shape == y.shape and np.abs(x - y).max() <= 1


def test_decode_batch_auto_takes_the_device_with_the_gpu_table(monkeypatch):
    """engine="auto" with the GPU's entry sends a bank to the device."""
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.conftest import make_sine_pcm16

    blob = hca_encode_host.encode(write_wav(
        make_sine_pcm16(6000, 2, 48000, seed=9), 2, 48000), quality=2)
    host = parallel.decode_batch([blob], engine="host")
    monkeypatch.setitem(backend.ENGINES[("hca", "decode")], "cpu", "device")
    stats = parallel.DecodeStats()
    assert parallel.decode_batch([blob], stats=stats) == host
    assert stats.device_unpack_streams == 1


def test_decode_batch_device_failure_raises(monkeypatch):
    """A device failure on an auto-routed call raises; the host lanes do
    not answer it."""
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.parallel import pipeline
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.conftest import make_sine_pcm16

    blob = hca_encode_host.encode(write_wav(
        make_sine_pcm16(4096, 1, 48000, seed=4), 1, 48000), quality=1)
    monkeypatch.setitem(backend.ENGINES[("hca", "decode")], "cpu", "device")

    def broken(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(pipeline, "_decode_group", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        parallel.decode_batch([blob])


@pytest.mark.parametrize("env_dir", [None, "some/cache"])
def test_compile_cache_location(monkeypatch, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the package sets no cache
    directory; without it the cache goes to .jax_cache/ in the checkout."""
    import os

    from pycricodecs_tpu.parallel import pipeline

    calls = []
    monkeypatch.setattr(pipeline, "_cache_ready", False)
    monkeypatch.delenv("PYCRICODECS_NO_JAX_CACHE", raising=False)
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(pipeline.jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    pipeline._ensure_compile_cache()
    if env_dir:
        assert calls == []
    else:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert pipeline.CACHE_DIR == os.path.join(root, ".jax_cache")
        assert ("jax_compilation_cache_dir", pipeline.CACHE_DIR) in calls
