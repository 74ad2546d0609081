"""Tests that need a GPU: they skip elsewhere (the `gpu` fixture decides at
run time). On the card:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import pytest

import chip_smoke
from pycricodecs_tpu import parallel

pytestmark = pytest.mark.gpu


def test_bank_decode_on_gpu_matches_host_lanes(gpu):
    blobs = chip_smoke.make_bank(8, 2.0)
    stats = parallel.DecodeStats()
    dev = parallel.decode_batch(blobs, key=chip_smoke.KEY, stats=stats)
    assert stats.device_unpack_streams == len(blobs)
    assert dev == parallel.decode_batch(blobs, key=chip_smoke.KEY,
                                        engine="host")


def test_device_engines_on_gpu_match_host(gpu):
    chip_smoke.phase_engines(n=4, seconds=1.0, candidates=2000)
