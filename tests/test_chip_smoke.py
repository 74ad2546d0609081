"""chip_smoke.py's phases at a tiny size on the CPU.

The phases run with the GPU's engine choices (device decode, device encode
packing, device AHX decode) injected into the engine table. On the card the
script runs them at full size (`python chip_smoke.py`).
"""
import os
import subprocess
import sys

import pytest

import chip_smoke
from pycricodecs_tpu import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def gpu_engines(monkeypatch):
    for key in (("hca", "decode"), ("hca", "encode_pack"), ("ahx", "decode")):
        monkeypatch.setitem(backend.ENGINES[key], "cpu",
                            backend.ENGINES[key]["gpu"])


def test_phase_main_tiny(gpu_engines, capsys):
    blobs, host = chip_smoke.phase_main(n=3, seconds=0.5, reps=1)
    out = capsys.readouterr().out
    assert len(blobs) == len(host) == 3
    assert "device_unpack_streams=3" in out
    assert "decode_awb byte-identical" in out
    mem = chip_smoke.memory_report(blobs)
    assert mem is not None


def test_phase_engines_tiny(gpu_engines, capsys):
    chip_smoke.phase_engines(n=2, seconds=0.5, candidates=64)
    out = capsys.readouterr().out
    assert "HCA device encode byte-identical" in out
    assert "ADX device encode and decode byte-identical" in out
    assert "best key 0xcf222f1fe0748978" in out


def test_bank_is_keyed_and_distinct():
    from pycricodecs_tpu.ops import hca_frame

    blobs = chip_smoke.make_bank(2, 0.2)
    assert blobs[0] != blobs[1]
    hs = int.from_bytes(blobs[0][6:8], "big")
    assert hca_frame.parse_header(blobs[0][:hs]).ciph_type == 56


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "needs a GPU" in captured.err


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
