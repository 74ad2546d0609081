"""chip_smoke.py's --four phase at a tiny size on 4 of the 8 virtual CPU
devices: both meshes byte-identical to one device."""
import jax
import pytest

import chip_smoke


def test_phase_four_tiny(capsys):
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four(n=4, seconds=0.5)
    out = capsys.readouterr().out
    assert "make_mesh((4, 1)) byte-identical" in out
    assert "make_mesh((2, 2)) byte-identical" in out


def test_four_option_needs_four_gpus(capsys):
    assert chip_smoke.main(["--four"]) == 1
    assert '"ok"' not in capsys.readouterr().out
