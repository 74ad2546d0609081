"""The choice of engine for each (codec, stage), made in one place.

The choice follows the platform of the first JAX device and is read outside
`jit`, so a compiled program never depends on it:

- "gpu": the device engines (batched XLA programs);
- "cpu": the host C++ lanes where the stage has them, XLA on the CPU
  otherwise.

No other platform is supported.
"""
from __future__ import annotations

from typing import Optional

import jax

ENGINES = {
    # bank decode: batched device dispatch vs per-stream C++ lanes
    ("hca", "decode"): {"gpu": "device", "cpu": "host"},
    # HCA device encode: frame packer on the device vs the C++ packer
    ("hca", "encode_pack"): {"gpu": "device", "cpu": "host"},
    # AHX bank decode: device synthesis vs the float64 host path
    ("ahx", "decode"): {"gpu": "device", "cpu": "host"},
}


def platform() -> str:
    return jax.devices()[0].platform


def engine(codec: str, stage: str, plat: Optional[str] = None) -> str:
    """Engine for (codec, stage) on `plat` (default: the JAX platform)."""
    plat = plat or platform()
    table = ENGINES[(codec, stage)]
    if plat not in table:
        raise RuntimeError(f"unsupported JAX platform {plat!r} "
                           f"(supported: {', '.join(sorted(table))})")
    return table[plat]
