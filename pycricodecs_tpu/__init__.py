"""pycricodecs_tpu: a batched CRIWARE codec framework on JAX.

A from-scratch rebuild of the capabilities of Youjose/PyCriCodecs with a
JAX/XLA compute path (batched ADX/HCA/AHX transcode on a GPU) and a C++ host core
for bitstream work. The public API mirrors the reference package:

    ADX, HCA, CPK, CPKBuilder, USM, USMBuilder, UTF, UTFBuilder,
    ACB, ACBBuilder, AWB, AWBBuilder, IVF

plus new batched/sharded entry points under ``pycricodecs_tpu.parallel``.
"""
from enum import Enum
from struct import Struct

from .containers.acb import ACB, ACBBuilder
from .containers.chunk import (AWBChunkHeader, AWBType, CPKChunkHeader,
                               CPKChunkHeaderType, CriHcaQuality, HCAType,
                               SBTChunkHeader, USMChunckHeaderType,
                               USMChunkHeader, UTFChunkHeader, UTFType,
                               UTFTypeValues, VideoType, WavDataHeaderStruct,
                               WavHeaderStruct, WavNoteHeaderStruct,
                               WavSmplHeaderStruct)
from .containers.awb import AWB, AWBBuilder
from .containers.cpk import CPK, CPKBuilder
from .containers.ivf import IVF
from .containers.usm import USM, USMBuilder
from .containers.utf import UTF, UTFBuilder
from .models.adx import ADX
from .models.ahx import AHX
from .models.hca import HCA
from .models import crilayla

# submodule aliases matching the reference package layout (its __init__ does
# star-imports, so `PyCriCodecs.usm` / `from PyCriCodecs import chunk` are
# reachable; mirror that surface onto our modules)
from .containers import acb, awb, chunk, cpk, ivf, usm, utf
from .models import adx, ahx, hca

__all__ = ["ADX", "AHX", "HCA", "CPK", "CPKBuilder", "USM", "USMBuilder",
           "UTF", "UTFBuilder", "ACB", "ACBBuilder", "AWB", "AWBBuilder",
           "IVF", "crilayla", "USMChunckHeaderType", "CPKChunkHeaderType",
           "UTFType", "AWBType", "HCAType", "VideoType", "UTFTypeValues",
           "CriHcaQuality", "Enum", "Struct", "UTFChunkHeader",
           "USMChunkHeader", "CPKChunkHeader", "AWBChunkHeader",
           "SBTChunkHeader", "WavHeaderStruct", "WavSmplHeaderStruct",
           "WavNoteHeaderStruct", "WavDataHeaderStruct",
           "acb", "adx", "ahx", "awb", "chunk", "cpk", "hca", "ivf",
           "usm", "utf"]
__version__ = "0.1.0"
