"""Native host core loader.

Compiles native/cricore.cpp on first use (g++, -O3 -march=native) and exposes
it through ctypes. The built file is named by a hash of the source, the
compiler flags and the host's CPU features, so a library built on one machine
is never loaded on another whose CPU lacks its instructions. All entry points
have pure-Python fallbacks in the rest of the package; `load()` returns None
when no toolchain is available.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cricore.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
# -ffp-contract=off: the HCA decode transform must round every fp32 mul/add
# separately to stay bit-exact with the XLA kernel (FMA contraction perturbs
# ~0.1% of samples by 1 LSB)
_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared",
          "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_features() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return ""


def _so_path() -> str:
    """Build path keyed by source, flags, machine and CPU features."""
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + "|".join(
        _FLAGS + [platform.machine(), _cpu_features()]).encode())
    return os.path.join(_BUILD_DIR,
                        f"libcricore-{key.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # build to a private name, then rename: processes building at the
        # same time (test workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *_FLAGS, _SRC, "-o", tmp, "-lpthread"]
        res = subprocess.run(cmd, capture_output=True, timeout=300)
        if res.returncode != 0:
            os.unlink(tmp)
            return False
        os.replace(tmp, so)
        return True
    except Exception:
        return False


def load():
    """Return the ctypes library handle, building it if needed (or None)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = _so_path()
        except OSError:
            return None
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.cri_crc16.restype = ctypes.c_uint16
        lib.cri_crc16.argtypes = [u8p, ctypes.c_uint32]
        lib.cri_layla_decompress.restype = ctypes.c_int64
        lib.cri_layla_decompress.argtypes = [u8p, ctypes.c_uint32,
                                             ctypes.c_uint32, u8p]
        lib.cri_layla_compress.restype = ctypes.c_uint32
        lib.cri_layla_compress.argtypes = [u8p, ctypes.c_uint32, u8p,
                                           ctypes.c_uint32]
        i32p = ctypes.POINTER(ctypes.c_int32)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.cri_hca_unpack_frames.restype = ctypes.c_int32
        lib.cri_hca_unpack_frames.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, i32p, u8p, u8p, u8p, u8p, i8p, u32p,
            i16p, u8p, u8p, u8p, i32p, u8p, u8p, ctypes.c_int32]
        lib.cri_hca_pack_frames.restype = None
        lib.cri_hca_pack_frames.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, i32p, i32p, i32p, u8p, u8p, u8p, i32p, i32p, i32p,
            u8p, u8p, u8p, u8p, ctypes.c_int32]
        lib.cri_crc16_batch.restype = None
        lib.cri_crc16_batch.argtypes = [u8p, ctypes.c_uint32,
                                        ctypes.c_uint32, u16p]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.cri_mp2_unpack_frames.restype = ctypes.c_int32
        lib.cri_mp2_unpack_frames.argtypes = [
            u8p, i64p, i32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32,
            i32p, i32p, u16p, i32p, u8p]
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.cri_mp2_synthesize.restype = ctypes.c_int32
        lib.cri_mp2_synthesize.argtypes = [
            u16p, i32p, u8p, ctypes.c_int32, ctypes.c_int32,
            f64p, f64p, f64p, i16p]
        lib.cri_adx_decode_scan.restype = None
        lib.cri_adx_decode_scan.argtypes = [
            i32p, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int64, i16p, ctypes.c_int32]
        lib.cri_adx_encode_scan.restype = None
        lib.cri_adx_encode_scan.argtypes = [
            i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p, u8p, ctypes.c_int32,
            ctypes.c_int32]
        lib.cri_adx_decode_blocks.restype = None
        lib.cri_adx_decode_blocks.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i16p, ctypes.c_int32]
        lib.cri_adx_encode_blocks.restype = None
        lib.cri_adx_encode_blocks.argtypes = [
            i16p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p, u8p, ctypes.c_int32,
            ctypes.c_int32]
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.cri_hca_search_levels.restype = ctypes.c_int32
        lib.cri_hca_search_levels.argtypes = [
            i32p, f32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            i32p, u8p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            u8p, u8p, f32p, f32p, u8p,
            i32p, i32p, ctypes.c_int32]
        lib.cri_hca_intensity_stereo.restype = None
        lib.cri_hca_intensity_stereo.argtypes = [
            f32p, u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, u8p, ctypes.c_int32, f32p]
        lib.cri_hca_scalefactors_scale.restype = None
        lib.cri_hca_scalefactors_scale.argtypes = [
            f32p, ctypes.c_int32, ctypes.c_int32, i32p,
            f32p, f32p, ctypes.c_float, i32p, f32p]
        lib.cri_hca_resolution_quantize.restype = None
        lib.cri_hca_resolution_quantize.argtypes = [
            i32p, f32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            i32p, u8p, f32p, i32p, i32p]
        lib.cri_hca_delta_lengths.restype = None
        lib.cri_hca_delta_lengths.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32, i32p, u8p,
            ctypes.c_int32, ctypes.c_int32, i32p, i32p]
        lib.cri_hca_cipher56_batch.restype = None
        lib.cri_hca_cipher56_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, u8p,
            ctypes.c_int32]
        lib.cri_hca_test_frames.restype = None
        lib.cri_hca_test_frames.argtypes = [
            u8p, i32p, ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            u8p, i32p, u8p, u8p, u8p, u8p,
            ctypes.POINTER(ctypes.c_int8),
            i32p, i16p, u8p, u8p, u8p, ctypes.c_int32]
        lib.cri_hca_mdct.restype = None
        lib.cri_hca_mdct.argtypes = [
            i16p, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, f32p, i32p, f32p]
        lib.cri_hca_decode_transform.restype = None
        lib.cri_hca_decode_transform.argtypes = [
            i16p, u8p, u8p, u8p, i32p, u8p, u8p,          # qc..noise_mask
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, ctypes.c_int32,                          # pairs, npairs
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, i32p, i32p, ctypes.c_int32,               # hfr maps
            f32p, f32p, f32p, f32p, f32p, f32p, f32p,      # tables
            i16p]
        _lib = lib
        return _lib
