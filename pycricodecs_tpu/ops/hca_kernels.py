"""HCA device transform kernels (JAX): the numeric half of decode/encode.

Decode pipeline (clHCA_DecodeBlock_transform, hca.cpp:1207-1233, batched):
  dequantise -> noise fill (unpacker-computed indices) ->
  HFR reconstruction (static gather map) -> intensity stereo -> IMDCT
  (7 add/sub stages + 7 twiddle stages) -> window overlap-add.
Plain XLA: the whole chain is elementwise work and reshapes that XLA fuses.

The overlap-add carry between subframes is *linear*: prev(t) depends only on
dct(t-1), so the whole time axis is a shifted elementwise expression — no scan,
every (stream, frame, subframe, channel) lane runs in parallel. All float ops
are single-rounded fp32 mul/add in the same order as the reference, keeping
output bit-exact modulo FMA contraction (tests measure exactness).

Shapes: B = batch of streams, T = frames*8 subframes, C channels, 128 bands.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import hca_tables as T

# contiguous fp32 copies of the constant transform tables, marshalled once
# for the native ctypes call (kept alive for the library's pointer lifetime)
_TRANSFORM_TABLES_F32 = [np.ascontiguousarray(a, dtype=np.float32) for a in
                         (T.SCALING_TABLE, T.RANGE_TABLE,
                          T.SCALE_CONVERSION_TABLE, T.INTENSITY_RATIO_TABLE,
                          T.IMDCT_SIN, T.IMDCT_COS, T.IMDCT_WINDOW)]


# NOTE on bit-exactness: XLA CPU contracts fp32 mul+add chains into FMAs at
# the LLVM level (barriers and precision flags do not stop it). For bit-exact
# decode parity with the C++ reference run with
# XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 (no FMA hardware -> no contraction); see
# tests/conftest.py. Without it, output differs by at most 1 LSB on ~0.1% of
# samples.


class HfrMap(NamedTuple):
    """Static high-frequency-reconstruction gather map for one stream config."""
    band_is_hfr: np.ndarray   # bool [128]
    src_band: np.ndarray      # int32 [128] lowband source (identity elsewhere)
    group_of: np.ndarray      # int32 [128]
    zero_band: int            # band zeroed after reconstruction (-1 = none)


def build_hfr_map(total_band_count: int, base_band_count: int,
                  stereo_band_count: int, bands_per_hfr_group: int,
                  hfr_group_count: int, version: int) -> HfrMap:
    """Precompute the highband<-lowband walk (hca.cpp:1638-1683)."""
    is_hfr = np.zeros(128, dtype=bool)
    src = np.arange(128, dtype=np.int32)
    group_of = np.zeros(128, dtype=np.int32)
    zero_band = -1
    if bands_per_hfr_group > 0 and hfr_group_count > 0:
        start_band = stereo_band_count + base_band_count
        highband = start_band
        lowband = start_band - 1
        if version <= 0x0200:
            group_limit = hfr_group_count
        else:
            group_limit = (hfr_group_count if hfr_group_count >= 0
                           else hfr_group_count + 1) >> 1
        for group in range(hfr_group_count):
            lowband_sub = 1 if group < group_limit else 0
            for _ in range(bands_per_hfr_group):
                if highband >= total_band_count or lowband < 0:
                    break
                is_hfr[highband] = True
                src[highband] = lowband
                group_of[highband] = group
                highband += 1
                lowband -= lowband_sub
        zero_band = highband - 1
    return HfrMap(is_hfr, src, group_of, zero_band)


# ---------------------------------------------------------------------------
# IMDCT (decode)
# ---------------------------------------------------------------------------

def _imdct_butterflies(spec):
    """DCT-IV via the reference's 7+7 stage network; spec [..., 128] f32."""
    x = spec
    # part 1: add/sub tree (hca.cpp:1906-1935)
    count1, count2 = 1, 64
    for _ in range(T.MDCT_BITS):
        g = x.reshape(*x.shape[:-1], count1, count2, 2)
        a = g[..., 0]
        b = g[..., 1]
        x = jnp.concatenate([a + b, a - b], axis=-1).reshape(*spec.shape)
        count1 <<= 1
        count2 >>= 1
    # part 2: twiddle stages (hca.cpp:1937-1972)
    count1, count2 = 64, 1
    for i in range(T.MDCT_BITS):
        sin = jnp.asarray(T.IMDCT_SIN[i]).reshape(count1, count2)
        cos = jnp.asarray(T.IMDCT_COS[i]).reshape(count1, count2)
        g = x.reshape(*x.shape[:-1], count1, 2, count2)
        s1 = g[..., 0, :]
        s2 = g[..., 1, :]
        first = s1 * sin - s2 * cos
        second = jnp.flip(s1 * cos + s2 * sin, axis=-1)
        x = jnp.concatenate([first, second], axis=-1).reshape(*spec.shape)
        count1 >>= 1
        count2 <<= 1
    return x


def _window_overlap_add(dct):
    """Windowed overlap-add over the time axis; dct [..., T, 128] f32."""
    w = jnp.asarray(T.IMDCT_WINDOW)
    p_first = jnp.flip(w[64:]) * jnp.flip(dct[..., :64], axis=-1)
    p_second = jnp.flip(w[:64]) * dct[..., :64]
    prev = jnp.concatenate([p_first, p_second], axis=-1)
    zeros = jnp.zeros_like(prev[..., :1, :])
    prev = jnp.concatenate([zeros, prev[..., :-1, :]], axis=-2)
    first = w[:64] * dct[..., 64:] + prev[..., :64]
    second = w[64:] * jnp.flip(dct[..., 64:], axis=-1) - prev[..., 64:]
    return jnp.concatenate([first, second], axis=-1)


# ---------------------------------------------------------------------------
# Decode transform
# ---------------------------------------------------------------------------

def hfr_static_of(hfr_map) -> tuple:
    """Hashable form of a build_hfr_map result, for the `hfr_static` fast
    path of the decode transform (static 0/1 matmuls instead of gathers)."""
    return (tuple(bool(x) for x in np.asarray(hfr_map.band_is_hfr)),
            tuple(int(x) for x in np.asarray(hfr_map.src_band)),
            tuple(int(x) for x in np.asarray(hfr_map.group_of)),
            int(hfr_map.zero_band))


def _onehot_take(table, idx, n):
    """table[idx] without a dynamic gather: balanced binary select tree.

    A one-hot compare+reduce costs n*(cmp+sel+add) ops and materialises an
    [..., n] axis; the select tree costs n-1 selects of the exact table
    constants (pure elementwise, XLA fuses it). Exact: selects preserve
    the table's fp32 bit patterns. `table` is a [n] constant; idx integer
    array of any shape with values in [0, n) (tree wraps mod 2^ceil(log2 n),
    callers guarantee range)."""
    tab = np.asarray(table)[:n]
    m = max(1 << (n - 1).bit_length(), 1)
    if m > n:
        tab = np.concatenate([tab, np.broadcast_to(tab[-1:], (m - n,))])
    idx = idx.astype(jnp.int32)
    vals = list(tab)
    bit = 0
    while len(vals) > 1:
        b = (idx >> bit) & 1 == 1
        nxt = []
        for i in range(0, len(vals), 2):
            lo, hi = vals[i], vals[i + 1]
            if isinstance(lo, (np.generic, float, int)) and \
                    isinstance(hi, (np.generic, float, int)) and lo == hi:
                nxt.append(lo)  # identical pair: no select needed
            else:
                nxt.append(jnp.where(b, hi, lo))
        vals = nxt
        bit += 1
    out = vals[0]
    if isinstance(out, (np.generic, float, int)):
        out = jnp.broadcast_to(jnp.asarray(tab[0]), idx.shape)
    return out


def _reconstruct_spectra(qc, sf, res, intensity, noise_src, noise_sci,
                         noise_mask, hfr_is, hfr_src, hfr_group, hfr_zero, *,
                         base_band, total_band, stereo_pairs, apply_noise,
                         apply_hfr, hfr_group_count, hfr_static=None):
    """Dequantise + noise fill + HFR + intensity stereo -> [B, F, C, 8, 128].

    The shared front half of the decode transform; both the PCM path
    (hca_decode_transform_batched) and the key-scorer's float inspection
    path (hca_decode_wave) run exactly this, so they cannot drift.

    hfr_static: optional hashable HFR map (hfr_static_of). When given, the
    hfr_* array arguments are ignored and the HFR stage routes bands with
    trace-time-constant 0/1 matmuls (exact: one nonzero product per output,
    precision=HIGHEST keeps fp32 multiplicands) instead of dynamic gathers.
    """
    C = qc.shape[2]

    # dequantise: table lookups as select trees
    gain = _onehot_take(T.SCALING_TABLE, sf, 64) \
        * _onehot_take(T.RANGE_TABLE, res, 16)            # [B, F, C, 128]
    spectra = gain[..., None, :] * qc.astype(jnp.float32)  # [B, F, C, 8, 128]

    if apply_noise:
        # noise_src holds band indices 0..127; callers may ship it as uint8
        # to quarter the H2D bytes. The band routing is a per-lane
        # select-sum over the 128 bands.
        iota = jnp.arange(128, dtype=jnp.int32)
        gathered = jnp.sum(
            jnp.where(noise_src.astype(jnp.int32)[..., None] == iota,
                      spectra[..., None, :], jnp.float32(0.0)), axis=-1)
        spectra = jnp.where(noise_mask,
                            _onehot_take(T.SCALE_CONVERSION_TABLE,
                                         noise_sci, 128) * gathered, spectra)

    if apply_hfr:
        # sci = hfr_scale(group) - sf[lowband] + 63, clamped at 0
        hfr_scales = sf[..., 128 - hfr_group_count:]       # [B, F, C, G]
        if hfr_static is not None:
            is_hfr_t, src_t, grp_t, _zero = hfr_static
            src_np = np.asarray(src_t, np.int64)
            grp_np = np.asarray(grp_t, np.int64)
            m_src = np.zeros((128, 128), np.float32)
            m_src[src_np, np.arange(128)] = 1.0            # out[j]=x[src[j]]
            m_grp = np.zeros((hfr_group_count, 128), np.float32)
            # mirror take_along_axis OOB semantics (clamp) for non-HFR rows
            m_grp[np.clip(grp_np, 0, hfr_group_count - 1),
                  np.arange(128)] = 1.0
            hp = jax.lax.Precision.HIGHEST
            g_scale = jnp.einsum("...g,gk->...k",
                                 hfr_scales.astype(jnp.float32),
                                 jnp.asarray(m_grp),
                                 precision=hp).astype(jnp.int32)
            low_sf = jnp.einsum("...k,kj->...j", sf.astype(jnp.float32),
                                jnp.asarray(m_src),
                                precision=hp).astype(jnp.int32)
            low_spec = jnp.einsum("...k,kj->...j", spectra,
                                  jnp.asarray(m_src), precision=hp)
            hfr_is = jnp.asarray(np.asarray(is_hfr_t, bool))
        else:
            bc = (1,) * 3
            g_scale = jnp.take_along_axis(
                hfr_scales.astype(jnp.int32),
                hfr_group.reshape(bc + (-1,)), axis=-1)
            low_sf = jnp.take_along_axis(sf.astype(jnp.int32),
                                         hfr_src.reshape(bc + (-1,)), axis=-1)
            low_spec = jnp.take_along_axis(
                spectra, hfr_src.reshape(bc + (1, -1)), axis=-1)
        sci = jnp.maximum(g_scale - low_sf + 63, 0)
        hfr_fill = _onehot_take(T.SCALE_CONVERSION_TABLE, sci,
                                128)[..., None, :] * low_spec
        # secondary channels skip HFR (their high bands come from intensity)
        is_secondary = jnp.zeros((C,), dtype=bool)
        for (p, s) in stereo_pairs:
            is_secondary = is_secondary.at[s].set(True)
        not_sec = (~is_secondary)[None, None, :, None, None]
        mask = hfr_is[None, None, None, None, :] & not_sec
        spectra = jnp.where(mask, hfr_fill, spectra)
        zero_mask = (jnp.arange(128) == hfr_zero)[None, None, None, None, :] \
            & not_sec
        spectra = jnp.where(zero_mask, 0.0, spectra)

    if stereo_pairs:
        band = jnp.arange(128)
        sel = (band >= base_band) & (band < total_band)
        for (p, s) in stereo_pairs:
            ratio_l = _onehot_take(T.INTENSITY_RATIO_TABLE,
                                   intensity[..., s, :], 16)[..., None]
            ratio_r = jnp.float32(2.0) - ratio_l
            l_spec = spectra[..., p, :, :]
            new_l = jnp.where(sel, l_spec * ratio_l, l_spec)
            new_r = jnp.where(sel, l_spec * ratio_r, spectra[..., s, :, :])
            spectra = spectra.at[..., p, :, :].set(new_l)
            spectra = spectra.at[..., s, :, :].set(new_r)
    return spectra


@partial(jax.jit, static_argnames=("base_band", "total_band", "stereo_pairs",
                                   "apply_noise", "apply_hfr",
                                   "hfr_group_count", "hfr_static"))
def hca_decode_transform_batched(qc, sf, res, intensity, noise_src, noise_sci,
                                 noise_mask, hfr_is, hfr_src, hfr_group,
                                 hfr_zero, *, base_band, total_band,
                                 stereo_pairs, apply_noise, apply_hfr,
                                 hfr_group_count, hfr_static=None):
    """Spectra -> interleaved PCM16 for a batch of streams.

    qc        : int16 [B, F, C, 8, 128] (B streams x F frames)
    sf, res   : uint8 [B, F, C, 128]
    intensity : uint8 [B, F, C, 8]
    noise_*   : gather maps from unpack (only read when apply_noise)
    hfr_*     : static gather maps (build_hfr_map), device arrays
    returns   : int16 [B, F, 8, 128, C] (frame-major interleaved samples)

    All stages are batched elementwise/gather math; the only cross-frame
    coupling (overlap-add) is a one-step shift over the time axis, so when F
    is sharded over a mesh axis XLA lowers it to a neighbour collective-permute
    (halo exchange) rather than a serial scan.
    """
    B, F, C = qc.shape[0], qc.shape[1], qc.shape[2]
    spectra = _reconstruct_spectra(
        qc, sf, res, intensity, noise_src, noise_sci, noise_mask, hfr_is,
        hfr_src, hfr_group, hfr_zero, base_band=base_band,
        total_band=total_band, stereo_pairs=stereo_pairs,
        apply_noise=apply_noise, apply_hfr=apply_hfr,
        hfr_group_count=hfr_group_count, hfr_static=hfr_static)

    dct = _imdct_butterflies(spectra)                     # [B, F, C, 8, 128]
    # time axis per (stream, channel): [B, C, F*8, 128]
    dct_t = jnp.moveaxis(dct, 2, 1).reshape(B, C, F * 8, 128)
    wave = _window_overlap_add(dct_t)                     # [B, C, T, 128]

    scaled = wave * jnp.float32(32768.0)
    ints = jnp.clip(scaled.astype(jnp.int32), -32768, 32767).astype(jnp.int16)
    # -> [B, F, 8, 128, C] interleaved sample layout
    return jnp.moveaxis(ints.reshape(B, C, F, 8, 128), 1, 4)


def hca_decode_transform(qc, sf, res, intensity, noise_src, noise_sci,
                         noise_mask, hfr_is, hfr_src, hfr_group, hfr_zero,
                         **config):
    """Single-stream decode transform: [F, ...] wrapper over the batched op."""
    out = hca_decode_transform_batched(
        qc[None], sf[None], res[None], intensity[None], noise_src[None],
        noise_sci[None], noise_mask[None], hfr_is, hfr_src, hfr_group,
        hfr_zero, **config)
    return out[0]


def hca_decode_transform_host(qc, sf, res, intensity, noise_src, noise_sci,
                              noise_mask, hfr_is, hfr_src, hfr_group,
                              hfr_zero, *, base_band, total_band,
                              stereo_pairs, apply_noise, apply_hfr,
                              hfr_group_count):
    """Single-stream C++ decode transform; returns [F, 8, 128, C] int16 or
    None when the native core is unavailable.

    Numerically identical to hca_decode_transform (same fp32 op order; the
    native build disables FMA contraction). Preferred for single files where
    device dispatch latency dominates; the batched device kernel remains the
    path for banks.
    """
    import ctypes

    from .. import native
    lib = native.load()
    if lib is None:
        return None
    qc = np.ascontiguousarray(qc, dtype=np.int16)
    F, C = qc.shape[0], qc.shape[1]
    out = np.empty((F, 8, 128, C), dtype=np.int16)
    if F == 0:
        return out
    sf = np.ascontiguousarray(sf, dtype=np.uint8)
    res = np.ascontiguousarray(res, dtype=np.uint8)
    intensity = np.ascontiguousarray(intensity, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32).ctypes.data_as(f32p)

    if apply_noise:
        nsrc = np.ascontiguousarray(noise_src, dtype=np.int32)
        nsci = np.ascontiguousarray(noise_sci, dtype=np.uint8)
        nmask = np.ascontiguousarray(noise_mask, dtype=np.uint8)
        noise_args = (nsrc.ctypes.data_as(i32p), nsci.ctypes.data_as(u8p),
                      nmask.ctypes.data_as(u8p))
    else:
        noise_args = (None, None, None)
    pairs = np.ascontiguousarray(
        np.asarray(stereo_pairs, dtype=np.int32).reshape(-1))
    hfr_is = np.ascontiguousarray(np.asarray(hfr_is), dtype=np.uint8)
    hfr_src = np.ascontiguousarray(hfr_src, dtype=np.int32)
    hfr_group = np.ascontiguousarray(hfr_group, dtype=np.int32)
    tables = _TRANSFORM_TABLES_F32
    lib.cri_hca_decode_transform(
        qc.ctypes.data_as(i16p), sf.ctypes.data_as(u8p),
        res.ctypes.data_as(u8p), intensity.ctypes.data_as(u8p),
        *noise_args,
        np.int32(F), np.int32(C), np.int32(base_band), np.int32(total_band),
        pairs.ctypes.data_as(i32p) if pairs.size else None,
        np.int32(len(stereo_pairs)),
        np.int32(1 if apply_noise else 0), np.int32(1 if apply_hfr else 0),
        np.int32(hfr_group_count),
        hfr_is.ctypes.data_as(u8p), hfr_src.ctypes.data_as(i32p),
        hfr_group.ctypes.data_as(i32p), np.int32(hfr_zero),
        *(t.ctypes.data_as(f32p) for t in tables),
        out.ctypes.data_as(i16p))
    return out


def stereo_pairs_of(channel_type: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    """(primary, secondary) channel index pairs (adjacent by construction)."""
    pairs = []
    for c in range(len(channel_type) - 1):
        if channel_type[c] == T.STEREO_PRIMARY:
            pairs.append((c, c + 1))
    return tuple(pairs)


@partial(jax.jit, static_argnames=("base_band", "total_band", "stereo_pairs",
                                   "apply_hfr", "hfr_group_count",
                                   "hfr_static"))
def hca_decode_wave(qc, sf, res, intensity, hfr_is, hfr_src, hfr_group,
                    hfr_zero, *, base_band, total_band, stereo_pairs,
                    apply_hfr, hfr_group_count, noise_src=None,
                    noise_sci=None, noise_mask=None, hfr_static=None):
    """Float-domain decode (no PCM16 quantisation).

    Used by the key tester (clHCA_TestBlock analogue, hca.cpp:1004-1097)
    which inspects the waveform before int16 conversion; the reference runs
    the FULL transform there, including PNS noise fill for v3.0 streams, so
    callers pass the noise gather maps too (None = no noise bands).  Shapes
    as in hca_decode_transform_batched; returns f32 [B, C, F*8, 128].
    """
    apply_noise = noise_mask is not None
    if not apply_noise:
        noise_src = jnp.zeros((1,) * 5, jnp.int32)
        noise_sci = jnp.zeros((1,) * 5, jnp.uint8)
        noise_mask = jnp.zeros((1,) * 5, bool)
    B, F, C = qc.shape[0], qc.shape[1], qc.shape[2]
    spectra = _reconstruct_spectra(
        qc, sf, res, intensity, noise_src, noise_sci, noise_mask, hfr_is,
        hfr_src, hfr_group, hfr_zero, base_band=base_band,
        total_band=total_band, stereo_pairs=stereo_pairs,
        apply_noise=apply_noise, apply_hfr=apply_hfr,
        hfr_group_count=hfr_group_count, hfr_static=hfr_static)
    dct = _imdct_butterflies(spectra)
    dct_t = jnp.moveaxis(dct, 2, 1).reshape(B, C, F * 8, 128)
    return _window_overlap_add(dct_t)
