"""Device-side (JAX) HCA encoder: PCM -> quantised spectra on the device.

The numeric pipeline of the encoder (MDCT, intensity-stereo, scalefactor
search, rate control, quantisation — hca.cpp:2470-2892) runs as one jitted
graph over [B streams, F frames]; only the variable-length frame *packing*
(and the tiny HFR-scale normalisation, which needs one float64 multiply and
feeds nothing downstream on device) stay on the host.

Order-sensitive fp32 accumulations (intensity energies, HFR group sums) run
as `lax.scan` over the band axis with wide [B, F] carries — the exact
summation order of the reference, vectorised across everything else.
Rate-control binary searches are `lax.while_loop`s over per-frame (low, high)
vectors, bit-identical to the reference's scalar searches.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import hca_tables as T
from .hca_kernels import _onehot_take
from .hca_unpack_device import _mux8, _nib16

f32 = jnp.float32
i32 = jnp.int32

# QUANTIZE_SPECTRUM_BITS[8][16] packed 4 bits/entry per row (values <= 4):
# evaluated inside the rate-control while_loops over [B,F,C,8,128] tensors,
# where a dynamic gather costs ~12ns/element -- packed-nibble row muxes are
# the same trick as the device unpacker's VLC tables
def _pack_rows(table):
    lo, hi = [], []
    for row in np.asarray(table, np.int64):
        l = h = 0
        for c in range(8):
            l |= int(row[c]) << (4 * c)
            h |= int(row[c + 8]) << (4 * c)
        lo.append(l)
        hi.append(h)
    return lo, hi
_QSB_LO, _QSB_HI = _pack_rows(T.QUANTIZE_SPECTRUM_BITS)

# int constant tables precomputed with the reference's float64 semantics
_SHIFT_DOWN_UB = np.trunc(
    T.QUANTIZER_INVERSE_STEP_SIZE.astype(np.float64) + 0.5 - 8).astype(np.int32)
_SHIFT_DOWN_Q = np.trunc(
    T.QUANTIZER_INVERSE_STEP_SIZE.astype(np.float64) + 0.5).astype(np.int32)
_SQRT2_2_F32 = np.float32(np.sqrt(2.0) / 2.0)


def _mdct(pcm_f, window):
    """wave [B, C, T, 128] -> spectra via fold + DCT4 (hca.cpp:2529-2553)."""
    half = 64
    prev = jnp.concatenate(
        [jnp.zeros_like(pcm_f[:, :, :1, :]), pcm_f[:, :, :-1, :]], axis=2)
    a = jnp.flip(window[:half]) * (-pcm_f[..., half:])
    b = (-window[half:]) * jnp.flip(pcm_f[..., :half], axis=-1)
    first = a - b
    c = window[:half] * prev[..., :half]
    d = (-jnp.flip(window[half:])) * jnp.flip(prev[..., half:], axis=-1)
    second = c - d
    scratch = jnp.concatenate([first, second], axis=-1)
    return _dct4(scratch)


def _dct4(x):
    """Exact-order DCT-IV (hca.cpp:2481-2527); x [..., 128]."""
    shape = x.shape
    sin7, cos7 = T.dct4_stage_tables(7)
    sin7 = jnp.asarray(sin7[:64])
    cos7 = jnp.asarray(cos7[:64])
    a = x[..., 0::2]
    b = jnp.flip(x, axis=-1)[..., 0::2]                  # x[127-2k]
    even = a * cos7 + b * sin7
    odd = a * sin7 - b * cos7
    temp = jnp.stack([even, odd], axis=-1).reshape(shape)
    for stage in range(6):
        block_count = 1 << stage
        bhs_bits = 5 - stage
        bhs = 1 << bhs_bits
        sin, cos = T.dct4_stage_tables(bhs_bits)
        sin = jnp.asarray(sin)
        cos = jnp.asarray(cos)
        g = temp.reshape(*shape[:-1], block_count, 2, bhs, 2)
        fe, fo = g[..., 0, :, 0], g[..., 0, :, 1]
        be, bo = g[..., 1, :, 0], g[..., 1, :, 1]
        a2 = fe - be
        b2 = fo - bo
        ne = fe + be
        no = fo + bo
        nbe = a2 * cos + b2 * sin
        nbo = a2 * sin - b2 * cos
        front = jnp.stack([ne, no], axis=-1)    # [..., bc, bhs, 2]
        back = jnp.stack([nbe, nbo], axis=-1)
        temp = jnp.stack([front, back], axis=-3).reshape(shape)
    out = jnp.take(temp, jnp.asarray(T.SHUFFLE_TABLE.astype(np.int32)), axis=-1)
    return out * f32(0.125)


def _scan_band_sum(values):
    """Exact sequential f32 sum over the last axis. [..., N] -> [...].

    Fully unrolled left fold: identical additions in identical order to a
    lax.scan (bit-exact), but one fused XLA kernel instead of an N-step
    device loop — the per-step loop overhead at N≈288 dominated the
    intensity/HFR stages (measured ~50 ms standalone at 256-stream banks).
    """
    moved = jnp.moveaxis(values, -1, 0)
    out = jnp.zeros(moved.shape[1:], f32)
    for i in range(moved.shape[0]):
        out = out + moved[i]
    return out


def _encode_intensity(spectra, base_band, total_band, pairs):
    """EncodeIntensityStereo (hca.cpp:2561-2609); spectra [B, F, C, 8, 128]."""
    intensity = jnp.zeros(spectra.shape[:3] + (8,), jnp.uint8)
    if not pairs:
        return spectra, intensity
    bounds = jnp.asarray(T.INTENSITY_RATIO_BOUNDS)
    band_sel = jnp.arange(128)
    sel = (band_sel >= base_band) & (band_sel < total_band)
    for (p, s) in pairs:
        l = spectra[..., p, :, :]
        r = spectra[..., s, :, :]
        rng = slice(base_band, total_band)
        e_l = _scan_band_sum(jnp.abs(l[..., rng]))
        e_r = _scan_band_sum(jnp.abs(r[..., rng]))
        e_t = _scan_band_sum(jnp.abs(l[..., rng] + r[..., rng])) * f32(2.0)
        e_lr = e_r + e_l
        stored = (f32(2.0) * e_l) / e_lr
        ratio = e_lr / e_t
        ratio = jnp.where(ratio < f32(0.5), f32(0.5), ratio)
        ratio = jnp.where(ratio > _SQRT2_2_F32, _SQRT2_2_F32, ratio)
        quant = 1 + jnp.sum(
            jnp.where(jnp.isnan(stored[..., None]), False,
                      bounds[1:13] >= stored[..., None]), axis=-1)
        has_energy = (e_r > 0) | (e_l > 0)
        quant = jnp.where(has_energy, quant, 0)
        ratio = jnp.where(has_energy, ratio, f32(1.0))
        new_l = jnp.where(sel, (l + r) * ratio[..., None], l)
        new_r = jnp.where(sel, f32(0.0), r)
        spectra = spectra.at[..., p, :, :].set(new_l)
        spectra = spectra.at[..., s, :, :].set(new_r)
        intensity = intensity.at[..., s, :].set(quant.astype(jnp.uint8))
    return spectra, intensity


def _find_scale_factor(values):
    # searchsorted(side="right") == count of table entries <= value; the
    # compare+reduce form avoids the backend's slow dynamic gather lowering
    idx = jnp.sum(values.astype(f32)[..., None]
                  >= jnp.asarray(T.SCALING_TABLE), axis=-1)
    return jnp.minimum(idx, 63).astype(jnp.int32)


def _calc_resolution(sf, noise):
    curve = noise - (5 * sf) // 2 + 2
    curve = jnp.clip(curve, 0, 58)
    res = _onehot_take(T.SCALE_TO_RESOLUTION_CURVE.astype(np.int32),
                       curve, 59)
    return jnp.where(sf == 0, 0, res)


def _used_bits(sf, scaled, header_len, noise_level, eval_boundary,
               coded_mask):
    """CalculateUsedBits vectorised over [B, F] (hca.cpp:2763-2790).

    sf [B,F,C,128] i32, scaled [B,F,C,8,128] f32, header_len [B,F,C] i32,
    noise_level/eval_boundary [B,F] i32, coded_mask [C,128] bool.
    """
    band = jnp.arange(128)
    noise = jnp.where(band[None, None, None, :] < eval_boundary[..., None, None],
                      noise_level[..., None, None] - 1,
                      noise_level[..., None, None])
    res = _calc_resolution(sf, noise)                        # [B,F,C,128]
    res_c = jnp.clip(res, 0, 15)
    hi = res >= 8
    bits_hi = _onehot_take(T.QUANTIZED_SPECTRUM_MAX_BITS.astype(np.int32),
                           res_c, 16) - 1
    extra = jnp.sum(
        jnp.abs(scaled)
        >= _onehot_take(T.QUANTIZER_DEAD_ZONE, res_c, 16)[..., None, :],
        axis=-2)
    cost_hi = 8 * bits_hi + extra.astype(jnp.int32)
    ssi = _onehot_take(T.QUANTIZER_INVERSE_STEP_SIZE, res_c, 16)
    shift_up = ssi + f32(1.0)
    shift_down = _onehot_take(_SHIFT_DOWN_UB, res_c, 16)
    q = (scaled * ssi[..., None, :] + shift_up[..., None, :]).astype(jnp.int32) \
        - shift_down[..., None, :]
    r8 = jnp.clip(res_c, 0, 7)[..., None, :]
    qbits = _nib16(_mux8(_QSB_LO, r8), _mux8(_QSB_HI, r8),
                   jnp.clip(q, 0, 15))
    cost_lo = jnp.sum(qbits, axis=-2)
    cost = jnp.where(hi, cost_hi, cost_lo)
    cost = jnp.where(coded_mask[None, None], cost, 0)
    return (48 + jnp.sum(header_len, axis=-1)
            + jnp.sum(cost, axis=(-2, -1))).astype(jnp.int32)


# positions where the (monotone nonincreasing) resolution curve drops by 1:
# res(idx) = 15 - #{k : idx >= k}, giving the exact table lookup as 14
# integer compares instead of a 59-way select
_CURVE_DROPS = tuple(
    int(i) for i in
    (np.nonzero(np.diff(np.asarray(T.SCALE_TO_RESOLUTION_CURVE,
                                   np.int64)) == -1)[0] + 1))
assert len(_CURVE_DROPS) == 15 - int(T.SCALE_TO_RESOLUTION_CURVE[-1])


def _band_cost_table(scaled, coded_mask):
    """Per-band bit cost for every resolution r in 0..15, byte-packed.

    The search-time half of _used_bits depends on (sf, scaled) only through
    cost[band, r]: one pass over the [B,F,C,8,128] spectra builds the table,
    after which each binary-search iteration touches only [B,F,C,128] bytes
    (the host AVX2 encoder's resolution->cost-table trick, cricore.cpp).
    Costs are <= 96 bits per band so a byte holds them; returns 4 u32 words
    [B,F,C,128] with cost[r] at byte (r & 3) of word (r >> 2).
    """
    a = jnp.abs(scaled)
    costs = []
    for r in range(16):
        if r == 0:
            costs.append(jnp.zeros(scaled.shape[:3] + (128,), i32))
            continue
        if r >= 8:
            extra = jnp.sum(
                (a >= f32(float(T.QUANTIZER_DEAD_ZONE[r]))).astype(i32),
                axis=-2)
            costs.append(8 * (int(T.QUANTIZED_SPECTRUM_MAX_BITS[r]) - 1)
                         + extra)
        else:
            # same f32 arithmetic as _used_bits: ssi from the f32 table,
            # shift_up = ssi + 1 computed IN f32, shift_down from the
            # precomputed trunc table
            ssi = np.float32(T.QUANTIZER_INVERSE_STEP_SIZE[r])
            shift_up = np.float32(ssi + np.float32(1.0))
            shift_down = int(_SHIFT_DOWN_UB[r])
            q = (scaled * ssi + shift_up).astype(i32) - shift_down
            qb = _nib16(_QSB_LO[r], _QSB_HI[r], jnp.clip(q, 0, 15))
            costs.append(jnp.sum(qb, axis=-2))
    words = []
    for j in range(4):
        wv = costs[4 * j].astype(jnp.uint32)
        for k in range(1, 4):
            wv = wv | (costs[4 * j + k].astype(jnp.uint32) << (8 * k))
        words.append(jnp.where(coded_mask[None, None], wv, jnp.uint32(0)))
    # one materialization; without the fence XLA refuses the table into the
    # while_loop bodies and recomputes the full spectra pass per iteration
    return jax.lax.optimization_barrier(tuple(words))


def _used_bits_fast(cost_words, sf, header_sum, noise_level, eval_boundary):
    """Table-backed CalculateUsedBits: exact same result as _used_bits.

    cost_words: the 4 packed u32 tables; sf i32 [B,F,C,128];
    header_sum [B,F] = 48 + sum(header_len); noise/eval_boundary [B,F].
    """
    band = jnp.arange(128)
    noise = jnp.where(
        band[None, None, None, :] < eval_boundary[..., None, None],
        noise_level[..., None, None] - 1, noise_level[..., None, None])
    idx = jnp.clip(noise - (5 * sf) // 2 + 2, 0, 58)
    res = 15 - sum((idx >= k).astype(i32) for k in _CURVE_DROPS)
    res = jnp.where(sf == 0, 0, res)
    w01 = jnp.where(res < 8, cost_words[0], cost_words[2])
    w23 = jnp.where(res < 8, cost_words[1], cost_words[3])
    word = jnp.where((res & 4) == 0, w01, w23)
    byte = (word >> ((res & 3).astype(jnp.uint32) * 8)) & jnp.uint32(0xFF)
    return (header_sum
            + jnp.sum(byte.astype(i32), axis=(-2, -1))).astype(i32)


def _binary_search_level(sf, cost_words, header_len, avail):
    B, F = sf.shape[0], sf.shape[1]
    zeros = jnp.zeros((B, F), jnp.int32)
    sf_i = sf.astype(i32) if sf.dtype != jnp.int32 else sf
    header_sum = 48 + jnp.sum(header_len, axis=-1)

    # unrolled fixed-trip search: the interval [0,255] provably collapses
    # in 8 halvings (255->127->63->31->15->7->3->1->0), and the unrolled
    # form drops the while_loop's per-step any() reduce + loop overhead
    # while keeping the exact same masked updates (bit-exact)
    low, high, mid_value = (zeros, jnp.full((B, F), 255, jnp.int32), zeros)
    for _ in range(8):
        active = low != high
        mid = (low + high) // 2
        mv = _used_bits_fast(cost_words, sf_i, header_sum, mid, zeros)
        mid_value = jnp.where(active, mv, mid_value)
        go_up = active & (mv > avail)
        low = jnp.where(go_up, mid + 1, low)
        high = jnp.where(active & ~go_up, mid, high)
    fail = (low == 255) & (mid_value > avail)
    return jnp.where(fail, -1, low)


def _binary_search_boundary(sf, cost_words, header_len, avail, noise_level):
    B, F = sf.shape[0], sf.shape[1]
    sf_i = sf.astype(i32) if sf.dtype != jnp.int32 else sf
    header_sum = 48 + jnp.sum(header_len, axis=-1)

    # unrolled fixed-trip search: |high-low| starts at 127 and provably
    # reaches <= 1 in 7 halvings (127->64->32->16->8->4->2->1); same masked
    # updates as the while_loop form (bit-exact), no per-step any() reduce
    low = jnp.zeros((B, F), jnp.int32)
    high = jnp.full((B, F), 127, jnp.int32)
    for _ in range(7):
        active = jnp.abs(high - low) > 1
        mid = (low + high) // 2
        mv = _used_bits_fast(cost_words, sf_i, header_sum, noise_level, mid)
        over = active & (avail < mv)
        high = jnp.where(over, mid - 1, high)
        low = jnp.where(active & ~over, mid, low)
    eq = low == high
    hi_val = _used_bits_fast(cost_words, sf_i, header_sum, noise_level, high)
    res_eq = jnp.where(low < 127, low, -1)
    res_neq = jnp.where(hi_val > avail, low, high)
    return jnp.where(eq, res_eq, res_neq)


@partial(jax.jit, static_argnames=("base_band", "total_band", "pairs",
                                   "coded_counts", "channel_types",
                                   "hfr_group_count", "bands_per_hfr_group",
                                   "hfr_band_count", "frame_size"))
def hca_encode_transform(pcm, *, base_band, total_band, pairs, coded_counts,
                         channel_types, hfr_group_count, bands_per_hfr_group,
                         hfr_band_count, frame_size):
    """PCM16 [B, C, F*1024] -> per-frame encode tensors.

    Returns (sf u8, res u8, intensity u8, quantized i16, level i32,
    boundary i32, delta_bits i32, group_avg_sums f32, scaled_group_sums f32).
    Frames whose rate control failed carry level == -1 and must be re-run on
    the host fallback (top-band zeroing, hca.cpp:2816-2828).
    """
    B, C, total = pcm.shape
    F = total // 1024
    window = jnp.asarray(T.IMDCT_WINDOW)
    coded = np.zeros((C, 128), dtype=bool)
    for c in range(C):
        coded[c, :coded_counts[c]] = True
    coded_mask = jnp.asarray(coded)

    wave = (pcm.astype(f32) * f32(1.0 / 32768.0)).reshape(B, C, F * 8, 128)
    spectra = _mdct(wave, window)                       # [B, C, T, 128]
    spectra = jnp.moveaxis(spectra.reshape(B, C, F, 8, 128), 1, 2)

    spectra, intensity = _encode_intensity(spectra, base_band, total_band,
                                           pairs)

    peak = jnp.max(jnp.abs(spectra), axis=-2)           # [B, F, C, 128]
    sf = _find_scale_factor(peak)
    sf = jnp.where(coded_mask[None, None], sf, 0)

    qs = _onehot_take(T.QUANTIZER_SCALING_TABLE, sf, 64)
    ans = spectra * qs[..., None, :]
    lim = f32(0.9999999)
    ans = jnp.where(ans > lim, lim, ans)
    ans = jnp.where(ans < -lim, -lim, ans)
    scaled = jnp.where((sf == 0)[..., None, :], f32(0.0), ans)
    scaled = jnp.where(coded_mask[None, None, :, None, :], scaled, f32(0.0))

    # HFR group sums (exact order: band-major, subframe-minor); the float64
    # normalisation + scalefactor lookup happen on the host (their results
    # feed only the packer, never the device pipeline)
    ga, gs = _hfr_sums(spectra, scaled, hfr_group_count,
                       bands_per_hfr_group, hfr_band_count,
                       base_band, total_band, channel_types)

    delta_bits, header_len = _delta_lengths(sf, coded_counts, channel_types,
                                            hfr_group_count)

    avail = jnp.int32(frame_size * 8)
    # the [band, resolution] cost table is a full pass over the [B,F,C,8,128]
    # spectra (~16 fused reads per bank) — build it ONCE and share it between
    # the level and boundary searches (it depends only on `scaled`)
    cost_words = _band_cost_table(scaled, coded_mask)
    level = _binary_search_level(sf, cost_words, header_len, avail)
    boundary = jnp.where(
        level > 0,
        _binary_search_boundary(sf, cost_words, header_len, avail,
                                jnp.maximum(level, 0)),
        0)

    band = jnp.arange(128)
    noise = jnp.where(band[None, None, None, :] < boundary[..., None, None],
                      level[..., None, None] - 1, level[..., None, None])
    res = _calc_resolution(sf, noise)
    res = jnp.where(coded_mask[None, None], res, 0)

    res_c = jnp.clip(res, 0, 15)
    ssi = _onehot_take(T.QUANTIZER_INVERSE_STEP_SIZE, res_c, 16)
    shift_up = ssi + f32(1.0)
    shift_down = _onehot_take(_SHIFT_DOWN_Q, res_c, 16)
    quant = (scaled * ssi[..., None, :] + shift_up[..., None, :]).astype(jnp.int32) \
        - shift_down[..., None, :]
    quant = jnp.where(coded_mask[None, None, :, None, :], quant, 0)

    return (sf.astype(jnp.uint8), res.astype(jnp.uint8), intensity,
            quant.astype(jnp.int16), level, boundary, delta_bits, ga, gs)


def _hfr_sums(spectra, scaled, hfr_group_count, bands_per_hfr_group,
              hfr_band_count, base_band, total_band, channel_types):
    """Group |.| sums (hca.cpp:2656-2706) with exact accumulation order.

    hfr start band = total_band's stereo+base boundary == the encoder's
    hfrStartBand; here base_band/total_band are base and total counts, and
    the start is stereo+base = total - hfr_band_count_initial... the caller
    passes hfr_band_count = HfrBandCount; start = stereo + base.
    """
    B, F, C = spectra.shape[0], spectra.shape[1], spectra.shape[2]
    G = max(hfr_group_count, 1)
    ga = jnp.zeros((B, F, C, G), f32)
    gs = jnp.zeros((B, F, C, G), f32)
    if hfr_group_count == 0:
        return ga, gs
    start = total_band - hfr_band_count  # stereo_band_count + base_band_count
    capped = min(hfr_band_count, total_band - hfr_band_count)
    sec = [c for c in range(C) if channel_types[c] == 2]
    band = start
    band2 = 0
    for g in range(hfr_group_count):
        # group averages over |spectra|
        cols = []
        for _ in range(bands_per_hfr_group):
            if band >= 128:
                break
            cols.append(band)
            band += 1
        if cols:
            block = jnp.abs(spectra[..., cols])          # [B,F,C,8,len]
            flat = jnp.moveaxis(block, -1, -2).reshape(
                B, F, C, len(cols) * 8)                   # band-major, sf-minor
            ga = ga.at[..., g].set(_scan_band_sum(flat))
        # scaled-spectra sums from descending source bands
        cols2 = []
        for _ in range(bands_per_hfr_group):
            if band2 >= capped:
                break
            cols2.append(start - band2 - 1)
            band2 += 1
        if cols2:
            block = jnp.abs(scaled[..., cols2])
            flat = jnp.moveaxis(block, -1, -2).reshape(B, F, C, len(cols2) * 8)
            gs = gs.at[..., g].set(_scan_band_sum(flat))
    if sec:
        mask = np.ones(C, dtype=bool)
        for c in sec:
            mask[c] = False
        ga = jnp.where(jnp.asarray(mask)[None, None, :, None], ga, f32(0.0))
        gs = jnp.where(jnp.asarray(mask)[None, None, :, None], gs, f32(0.0))
    return ga, gs


def _delta_lengths(sf, coded_counts, channel_types, hfr_group_count):
    """CalculateOptimalDeltaLength, vectorised (hca.cpp:2708-2750)."""
    B, F, C = sf.shape[0], sf.shape[1], sf.shape[2]
    delta_bits = jnp.zeros((B, F, C), jnp.int32)
    header_len = jnp.zeros((B, F, C), jnp.int32)
    for c in range(C):
        cc = coded_counts[c]
        s = sf[..., c, :cc]
        empty = jnp.all(s == 0, axis=-1)
        deltas = jnp.abs(jnp.diff(s, axis=-1))
        min_len = jnp.full((B, F), 3 + 6 * cc, jnp.int32)
        min_bits = jnp.full((B, F), 6, jnp.int32)
        for db in range(1, 6):
            max_delta = (1 << (db - 1)) - 1
            length = 3 + 6 + jnp.sum(
                jnp.where(deltas > max_delta, db + 6, db), axis=-1)
            upd = length < min_len
            min_len = jnp.where(upd, length, min_len)
            min_bits = jnp.where(upd, db, min_bits)
        dbv = jnp.where(empty, 0, min_bits)
        hlv = jnp.where(empty, 3, min_len)
        if channel_types[c] == 2:
            hlv = hlv + 32
        elif hfr_group_count > 0:
            hlv = hlv + 6 * hfr_group_count
        delta_bits = delta_bits.at[..., c].set(dbv)
        header_len = header_len.at[..., c].set(hlv)
    return delta_bits, header_len


# ---------------------------------------------------------------------------
# Fused on-device encode: PCM -> HCA frame bytes in device memory
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("base_band", "total_band", "pairs",
                                   "coded_counts", "channel_types",
                                   "hfr_group_count", "bands_per_hfr_group",
                                   "hfr_band_count", "frame_size",
                                   "hfr_counts", "hfr_counts2"))
def hca_encode_frames(pcm, *, base_band, total_band, pairs, coded_counts,
                      channel_types, hfr_group_count, bands_per_hfr_group,
                      hfr_band_count, frame_size, hfr_counts, hfr_counts2):
    """PCM16 [B, C, F*1024] -> (frames u8 [B, F, frame_size], fallback [B,F]).

    The full encode pipeline on device: transform -> certified-exact HFR
    scale normalisation (ops/hca_hfr_device.py) -> frame packer
    (ops/hca_pack_device.py).  Frame bytes stay on the device; nothing but
    the packed frames (and the tiny fallback mask) is fetched.

    fallback[b, f] is True where byte-exactness cannot be certified on
    device: rate-control failure (level < 0, reference top-band zeroing
    hca.cpp:2816-2828) or an HFR comparison inside the guard band.  Callers
    must reroute those streams to the exact host encoder.
    """
    from .hca_hfr_device import hfr_scales_device
    from .hca_pack_device import pack_frames_device

    sf, res, intensity, quant, level, boundary, delta_bits, ga, gs = \
        hca_encode_transform(
            pcm, base_band=base_band, total_band=total_band, pairs=pairs,
            coded_counts=coded_counts, channel_types=channel_types,
            hfr_group_count=hfr_group_count,
            bands_per_hfr_group=bands_per_hfr_group,
            hfr_band_count=hfr_band_count, frame_size=frame_size)
    # materialisation fence: without it XLA rematerialises transform
    # intermediates inside the packer's consumers (same disease
    # _band_cost_table documents)
    sf, res, intensity, quant, level, boundary, delta_bits, ga, gs = \
        jax.lax.optimization_barrier(
            (sf, res, intensity, quant, level, boundary, delta_bits, ga, gs))
    hfr_scales, guard = hfr_scales_device(
        ga, gs, counts=hfr_counts, counts2=hfr_counts2,
        channel_types=channel_types)
    hfr_scales, guard = jax.lax.optimization_barrier((hfr_scales, guard))
    frames = pack_frames_device(
        level, boundary, sf, res, intensity, hfr_scales, delta_bits, quant,
        channels=pcm.shape[1], coded_counts=coded_counts,
        channel_types=channel_types, hfr_group_count=hfr_group_count,
        frame_size=frame_size)
    return frames, guard | (level < 0)


# ---------------------------------------------------------------------------
# Host driver: batched device encode
# ---------------------------------------------------------------------------

def encode_batch_device(wav_blobs, quality: int = 1,
                        force_not_looping: bool = False, mesh=None,
                        pack: str = "auto", stats=None):
    """Encode a batch of same-format WAVs to HCA with the device pipeline.

    Streams must share (channels, sample_rate) so they form one jitted shape
    group; differing lengths are frame-padded. Rate-control fallback frames
    (level < 0) reroute the whole stream to the exact host encoder.
    Output is byte-identical to hca_encode_host.encode / the C++ reference.
    With a `mesh`, the stream axis shards over the first mesh axis (the
    encode transform is per-stream; no collectives needed).

    pack="device" runs the frame packer + HFR normalisation on device too
    (hca_encode_frames): only finished frame bytes are fetched, ~6x less
    traffic than the tensor fetch.  pack="host" fetches the encode tensors
    and packs with the native C++ packer.  "auto" takes the choice of
    `backend` (device on a GPU, host on the CPU, where the XLA packer loses
    to the native one). Streams re-encoded on the host are counted in
    `stats.host_fallback_streams`.
    """
    from . import hca_encode_host as H
    from ..utils import wav as wavmod

    wavs = [wavmod.parse_wav(bytes(b)) for b in wav_blobs]
    cfgs = [H.init_encode(w, quality, w.looping and not force_not_looping)
            for w in wavs]
    info0 = cfgs[0].info
    for cfg in cfgs[1:]:
        if (cfg.info.channels != info0.channels
                or cfg.info.sample_rate != info0.sample_rate):
            raise ValueError("encode_batch_device requires uniform "
                             "channel count and sample rate")

    B = len(wavs)
    C = info0.channels
    Bp = B
    if mesh is not None:
        nd = int(mesh.devices.shape[0])
        Bp = -(-B // nd) * nd  # pad streams to shard evenly (silence rows)
    fmax = max(cfg.info.frame_count for cfg in cfgs)
    fmax = -(-fmax // 16) * 16
    pcm = np.zeros((Bp, C, fmax * 1024), dtype=np.int16)
    for b, (w, cfg) in enumerate(zip(wavs, cfgs)):
        tl = H.build_timeline(cfg, w)
        pcm[b, :, :tl.shape[1]] = tl
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        pcm = jax.device_put(
            pcm, NamedSharding(mesh, P(mesh.axis_names[0], None, None)))

    pairs = tuple((c, c + 1) for c in range(C - 1)
                  if info0.channel_type[c] == T.STEREO_PRIMARY) \
        if info0.stereo_band_count > 0 else ()
    kw = dict(
        base_band=int(info0.base_band_count),
        total_band=int(info0.total_band_count),
        pairs=pairs,
        coded_counts=tuple(int(x) for x in info0.coded_count),
        channel_types=tuple(int(x) for x in info0.channel_type),
        hfr_group_count=int(info0.hfr_group_count),
        bands_per_hfr_group=int(info0.bands_per_hfr_group),
        hfr_band_count=int(cfgs[0].hfr_band_count),
        frame_size=int(info0.frame_size))

    if pack == "auto":
        from .. import backend
        pack = backend.engine("hca", "encode_pack")
    if pack == "device":
        from .hca_hfr_device import _group_counts

        counts, counts2 = _group_counts(info0, int(cfgs[0].hfr_band_count))
        frames, fb = hca_encode_frames(
            pcm, hfr_counts=tuple(counts), hfr_counts2=tuple(counts2), **kw)
        frames = np.asarray(frames[:B])
        fb = np.asarray(fb[:B])
        results = []
        for b, cfg in enumerate(cfgs):
            F = cfg.info.frame_count
            if fb[b, :F].any():
                # guard-band or rate-control fallback: exact host path
                if stats is not None:
                    stats.host_fallback_streams += 1
                results.append(H.encode(bytes(wav_blobs[b]),
                                        force_not_looping=force_not_looping,
                                        quality=quality))
            else:
                results.append(H.pack_header(cfg.info)
                               + frames[b, :F].tobytes())
        return results

    out = hca_encode_transform(pcm, **kw)
    # slice padded mesh rows off on device BEFORE fetching: the silence
    # rows would be wasted transfer
    sf, res, intensity, quant, level, boundary, delta_bits, ga, gs = \
        [np.asarray(x[:B]) for x in out]

    # host: HFR scale normalisation (float64, matches hca.cpp:2699-2703)
    hfr_scales = _host_hfr_scales(info0, cfgs[0], ga, gs)

    results = []
    for b, cfg in enumerate(cfgs):
        info = cfg.info
        F = info.frame_count
        if (level[b, :F] < 0).any():
            # rare rate-control fallback: exact host path for this stream
            if stats is not None:
                stats.host_fallback_streams += 1
            results.append(H.encode(bytes(wav_blobs[b]),
                                    force_not_looping=force_not_looping,
                                    quality=quality))
            continue
        packed = hca_frame_pack(info, level[b, :F], boundary[b, :F],
                                sf[b, :F], res[b, :F], intensity[b, :F],
                                hfr_scales[b, :F], delta_bits[b, :F],
                                quant[b, :F])
        results.append(H.pack_header(info) + packed)
    return results


def _host_hfr_scales(info, cfg, ga, gs):
    """avg -> normalise (f64) -> FindScaleFactor; [B, F, C, G] i32."""
    from . import hca_encode_host as H

    B, F, C, G = ga.shape
    scales = np.zeros((B, F, C, G), dtype=np.int32)
    if info.hfr_group_count == 0:
        return scales
    start = info.stereo_band_count + info.base_band_count
    bpg = info.bands_per_hfr_group
    capped = min(cfg.hfr_band_count,
                 info.total_band_count - cfg.hfr_band_count)
    band = start
    band2 = 0
    for g in range(info.hfr_group_count):
        count = 0
        for _ in range(bpg):
            if band >= 128:
                break
            count += 8
            band += 1
        count2 = 0
        for _ in range(bpg):
            if band2 >= capped:
                break
            count2 += 8
            band2 += 1
        avg = (ga[..., g] / np.float32(count)).astype(np.float32) \
            if count else np.zeros((B, F, C), np.float32)
        if count2:
            avg2 = (gs[..., g] / np.float32(count2)).astype(np.float32)
            factor = np.minimum(
                1.0 / np.maximum(avg2.astype(np.float64), 1e-300),
                np.sqrt(2.0))
            upd = (avg.astype(np.float64) * factor).astype(np.float32)
            avg = np.where(avg2.astype(np.float64) > 0.0, upd, avg)
        scales[..., g] = H.find_scale_factor(avg)
    for c in range(info.channels):
        if info.channel_type[c] == T.STEREO_SECONDARY:
            scales[:, :, c, :] = 0
    return scales


def hca_frame_pack(info, level, boundary, sf, res, intensity, hfr_scales,
                   delta_bits, quantized):
    """Pack one stream's frames (native C++ packer with Python fallback)."""
    from . import hca_frame

    packed = hca_frame.pack_frames_native(
        info, level, boundary, sf, res, intensity, hfr_scales, delta_bits,
        quantized)
    if packed is not None:
        return packed
    out = bytearray()
    for fidx in range(len(level)):
        out += hca_frame.pack_frame(
            info, int(level[fidx]), int(boundary[fidx]), sf[fidx], res[fidx],
            intensity[fidx], hfr_scales[fidx], delta_bits[fidx],
            quantized[fidx])
    return bytes(out)
