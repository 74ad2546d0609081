"""ADX block-ADPCM compute kernels (JAX) plus exact numpy reference paths.

Design (see SURVEY.md §7.3): the ADPCM recurrence

    s_t = clamp(q_t * scale_t + (c0 * s_{t-1} >> 12) + (c1 * s_{t-2} >> 12))

is non-associative (the clamp binds), so time stays a `lax.scan`; throughput
comes from batching thousands of [stream x channel] lanes per scan step. All
arithmetic is int32 with C semantics (arithmetic right shift,
truncating division), making decode bit-exact against the reference decoder
(adx.cpp:189-213) and encode bit-exact against adx.cpp:215-273.

Shapes: lanes axis L = streams*channels, time axis N = blocks*samples_per_block.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_S16 = 0x7FFF


def _clamp16(x):
    return jnp.clip(x, -MAX_S16 - 1, MAX_S16)


def _tdiv(a, b):
    """C-style truncating integer division (rounds toward zero)."""
    q = jnp.abs(a) // jnp.abs(b)
    return jnp.where((a < 0) != (b < 0), -q, q)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=())
def adx_decode_scan(codes, scales, c0, c1, h1, h2):
    """Decode signed ADPCM codes to PCM16.

    codes  : int32 [L, N]  sign-extended bitstream codes
    scales : int32 [L, N]  per-sample effective scale (already mode-transformed)
    c0, c1 : int32 [L, N]  per-sample prediction coefficients (mode 2 varies
                           them per block; modes 3/4 broadcast a constant)
    h1, h2 : int32 [L]     initial history (version 4 headers carry this)
    returns int16 [L, N]
    """

    def step(carry, xs):
        p1, p2 = carry
        q, s, a0, a1 = xs
        sample = q * s + ((a0 * p1) >> 12) + ((a1 * p2) >> 12)
        sample = _clamp16(sample)
        return (sample, p1), sample.astype(jnp.int16)

    xs = (codes.T, scales.T, c0.T, c1.T)  # scan over time (leading axis)
    _, out = jax.lax.scan(step, (h1, h2), xs)
    return out.T


@partial(jax.jit, static_argnames=("spb",))
def adx_decode_scan_blocked(codes, scales, c0, c1, h1, h2, *, spb):
    """Blocked decode scan: one lax.scan step per ADX *block*, the spb
    samples inside a block unrolled in the body.

    Numerically identical to adx_decode_scan (same per-sample op order), but
    the scan length drops from blocks*spb to blocks — a 10s stream is ~460
    steps instead of ~15k (fewer, fatter device loop steps). Inputs are the
    same per-sample [L, N] lane arrays (scales/coefficients constant within
    a block); returns int16 [L, N].
    """
    L, N = codes.shape
    nb = N // spb
    q_blocks = codes.reshape(L, nb, spb)
    s_blocks = scales.reshape(L, nb, spb)[:, :, 0]
    a0_blocks = c0.reshape(L, nb, spb)[:, :, 0]
    a1_blocks = c1.reshape(L, nb, spb)[:, :, 0]

    def step(carry, xs):
        p1, p2 = carry
        q, s, a0, a1 = xs  # q [L, spb]; s/a0/a1 [L]
        outs = []
        for t in range(spb):
            sample = q[:, t] * s + ((a0 * p1) >> 12) + ((a1 * p2) >> 12)
            sample = _clamp16(sample)
            p2 = p1
            p1 = sample
            outs.append(sample.astype(jnp.int16))
        return (p1, p2), jnp.stack(outs, axis=1)  # [L, spb]

    xs = (jnp.moveaxis(q_blocks, 1, 0), s_blocks.T, a0_blocks.T, a1_blocks.T)
    _, out = jax.lax.scan(step, (h1, h2), xs)     # [nb, L, spb]
    return jnp.moveaxis(out, 0, 1).reshape(L, N)


@partial(jax.jit, static_argnames=("spb", "max_passes"))
def adx_decode_fixpoint(codes, scales, c0, c1, h1, h2, *, spb,
                        max_passes=None):
    """Block-parallel EXACT ADX decode by chained-block fixpoint iteration.

    The ADPCM recurrence is serial (clamp + per-term >>12 truncation), but
    the AR(2) predictor is contractive: its poles satisfy |z|^2 = |c1|/4096
    < 1, so a 32-sample block shrinks any start-state error by |z|^spb
    (~0.036 for the mode-3 filter). Decode EVERY block in parallel from
    guessed start states, feed each block's computed end state to its
    successor, repeat: block 0's start is the exact header history, so after
    p passes blocks 0..p-1 are provably exact, and the contraction collapses
    the rest in a handful of passes. The loop stops when no start state
    changes between passes — at that fixpoint every block's start equals its
    predecessor's end, which by induction IS the serial decode.

    This resolves the round-1 negative result (19x realtime for the serial
    device scan): lanes become streams x channels x BLOCKS instead of
    streams x channels, and the scan length drops from `blocks` to
    `max_passes` (~4-6 in practice).

    Near-resonance tones sit at the truncation floor (errors hover at tens
    of LSB where per-block contraction ~1), where the settled frontier
    advances a few hundred blocks per pass instead of collapsing globally —
    max_passes therefore scales with the block count (measured: a 440 Hz
    10 s stream needs 36 passes over 15000 blocks). The while_loop exits
    the moment states stop changing, so typical content pays ~4-8 passes.

    Returns (pcm int16 [L, N], converged bool). A non-converged result
    (adversarial content advancing the frontier ~1 block/pass) must be
    discarded by the caller in favour of the serial scan.
    """
    L, N = codes.shape
    nb = N // spb
    q = codes.reshape(L, nb, spb)
    s = scales.reshape(L, nb, spb)[:, :, 0]
    a0 = c0.reshape(L, nb, spb)[:, :, 0]
    a1 = c1.reshape(L, nb, spb)[:, :, 0]
    out, conv = adx_decode_fixpoint_blocks(q, s, a0, a1, h1, h2,
                                           max_passes=max_passes)
    return out.reshape(L, N), conv


@partial(jax.jit, static_argnames=("max_passes",))
def adx_decode_fixpoint_blocks(q, s, a0, a1, h1, h2, *, max_passes=None):
    """Block-form fixpoint decode: q int32 [L, nb, spb]; s/a0/a1 [L, nb]
    per-block scale/coefficients; h1/h2 [L] initial history.  Returns
    (pcm int16 [L, nb, spb], converged).  See adx_decode_fixpoint."""
    L, nb, spb = q.shape
    if max_passes is None:
        # frontier advance per pass scales with the per-block contraction
        # |z|^spb, so small blocks (high bit depths) need proportionally
        # more passes; the while_loop exits early on convergence, so the
        # cap only bounds adversarial content (measured: spb=8 banks that
        # fail at the spb=32 budget converge within ~2x the scaled one)
        max_passes = 48 + (nb * 64) // (96 * max(spb, 1))

    def block_pass(p1, p2):
        """Decode all blocks in parallel from (p1, p2) [L, nb] start states;
        returns (out [L, nb, spb], end1, end2). Same per-sample op order as
        adx_decode_scan — bit-exact given exact start states."""
        outs = []
        for t in range(spb):
            sample = q[:, :, t] * s + ((a0 * p1) >> 12) + ((a1 * p2) >> 12)
            sample = _clamp16(sample)
            p2 = p1
            p1 = sample
            outs.append(sample)
        return jnp.stack(outs, axis=2), p1, p2

    def starts_from(end1, end2):
        s1 = jnp.concatenate([h1[:, None], end1[:, :-1]], axis=1)
        s2 = jnp.concatenate([h2[:, None], end2[:, :-1]], axis=1)
        return s1, s2

    def cond(state):
        npass, _s1, _s2, changed = state
        return changed & (npass < max_passes)

    def body(state):
        npass, s1, s2, _changed = state
        _out, e1, e2 = block_pass(s1, s2)
        n1, n2 = starts_from(e1, e2)
        changed = jnp.any((n1 != s1) | (n2 != s2))
        return npass + 1, n1, n2, changed

    s1 = jnp.broadcast_to(h1[:, None], (L, nb)).astype(jnp.int32)
    s2 = jnp.broadcast_to(h2[:, None], (L, nb)).astype(jnp.int32)
    npass, s1, s2, changed = jax.lax.while_loop(
        cond, body, (jnp.int32(0), s1, s2, jnp.bool_(True)))
    out, _e1, _e2 = block_pass(s1, s2)
    return (out.astype(jnp.int16), ~changed)


# ---------------------------------------------------------------------------
# On-device block unpack + fused raw-bytes -> PCM pipeline
# ---------------------------------------------------------------------------

def adx_unpack_device(payload, *, block_size, bit_depth, encoding_mode,
                      coef, static_coefficients=None):
    """Raw ADX blocks -> dense fixpoint-kernel inputs, on device.

    payload: uint8 [L, nb, block_size] (one lane per (stream, channel) —
    the container's channel interleave is a host-side reshape/transpose of
    the mmapped bytes, no unpacking).  Unlike HCA there is NO VLC: each
    block is a 2-byte BE scale word + fixed `bit_depth`-wide codes MSB-
    first (reference adx.cpp:380-414), so the unpack is static slicing,
    shifts and masks — exactly the tensor reshape SURVEY §7.1 L1 predicted.

    Returns (q int32 [L, nb, spb], s, a0, a1 int32 [L, nb]) matching
    models/adx._decode_arrays_host semantics byte-for-byte (incl. the mode
    4 int32 `1 << ((12 - scale) & 31)` overflow and the mode 2 predictor
    select from STATIC_COEFFICIENTS).
    """
    i32 = jnp.int32
    L, nb, bs = payload.shape
    spb = (bs - 2) * 8 // bit_depth
    p = payload.astype(i32)
    scale_raw = (p[..., 0] << 8) | p[..., 1]
    data = p[..., 2:]

    if bit_depth == 4:
        q = jnp.stack([data >> 4, data & 15], axis=-1).reshape(L, nb, spb)
    elif bit_depth == 8:
        q = data
    elif bit_depth == 2:
        q = jnp.stack([(data >> 6) & 3, (data >> 4) & 3,
                       (data >> 2) & 3, data & 3], axis=-1).reshape(
            L, nb, spb)
    else:
        # generic width: sample t spans <= 3 bytes at static offsets
        cols = []
        for t in range(spb):
            bit0 = t * bit_depth
            b0 = bit0 // 8
            word = data[..., b0] << 16
            if b0 + 1 < bs - 2:
                word = word | (data[..., b0 + 1] << 8)
            if b0 + 2 < bs - 2:
                word = word | data[..., b0 + 2]
            sh = 24 - (bit0 - 8 * b0) - bit_depth
            cols.append((word >> sh) & ((1 << bit_depth) - 1))
        q = jnp.stack(cols, axis=-1)
    signbit = 1 << (bit_depth - 1)
    q = jnp.where((q & signbit) != 0, q - (1 << bit_depth), q)

    if encoding_mode == 4:
        s = i32(1) << ((i32(12) - scale_raw) & 31)
        a0 = jnp.full((L, nb), coef[0], i32)
        a1 = jnp.full((L, nb), coef[1], i32)
    elif encoding_mode == 2:
        predictor = scale_raw >> 13                     # 0..7
        s = (scale_raw & 0x1FFF) + 1
        tab = np.asarray(static_coefficients, np.int32).reshape(-1, 2)
        a0 = jnp.zeros((L, nb), i32)
        a1 = jnp.zeros((L, nb), i32)
        for k in range(tab.shape[0]):
            hit = predictor == k
            a0 = jnp.where(hit, i32(int(tab[k, 0])), a0)
            a1 = jnp.where(hit, i32(int(tab[k, 1])), a1)
    else:
        s = scale_raw + 1
        a0 = jnp.full((L, nb), coef[0], i32)
        a1 = jnp.full((L, nb), coef[1], i32)
    return q, s, a0, a1


@partial(jax.jit, static_argnames=("block_size", "bit_depth",
                                   "encoding_mode", "coef",
                                   "static_coefficients", "max_passes"))
def adx_decode_device_pipeline(payload, h1, h2, *, block_size, bit_depth,
                               encoding_mode, coef,
                               static_coefficients=None, max_passes=None):
    """Full on-device ADX decode: raw block bytes -> PCM16, both in device
    memory.

    payload uint8 [L, nb, block_size], h1/h2 int32 [L].  Returns
    (pcm int16 [L, nb, spb], converged bool).  The unpack is reshape/mask
    work (no VLC); the ADPCM recurrence runs as the provably-exact
    chained-block fixpoint (XLA, shardable). Reference hot loop:
    adx.cpp:189-273."""
    q, s, a0, a1 = adx_unpack_device(
        payload, block_size=block_size, bit_depth=bit_depth,
        encoding_mode=encoding_mode, coef=coef,
        static_coefficients=static_coefficients)
    return adx_decode_fixpoint_blocks(q, s, a0, a1, h1, h2,
                                      max_passes=max_passes)


def adx_decode_host(codes, scales, c0, c1, h1, h2):
    """Host fast path: native C++ lane scan when available, numpy otherwise.

    Bit-exact with adx_decode_scan; preferred for single files / small
    batches where device dispatch latency dominates.
    """
    import ctypes

    from .. import native
    lib = native.load()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    if lib is None or codes.size == 0:
        return adx_decode_numpy(codes, scales, c0, c1, h1, h2)
    scales = np.ascontiguousarray(scales, dtype=np.int32)
    c0 = np.ascontiguousarray(c0, dtype=np.int32)
    c1 = np.ascontiguousarray(c1, dtype=np.int32)
    h1 = np.ascontiguousarray(h1, dtype=np.int32)
    h2 = np.ascontiguousarray(h2, dtype=np.int32)
    L, N = codes.shape
    out = np.empty((L, N), dtype=np.int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.cri_adx_decode_scan(
        codes.ctypes.data_as(i32p), scales.ctypes.data_as(i32p),
        c0.ctypes.data_as(i32p), c1.ctypes.data_as(i32p),
        h1.ctypes.data_as(i32p), h2.ctypes.data_as(i32p),
        np.int32(L), np.int64(N),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), np.int32(0))
    return out


def adx_encode_host(pcm, c0, c1, h1_init, h2_init, *, spb, encoding_mode,
                    bit_depth, scale_fix=False):
    """Host fast path for adx_encode_scan: native C++ when available."""
    import ctypes

    from .. import native
    lib = native.load()
    pcm = np.ascontiguousarray(pcm, dtype=np.int32)
    if lib is None or pcm.size == 0:
        return adx_encode_numpy(pcm, c0, c1, h1_init, h2_init, spb=spb,
                                encoding_mode=encoding_mode,
                                bit_depth=bit_depth, scale_fix=scale_fix)
    c0 = np.ascontiguousarray(c0, dtype=np.int32)
    c1 = np.ascontiguousarray(c1, dtype=np.int32)
    h1 = np.ascontiguousarray(h1_init, dtype=np.int32)
    h2 = np.ascontiguousarray(h2_init, dtype=np.int32)
    L, B, _ = pcm.shape
    codes = np.empty((L, B, spb), dtype=np.int32)
    scale_raw = np.empty((L, B), dtype=np.int32)
    zero = np.empty((L, B), dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.cri_adx_encode_scan(
        pcm.ctypes.data_as(i32p), c0.ctypes.data_as(i32p),
        c1.ctypes.data_as(i32p), h1.ctypes.data_as(i32p),
        h2.ctypes.data_as(i32p), np.int32(L), np.int32(B), np.int32(spb),
        np.int32(encoding_mode), np.int32(bit_depth),
        codes.ctypes.data_as(i32p), scale_raw.ctypes.data_as(i32p),
        zero.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), np.int32(0),
        np.int32(1 if scale_fix else 0))
    return codes, scale_raw, zero.astype(bool)


def adx_decode_numpy(codes, scales, c0, c1, h1, h2):
    """Bit-exact numpy mirror of adx_decode_scan (host fallback / oracle)."""
    codes = np.asarray(codes, dtype=np.int64)
    scales = np.asarray(scales, dtype=np.int64)
    c0 = np.asarray(c0, dtype=np.int64)
    c1 = np.asarray(c1, dtype=np.int64)
    L, N = codes.shape
    out = np.empty((L, N), dtype=np.int16)
    p1 = np.asarray(h1, dtype=np.int64).copy()
    p2 = np.asarray(h2, dtype=np.int64).copy()
    for t in range(N):
        s = codes[:, t] * scales[:, t] + ((c0[:, t] * p1) >> 12) + ((c1[:, t] * p2) >> 12)
        np.clip(s, -MAX_S16 - 1, MAX_S16, out=s)
        p2 = p1
        p1 = s
        out[:, t] = s
    return out


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _scale_from_minmax(minimum, maximum, limit, scale_fix=False):
    """Reference scale selection (adx.cpp:236-238): C truncating division,
    then the assignment to `unsigned short` truncates mod 65536 BEFORE the
    0x1000 cap — residuals >= 65536*limit wrap (reproduced for parity;
    scale_fix mode caps without wrapping instead)."""
    cand_max = _tdiv(maximum, limit)
    cand_min = _tdiv(minimum, ~limit + 0)  # ~limit == -(limit+1)
    scale = jnp.maximum(cand_max, cand_min)
    if not scale_fix:
        scale = scale & 0xFFFF
    return jnp.minimum(scale, 0x1000)


def _ilog2(value):
    """floor(log2(value)) for value >= 1 (int32)."""
    v = value
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    # popcount-style: number of set bits of the filled mask minus 1
    ones = jax.lax.population_count(v.astype(jnp.uint32)).astype(jnp.int32)
    return ones - 1


@partial(jax.jit, static_argnames=("spb", "encoding_mode", "bit_depth",
                                   "scale_fix"))
def adx_encode_scan(pcm, c0, c1, h1_init, h2_init, *, spb, encoding_mode,
                    bit_depth, scale_fix=False):
    """Encode PCM16 into ADPCM codes + per-block raw scale fields.

    pcm     : int32 [L, B, spb]  input samples grouped by block
    c0, c1  : int32 [L]          prediction coefficients (mode 2: filter coefs)
    returns (codes int32 [L, B, spb], scale_raw int32 [L, B], zero_mask bool [L, B])

    Exact mirror of ChannelFrame::Encode (adx.cpp:215-273), including:
    - pass-1 residual min/max computed against *original* sample history;
    - the zero-residual early-out that leaves history updated with originals;
    - pass-2 quantisation feedback through the simulated decoder.
    """
    limit = (1 << (bit_depth - 1)) - 1
    L = pcm.shape[0]

    def encode_block(carry, block):
        h1, h2 = carry  # int32 [L] simulated decoder history

        # Pass 1: residuals against original-sample prediction (vectorised:
        # the predictor history here is just the shifted original signal).
        prev1 = jnp.concatenate([h1[:, None], block[:, :-1]], axis=1)
        prev2 = jnp.concatenate([h2[:, None], h1[:, None], block[:, :-2]], axis=1)
        resid = ((block << 12) - c0[:, None] * prev1 - c1[:, None] * prev2) >> 12
        minimum = jnp.minimum(jnp.min(resid, axis=1), 0)
        maximum = jnp.maximum(jnp.max(resid, axis=1), 0)
        zero = (minimum == 0) & (maximum == 0)

        scale = _scale_from_minmax(minimum, maximum, limit,
                                   scale_fix=scale_fix)
        if encoding_mode == 4:
            # Scale == 0 -> Power = 0 (adx.cpp:242); quiet non-zero blocks
            # hit this (residual range within the bitdepth limit)
            power = jnp.where(scale == 0, 0,
                              _ilog2(jnp.maximum(scale, 1)) + 1)
            scale_eff = (1 << power).astype(jnp.int32)
            scale_raw = 12 - power
        elif encoding_mode == 2:
            scale_raw = scale & 0x1FFF  # caller ORs in Filter<<13
            scale_eff = scale
        else:
            scale_raw = scale
            scale_eff = scale
        scale_eff = jnp.maximum(scale_eff, 1)

        # Pass 2: serial quantisation with decoder-feedback history.
        eff = scale_eff if encoding_mode == 4 else scale + 1

        def qstep_fixed(qcarry, x):
            # decoder-exact arithmetic; see cri_adx_encode_blocks
            q1, q2 = qcarry
            pred = ((c0 * q1) >> 12) + ((c1 * q2) >> 12)
            delta = x - pred
            delta = jnp.where(delta > 0, delta + (eff >> 1),
                              delta - (eff >> 1))
            delta = _tdiv(delta, eff)
            delta = jnp.clip(delta, -limit - 1, limit)
            sim = _clamp16(delta * eff + pred)
            return (sim, q1), delta

        def qstep(qcarry, x):
            q1, q2 = qcarry
            delta = ((x << 12) - c0 * q1 - c1 * q2) >> 12
            delta = jnp.where(delta > 0, delta + (scale_eff >> 1),
                              delta - (scale_eff >> 1))
            delta = _tdiv(delta, scale_eff)
            delta = jnp.clip(delta, -limit - 1, limit)
            # (delta*scale_eff is bounded by |residual| + 1.5*scale ~ 2^17,
            # so the pre-shift sum stays under 2^30: int32 never wraps and
            # the int64 numpy/C++ mirrors agree exactly)
            sim = (((delta << 12) * scale_eff) + c0 * q1 + c1 * q2) >> 12
            sim = _clamp16(sim)
            return (sim, q1), delta

        (h1q, h2q), codes = jax.lax.scan(
            qstep_fixed if scale_fix else qstep, (h1, h2), block.T)
        codes = codes.T
        codes = jnp.where(zero[:, None], 0, codes)
        scale_raw = jnp.where(zero, 0, scale_raw)

        # History carried out: simulated on normal blocks, original-updated on
        # zero blocks (reference early-return quirk, adx.cpp:231-234).
        h1_out = jnp.where(zero, block[:, -1], h1q)
        h2_out = jnp.where(zero, block[:, -2] if spb >= 2 else h1, h2q)
        return (h1_out, h2_out), (codes, scale_raw, zero)

    blocks = jnp.moveaxis(pcm, 1, 0)  # [B, L, spb]
    _, (codes, scale_raw, zero) = jax.lax.scan(
        encode_block, (h1_init, h2_init), blocks)
    return (jnp.moveaxis(codes, 0, 1),
            jnp.moveaxis(scale_raw, 0, 1),
            jnp.moveaxis(zero, 0, 1))


def adx_encode_numpy(pcm, c0, c1, h1_init, h2_init, *, spb, encoding_mode,
                     bit_depth, scale_fix=False):
    """Bit-exact numpy mirror of adx_encode_scan."""
    def tdiv(a, b):
        q = np.abs(a) // np.abs(b)
        return np.where((a < 0) != (b < 0), -q, q)

    pcm = np.asarray(pcm, dtype=np.int64)
    c0 = np.asarray(c0, dtype=np.int64)
    c1 = np.asarray(c1, dtype=np.int64)
    limit = (1 << (bit_depth - 1)) - 1
    L, B, _ = pcm.shape
    codes = np.zeros((L, B, spb), dtype=np.int64)
    scale_raws = np.zeros((L, B), dtype=np.int64)
    zeros = np.zeros((L, B), dtype=bool)
    h1 = np.asarray(h1_init, dtype=np.int64).copy()
    h2 = np.asarray(h2_init, dtype=np.int64).copy()
    for b in range(B):
        block = pcm[:, b, :]
        prev1 = np.concatenate([h1[:, None], block[:, :-1]], axis=1)
        prev2 = np.concatenate([h2[:, None], h1[:, None], block[:, :-2]], axis=1)
        resid = ((block << 12) - c0[:, None] * prev1 - c1[:, None] * prev2) >> 12
        minimum = np.minimum(resid.min(axis=1), 0)
        maximum = np.maximum(resid.max(axis=1), 0)
        zero = (minimum == 0) & (maximum == 0)

        scale = np.maximum(tdiv(maximum, limit), tdiv(minimum, -(limit + 1)))
        if not scale_fix:
            scale = scale & 0xFFFF  # reference u16 truncation BEFORE the cap
        scale = np.minimum(scale, 0x1000)
        if encoding_mode == 4:
            power = np.where(scale >= 1,
                             np.floor(np.log2(np.maximum(scale, 1))).astype(np.int64) + 1, 0)
            scale_eff = (1 << power)
            scale_raw = 12 - power
        elif encoding_mode == 2:
            scale_raw = scale & 0x1FFF
            scale_eff = scale
        else:
            scale_raw = scale.copy()
            scale_eff = scale
        scale_eff = np.maximum(scale_eff, 1)

        q1, q2 = h1.copy(), h2.copy()
        eff = scale_eff if encoding_mode == 4 else scale + 1
        for t in range(spb):
            x = block[:, t]
            if scale_fix:
                # decoder-exact arithmetic; see cri_adx_encode_blocks
                pred = ((c0 * q1) >> 12) + ((c1 * q2) >> 12)
                delta = x - pred
                delta = np.where(delta > 0, delta + (eff >> 1),
                                 delta - (eff >> 1))
                delta = tdiv(delta, eff)
                delta = np.clip(delta, -limit - 1, limit)
                sim = delta * eff + pred
            else:
                delta = ((x << 12) - c0 * q1 - c1 * q2) >> 12
                delta = np.where(delta > 0, delta + (scale_eff >> 1), delta - (scale_eff >> 1))
                delta = tdiv(delta, scale_eff)
                delta = np.clip(delta, -limit - 1, limit)
                sim = (((delta << 12) * scale_eff) + c0 * q1 + c1 * q2) >> 12
            np.clip(sim, -MAX_S16 - 1, MAX_S16, out=sim)
            q2 = q1
            q1 = sim
            codes[:, b, t] = delta
        codes[zero, b, :] = 0
        scale_raw = np.where(zero, 0, scale_raw)
        scale_raws[:, b] = scale_raw
        zeros[:, b] = zero
        h1 = np.where(zero, block[:, -1], q1)
        h2 = np.where(zero, block[:, -2] if spb >= 2 else h1, q2)
    return codes, scale_raws, zeros


# ---------------------------------------------------------------------------
# Block-parallel device encode (fixpoint) + on-device block packer
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("spb", "encoding_mode", "bit_depth",
                                   "scale_fix", "max_passes",
                                   "segment_blocks"))
def adx_encode_fixpoint(pcm, c0, c1, h1, h2, *, spb, encoding_mode,
                        bit_depth, scale_fix=False, max_passes=None,
                        segment_blocks=512):
    """Block-parallel EXACT ADX encode by chained-block fixpoint iteration.

    The encode mirror of adx_decode_fixpoint: the only cross-block coupling
    is the simulated-decoder history pair entering each block (pass-1 uses
    it for the first residual; pass-2 feeds quantisation through it), so
    encode EVERY block in parallel from guessed start states, chain each
    block's end state to its successor, and iterate until no start changes
    — at that fixpoint every start equals its predecessor's end, which by
    induction IS the serial adx_encode_scan result, bit for bit.

    Start guesses come from the ORIGINAL signal (the simulated decoder
    tracks it within the quantisation error), so the discrete outputs
    (scale, codes) usually match on pass one and convergence is a handful
    of passes.  Unlike DECODE (whose AR(2) filter contracts start-state
    errors), a wrong encode start can flip a quantisation decision and
    re-perturb the chain, so on near-resonant content exactness provably
    propagates only ~1 block per pass — a 10 s tone bank (15k blocks)
    never converges under any practical global pass budget.  Streams
    longer than `segment_blocks` therefore run as a lax.scan of per-
    segment fixpoints chained through their exact end states: within a
    G-block segment, pass k makes blocks 0..k-1 exact by induction, so
    max_passes = G+1 GUARANTEES convergence (the while_loop exits as soon
    as nothing changes, so benign content still takes its usual handful
    of passes per segment).

    pcm int32 [L, B, spb]; c0/c1/h1/h2 int32 [L].
    Returns (codes int32 [L, B, spb], scale_raw int32 [L, B],
             zero bool [L, B], converged bool).
    """
    L, B, _ = pcm.shape
    if max_passes is None and B > segment_blocks:
        G = segment_blocks
        nseg = -(-B // G)
        Bp = nseg * G
        if Bp != B:
            pcm = jnp.concatenate(
                [pcm, jnp.zeros((L, Bp - B, spb), pcm.dtype)], axis=1)
        segs = jnp.moveaxis(pcm.reshape(L, nseg, G, spb), 1, 0)

        def seg_body(carry, seg):
            ch1, ch2 = carry
            codes, sr, zero, conv, e1, e2, npass = _adx_encode_fixpoint_core(
                seg, c0, c1, ch1, ch2, spb=spb,
                encoding_mode=encoding_mode, bit_depth=bit_depth,
                scale_fix=scale_fix, max_passes=G + 1)
            return (e1, e2), (codes, sr, zero, conv)

        (_, _), (codes, sr, zero, conv) = jax.lax.scan(
            seg_body, (h1.astype(jnp.int32), h2.astype(jnp.int32)), segs)
        codes = jnp.moveaxis(codes, 0, 1).reshape(L, Bp, spb)[:, :B]
        sr = jnp.moveaxis(sr, 0, 1).reshape(L, Bp)[:, :B]
        zero = jnp.moveaxis(zero, 0, 1).reshape(L, Bp)[:, :B]
        return codes, sr, zero, jnp.all(conv)
    if max_passes is None:
        max_passes = 48 + (B * 64) // (96 * max(spb, 1))
    out = _adx_encode_fixpoint_core(
        pcm, c0, c1, h1, h2, spb=spb, encoding_mode=encoding_mode,
        bit_depth=bit_depth, scale_fix=scale_fix, max_passes=max_passes)
    return out[:4]


def _adx_encode_fixpoint_core(pcm, c0, c1, h1, h2, *, spb, encoding_mode,
                              bit_depth, scale_fix, max_passes):
    """One fixpoint over [L, B, spb]; additionally returns the exact end
    state pair of the LAST block (the chain carry for segmented runs)."""
    L, B, _ = pcm.shape
    limit = (1 << (bit_depth - 1)) - 1
    c0b = c0[:, None]
    c1b = c1[:, None]

    def block_pass(s1, s2):
        """Encode all blocks from start states [L, B]; returns
        (codes, scale_raw, zero, end1, end2) — same op order per block as
        adx_encode_scan, so exact given exact starts."""
        prev1 = jnp.concatenate([s1[:, :, None], pcm[:, :, :-1]], axis=2)
        if spb >= 2:
            prev2 = jnp.concatenate(
                [s2[:, :, None], s1[:, :, None], pcm[:, :, :-2]], axis=2)
        else:
            prev2 = s2[:, :, None]
        resid = ((pcm << 12) - c0b[..., None] * prev1
                 - c1b[..., None] * prev2) >> 12
        minimum = jnp.minimum(jnp.min(resid, axis=2), 0)
        maximum = jnp.maximum(jnp.max(resid, axis=2), 0)
        zero = (minimum == 0) & (maximum == 0)

        scale = _scale_from_minmax(minimum, maximum, limit,
                                   scale_fix=scale_fix)
        if encoding_mode == 4:
            power = jnp.where(scale == 0, 0,
                              _ilog2(jnp.maximum(scale, 1)) + 1)
            scale_eff = (1 << power).astype(jnp.int32)
            scale_raw = 12 - power
        elif encoding_mode == 2:
            scale_raw = scale & 0x1FFF
            scale_eff = scale
        else:
            scale_raw = scale
            scale_eff = scale
        scale_eff = jnp.maximum(scale_eff, 1)
        eff = scale_eff if encoding_mode == 4 else scale + 1

        q1, q2 = s1, s2
        outs = []
        for t in range(spb):
            x = pcm[:, :, t]
            if scale_fix:
                pred = ((c0b * q1) >> 12) + ((c1b * q2) >> 12)
                delta = x - pred
                delta = jnp.where(delta > 0, delta + (eff >> 1),
                                  delta - (eff >> 1))
                delta = _tdiv(delta, eff)
                delta = jnp.clip(delta, -limit - 1, limit)
                sim = _clamp16(delta * eff + pred)
            else:
                delta = ((x << 12) - c0b * q1 - c1b * q2) >> 12
                delta = jnp.where(delta > 0, delta + (scale_eff >> 1),
                                  delta - (scale_eff >> 1))
                delta = _tdiv(delta, scale_eff)
                delta = jnp.clip(delta, -limit - 1, limit)
                sim = _clamp16((((delta << 12) * scale_eff)
                                + c0b * q1 + c1b * q2) >> 12)
            q2 = q1
            q1 = sim
            outs.append(delta)
        codes = jnp.stack(outs, axis=2)
        codes = jnp.where(zero[:, :, None], 0, codes)
        scale_raw = jnp.where(zero, 0, scale_raw)
        end1 = jnp.where(zero, pcm[:, :, -1], q1)
        end2 = jnp.where(zero, pcm[:, :, -2] if spb >= 2 else s1, q2)
        return codes, scale_raw, zero, end1, end2

    def starts_from(end1, end2):
        n1 = jnp.concatenate([h1[:, None], end1[:, :-1]], axis=1)
        n2 = jnp.concatenate([h2[:, None], end2[:, :-1]], axis=1)
        return n1, n2

    def cond(state):
        npass, _s1, _s2, changed = state
        return changed & (npass < max_passes)

    def body(state):
        npass, s1, s2, _changed = state
        _c, _sr, _z, e1, e2 = block_pass(s1, s2)
        n1, n2 = starts_from(e1, e2)
        changed = jnp.any((n1 != s1) | (n2 != s2))
        return npass + 1, n1, n2, changed

    # start guesses: block 0 exact (header history), others from the
    # original signal's block tails
    g1 = jnp.concatenate([h1[:, None], pcm[:, :-1, -1]], axis=1)
    if spb >= 2:
        g2 = jnp.concatenate([h2[:, None], pcm[:, :-1, -2]], axis=1)
    else:
        g2 = jnp.concatenate([h2[:, None], g1[:, :-1]], axis=1)
    npass, s1, s2, changed = jax.lax.while_loop(
        cond, body, (jnp.int32(0), g1.astype(jnp.int32),
                     g2.astype(jnp.int32), jnp.bool_(True)))
    codes, scale_raw, zero, e1, e2 = block_pass(s1, s2)
    return codes, scale_raw, zero, ~changed, e1[:, -1], e2[:, -1], npass


def adx_pack_device(codes, scale_field, *, block_size, bit_depth):
    """codes int32 [L, nb, spb] + scale_field int32 [L, nb] -> raw block
    bytes uint8 [L, nb, block_size], on device (inverse of
    adx_unpack_device: 2-byte BE scale word + MSB-first fixed-width codes;
    reference adx.cpp:380-414)."""
    i32 = jnp.int32
    L, nb, spb = codes.shape
    db = block_size - 2
    mask = (1 << bit_depth) - 1
    u = codes.astype(i32) & mask
    if bit_depth == 4:
        pairs = u.reshape(L, nb, db, 2)
        data = (pairs[..., 0] << 4) | pairs[..., 1]
    elif bit_depth == 8:
        data = u
    elif bit_depth == 2:
        quads = u.reshape(L, nb, db, 4)
        data = ((quads[..., 0] << 6) | (quads[..., 1] << 4)
                | (quads[..., 2] << 2) | quads[..., 3])
    else:
        # generic width: byte j collects the (static) overlapping samples
        cols = []
        for j in range(db):
            acc = jnp.zeros((L, nb), i32)
            for t in range(spb):
                bit0 = t * bit_depth
                b0 = bit0 // 8
                # sample t's bits land in bytes b0..b0+2 at static shifts
                if not (b0 <= j <= b0 + 2):
                    continue
                sh = 24 - (bit0 - 8 * b0) - bit_depth  # within 24-bit window
                # window byte (j - b0) holds bits [8*(b0+2-j), 8*(b0+3-j))
                word_sh = sh - 8 * (b0 + 2 - j)        # sample -> byte j
                if word_sh >= 0:
                    part = (u[:, :, t] << word_sh) & 0xFF
                else:
                    part = (u[:, :, t] >> (-word_sh)) & 0xFF
                acc = acc | part
            cols.append(acc)
        data = jnp.stack(cols, axis=-1)
    sf = scale_field.astype(i32) & 0xFFFF
    out = jnp.concatenate([
        (sf >> 8)[..., None], (sf & 0xFF)[..., None], data], axis=-1)
    return out.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("spb", "encoding_mode", "bit_depth",
                                   "block_size", "filter_", "scale_fix",
                                   "max_passes"))
def adx_encode_device_pipeline(pcm, c0, c1, h1, h2, *, spb, encoding_mode,
                               bit_depth, block_size, filter_=0,
                               scale_fix=False, max_passes=None):
    """Full on-device ADX encode: PCM blocks -> raw block bytes, both in
    device memory.

    pcm int32 [L, nb, spb] (one lane per (stream, channel)); returns
    (payload uint8 [L, nb, block_size], converged bool).  The encode
    mirror of adx_decode_device_pipeline — the chained-block fixpoint
    quantisation (XLA, shardable) followed by reshape/shift packing (no
    VLC).  converged=False results must be discarded for the host encoder
    (reference hot loop: adx.cpp:215-273, 380-414)."""
    codes, scale_raw, zero, conv = adx_encode_fixpoint(
        pcm, c0, c1, h1, h2, spb=spb, encoding_mode=encoding_mode,
        bit_depth=bit_depth, scale_fix=scale_fix, max_passes=max_passes)
    if encoding_mode == 2:
        scale_field = jnp.where(zero, 0,
                                (filter_ << 13) | (scale_raw & 0x1FFF))
    else:
        scale_field = jnp.where(zero, 0, scale_raw & 0xFFFF)
    payload = adx_pack_device(codes, scale_field, block_size=block_size,
                              bit_depth=bit_depth)
    return payload, conv
