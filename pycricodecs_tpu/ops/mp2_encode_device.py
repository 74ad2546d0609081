"""Device-side MPEG Layer II encoder for the AHX codec (full device path).

Layer II has no serial
dependency anywhere — the analysis filterbank is one matmul, the
psychoacoustic-free greedy bit allocation advances every frame in lockstep,
and every bitstream offset is a prefix sum over closed-form field widths —
so the whole pipeline (PCM -> finished frame bytes) runs as one jitted
program with frames left in device memory.

Determinism contract (the load-bearing design decision): everything AFTER
the analysis matmul uses only IEEE-exact f32 ops (+,-,*, compares) and
integer math — no division, no transcendentals, no gathers:

- The reference greedy allocation (models/ahx.py::encode_mp2,
  hca-style max-(SMR - SNR)) ranks subbands by
  ``20*log10(peak) - 20*log10(n_levels)``.  Monotonicity of log makes that
  ordering IDENTICAL to ranking ``peak * (1/n_levels)`` — and 1/n_levels
  for every class is a precomputed f32 constant, so the device ranking is
  a single multiply.  The -60 dB cutoff becomes ``peak > n_levels * 1e-3``
  (constant table, exact compare).
- Scalefactor selection: the ISO table is strictly decreasing, so the
  chosen index / reciprocal are masked max-reduces over 63 constant
  compares (no searchsorted, no gather).
- Quantisation divides by the scalefactor in the reference; here it
  multiplies by the f32-rounded reciprocal of the table entry (a constant),
  with a pinned op order shared by the numpy mirror.

Because f32 mul/add/compare are correctly rounded on every backend, the
post-analysis pipeline is bit-identical across XLA backends and the numpy
mirror (``encode_from_spectra_np``) GIVEN THE SAME SPECTRA.  The analysis
matmul itself is platform-rounded (accumulation order differs by backend),
so end-to-end streams are certified by: device bytes == mirror bytes fed
with the device-computed spectra (the device guard), plus decoded-SNR quality
gates vs the float64 host encoder.  The f64 host path
(models/ahx.py::encode_mp2) remains the default single-file encoder.

Bit packing reuses the HCA device packer's two-level scatter
(ops/hca_pack_device._scatter_words): symbol (value, width) tensors are
closed-form here — alloc widths are static, scfsi/scalefactor widths are
selects on scfsi, sample widths repeat one per-granule layout 12 times —
and offsets are one cumsum.  Layer II CBR frames carry no CRC in our
streams (protection bit set), so there is no checksum stage at all.

Field layout matches ops/mp2_frame.py::pack_frame (locked against
libtwolame/libmpg123 oracles); container framing (AHX wrap) stays on host.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from . import mp2_frame
from . import mp2_tables as T
from .hca_pack_device import _scatter_words

i32 = jnp.int32
u32 = jnp.uint32
f32 = jnp.float32


# ---------------------------------------------------------------------------
# Static per-(table, mode) constants
# ---------------------------------------------------------------------------

class Mp2EncConfig(NamedTuple):
    """Host-side static config for one uniform encode group."""
    version: int          # 2 = MPEG-2 LSF, 3 = MPEG-1
    sr_idx: int
    bitrate_idx: int
    bitrate_kbps: int
    sample_rate: int
    mode: int             # 0 stereo, 1 joint, 3 mono
    table_id: int
    sblimit: int
    channels: int
    frame_base: int       # unpadded frame bytes
    nbal_bits: int        # per-frame allocation section bits (all channels)
    bound: int = 32       # first jointly-coded subband (== sblimit: none)
    mode_ext: int = 0


def make_config(sample_rate: int, channels: int,
                bitrate_kbps: Optional[int] = None,
                joint_bound: Optional[int] = None) -> Mp2EncConfig:
    """Resolve the static encode config (mirrors encode_mp2's header probe)."""
    if channels not in (1, 2):
        raise ValueError("Layer II supports 1 or 2 channels.")
    if joint_bound is not None and joint_bound not in (4, 8, 12, 16):
        raise ValueError("joint_bound must be one of 4/8/12/16.")
    joint = joint_bound is not None and channels == 2
    if sample_rate in T.SAMPLE_RATES_V2:
        version, rates = 2, T.BITRATES_V2_L2
        sr_idx = T.SAMPLE_RATES_V2.index(sample_rate)
        if bitrate_kbps is None:
            bitrate_kbps = 80 * channels
    elif sample_rate in T.SAMPLE_RATES_V1:
        version, rates = 3, T.BITRATES_V1_L2
        sr_idx = T.SAMPLE_RATES_V1.index(sample_rate)
        if bitrate_kbps is None:
            bitrate_kbps = 128 * channels
    else:
        raise ValueError(f"Unsupported Layer II sample rate {sample_rate}.")
    if bitrate_kbps not in rates[1:]:
        raise ValueError(f"Unsupported Layer II bitrate {bitrate_kbps} "
                         f"(valid: {sorted(rates[1:])}).")
    bitrate_idx = rates.index(bitrate_kbps)
    mode = 3 if channels == 1 else (1 if joint else 0)
    mode_ext = (joint_bound // 4 - 1) if joint else 0
    hdr = mp2_frame.parse_header(
        mp2_frame.header_word(version, bitrate_idx, sr_idx, 0, mode,
                              mode_ext).to_bytes(4, "big"))
    table = T.ALLOC_TABLES[hdr.table_id]
    nbal_bits = sum(
        (len(t) - 1).bit_length() * (channels if sb < hdr.bound else 1)
        for sb, t in enumerate(table))
    return Mp2EncConfig(
        version=version, sr_idx=sr_idx, bitrate_idx=bitrate_idx,
        bitrate_kbps=bitrate_kbps, sample_rate=sample_rate, mode=mode,
        table_id=int(hdr.table_id), sblimit=int(hdr.sblimit),
        channels=channels, frame_base=int(hdr.frame_size),
        nbal_bits=nbal_bits, bound=int(hdr.bound), mode_ext=mode_ext)


def frame_padding(cfg: Mp2EncConfig, F: int) -> np.ndarray:
    """CBR padding-slot accumulator -> pads [F] (encode_mp2 semantics)."""
    slots_num = 144 * cfg.bitrate_kbps * 1000
    acc = 0
    pads = np.zeros(F, dtype=np.int32)
    for f in range(F):
        acc += slots_num % cfg.sample_rate
        if acc >= cfg.sample_rate:
            acc -= cfg.sample_rate
            pads[f] = 1
    return pads


def _table_constants(table_id: int, sblimit: int):
    """Numpy constant tables for the allocation/quantise/pack stages."""
    table = T.ALLOC_TABLES[table_id]
    maxc = max(len(t) for t in table)
    ncls = np.array([len(t) for t in table], np.int32)
    levels = np.zeros((sblimit, maxc), np.int32)
    bits = np.zeros((sblimit, maxc + 1), np.int64)
    for sb, classes in enumerate(table):
        levels[sb, :len(classes)] = classes
        for k, n in enumerate(classes[1:], start=1):
            gb = T.GROUP_BITS.get(n)
            per_gr = gb if gb is not None else 3 * T.code_bits(n)
            bits[sb, k] = 12 * per_gr
        bits[sb, len(classes):] = bits[sb, len(classes) - 1]
    n_eff = np.maximum(levels, 1).astype(np.float64)
    inv_n = (1.0 / n_eff).astype(np.float32)            # exact-by-definition
    thr_n = (n_eff * 1e-3).astype(np.float32)           # -60 dB cutoff
    cost = (bits[:, 1:] - bits[:, :-1]).astype(np.int32)  # class k -> k+1
    nbal = np.array([(len(t) - 1).bit_length() for t in table], np.int32)
    grouped = np.isin(levels, (3, 5, 9)) & (levels > 0)
    code_b = np.zeros((sblimit, maxc), np.int32)
    for sb in range(sblimit):
        for k in range(maxc):
            n = int(levels[sb, k])
            if n > 0:
                code_b[sb, k] = (T.GROUP_BITS[n] if n in T.GROUP_BITS
                                 else T.code_bits(n))
    return dict(maxc=maxc, ncls=ncls, levels=levels, inv_n=inv_n,
                thr_n=thr_n, cost=cost, nbal=nbal, grouped=grouped,
                code_b=code_b)


_SF32 = T.scalefactors(np.float64)[:63].astype(np.float32)
_INV_SF32 = (1.0 / T.scalefactors(np.float64)[:63]).astype(np.float32)


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------

def _analyze_batch(pcm_f, c_win, m_t):
    """[B, C, N] f32 (+-1 scale) -> [B, C, T, 32] subbands (one matmul)."""
    B, C, N = pcm_f.shape
    Tn = N // 32
    x = pcm_f.reshape(B * C, N)
    xp = jnp.concatenate([jnp.zeros((B * C, 480), f32), x], axis=-1)
    idx = (jnp.arange(Tn)[:, None] * 32 + 511 - jnp.arange(512)[None, :])
    frames = xp[:, idx]                                   # [BC, T, 512]
    Z = frames * c_win
    Y = Z.reshape(B * C, Tn, 8, 64).sum(axis=2)
    S = jnp.matmul(Y, m_t, precision=jax.lax.Precision.HIGHEST)
    return S.reshape(B, C, Tn, 32)


def _sf_select(peaks):
    """peaks f32 [...] -> (sfidx i32, inv_sf f32), gather-free.

    The ISO table is strictly decreasing: the host picks the LAST index with
    sf[idx] >= peak (count - 1, floored at 0).  Masked max-reduces over the
    63 constant compares produce the index and the reciprocal directly.
    """
    sf_t = jnp.asarray(_SF32)
    inv_t = jnp.asarray(_INV_SF32)
    mask = sf_t >= peaks[..., None]                      # [..., 63]
    idx = jnp.max(jnp.where(mask, jnp.arange(63, dtype=i32), 0), axis=-1)
    inv = jnp.max(jnp.where(mask, inv_t, inv_t[0]), axis=-1)
    return idx.astype(i32), inv


def _alloc_loop(keyc, okthr, cost_t, ncls_t, first_cost, budgets):
    """Greedy lockstep allocation (encode_mp2 semantics, proxy ranking).

    keyc f32 [B,F,C,SB,K]: peak * inv_n per class (precomputed, static
    across steps).  okthr bool same shape: peak > n*1e-3.  cost_t i32
    [SB,K]: sample-bit increment class k -> k+1.  first_cost i32 [B,F,C,SB]
    extra bits when a subband first activates.  budgets i32 [F].
    """
    B, F, C, SB, K = keyc.shape
    kk = jnp.arange(K, dtype=i32)
    neg = jnp.float32(-jnp.inf)

    def body(state):
        alloc, spent, _ = state
        oh = alloc[..., None] == kk                       # [B,F,C,SB,K]
        key = jnp.sum(jnp.where(oh, keyc, 0.0), axis=-1)
        ok_t = jnp.any(oh & okthr, axis=-1)
        cost = jnp.sum(jnp.where(oh, cost_t, 0), axis=-1) \
            + jnp.where(alloc == 0, first_cost, 0)
        ok = ((alloc + 1 < ncls_t) & ok_t
              & (spent[:, :, None, None] + cost
                 <= budgets[None, :, None, None]))
        flat = jnp.where(ok, key, neg).reshape(B, F, C * SB)
        best = jnp.argmax(flat, axis=-1)                  # ties: first index
        active = jnp.isfinite(jnp.max(flat, axis=-1))
        upd = ((jnp.arange(C * SB, dtype=i32) == best[..., None])
               & active[..., None]).reshape(B, F, C, SB)
        alloc = alloc + upd.astype(i32)
        spent = spent + jnp.sum(jnp.where(upd, cost, 0), axis=(2, 3))
        return alloc, spent, jnp.any(active)

    def cond(state):
        return state[2]

    alloc0 = jnp.zeros((B, F, C, SB), i32)
    spent0 = jnp.zeros((B, F), i32)
    alloc, spent, _ = jax.lax.while_loop(
        cond, body, (alloc0, spent0, jnp.bool_(True)))
    return alloc, spent


@partial(jax.jit, static_argnames=("version", "sr_idx", "bitrate_idx",
                                   "mode", "table_id", "sblimit", "channels",
                                   "frame_base", "nbal_bits", "bound",
                                   "mode_ext", "return_spectra"))
def mp2_encode_frames(pcm, pads, *, version, sr_idx, bitrate_idx, mode,
                      table_id, sblimit, channels, frame_base, nbal_bits,
                      bound=32, mode_ext=0, return_spectra=False):
    """PCM16 [B, C, F*1152] + pads i32 [F] -> frame bytes u8 [B, F, Wmax*4].

    Frames are packed at static width Wmax*4 >= frame_base+1; the caller
    slices frame f to frame_base + pads[f] bytes (the padding byte is
    trailing zeros, so the slice is exact).  Everything from the analysis
    matmul to the packed words runs on device.

    return_spectra=True additionally returns stream 0's spectra
    f32 [1, C, F, 12, 3, 32] FROM THIS DISPATCH, for parity guards: the
    analysis reduction's float order is shape/fusion-dependent (a separate
    B=1 dispatch produced spectra off by 1 ulp at bank scale, failing the
    mirror byte-compare), so determinism checks must pin the spectra the
    pipeline itself computed.
    """
    B, C, N = pcm.shape
    F = N // 1152
    c_win = T.analysis_window(np.float32)
    m_t = np.ascontiguousarray(T.analysis_matrix(np.float32).T)
    x = pcm.astype(f32) * f32(1.0 / 32768.0)
    S = _analyze_batch(x, c_win, m_t)                    # [B, C, 36F, 32]
    S = S.reshape(B, C, F, 12, 3, 32)

    frames = mp2_pack_pipeline(
        S, pads, version=version, sr_idx=sr_idx, bitrate_idx=bitrate_idx,
        mode=mode, table_id=table_id, sblimit=sblimit, channels=channels,
        frame_base=frame_base, nbal_bits=nbal_bits, bound=bound,
        mode_ext=mode_ext)
    if return_spectra:
        return frames, S[:1]
    return frames


@partial(jax.jit, static_argnames=("version", "sr_idx", "bitrate_idx",
                                   "mode", "table_id", "sblimit", "channels",
                                   "frame_base", "nbal_bits", "bound",
                                   "mode_ext"))
def mp2_pack_pipeline(S, pads, *, version, sr_idx, bitrate_idx, mode,
                      table_id, sblimit, channels, frame_base, nbal_bits,
                      bound=32, mode_ext=0):
    """Spectra f32 [B, C, F, 12, 3, 32] -> frame bytes (post-analysis half).

    Split from mp2_encode_frames so parity tests / the device guard can
    drive the deterministic half with pinned spectra.
    """
    B, C, F = S.shape[:3]
    SB = sblimit
    tc = _table_constants(table_id, sblimit)
    maxc = tc["maxc"]

    # scalefactors per part (part p = granules 4p..4p+3 with their 3-sample
    # rows: the [12, 3] row grid regroups as [3, 12])
    peaks_part = jnp.max(jnp.abs(S).reshape(B, C, F, 3, 12, 32), axis=4)
    sfidx, inv_sf = _sf_select(peaks_part)               # [B, C, F, 3, 32]
    peak_f = jnp.max(peaks_part, axis=3)                 # [B, C, F, 32]

    # scfsi + per-(ch, sb) scalefactor bits
    eq01 = sfidx[:, :, :, 0, :] == sfidx[:, :, :, 1, :]
    eq12 = sfidx[:, :, :, 1, :] == sfidx[:, :, :, 2, :]
    scfsi = jnp.where(eq01 & eq12, 2,
                      jnp.where(eq01, 1, jnp.where(eq12, 3, 0)))
    sf_bits = jnp.where(scfsi == 2, 6,
                        jnp.where(scfsi == 0, 18, 12))   # [B, C, F, 32]

    joint = bound < SB and C == 2
    if joint:
        # intensity (joint) stereo: subbands >= bound carry ONE shared
        # allocation + code set quantised from the mid signal (l+r)/2
        # against its own scalefactor; both channels still transmit scfsi
        # + scalefactors (models/ahx.py::encode_mp2 semantics, f32 here)
        Sj = (S[:, 0] + S[:, 1]) * f32(0.5)              # [B, F, 12, 3, 32]
        peaks_j = jnp.max(jnp.abs(Sj).reshape(B, F, 3, 12, 32), axis=3)
        _, inv_sf_j = _sf_select(peaks_j)                # [B, F, 3, 32]

    # budgets (frame bits minus header + alloc section)
    fsz_bits = (frame_base + pads) * 8                   # [F]
    budgets = (fsz_bits - 32 - nbal_bits).astype(i32)

    # allocation inputs, [B, F, C, SB] layout
    peak_a = jnp.moveaxis(peak_f[..., :SB], 1, 2)        # [B, F, C, SB]
    first_cost = (2 + jnp.moveaxis(sf_bits[..., :SB], 1, 2)).astype(i32)
    if joint:
        # shared subbands allocate once through the ch0 slot: its first
        # activation pays BOTH channels' scfsi (2+2) and scalefactor bits;
        # its need covers the louder channel; ch1's slot goes ineligible
        peak_a = peak_a.at[:, :, 0, bound:].set(
            jnp.maximum(peak_a[:, :, 0, bound:], peak_a[:, :, 1, bound:]))
        sfb = jnp.moveaxis(sf_bits[..., :SB], 1, 2)      # [B, F, C, SB]
        first_cost = first_cost.at[:, :, 0, bound:].set(
            (4 + sfb[:, :, 0, bound:] + sfb[:, :, 1, bound:]).astype(i32))
    keyc = peak_a[..., None] * jnp.asarray(tc["inv_n"])  # [B,F,C,SB,K]
    okthr = peak_a[..., None] > jnp.asarray(tc["thr_n"])
    if joint:
        elig = np.ones((1, 1, C, SB, 1), bool)
        elig[:, :, 1, bound:, :] = False
        okthr = okthr & jnp.asarray(elig)
    alloc, _ = _alloc_loop(keyc, okthr, jnp.asarray(tc["cost"]),
                           jnp.asarray(tc["ncls"]), first_cost, budgets)

    # per-subband levels / widths from the final classes
    oh = alloc[..., None] == jnp.arange(maxc, dtype=i32)  # [B,F,C,SB,K]
    n_lv = jnp.sum(jnp.where(oh, jnp.asarray(tc["levels"]), 0), axis=-1)
    grouped = jnp.any(oh & jnp.asarray(tc["grouped"]), axis=-1)
    code_b = jnp.sum(jnp.where(oh, jnp.asarray(tc["code_b"]), 0), axis=-1)

    # quantise: q = clip(floor(((s*inv_sf)*n + n-1)/2 + .5), 0, n-1)
    # pinned op order, shared with encode_from_spectra_np
    nf = jnp.moveaxis(n_lv, 1, 2)[:, :, :, None, None, :].astype(f32)
    inv_g = inv_sf[:, :, :, jnp.arange(12) // 4, :]      # [B,C,F,12,32]
    S_q, inv_gq = S, inv_g
    if joint:
        # shared subbands quantise the mid signal against its scalefactor
        # (only the ch0 slot's codes are transmitted there)
        bmask = jnp.asarray(np.arange(32) >= bound)
        inv_gj = inv_sf_j[:, :, jnp.arange(12) // 4, :]  # [B,F,12,32]
        S_q = S.at[:, 0].set(jnp.where(bmask, Sj, S[:, 0]))
        inv_gq = inv_g.at[:, 0].set(jnp.where(bmask, inv_gj, inv_g[:, 0]))
    t = S_q[..., :SB] * inv_gq[..., :SB][:, :, :, :, None, :]
    t = t * nf
    t = (t + (nf - f32(1.0))) * f32(0.5) + f32(0.5)
    q = jnp.floor(t)
    codes = jnp.clip(q, 0.0, jnp.maximum(nf - 1.0, 0.0))
    codes = jnp.where(nf > 0, codes, 0.0).astype(i32)    # [B,C,F,12,3,SB]

    # ---- pack: symbol (value, width) tensors + one cumsum -> scatter ----
    values = []
    widths = []
    hdr_w = mp2_frame.header_word(version, bitrate_idx, sr_idx, 0, mode,
                                  mode_ext)
    hw = jnp.broadcast_to(u32(hdr_w >> 16), (B, F))[..., None]
    lw = (u32(hdr_w & 0xFFFF) | (pads.astype(u32) << 9))[None, :, None]
    values.append(hw)
    widths.append(jnp.broadcast_to(i32(16), (B, F, 1)))
    values.append(jnp.broadcast_to(lw, (B, F, 1)).astype(u32))
    widths.append(jnp.broadcast_to(i32(16), (B, F, 1)))

    # alloc section: (sb-major, ch-minor) static widths; joint-shared
    # subbands emit ONE field through the ch0 slot (ch1 slot width 0)
    alloc_p = jnp.moveaxis(alloc, 3, 2).reshape(B, F, SB * C)
    nbal_np = np.repeat(tc["nbal"], C)
    if joint:
        keep_sb = np.ones((SB, C), bool)
        keep_sb[bound:, 1:] = False
        nbal_np = np.where(keep_sb.reshape(-1), nbal_np, 0)
    nbal_p = jnp.asarray(nbal_np)
    values.append(alloc_p.astype(u32))
    widths.append(jnp.broadcast_to(nbal_p.astype(i32), (B, F, SB * C)))

    # scfsi/scalefactors transmit PER CHANNEL wherever that channel's
    # (transmitted) allocation is active — at shared subbands both
    # channels mirror the ch0 allocation
    alloc_tx = alloc
    if joint:
        alloc_tx = alloc.at[:, :, 1, bound:].set(alloc[:, :, 0, bound:])
    act = jnp.moveaxis(alloc_tx, 3, 2).reshape(B, F, SB * C) > 0
    scfsi_p = jnp.moveaxis(jnp.moveaxis(scfsi[..., :SB], 1, 2), 3, 2) \
        .reshape(B, F, SB * C)
    values.append(jnp.where(act, scfsi_p, 0).astype(u32))
    widths.append(jnp.where(act, 2, 0).astype(i32))

    # scalefactor slots (a | b/c | c by scfsi)
    sfx = jnp.moveaxis(sfidx[..., :SB], 1, 2)            # [B,F,C,3,SB]
    sfx = jnp.transpose(sfx, (0, 1, 3, 4, 2))            # [B,F,3,SB,C]
    sfx = sfx.reshape(B, F, 3, SB * C)                   # [B,F,part,P]
    a_v, b_v, c_v = sfx[:, :, 0], sfx[:, :, 1], sfx[:, :, 2]
    s1 = jnp.where(scfsi_p == 1, c_v, b_v)
    m1 = act & ((scfsi_p == 0) | (scfsi_p == 1) | (scfsi_p == 3))
    m2 = act & (scfsi_p == 0)
    # slots are CONTIGUOUS PER PAIR in the stream (a, b/c, c), so stack on
    # a trailing slot axis and flatten pair-major
    sf_v = jnp.stack([jnp.where(act, a_v, 0), jnp.where(m1, s1, 0),
                      jnp.where(m2, c_v, 0)], axis=-1)
    sf_w = jnp.stack([jnp.where(act, 6, 0), jnp.where(m1, 6, 0),
                      jnp.where(m2, 6, 0)], axis=-1)
    values.append(sf_v.reshape(B, F, SB * C * 3).astype(u32))
    widths.append(sf_w.reshape(B, F, SB * C * 3).astype(i32))

    # samples: 12 granules x (sb-major, ch-minor) x 3 slots
    cd = jnp.moveaxis(codes, 1, 2)                       # [B,F,C,12,3,SB]
    cd = jnp.transpose(cd, (0, 1, 3, 5, 2, 4))           # [B,F,12,SB,C,3]
    cd = cd.reshape(B, F, 12, SB * C, 3)
    n_p = jnp.moveaxis(n_lv, 3, 2).reshape(B, F, SB * C)
    g_p = jnp.moveaxis(grouped, 3, 2).reshape(B, F, SB * C)
    cb_p = jnp.moveaxis(code_b, 3, 2).reshape(B, F, SB * C)
    v0, v1, v2 = cd[..., 0], cd[..., 1], cd[..., 2]
    gval = v0 + n_p[:, :, None, :] * (v1 + n_p[:, :, None, :] * v2)
    s0 = jnp.where(g_p[:, :, None, :], gval, v0)
    w0 = jnp.where(n_p > 0, cb_p, 0)[:, :, None, :] \
        * jnp.ones((1, 1, 12, 1), i32)
    wu = jnp.where(g_p | (n_p == 0), 0, cb_p)[:, :, None, :] \
        * jnp.ones((1, 1, 12, 1), i32)
    samp_v = jnp.stack([s0.astype(u32), v1.astype(u32), v2.astype(u32)],
                       axis=-1)
    samp_w = jnp.stack([w0, wu, wu], axis=-1)
    values.append(samp_v.reshape(B, F, 12 * SB * C * 3))
    widths.append(samp_w.reshape(B, F, 12 * SB * C * 3))

    value = jnp.concatenate(values, axis=-1)
    bits = jnp.concatenate(widths, axis=-1)
    value, bits = jax.lax.optimization_barrier((value, bits))

    W = -(-(frame_base + 1) // 4)
    from .hca_pack_device import _exclusive_prefix
    # hierarchical matmul prefix instead of cumsum (exact: widths <= 16 and
    # frame totals < 2^24 — see hca_pack_device._exclusive_prefix)
    off = _exclusive_prefix(bits)
    keep = (off + bits) <= (W * 32)       # memory-safety; never hit (CBR
    value = jnp.where(keep, value & ((u32(1) << jnp.minimum(
        bits, 31).astype(u32)) - 1), 0)   # budget bounds the layout)
    w_n = (off >> 5).astype(i32)
    rel = (off & 31).astype(i32)
    end = rel + bits
    sh_hi_le = jnp.clip(32 - end, 0, 31).astype(u32)
    sh_hi_gt = jnp.clip(end - 32, 0, 31).astype(u32)
    hi = jnp.where(end <= 32, value << sh_hi_le, value >> sh_hi_gt)
    sh_lo = jnp.clip(64 - end, 0, 31).astype(u32)
    lo = jnp.where(end > 32, value << sh_lo, u32(0))
    w_n, hi, lo = jax.lax.optimization_barrier((w_n, hi, lo))
    words = _scatter_words(w_n, hi, lo, W)               # [B, F, W]

    le = jax.lax.bitcast_convert_type(words, jnp.uint8)  # [B, F, W, 4]
    be = jnp.stack([le[..., 3], le[..., 2], le[..., 1], le[..., 0]],
                   axis=-1)
    return be.reshape(B, F, W * 4)


# ---------------------------------------------------------------------------
# Numpy mirror (bit-exact vs the device post-analysis pipeline)
# ---------------------------------------------------------------------------

def mirror_from_spectra_np(S: np.ndarray, cfg: Mp2EncConfig):
    """f32 spectra [C, F, 12, 3, 32] -> (alloc, scfsi, sfidx, codes, pads,
    frame_sizes) with EXACTLY the device pipeline's semantics (f32 ops in
    the same order, proxy ranking, first-index ties).  Feeding the result
    to mp2_frame.pack_frames reproduces the device bytes byte-for-byte."""
    S = np.asarray(S, np.float32)
    C, F = S.shape[:2]
    SB = cfg.sblimit
    tc = _table_constants(cfg.table_id, SB)
    maxc = tc["maxc"]

    peaks_part = np.max(np.abs(S).reshape(C, F, 3, 12, 32),
                        axis=3).astype(np.float32)       # [C, F, 3, 32]
    mask = _SF32 >= peaks_part[..., None]
    sfidx = np.max(np.where(mask, np.arange(63, dtype=np.int32), 0),
                   axis=-1).astype(np.int32)
    inv_sf = np.max(np.where(mask, _INV_SF32, _INV_SF32[0]),
                    axis=-1).astype(np.float32)
    peak_f = np.max(peaks_part, axis=2)                  # [C, F, 32]

    eq01 = sfidx[:, :, 0, :] == sfidx[:, :, 1, :]
    eq12 = sfidx[:, :, 1, :] == sfidx[:, :, 2, :]
    scfsi = np.where(eq01 & eq12, 2,
                     np.where(eq01, 1, np.where(eq12, 3, 0))).astype(np.int32)
    sf_bits = np.where(scfsi == 2, 6, np.where(scfsi == 0, 18, 12))

    bound = cfg.bound
    joint = bound < SB and C == 2
    if joint:
        # mid signal for the shared (intensity) subbands — f32 op order
        # pinned to mp2_pack_pipeline's
        Sj = ((S[0] + S[1]) * np.float32(0.5)).astype(np.float32)
        peaks_j = np.max(np.abs(Sj).reshape(F, 3, 12, 32),
                         axis=2).astype(np.float32)      # [F, 3, 32]
        mask_j = _SF32 >= peaks_j[..., None]
        inv_sf_j = np.max(np.where(mask_j, _INV_SF32, _INV_SF32[0]),
                          axis=-1).astype(np.float32)

    pads = frame_padding(cfg, F)
    budgets = ((cfg.frame_base + pads) * 8 - 32 - cfg.nbal_bits) \
        .astype(np.int64)

    peak_a = np.moveaxis(peak_f[..., :SB], 0, 1).copy()  # [F, C, SB]
    first_cost = 2 + np.moveaxis(sf_bits[..., :SB], 0, 1)
    if joint:
        peak_a[:, 0, bound:] = np.maximum(peak_a[:, 0, bound:],
                                          peak_a[:, 1, bound:])
        sfb = np.moveaxis(sf_bits[..., :SB], 0, 1)
        first_cost = first_cost.copy()
        first_cost[:, 0, bound:] = (4 + sfb[:, 0, bound:]
                                    + sfb[:, 1, bound:])
    keyc = (peak_a[..., None] * tc["inv_n"]).astype(np.float32)
    okthr = peak_a[..., None] > tc["thr_n"]
    if joint:
        okthr = okthr.copy()
        okthr[:, 1, bound:, :] = False
    alloc = np.zeros((F, C, SB), np.int32)
    spent = np.zeros(F, np.int64)
    kk = np.arange(maxc)
    active = np.ones(F, bool)
    while active.any():
        oh = alloc[..., None] == kk
        key = np.sum(np.where(oh, keyc, np.float32(0)), axis=-1,
                     dtype=np.float32)
        ok_t = np.any(oh & okthr, axis=-1)
        cost = np.sum(np.where(oh, tc["cost"], 0), axis=-1) \
            + np.where(alloc == 0, first_cost, 0)
        ok = ((alloc + 1 < tc["ncls"]) & ok_t
              & (spent[:, None, None] + cost <= budgets[:, None, None]))
        flat = np.where(ok, key, -np.inf).reshape(F, C * SB)
        best = flat.argmax(axis=1)
        active = np.isfinite(flat[np.arange(F), best])
        if not active.any():
            break
        fsel = np.nonzero(active)[0]
        ch_b, sb_b = np.unravel_index(best[fsel], (C, SB))
        spent[fsel] += cost[fsel, ch_b, sb_b]
        alloc[fsel, ch_b, sb_b] += 1

    oh = alloc[..., None] == kk
    n_lv = np.sum(np.where(oh, tc["levels"], 0), axis=-1)  # [F, C, SB]

    nf = np.moveaxis(n_lv, 1, 0)[:, :, None, None, :].astype(np.float32)
    inv_g = inv_sf[:, :, np.arange(12) // 4, :]          # [C, F, 12, 32]
    S_q = S
    if joint:
        # shared subbands quantise the mid signal against its scalefactor
        S_q = S.copy()
        S_q[0, :, :, :, bound:] = Sj[:, :, :, bound:]
        inv_g = inv_g.copy()
        inv_g[0, :, :, bound:] = inv_sf_j[:, np.arange(12) // 4, bound:]
    t = (S_q[..., :SB] * inv_g[..., :SB][:, :, :, None, :]) \
        .astype(np.float32)
    t = (t * nf).astype(np.float32)
    t = ((t + (nf - np.float32(1.0))) * np.float32(0.5)
         + np.float32(0.5)).astype(np.float32)
    q = np.floor(t)
    codes = np.clip(q, 0.0, np.maximum(nf - 1.0, 0.0))
    codes = np.where(nf > 0, codes, 0.0).astype(np.uint16)
    codes = codes.reshape(C, F, 36, SB)

    # pack_frames operand layouts: alloc as TABLE INDICES.  Joint streams
    # return the TRANSMITTED matrix: ch1 mirrors ch0 at shared subbands so
    # pack_frames emits both channels' scfsi + scalefactors there (the
    # alloc and sample sections read only the ch0 slot at those subbands).
    if joint:
        alloc = alloc.copy()
        alloc[:, 1, bound:] = alloc[:, 0, bound:]
    frame_sizes = cfg.frame_base + pads
    return alloc, scfsi, sfidx, codes, pads, frame_sizes


def encode_from_spectra_np(S: np.ndarray, cfg: Mp2EncConfig) -> bytes:
    """Mirror encode: spectra -> full CBR stream bytes via the host packer."""
    alloc, scfsi, sfidx, codes, pads, frame_sizes = \
        mirror_from_spectra_np(S, cfg)
    hdr = mp2_frame.parse_header(
        mp2_frame.header_word(cfg.version, cfg.bitrate_idx, cfg.sr_idx, 0,
                              cfg.mode, cfg.mode_ext).to_bytes(4, "big"))
    SB = cfg.sblimit
    return mp2_frame.pack_frames(
        hdr, cfg.bitrate_idx, cfg.sr_idx, alloc,
        np.moveaxis(scfsi, 0, 1)[:, :, :SB],
        np.moveaxis(sfidx, 0, 1)[:, :, :, :SB],
        np.moveaxis(codes, 0, 1), pads, frame_sizes)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

def assemble_stream(frame_bytes: np.ndarray, cfg: Mp2EncConfig,
                    pads: np.ndarray) -> bytes:
    """[F, Wmax*4] u8 device output -> contiguous CBR stream bytes."""
    out = bytearray()
    fb = cfg.frame_base
    for f in range(frame_bytes.shape[0]):
        out += frame_bytes[f, :fb + int(pads[f])].tobytes()
    return bytes(out)


def encode_mp2_device_batch(pcms, sample_rate: int,
                            bitrate_kbps: Optional[int] = None,
                            mesh=None,
                            joint_bound: Optional[int] = None) -> list:
    """Encode a batch of int16 PCM arrays ([N] mono / [C, N]) on device.

    Streams must share (channels, sample_rate); differing lengths are
    frame-padded with silence and trimmed by CBR framing (every frame is
    emitted, matching encode_mp2's zero-padded tail behaviour).  Returns
    raw Layer II streams (no container).  With a mesh, the stream axis
    shards over the first mesh axis (pure jnp pipeline: GSPMD handles it).
    """
    arrs = []
    for p in pcms:
        a = np.asarray(p, np.int16)
        if a.ndim == 1:
            a = a[None, :]
        arrs.append(a)
    C = arrs[0].shape[0]
    if any(a.shape[0] != C for a in arrs):
        raise ValueError("encode_mp2_device_batch requires a uniform "
                         "channel count")
    cfg = make_config(sample_rate, C, bitrate_kbps, joint_bound=joint_bound)
    spf = mp2_frame.SAMPLES_PER_FRAME
    fcounts = [(a.shape[1] + spf - 1) // spf for a in arrs]
    # bucket the padded frame count so varied-length banks reuse compiles;
    # per-stream assembly below slices back to the true frame counts
    F = -(-max(fcounts) // 16) * 16
    B = len(arrs)
    Bp = B
    if mesh is not None:
        nd = int(mesh.devices.shape[0])
        Bp = -(-B // nd) * nd
    pcm = np.zeros((Bp, C, F * spf), np.int16)
    for b, a in enumerate(arrs):
        pcm[b, :, :a.shape[1]] = a
    pads = frame_padding(cfg, F)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        pcm = jax.device_put(
            pcm, NamedSharding(mesh, P(mesh.axis_names[0], None, None)))
    out = mp2_encode_frames(
        pcm, jnp.asarray(pads),
        version=cfg.version, sr_idx=cfg.sr_idx,
        bitrate_idx=cfg.bitrate_idx, mode=cfg.mode, table_id=cfg.table_id,
        sblimit=cfg.sblimit, channels=cfg.channels,
        frame_base=cfg.frame_base, nbal_bits=cfg.nbal_bits,
        bound=cfg.bound, mode_ext=cfg.mode_ext)
    out = np.asarray(out[:B])
    results = []
    for b in range(B):
        Fb = fcounts[b]
        results.append(assemble_stream(out[b, :Fb], cfg, pads[:Fb]))
    return results
