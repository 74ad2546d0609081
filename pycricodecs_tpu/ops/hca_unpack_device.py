"""Device-side (JAX) HCA frame unpacker.

The HCA bitstream is serial WITHIN a frame (variable-length codes move a bit
cursor) but frames are independent, so the unpack is SPMD across frames with
`lax.scan` over the serial step sequence: every frame executes the same
statically-known sequence of semantic steps (the per-channel
scalefactor/intensity sections, then 8 x coded_count coefficient reads —
the sequence depends only on the header config, never on frame content).

Gather-free formulation: bit windows are fetched by a one-hot
compare+reduce over the frame's ALIGNED u32 word table funnel-shifted to
the byte offset, the VLC tables are evaluated as closed forms and
packed-nibble constants muxed by 3-bit binary trees, and the per-step
resolution/output routing uses static slices/reshapes instead of
gather/scatter. Supersteps: one 128-bit window (4 words, one traversal)
serves 10 VLC symbols (max 12 bits each: 7 + 120 < 128), cutting window
fetches 10x.

Raw frame bytes are ~10x less H2D volume than unpacked SoA tensors.

Bit-exactness: all arithmetic is integer; semantics mirror
ops/hca_frame.py::_unpack_frames_py line by line (itself locked against the
reference hca.cpp:1100-1237 by byte-parity tests). Error conditions that the
host path raises for (scalefactor delta out of range, v3 intensity delta
out of range) are returned as a per-frame `err` flag: the caller checks the
flags and raises to match host semantics.

The v3 PNS noise fill (min_resolution == 0) also runs here: its LCG draw
chain threads serially across frames, but the LCG is an affine map — the
per-slot draw ordinal comes from exact prefix sums over (frame, channel,
subframe, band) counts and the state at any ordinal from a closed-form
32-step square-and-multiply jump, so every noise band fills in parallel,
bit-exact with the host chain (seeded 1 per stream, matching DecodeReset).

Reference anchors: hca.cpp:1290-1355 (scalefactors), 1357-1434 (intensity),
1444-1494 (resolutions), 1543-1577 (dequantize).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import hca_tables as T

VERSION_V200 = 0x0200

# READ_BIT_TABLE / READ_VAL_TABLE rows (r = 0..7) packed 4 bits per code:
# lo word = codes 0..7, hi word = codes 8..15; VAL nibbles store value + 8.
# Verified against the parsed reference tables in tests/test_hca_tables.py
# via tests/test_hca_unpack_device.py byte-parity.
_BIT_LO = [0x0, 0x2211, 0x33222222, 0x33333322,
           0x33333333, 0x33333333, 0x44333333, 0x44444433]
_BIT_HI = [0x0, 0x0, 0x0, 0x0,
           0x44333333, 0x44444433, 0x44444444, 0x44444444]
_VAL_LO = [0x88888888, 0x88887988, 0x6A779988, 0x5B6A7988,
           0xAA779988, 0xAA779988, 0x6A779988, 0x5B6A7988]
_VAL_HI = [0x88888888, 0x88888888, 0x88888888, 0x88888888,
           0x4C55BB66, 0x3D4C5B66, 0x2E3D4C5B, 0x1F2E3D4C]


# Combined (value, advance) byte tables: VB[r][k] packs codes 4k..4k+3 of
# resolution r as one byte each — low nibble = value+8, high nibble = the
# bit advance — derived from the packed nibble tables above so they cannot
# drift. The coefficient phase reads these as PRECOMPUTED per-symbol data
# (computed once per frame-symbol, reused by all 8 subframes) instead of
# re-deriving four 3-bit muxes per symbol instance.
_VB = [[0] * 4 for _ in range(8)]
for _r in range(8):
    for _code in range(16):
        if _code < 8:
            _val = (_VAL_LO[_r] >> (_code * 4)) & 0xF
            _adv = (_BIT_LO[_r] >> (_code * 4)) & 0xF
        else:
            _val = (_VAL_HI[_r] >> ((_code - 8) * 4)) & 0xF
            _adv = (_BIT_HI[_r] >> ((_code - 8) * 4)) & 0xF
        _VB[_r][_code >> 2] |= (_val | (_adv << 4)) << ((_code & 3) * 8)
del _r, _code, _val, _adv


def _mux8(consts, r):
    """Select consts[r] (r in 0..7, [N] vector) with a 3-bit binary tree —
    7 vector selects, no gather."""
    c = [jnp.uint32(x) for x in consts]
    b0 = (r & 1) == 1
    a01 = jnp.where(b0, c[1], c[0])
    a23 = jnp.where(b0, c[3], c[2])
    a45 = jnp.where(b0, c[5], c[4])
    a67 = jnp.where(b0, c[7], c[6])
    b1 = (r & 2) == 2
    a03 = jnp.where(b1, a23, a01)
    a47 = jnp.where(b1, a67, a45)
    return jnp.where((r & 4) == 4, a47, a03)


def _nib16(lo, hi, code):
    """Extract nibble `code` (0..15) from the packed (lo, hi) pair."""
    word = jnp.where(code >= 8, hi, lo)
    shift = ((code & 7) << 2).astype(jnp.uint32)
    return ((word >> shift) & jnp.uint32(15)).astype(jnp.int32)


def _max_bit(r):
    """MAX_BIT_TABLE closed form: 0, 2,3,3,4,4,4,4, then r-3."""
    small = 2 + (r >= 2) + (r >= 4)
    return jnp.where(r == 0, 0, jnp.where(r < 8, small, r - 3))


# PNS noise LCG (hca.cpp:1616): random' = 0x343FD*random + 0x269EC3 mod 2^32.
# An affine map composes associatively, so "state after n draws" is a 32-step
# square-and-multiply over precomputed f^(2^k) pairs — the serial draw chain
# is exactly parallelisable.
_LCG_POWS = []
_a, _b = 0x343FD, 0x269EC3
for _k in range(32):
    _LCG_POWS.append((_a, _b))
    _b = (_a * _b + _b) & 0xFFFFFFFF
    _a = (_a * _a) & 0xFFFFFFFF
del _a, _b, _k


def _lcg_jump(n_draws):
    """State after n_draws applications of the noise LCG to seed 1 (u32)."""
    x = jnp.ones(n_draws.shape, jnp.uint32)
    n = n_draws.astype(jnp.uint32)
    for k in range(32):
        a, b = _LCG_POWS[k]
        hit = ((n >> k) & 1) == 1
        x = jnp.where(hit, jnp.uint32(a) * x + jnp.uint32(b), x)
    return x


class DeviceUnpacker:
    """Per-config compiled unpacker. Build once per HcaInfo config, call with
    uint8 [N, frame_size] stacked (enciphered) frames."""

    def __init__(self, info):
        C = int(info.channels)
        self.C = C
        self.fs = int(info.frame_size)
        # aligned word-table width: fetches read the two 8-word chunks at
        # (q>>3) and (q>>3)+1 with q <= (fs-1)>>2, so nc chunks keep every
        # candidate in range (zero padding past the frame end)
        self.nc = ((int(info.frame_size) - 1) // 4) // 8 + 2
        self.wn = self.nc * 8
        self.version = int(info.version)
        self.hfr = int(info.hfr_group_count)
        self.min_res = int(info.min_resolution)
        self.max_res = int(info.max_resolution)
        self.coded = [int(x) for x in np.asarray(info.coded_count)]
        self.ctype = [int(x) for x in np.asarray(info.channel_type)]
        if any(c <= 0 for c in self.coded):
            raise ValueError("zero coded_count needs the host unpacker")
        self.ath = np.asarray(info.ath, dtype=np.int32)
        self.cipher = np.asarray(info.cipher, dtype=np.uint8)
        self.cipher_identity = bool(
            np.array_equal(self.cipher, np.arange(256, dtype=np.uint8)))
        # v3 streams with min_resolution 0 PNS-fill resolution-0 bands; the
        # serial LCG draw chain is an affine map, parallelised here with
        # prefix sums + closed-form jumps (see _noise)
        self.need_noise = self.min_res == 0
        if info.ms_stereo:
            raise ValueError("ms_stereo unsupported")  # parse rejects too
        # static per-channel scalefactor counts (incl. the v3 HFR extension)
        self.cs_counts = []
        self.extras = []
        for c in range(C):
            cs = self.coded[c]
            extra = 0
            if not (self.ctype[c] == T.STEREO_SECONDARY or self.hfr <= 0
                    or self.version <= VERSION_V200):
                extra = self.hfr
                cs += extra
            if cs > 128:
                raise ValueError("Unpack error (scalefactor count)")
            if cs >= 128 and extra:
                # the host/reference path reads sf[cs] out of bounds here
                raise ValueError("cs_count == 128 with HFR extension")
            self.cs_counts.append(cs)
            self.extras.append(extra)
        self._jit = jax.jit(self._unpack, static_argnames=("B",))

    # -- bit primitives ------------------------------------------------------
    #
    # One-hot window fetches: a compare+masked-reduce over the ALIGNED
    # [N, ceil(fs/4)+5] u32 word table; the fetched aligned words are
    # funnel-shifted by the byte remainder into byte-offset windows. XLA
    # fuses all candidate words of one fetch into a single traversal (one
    # variadic select_reduce).

    def _wa_words(self, wa, q, nwords):
        """Aligned words wa[q], .., wa[q+nwords-1] (nwords <= 9), two-level:
        a one-hot compare+reduce picks the two 8-word chunks containing the
        span (one fused traversal of the table, ~2 select+add per element vs
        ~3 per element PER WORD for the flat per-word one-hot), then a 3-bit
        mux (7 selects/word) slides to the word remainder."""
        wc = wa.reshape(wa.shape[0], self.nc, 8)
        qc = q >> 3
        ci = jnp.arange(self.nc, dtype=jnp.int32)[None, :, None]
        sel0 = qc[:, None, None] == ci
        sel1 = qc[:, None, None] == (ci - 1)
        c0 = jnp.sum(jnp.where(sel0, wc, jnp.uint32(0)), axis=1,
                     dtype=jnp.uint32)
        c1 = jnp.sum(jnp.where(sel1, wc, jnp.uint32(0)), axis=1,
                     dtype=jnp.uint32)
        w16 = [c0[:, i] for i in range(8)] + [c1[:, i] for i in range(8)]
        rem = q & 7
        return [_mux8(w16[k:k + 8], rem) for k in range(nwords)]

    @staticmethod
    def _funnel(w, r):
        """Byte-offset windows from aligned words: out[k] = bytes starting at
        word base + r bytes (r in 0..3 as a bit shift 0/8/16/24)."""
        nz = r > 0
        return [jnp.where(nz,
                          (w[k] << r) | (w[k + 1] >> (jnp.uint32(32) - r)),
                          w[k]) for k in range(len(w) - 1)]

    def _peek(self, wa, cur, count):
        """BitReader.peek: any read crossing the frame end returns 0."""
        bb = jnp.minimum(cur >> 3, self.fs - 1)
        q = bb >> 2
        r = ((bb & 3) << 3).astype(jnp.uint32)
        w = self._funnel(self._wa_words(wa, q, 2), r)[0]
        count = jnp.broadcast_to(jnp.asarray(count, jnp.int32), cur.shape)
        shift = (32 - (cur & 7) - jnp.clip(count, 0, 25)).astype(jnp.uint32)
        val = (w >> shift).astype(jnp.int32) & (jnp.left_shift(1, count) - 1)
        ok = (cur + count <= self.fs * 8) & (count > 0)
        return jnp.where(ok, val, 0)

    def _win64(self, wa, cur):
        """Two u32 window words at byte(cur) and byte(cur)+4, one traversal."""
        bb = jnp.minimum(cur >> 3, self.fs - 1)
        q = bb >> 2
        r = ((bb & 3) << 3).astype(jnp.uint32)
        ws = self._funnel(self._wa_words(wa, q, 3), r)
        return ws[0], ws[1], bb * 8

    def _win128(self, wa, cur):
        """Four u32 window words (128 bits) in one traversal: serves 10
        symbols of <= 12 bits (7 + 120 < 128)."""
        bb = jnp.minimum(cur >> 3, self.fs - 1)
        q = bb >> 2
        r = ((bb & 3) << 3).astype(jnp.uint32)
        ws = self._funnel(self._wa_words(wa, q, 5), r)
        return ws, bb * 8

    def _ext128(self, ws, o, count, abs_cur):
        """Extract `count` (<= 12) bits at local offset `o` of the 128-bit
        window, BitReader.peek end-of-frame masking at `abs_cur`."""
        o = jnp.minimum(o, 115)
        wi = o >> 5                                  # word index 0..3
        oo = (o & 31).astype(jnp.uint32)
        hi = jnp.where(wi == 0, ws[0],
                       jnp.where(wi == 1, ws[1],
                                 jnp.where(wi == 2, ws[2], ws[3])))
        lo = jnp.where(wi == 0, ws[1],
                       jnp.where(wi == 1, ws[2],
                                 jnp.where(wi == 2, ws[3], jnp.uint32(0))))
        left = (hi << oo) | jnp.where(
            oo > 0, lo >> (jnp.uint32(32) - oo), jnp.uint32(0))
        count = jnp.broadcast_to(jnp.asarray(count, jnp.int32), o.shape)
        shift = (32 - jnp.clip(count, 0, 31)).astype(jnp.uint32)
        val = (left >> shift).astype(jnp.int32) & \
            ((jnp.left_shift(1, count) - 1))
        ok = (abs_cur + count <= self.fs * 8) & (count > 0)
        return jnp.where(ok, val, 0)

    def _ext64(self, w0, w1, o, count, abs_cur):
        """Extract `count` bits at local offset `o` of the (w0,w1) window,
        with BitReader.peek end-of-frame masking at absolute position
        `abs_cur`. Shift amounts are clamped so overrun lanes (whose values
        are masked to 0 anyway) never produce out-of-range shifts.

        Callers may read up to offset 59 with count <= 4 (the v3 intensity
        section's worst case is a 4-bit escape value at offset 58, ending at
        62 < 64); the clamp must not be tighter than any legitimate start
        offset or in-window reads get silently shifted."""
        o = jnp.minimum(o, 59)
        use_hi = o >= 32
        oo = jnp.where(use_hi, o - 32, o).astype(jnp.uint32)
        hi = jnp.where(use_hi, w1, w0)
        lo = jnp.where(use_hi, jnp.uint32(0), w1)
        left = (hi << oo) | jnp.where(
            oo > 0, lo >> (jnp.uint32(32) - oo), jnp.uint32(0))
        count = jnp.broadcast_to(jnp.asarray(count, jnp.int32), o.shape)
        shift = (32 - jnp.clip(count, 0, 31)).astype(jnp.uint32)
        val = (left >> shift).astype(jnp.int32) & \
            ((jnp.left_shift(1, count) - 1))
        ok = (abs_cur + count <= self.fs * 8) & (count > 0)
        return jnp.where(ok, val, 0)

    # -- phases --------------------------------------------------------------

    def _sf_symbol(self, ws, o, cur, value, err, act, mode):
        """One scalefactor symbol (delta/abs/zero mode per frame lane).
        mode = (is_abs, is_delta, db, expected, half) per-frame vectors.
        Returns (sf value i32, adv, new value, err)."""
        is_abs, is_delta, db, expected, half = mode
        dcount = jnp.where(is_delta, db, 0)
        delta = self._ext128(ws, o, dcount, cur)
        vabs = self._ext128(ws, o, 6, cur)
        esc = is_delta & (delta == expected)
        vesc = self._ext128(ws, o + dcount, 6, cur + dcount)
        test = value + delta - half
        bad = is_delta & (~esc) & ((test < 0) | (test >= 64))
        vdelta = jnp.where(esc, vesc, (value - half + delta) & 0x3F)
        sf_i = jnp.where(is_abs, vabs, jnp.where(is_delta, vdelta, 0))
        adv = jnp.where(is_abs, 6,
                        jnp.where(is_delta,
                                  dcount + jnp.where(esc, 6, 0), 0))
        adv = jnp.where(act, adv, 0)
        value = jnp.where(act & is_delta, vdelta, value)
        err = err | (act & bad)
        return sf_i, adv, value, err

    _SF_G = 10  # scalefactor symbols per 128-bit window (<= 11 bits each)

    def _scalefactors_channel(self, wa, cur, err, c):
        """One channel's scalefactor section. Returns (sf [N,128], cur, err)."""
        N = cur.shape[0]
        cs = self.cs_counts[c]
        db = self._peek(wa, cur, 3)
        cur = cur + 3
        v0 = self._peek(wa, cur, 6)
        has_first = db > 0
        cur = cur + jnp.where(has_first, 6, 0)
        sf0 = jnp.where(has_first, v0, 0)

        if cs > 1:
            mode = (db >= 6, (db >= 1) & (db <= 5), db,
                    jnp.left_shift(1, db) - 1,
                    (jnp.left_shift(1, db) - 1) >> 1)
            # supersteps: 10 symbols (each <= 5+6 = 11 bits -> all end
            # within the 128-bit window) per fetch; tail padded inactive
            G = self._SF_G
            S = cs - 1
            Sp = -(-S // G) * G
            active = np.zeros((Sp // G, G), dtype=bool)
            active.reshape(-1)[:S] = True

            def step(carry, act):
                cur, value, err = carry
                ws, base = self._win128(wa, cur)
                o = cur - base
                outs = []
                for j in range(G):
                    sf_i, adv, value, err = self._sf_symbol(
                        ws, o, cur, value, err, act[j], mode)
                    outs.append(sf_i.astype(jnp.uint8))
                    cur = cur + adv
                    o = o + adv
                return (cur, value, err), jnp.stack(outs)

            (cur, _v, err), ys = jax.lax.scan(
                step, (cur, sf0, err), jnp.asarray(active))
            ys = ys.reshape(Sp, N)[:S]
            sf_vals = jnp.concatenate(
                [sf0[None].astype(jnp.uint8), ys], axis=0)   # [cs, N]
        else:
            sf_vals = sf0[None].astype(jnp.uint8)

        sf = jnp.zeros((128, N), dtype=jnp.uint8).at[:cs].set(sf_vals)
        extra = self.extras[c]
        if extra:
            # hca.cpp:1352-1355 — note i=0 copies sf[cs] (a zero)
            src = [cs - i for i in range(extra)]
            dst = [127 - i for i in range(extra)]
            sf = sf.at[np.asarray(dst)].set(sf[np.asarray(src)])
        return sf.T, cur, err

    def _inten3_symbol(self, w0, w1, o, cur, value, err, mode3):
        """One v3 intensity follow-up symbol. mode3 = (direct, delta_m,
        bits, bmax) per-frame vectors. Returns (value-out, adv, new value,
        err)."""
        direct, delta_m, bits, bmax = mode3
        v4d = jnp.where(direct, self._ext64(w0, w1, o, 4, cur), 0)
        delta = jnp.where(delta_m, self._ext64(w0, w1, o, bits, cur), 0)
        esc = delta_m & (delta == bmax)
        vesc = self._ext64(w0, w1, o + bits, 4, cur + bits)
        vnew = jnp.where(esc, vesc, value - (bmax >> 1) + delta)
        # reference `value` is unsigned char: a negative differential
        # wraps >= 241 and fails its `> 15` check
        err = err | (delta_m & ((vnew > 15) | (vnew < 0)))
        value = jnp.where(delta_m, vnew, value)
        vi = jnp.where(direct, v4d, jnp.where(delta_m, value, 7))
        adv = jnp.where(direct, 4,
                        jnp.where(delta_m, bits + jnp.where(esc, 4, 0), 0))
        return vi, adv, value, err

    def _intensity_channel(self, wa, cur, err, c, sf_c):
        """Intensity (secondary) / v2 HFR scales (other types). Returns
        (intensity [N,8] u8, sf_c possibly updated, cur, err)."""
        N = cur.shape[0]
        zero8 = jnp.zeros((N, 8), dtype=jnp.uint8)
        if self.ctype[c] == T.STEREO_SECONDARY:
            v4 = self._peek(wa, cur, 4)
            flag = v4 < 15
            if self.version <= VERSION_V200:
                # hca.cpp:1357-1377: intensity[0] stored even when >= 15,
                # cursor advances only when < 15
                cur = cur + jnp.where(flag, 4, 0)
                cols = [v4.astype(jnp.uint8)]
                for _ in range(7):
                    vi = self._peek(wa, cur, 4)
                    cur = cur + jnp.where(flag, 4, 0)
                    cols.append(jnp.where(flag, vi, 0).astype(jnp.uint8))
                inten = jnp.stack(cols, axis=1)
            else:
                # v3: skip(4) in both branches; delta-coded follow-ups.
                # 8 x <= 7-bit symbols all fit one 64-bit window fetched at
                # the section start (4+2 header + 7*7 <= 55 bits).
                w0, w1, base = self._win64(wa, cur)
                o = cur - base
                cur = cur + 4
                o = o + 4
                db2 = self._ext64(w0, w1, o, 2, cur)
                cur = cur + jnp.where(flag, 2, 0)
                o = o + jnp.where(flag, 2, 0)
                value = v4
                mode3 = (flag & (db2 == 3), flag & (db2 < 3),
                         jnp.where(flag & (db2 < 3), db2 + 1, 0),
                         jnp.left_shift(2, db2) - 1)
                cols = [jnp.where(flag, v4, 7).astype(jnp.uint8)]
                for _ in range(7):
                    vi, adv, value, err = self._inten3_symbol(
                        w0, w1, o, cur, value, err, mode3)
                    cols.append((vi & 0xFF).astype(jnp.uint8))
                    cur = cur + adv
                    o = o + adv
                inten = jnp.stack(cols, axis=1)
            return inten, sf_c, cur, err
        if self.version <= VERSION_V200 and self.hfr > 0:
            cols = []
            for _i in range(self.hfr):
                cols.append(self._peek(wa, cur, 6).astype(jnp.uint8))
                cur = cur + 6
            hf = jnp.stack(cols, axis=1)                       # [N, hfr]
            sf_c = sf_c.at[:, 128 - self.hfr:].set(hf)
        return zero8, sf_c, cur, err

    def _noise(self, sf, res, B):
        """PNS noise gather maps (reconstruct_noise, hca.cpp:1602-1635),
        fully parallel. sf/res [N, C, 128] with N = B*F (frame-major per
        stream); returns (src i32, sci u8, mask bool) each [N, C, 8, 128].

        Draw order is subframe-major, channel, noise-slot; each (s,c) with
        nc>0 and vc>0 consumes nc draws. A band's draw ordinal =
        frames-before prefix + s*NC + channels-before prefix + noise rank;
        the LCG state there is a closed-form jump from seed 1 (per stream).
        The drawn 15-bit value picks the (vc-1-j)-th valid band, selected
        by a one-hot match on valid ranks."""
        N = sf.shape[0]
        k = jnp.arange(128, dtype=jnp.int32)
        coded = jnp.asarray(self.coded, jnp.int32)[None, :, None]
        in_coded = k[None, None, :] < coded
        sf_i = sf.astype(jnp.int32)
        active = (sf_i > 0) & in_coded
        noise_f = active & (res.astype(jnp.int32) < 1)
        valid_f = active & (res.astype(jnp.int32) >= 1)
        nrank = jnp.cumsum(noise_f, axis=-1) - 1           # [N, C, 128]
        vrank = jnp.cumsum(valid_f, axis=-1) - 1
        nc = jnp.sum(noise_f, axis=-1)                     # [N, C]
        vc = jnp.sum(valid_f, axis=-1)
        nc_eff = jnp.where((nc > 0) & (vc > 0), nc, 0)
        NC = jnp.sum(nc_eff, axis=-1)                      # [N] draws/subframe
        pre_c = jnp.cumsum(nc_eff, axis=-1) - nc_eff       # [N, C] exclusive
        per_frame = (8 * NC).reshape(B, -1)
        before = (jnp.cumsum(per_frame, axis=1) - per_frame).reshape(N)
        s8 = jnp.arange(8, dtype=jnp.int32)
        ordinal = (before[:, None, None, None]
                   + s8[None, None, :, None] * NC[:, None, None, None]
                   + pre_c[:, :, None, None]
                   + nrank[:, :, None, :])                 # [N, C, 8, 128]
        rand = _lcg_jump(ordinal + 1)                      # state at the draw
        vc_b = vc[:, :, None, None]
        j = (((rand & jnp.uint32(0x7FFF))
              * vc_b.astype(jnp.uint32)) >> 15).astype(jnp.int32)
        target = vc_b - 1 - j                              # valid rank wanted
        # one-hot select the source band and its scalefactor over bands b'
        sel = valid_f[:, :, None, None, :] \
            & (vrank[:, :, None, None, :] == target[..., None])
        vb = jnp.sum(jnp.where(sel, k, 0), axis=-1)        # [N, C, 8, 128]
        sf_vb = jnp.sum(jnp.where(sel, sf_i[:, :, None, None, :], 0), axis=-1)
        sci = jnp.maximum(sf_i[:, :, None, :] - sf_vb + 62, 0)
        mask = (noise_f & (vc > 0)[..., None])[:, :, None, :] \
            & jnp.ones((1, 1, 8, 1), bool)
        src = jnp.where(mask, vb, k[None, None, None, :])
        return (src.astype(jnp.int32), sci.astype(jnp.uint8),
                jnp.broadcast_to(mask, src.shape))

    def _resolutions(self, sf, packed_noise, ath_i32):
        """calc_resolutions (hca.cpp:1444-1494), vectorised [N, C, 128].
        INVERT_TABLE is monotone non-increasing, so invert[cp] equals the
        number of thresholds B_v = max{i : invert[i] >= v} with cp <= B_v —
        14 integer compares instead of a 66-way one-hot reduce."""
        k = jnp.arange(128, dtype=jnp.int32)
        coded = jnp.asarray(self.coded, jnp.int32)[None, :, None]
        sf_i = sf.astype(jnp.int32)
        ath = ath_i32.astype(jnp.int32)[None, None, :]
        noise_level = ath + ((packed_noise[:, None, None] + k) >> 8)
        curve_pos = noise_level + 1 - ((5 * sf_i) >> 1)
        cp = jnp.clip(curve_pos, 0, 65)
        invert = np.asarray(T.INVERT_TABLE, np.int32)
        assert (np.diff(invert) <= 0).all()  # monotone: thresholds valid
        inv = jnp.zeros(cp.shape, jnp.int32)
        for v in range(1, int(invert.max()) + 1):
            inv = inv + (cp <= int(np.max(np.nonzero(invert >= v)[0])))
        r = jnp.where(curve_pos < 0, 15,
                      jnp.where(curve_pos <= 65, inv, 0))
        r = jnp.clip(r, self.min_res, self.max_res)
        r = jnp.where(sf_i > 0, r, 0)
        r = jnp.where(k[None, None, :] < coded, r, 0)
        return r.astype(jnp.uint8)

    _G = 10  # symbols per 128-bit window superstep

    def _res_program(self, res):
        """One subframe's resolutions in program order (channel-major, then
        band) via static slices — no gather. The same program repeats for
        all 8 subframes, so it is built ONCE and the coefficient phase scans
        it 8 times (instead of materialising an 8x tile). [Sp//G, G, N]."""
        N = res.shape[0]
        pieces = [res[:, c, :self.coded[c]] for c in range(self.C)]
        prog = jnp.concatenate(pieces, axis=1).astype(jnp.int32)
        S = prog.shape[1]                                # sum(coded)
        G = self._G
        Sp = -(-S // G) * G
        prog = jnp.pad(prog, ((0, 0), (0, Sp - S)))      # pad rows: r=0 noop
        return prog.T.reshape(Sp // G, G, N), S

    def _vlc_symbol(self, ws, o, cur, r):
        """One VLC symbol at window offset `o` (abs position `cur`):
        returns (value i32, advance i32). The reference form of
        _vlc_symbol_fast (pinned equal by tests)."""
        bits = _max_bit(r)
        code = self._ext128(ws, o, bits, cur)
        big = r > 7
        v_big = (1 - ((code & 1) << 1)) * (code >> 1)
        adv_big = bits - jnp.where(v_big == 0, 1, 0)
        scode = jnp.where(big, 0, code)
        v_small = _nib16(_mux8(_VAL_LO, r), _mux8(_VAL_HI, r), scode) - 8
        adv_small = _nib16(_mux8(_BIT_LO, r), _mux8(_BIT_HI, r), scode)
        value = jnp.where(big, v_big, v_small)
        adv = jnp.where(big, adv_big, adv_small)
        return value, adv

    def _vlc_prog(self, res_prog):
        """Precompute per-symbol VLC data from the resolution program:
        rb = r | (MAX_BIT(r) << 8) (i32) and vb[...,4] = the packed
        (value, advance) byte table for codes 0..15 (u32, _VB layout).
        Computed ONCE per frame-symbol; the coefficient phase replays the
        same program for all 8 subframes, so the four 3-bit muxes + MAX_BIT
        leave the symbol chain. Shapes: res_prog [..., N] ->
        (rb [..., N], vb [..., 4, N])."""
        r = res_prog
        rb = r | (_max_bit(r) << 8)
        small = jnp.minimum(r, 7)
        vb = jnp.stack([_mux8([_VB[rr][k] for rr in range(8)], small)
                        for k in range(4)], axis=-2)
        return rb, vb

    def _vlc_symbol_fast(self, ws, o, cur, rb, vb):
        """_vlc_symbol with the table muxes precomputed (_vlc_prog): rb
        carries r|bits<<8, vb the 4-word packed byte table. Bit-identical
        to _vlc_symbol (pinned by tests)."""
        bits = rb >> 8
        r = rb & 0xFF
        code = self._ext128(ws, o, bits, cur)
        big = r > 7
        v_big = (1 - ((code & 1) << 1)) * (code >> 1)
        adv_big = bits - jnp.where(v_big == 0, 1, 0)
        scode = jnp.where(big, 0, code)
        w = jnp.where(scode >= 8,
                      jnp.where(scode >= 12, vb[3], vb[2]),
                      jnp.where(scode >= 4, vb[1], vb[0]))
        byte = (w >> ((scode & 3) << 3).astype(jnp.uint32)) & jnp.uint32(255)
        byte = byte.astype(jnp.int32)
        value = jnp.where(big, v_big, (byte & 15) - 8)
        adv = jnp.where(big, adv_big, byte >> 4)
        return value, adv

    def _route_qc(self, per_sub, N):
        """Program-order symbols [8, S, N] -> qc [N, C, 8, 128] int16 with
        static slices/pads — no scatter."""
        off = 0
        chans = []
        for c in range(self.C):
            piece = per_sub[:, off:off + self.coded[c], :]
            off += self.coded[c]
            piece = jnp.pad(piece,
                            ((0, 0), (0, 128 - self.coded[c]), (0, 0)))
            chans.append(piece)                          # [8, 128, N]
        qc = jnp.stack(chans, axis=0)                    # [C, 8, 128, N]
        return qc.transpose(3, 0, 1, 2)

    def _coefficients(self, wa, cur, res):
        """8 x C x coded_count VLC reads -> qc [N, C, 8, 128] int16.

        Supersteps: one 128-bit window fetch serves 10 symbols (max 12 bits
        each). VLC tables are closed-form/packed-nibble arithmetic — the
        scan body performs no gathers beyond the window fetch."""
        N = cur.shape[0]
        res_prog, S = self._res_program(res)
        rb_prog, vb_prog = self._vlc_prog(res_prog)
        G = self._G

        def step(cur, xs):
            rbG, vbG = xs
            ws, base = self._win128(wa, cur)
            o = cur - base
            vals = []
            for j in range(G):
                value, adv = self._vlc_symbol_fast(ws, o, cur, rbG[j],
                                                   vbG[j])
                vals.append(value.astype(jnp.int16))
                cur = cur + adv
                o = o + adv
            return cur, jnp.stack(vals)

        subframes = []
        for _s in range(8):
            cur, ys = jax.lax.scan(step, cur, (rb_prog, vb_prog))
            subframes.append(ys.reshape(-1, N)[:S])      # [sum(coded), N]
        per_sub = jnp.stack(subframes, axis=0)           # [8, sum, N]
        return self._route_qc(per_sub, N), cur

    # -- driver --------------------------------------------------------------

    def _unpack(self, frames_u8, cipher_u8, ath_i32, B=1):
        """frames_u8: uint8 [N, frame_size] (enciphered, sync+CRC already
        validated host-side); cipher_u8 [256], ath_i32 [128] as DYNAMIC
        inputs so one compiled program serves every key and sample rate of
        a config (only cipher_identity is static: the identity map skips
        the decipher pass entirely). Returns (qc, sf, res, inten, err,
        noise_src, noise_sci, noise_mask)."""
        N = frames_u8.shape[0]
        if self.cipher_identity:
            dec = frames_u8
        else:
            # arbitrary 256-entry permutation as a binary select tree over
            # the (dynamic) cipher table: 255 selects, no [..., 256] one-hot
            # axis and no gather
            vals = [cipher_u8[i] for i in range(256)]
            idx = frames_u8
            bit = 0
            while len(vals) > 1:
                b = ((idx >> bit) & 1) == 1
                vals = [jnp.where(b, vals[2 * i + 1], vals[2 * i])
                        for i in range(len(vals) // 2)]
                bit += 1
            dec = vals[0].astype(jnp.uint8)
        # aligned u32 word table: wa[:, k] = BE bytes 4k..4k+3, zero-padded
        # past the frame end (BitReader overruns are masked by the callers).
        # bitcast_convert_type groups 4 minor-dim bytes into one LE u32
        # (element 0 least significant); a byteswap flips to BE.
        pad = jnp.zeros((N, self.wn * 4 - self.fs), dtype=jnp.uint8)
        b = jnp.concatenate([dec, pad], axis=1).reshape(N, self.wn, 4)
        le = jax.lax.bitcast_convert_type(b, jnp.uint32)
        wa = ((le << 24) | ((le & jnp.uint32(0xFF00)) << 8)
              | ((le >> 8) & jnp.uint32(0xFF00)) | (le >> 24))
        anl = ((dec[:, 2].astype(jnp.int32) << 1)
               | (dec[:, 3].astype(jnp.int32) >> 7))
        evb = dec[:, 3].astype(jnp.int32) & 0x7F
        packed_noise = (anl << 8) - evb
        cur = jnp.full((N,), 32, dtype=jnp.int32)
        err = jnp.zeros((N,), dtype=bool)

        sf_ch, inten_ch = [], []
        for c in range(self.C):
            sf_c, cur, err = self._scalefactors_channel(wa, cur, err, c)
            inten_c, sf_c, cur, err = self._intensity_channel(
                wa, cur, err, c, sf_c)
            sf_ch.append(sf_c)
            inten_ch.append(inten_c)
        sf = jnp.stack(sf_ch, axis=1)          # [N, C, 128]
        inten = jnp.stack(inten_ch, axis=1)    # [N, C, 8]
        res = self._resolutions(sf, packed_noise, ath_i32)
        qc, cur = self._coefficients(wa, cur, res)
        if self.need_noise:
            nsrc, nsci, nmask = self._noise(sf, res, B)
        else:
            nsrc = jnp.zeros((1,) * 4, jnp.int32)
            nsci = jnp.zeros((1,) * 4, jnp.uint8)
            nmask = jnp.zeros((1,) * 4, bool)
        return qc, sf, res, inten, err, nsrc, nsci, nmask

    def __call__(self, frames_u8, cipher_u8=None, ath_i32=None, B=1):
        # Defaults come from the info this instance was BUILT with; when the
        # instance came from get_unpacker (cached without cipher/rate), pass
        # cipher/ath explicitly or a different-keyed stream would silently
        # decode with the first caller's tables.
        if cipher_u8 is None:
            cipher_u8 = self.cipher
        if ath_i32 is None:
            ath_i32 = self.ath
        return self._jit(frames_u8, np.asarray(cipher_u8, np.uint8),
                         np.asarray(ath_i32, np.int32), B=B)


_unpacker_cache: dict = {}


def get_unpacker(info) -> DeviceUnpacker:
    """Config-keyed DeviceUnpacker cache: building one traces/compiles the
    full unpack program (tens of seconds), so repeated
    same-config calls must reuse it. The cipher table and ATH curve are
    DYNAMIC inputs to the compiled program (pass them to __call__), so the
    key carries only the identity-cipher flag — one program serves every
    key and sample rate of a config. Raises ValueError for host-only
    configs, also cached."""
    key = (info.channels, info.version, info.frame_size,
           info.min_resolution, info.max_resolution, info.total_band_count,
           info.base_band_count, info.stereo_band_count,
           info.bands_per_hfr_group, info.hfr_group_count,
           info.channel_config, info.track_count, info.ath_type,
           bool(np.array_equal(np.asarray(info.cipher, np.uint8),
                               np.arange(256, dtype=np.uint8))))
    hit = _unpacker_cache.get(key)
    if hit is None:
        try:
            hit = DeviceUnpacker(info)
        except ValueError as exc:
            hit = exc
        _unpacker_cache[key] = hit
    if isinstance(hit, ValueError):
        raise ValueError(str(hit))
    return hit


def unpack_frames_device(info, data: bytes, check_crc: bool = True):
    """Convenience wrapper mirroring hca_frame.unpack_frames for one stream:
    validates sync+CRC host-side, runs the device unpack, raises HcaError on
    any per-frame error flag (host-path parity). Returns UnpackedFrames with
    numpy arrays (tests/fallback use; the pipeline keeps results on device).
    """
    from . import hca_frame
    from ..utils.crc import crc16_batch

    fs = info.frame_size
    nframes = len(data) // fs
    frames = np.frombuffer(data, dtype=np.uint8,
                           count=nframes * fs).reshape(nframes, fs)
    if not (frames[:, 0] == 0xFF).all() or not (frames[:, 1] == 0xFF).all():
        raise hca_frame.HcaError("Frame sync lost")
    if check_crc and crc16_batch(frames).any():
        raise hca_frame.HcaError("Frame checksum mismatch")
    up = get_unpacker(info)
    qc, sf, res, inten, err, nsrc, nsci, nmask = up(
        frames, info.cipher, info.ath)
    if bool(np.asarray(err).any()):
        raise hca_frame.HcaError("Unpack error (device)")
    N, C = nframes, info.channels
    if up.need_noise:
        noise_src = np.asarray(nsrc)
        noise_sci = np.asarray(nsci)
        noise_mask = np.asarray(nmask)
        # final LCG state for host-path parity: jump by the total draws
        sfn = np.asarray(sf)
        resn = np.asarray(res)
        total = 0
        for f in range(N):
            for c in range(C):
                cc = int(info.coded_count[c])
                act = sfn[f, c, :cc] > 0
                nc = int((act & (resn[f, c, :cc] < 1)).sum())
                vc = int((act & (resn[f, c, :cc] >= 1)).sum())
                if nc > 0 and vc > 0:
                    total += 8 * nc
        state = 1
        for a, b in _LCG_POWS:
            if total & 1:
                state = (a * state + b) & 0xFFFFFFFF
            total >>= 1
            if not total:
                break
        random_state = state
    else:
        noise_src = np.broadcast_to(np.arange(128, dtype=np.int32),
                                    (N, C, 8, 128)).copy()
        noise_sci = np.zeros((N, C, 8, 128), dtype=np.uint8)
        noise_mask = np.zeros((N, C, 8, 128), dtype=bool)
        random_state = 1
    return hca_frame.UnpackedFrames(
        qc=np.asarray(qc), scalefactors=np.asarray(sf),
        resolutions=np.asarray(res), intensity=np.asarray(inten),
        noise_src=noise_src, noise_sci=noise_sci, noise_mask=noise_mask,
        random_state=random_state)
