"""Device-side HFR scale normalisation (the encoder's last host-f64 stage).

Reference math (hca.cpp:2689-2706, mirrored by hca_encode_host.py::
calc_hfr_scales): per (frame, channel, group)

    avg  = f32(ga / count)            # f32 division
    avg2 = f32(gs / count2)           # f32 division
    if avg2 > 0:
        factor = min(round64(1 / avg2), sqrt(2))      # f64
        v = f32(round64(avg * factor))                # f64 product, f32 cast
    else:
        v = avg
    scale = FindScaleFactor(v)        # count of SCALING_TABLE entries <= v

The device path runs in f32, but every f64 operation above only feeds *comparisons*
against the 64 static SCALING_TABLE thresholds, and rounding is monotone:

    round32(y) >= t   <=>   y >= lo32(t)     (lo32 = least f64 rounding >= t)
    round64(x) >= u   <=>   x >= lo64(u)

so FindScaleFactor(v) = sum_i [ avg * factor >= L_i ] with static real
boundaries L_i = lo64(lo32(tab_i)).  In the division branch factor =
round64(1/avg2), hence

    avg * factor >= L_i   <=>   avg >= L_i * avg2     (up to 2^-53 rel)

and in the sqrt2 branch  avg * sqrt2_64 >= L_i  directly.  Both sides are
evaluated in f32-pair (Dekker TwoProd / Knuth TwoSum) arithmetic — error
~2^-45 relative — and every comparison lands either clearly on one side or
inside a guard band of 2^-38 relative, in which case the (frame) raises a
GUARD FLAG and the caller reroutes that stream to the exact host encoder.
The guard band covers the pair-arithmetic error, the 2^-53 reciprocal-
rounding ambiguity, and the lo64-vs-lo32 boundary gap (2^-54), so an
unflagged result is provably byte-identical to the host chain.  Flag
probability is ~2^-30 per comparison on real content (the band is ~2^-38
of a ~2^-8-wide scale bucket); flagged frames are correct, just rerouted.

The f32 divisions are made correctly-rounded (a backend may lower f32 divide
via reciprocal+Newton with no rounding guarantee): candidates q0 and q0+-1ulp
are scored by their exact residuals |ga - q*count| (TwoProd; the residual
subtraction is exact by Sterbenz), ties broken to the even mantissa —
bit-identical to the host's IEEE division.  A 2-ulp-off q0 or a flushed
subnormal quotient also raises the guard flag.
"""
from __future__ import annotations

import math

import numpy as np

import jax.numpy as jnp
from jax import lax

from . import hca_tables as T

f32 = jnp.float32
i32 = jnp.int32

_GUARD_REL = np.float32(2.0 ** -38)
_SPLIT = np.float32(4097.0)          # 2^12 + 1, Dekker split for f32


# ---------------------------------------------------------------------------
# f32-pair primitives (elementwise, XLA-friendly)
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _pair_add(xh, xl, yh, yl):
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    hi, lo = _two_sum(s, e)
    return hi, lo


def _pair_prod_const(a, const_terms):
    """a (f32 tensor) times a static multi-f32 constant -> f32 pair."""
    h = jnp.zeros_like(a)
    l = jnp.zeros_like(a)
    for t in const_terms:
        if float(t) == 0.0:
            continue
        p, e = _two_prod(a, f32(t))
        h, l = _pair_add(h, l, p, e)
    return h, l


# ---------------------------------------------------------------------------
# static boundary precomputation (Python, exact f64 bit tricks)
# ---------------------------------------------------------------------------

def _f32_terms(x: float, n: int = 3):
    """x (Python float) as an exact descending sum of n float32 terms."""
    out = []
    r = float(x)
    for _ in range(n):
        t = np.float32(r)
        out.append(float(t))
        r -= float(t)
    return out


def _lo32(t32: np.float32) -> float:
    """Least f64 whose round-to-nearest-even f32 value is >= t32 (t32 > 0)."""
    t = float(t32)
    pred = float(np.nextafter(t32, np.float32(0.0)))
    mid = (t + pred) / 2.0            # exact in f64 (<= 25 significant bits)
    if float(np.float32(mid)) == t:   # midpoint rounds up (t has even LSB)
        return mid
    return float(np.nextafter(mid, math.inf))


_TAB = np.asarray(T.SCALING_TABLE, np.float32)       # [64], increasing
_L_TERMS = [_f32_terms(_lo32(t)) for t in _TAB]       # exact f32 triples
_SQRT2_TERMS = _f32_terms(math.sqrt(2.0))
# round64(1/avg2) <= sqrt2_64  <=>  1/avg2 < midpoint(sqrt2_64, succ64)
# (the exact-midpoint tie sits inside the guard band): compare
# avg2 * mid > 1 instead — mid as exact f32 terms.  sqrt2 + ulp64/2 is NOT
# an f64 (54 bits), so the midpoint is assembled as terms(sqrt2) + [ulp/2]
# (ulp/2 is a power of two, exactly an f32).
_SQRT2_MID_TERMS = _SQRT2_TERMS + [
    (math.nextafter(math.sqrt(2.0), math.inf) - math.sqrt(2.0)) / 2.0]


# ---------------------------------------------------------------------------
# correctly-rounded f32 division by a small static int
# ---------------------------------------------------------------------------

def _residual(x, q, n):
    """Exact |x - q*n| and its sign, for q within 2 ulp of x/n."""
    p, e = _two_prod(q, f32(n))
    # x - p is exact by Sterbenz (p within a factor 2 of x); e is exact
    return (x - p) - e


def _div_exact(x, n: int):
    """round-to-nearest-even f32 of x/n (x >= 0 f32 tensor, n static int).

    Returns (q, guard): guard set where correctness can't be certified
    (q0 more than 1 ulp off, or subnormal-flush territory).
    """
    # subnormal land (x/n): backends flush-to-zero while the host's numpy
    # keeps subnormals — certify nothing there, reroute to host.  A
    # subnormal INPUT x is outside the contract entirely: XLA flushes it at
    # load so (x > 0) is already false here; in the pipeline ga/gs are
    # produced by the device transform, which flushed them identically.
    tiny = (x > 0) & (x < f32(2.0 ** -110))
    if n & (n - 1) == 0:              # power of two: exact rescale
        return x * f32(1.0 / n), tiny
    q0 = x / f32(n)
    bits = lax.bitcast_convert_type(q0, jnp.int32)
    qdn = lax.bitcast_convert_type(bits - 1, f32)
    qup = lax.bitcast_convert_type(bits + 1, f32)
    r0 = jnp.abs(_residual(x, q0, n))
    rdn = jnp.abs(_residual(x, qdn, n))
    rup = jnp.abs(_residual(x, qup, n))
    # pick min residual; ties to even mantissa (host IEEE semantics)
    q = q0
    r = r0
    even_dn = (bits & 1) == 1         # qdn even <=> q0 odd
    take_dn = (rdn < r) | ((rdn == r) & even_dn)
    q = jnp.where(take_dn, qdn, q)
    r = jnp.where(take_dn, rdn, r)
    even_up = (bits & 1) == 1
    take_up = (rup < r) | ((rup == r) & even_up & ~take_dn)
    q = jnp.where(take_up, qup, q)
    r = jnp.where(take_up, rup, r)
    # certification: winning residual must be <= n * ulp(q)/2 (else q0 was
    # >1 ulp off and the true quotient is outside the candidate set)
    ulp_half = jnp.abs(qup - q0) * f32(0.5)
    guard = tiny | ((x > 0)
                    & (r > f32(n) * ulp_half * f32(1.0000001)))
    q = jnp.where(x == 0, f32(0.0), q)
    return q, guard


# ---------------------------------------------------------------------------
# the normalisation itself
# ---------------------------------------------------------------------------

def _group_counts(info, hfr_band_count: int):
    """(count, count2) per group, mirroring calc_hfr_scales' band walk."""
    G = info.hfr_group_count
    bpg = info.bands_per_hfr_group
    start = info.stereo_band_count + info.base_band_count
    capped = min(hfr_band_count, info.total_band_count - hfr_band_count)
    counts, counts2 = [], []
    band = 0
    band2 = 0
    for _ in range(G):
        n = 0
        for _ in range(bpg):
            if start + band >= 128:
                break
            band += 1
            n += 8
        counts.append(n)
        n2 = 0
        for _ in range(bpg):
            if band2 >= capped:
                break
            band2 += 1
            n2 += 8
        counts2.append(n2)
    return counts, counts2


def hfr_scales_device(ga, gs, *, counts, counts2, channel_types):
    """[B,F,C,G] f32 group sums -> (scales i32 [B,F,C,G], guard bool [B,F]).

    counts/counts2: static per-group divisors from _group_counts.
    Byte-identical to hca_encode_host.calc_hfr_scales wherever guard is
    False; guard=True frames must reroute to the host encoder.
    """
    # ga/gs carry a padded group axis of max(G, 1); the real group count is
    # len(counts) (== info.hfr_group_count), zero for no-HFR configs
    B, F, C = ga.shape[:3]
    G = len(counts)
    scales = []
    guard = jnp.zeros((B, F), bool)
    sec = np.asarray([t == T.STEREO_SECONDARY for t in channel_types])
    for g in range(G):
        n = counts[g]
        n2 = counts2[g]
        if n == 0:
            scales.append(jnp.zeros((B, F, C), i32))
            continue
        avg, gd = _div_exact(ga[..., g], n)
        guard = guard | gd.any(axis=-1)
        if n2 == 0:
            s = jnp.sum((avg[..., None] >= jnp.asarray(_TAB)).astype(i32),
                        axis=-1)
            scales.append(jnp.minimum(s, 63))
            continue
        avg2, gd2 = _div_exact(gs[..., g], n2)
        guard = guard | gd2.any(axis=-1)
        upd = avg2 > 0

        # branch select: factor = sqrt2 iff round64(1/avg2) > sqrt2_64
        # <=> avg2 * mid64 < 1 (mid64 = midpoint(sqrt2, succ64(sqrt2)))
        mh, ml = _pair_prod_const(avg2, _SQRT2_MID_TERMS)
        dh, dl = _pair_add(mh, ml, f32(-1.0), f32(0.0))
        d = dh + dl
        use_sqrt2 = d < 0
        guard = guard | (upd & (jnp.abs(d) <= _GUARD_REL)).any(axis=-1)

        # sqrt2 branch left side: avg * sqrt2 as a pair
        s2h, s2l = _pair_prod_const(avg, _SQRT2_TERMS)

        s_upd = jnp.zeros((B, F, C), i32)
        for i in range(64):
            lt = _L_TERMS[i]
            # div branch: d = avg - L_i * avg2
            ph, pl = _pair_prod_const(avg2, lt)
            d1h, d1l = _pair_add(avg, jnp.zeros_like(avg), -ph, -pl)
            d1 = d1h + d1l
            scale1 = avg + ph
            # sqrt2 branch: d = avg*sqrt2 - L_i
            Lh = f32(lt[0])
            Ll = f32(lt[1] + lt[2])
            d2h, d2l = _pair_add(s2h, s2l, -Lh, -Ll)
            d2 = d2h + d2l
            scale2 = jnp.abs(s2h) + jnp.abs(Lh)
            d_i = jnp.where(use_sqrt2, d2, d1)
            sc = jnp.where(use_sqrt2, scale2, scale1)
            s_upd = s_upd + (d_i >= 0).astype(i32)
            guard = guard | (upd & (jnp.abs(d_i) <= _GUARD_REL * sc)
                             ).any(axis=-1)
        s_upd = jnp.minimum(s_upd, 63)

        s_raw = jnp.minimum(
            jnp.sum((avg[..., None] >= jnp.asarray(_TAB)).astype(i32),
                    axis=-1), 63)
        scales.append(jnp.where(upd, s_upd, s_raw))
    out = jnp.stack(scales, axis=-1) if scales else \
        jnp.zeros((B, F, C, max(G, 1)), i32)
    if out.shape[-1] < max(G, 1):
        out = jnp.concatenate(
            [out, jnp.zeros((B, F, C, max(G, 1) - out.shape[-1]), i32)],
            axis=-1)
    out = jnp.where(jnp.asarray(sec)[None, None, :, None], 0, out)
    return out, guard
