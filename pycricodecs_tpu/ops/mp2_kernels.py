"""MPEG Layer II device kernels (JAX) + numpy references (for the AHX codec).

Formulation: the ISO synthesis filterbank (matrixing + window
overlap) is a 16-tap FIR of 32x32 matrices with no serial state.  The DEVICE
path evaluates it as two block-Toeplitz [512, 512] matmuls (``_w_blocks``):
rows group 16 time steps, so out[b] = X[b-1] @ A + X[b] @ B over a dense
[T/16, 512] relayout — no 16-way shifted concat (16x HBM) and no lane-padded
[T, 32] temps.  The NUMPY reference (``synthesize_np``) keeps the original
stacked form: pcm[t*32:(t+1)*32] = concat(S_t, ..., S_{t-15}) @ W with one
constant W[512, 32] folding the cosine matrixing and the 512-tap window
(a [C*T, 512] x [512, 32] matmul).  The analysis filterbank (encoder) is the
same shape in reverse.

Dequantisation is closed-form elementwise: value = (2c + 1 - n) / n * sf.

Numpy (float64) references double as the no-JAX fallback and the parity
oracle for the float32 device path.
"""
from __future__ import annotations

from functools import partial

import numpy as np

from . import mp2_tables as T

_PART_OF_ROW = np.arange(36) // 12      # sample row -> scalefactor part


def _w512(dtype) -> np.ndarray:
    """W[512, 32]: block k rows are G[k].T (pcm = window_stack @ W)."""
    G = T.synthesis_matrices(np.float64)          # [16, 32, 32]
    return np.transpose(G, (0, 2, 1)).reshape(512, 32).astype(dtype)


def _w_blocks(dtype):
    """Block-Toeplitz synthesis constants A, B [512, 512].

    Grouping 16 time steps per row (X[b] = sb rows 16b..16b+15 flattened to
    512 lanes), the 16-tap FIR of 32x32 matrices becomes exactly
    out[b] = X[b-1] @ A + X[b] @ B, where
      B[j*32:(j+1)*32, r*32:(r+1)*32] = G[r-j].T   for 0 <= r-j <= 15
      A[j*32:(j+1)*32, r*32:(r+1)*32] = G[r-j+16].T for j > r.
    Same nonzero products as the [T, 512] @ W form, but the operand stays a
    dense [T/16, 512] relayout of the subband tensor — no 16-way shifted
    concat (16x memory traffic) and no [T, 32] lane-padded temps."""
    G = T.synthesis_matrices(np.float64)          # [16, 32, 32]
    GT = np.transpose(G, (0, 2, 1))
    A = np.zeros((512, 512), np.float64)
    B = np.zeros((512, 512), np.float64)
    for r in range(16):
        for j in range(16):
            if 0 <= r - j <= 15:
                B[j * 32:(j + 1) * 32, r * 32:(r + 1) * 32] = GT[r - j]
            elif j > r:
                A[j * 32:(j + 1) * 32, r * 32:(r + 1) * 32] = GT[r - j + 16]
    return A.astype(dtype), B.astype(dtype)


def dequantize_np(codes: np.ndarray, levels: np.ndarray,
                  sfidx: np.ndarray, dtype=np.float64) -> np.ndarray:
    """[F, C, 36, 32] codes -> subband samples (silent bands = 0)."""
    sf_table = T.scalefactors(np.float64)
    n = levels[:, :, None, :].astype(np.float64)            # [F, C, 1, 32]
    sf = sf_table[sfidx][:, :, _PART_OF_ROW, :]             # [F, C, 36, 32]
    with np.errstate(divide="ignore", invalid="ignore"):
        val = (2.0 * codes + 1.0 - n) / n * sf
    return np.where(n > 0, val, 0.0).astype(dtype)


def synthesize_np(subband: np.ndarray) -> np.ndarray:
    """[..., T, 32] subband samples -> [..., T*32] PCM in +-1 scale."""
    sb = np.asarray(subband, dtype=np.float64)
    lead = sb.shape[:-2]
    Tn = sb.shape[-2]
    pad = np.concatenate(
        [np.zeros(lead + (15, 32)), sb], axis=-2)
    stack = np.concatenate(
        [pad[..., 15 - k:15 - k + Tn, :] for k in range(16)], axis=-1)
    out = stack @ _w512(np.float64)
    return out.reshape(lead + (Tn * 32,))


def analyze_np(pcm: np.ndarray) -> np.ndarray:
    """[..., N] PCM (+-1 scale, N % 32 == 0) -> [..., N/32, 32] subbands.

    ISO analysis: X[0] is the NEWEST sample (window reversed), Z = C_win * X,
    Y[q] = sum_r Z[q + 64r], S = M @ Y.  481-sample total codec delay.
    """
    x = np.asarray(pcm, dtype=np.float64)
    lead = x.shape[:-1]
    N = x.shape[-1]
    Tn = N // 32
    xp = np.concatenate([np.zeros(lead + (480,)), x], axis=-1)
    idx = np.arange(Tn)[:, None] * 32 + 511 - np.arange(512)[None, :]
    frames = xp[..., idx]                           # [..., T, 512] newest-first
    Z = frames * T.analysis_window(np.float64)
    Y = Z.reshape(lead + (Tn, 8, 64)).sum(axis=-2)
    return Y @ T.analysis_matrix(np.float64).T


def analyze_fast(pcm: np.ndarray) -> np.ndarray:
    """Same maths as ``analyze_np`` without materialising the [T, 512]
    sliding window: with q = 32h + m the window fold becomes 16 shifted
    [T, 32] row accumulations over the 32-sample block grid,
      Y[t, 32h+m] = sum_r win[32h+m+64r] * x32[t + 15 - h - 2r, 31 - m],
    then S = Y @ M.T as before.  Differs from analyze_np only in f64
    association order (~1e-15 relative); the encoder uses this lane, the
    stacked form stays as the reference/parity oracle."""
    x = np.asarray(pcm, dtype=np.float64)
    lead = x.shape[:-1]
    N = x.shape[-1]
    Tn = N // 32
    win = T.analysis_window(np.float64)
    xp = np.concatenate([np.zeros(lead + (512,)), x], axis=-1)
    x32r = xp.reshape(lead + (Tn + 16, 32))[..., ::-1]   # block-reversed
    Y = np.zeros(lead + (Tn, 64))
    for h in range(2):
        for r in range(8):
            w = win[32 * h + np.arange(32) + 64 * r]
            s0 = 16 - h - 2 * r                # +16: one extra zero block
            Y[..., :, 32 * h:32 * h + 32] += w * x32r[..., s0:s0 + Tn, :]
    return Y @ T.analysis_matrix(np.float64).T


def pcm16(x: np.ndarray) -> np.ndarray:
    """+-1-scale float -> int16 (round-half-away, clipped)."""
    y = np.asarray(x, dtype=np.float64) * 32768.0
    return np.clip(np.floor(y + 0.5), -32768, 32767).astype(np.int16)


def decode_pcm16_host(codes: np.ndarray, levels: np.ndarray,
                      sfidx: np.ndarray) -> np.ndarray:
    """[F, C, 36, 32] codes -> int16 PCM [C, F*36*32] (host engine).

    Fast lane: the C++ core's factored V-FIFO synthesis (cricore.cpp
    cri_mp2_synthesize — matrixing once per granule + 16-tap windowed sum,
    80 MACs/sample vs the stacked matmul's 512).  Fallback: the float64
    numpy reference chain.  Dequantisation is bit-identical between the
    two; the synthesis differs only in f64 association order, within the
    package-wide 1-LSB engine fence (tests/test_ahx.py pins both to
    libmpg123)."""
    from .. import native

    F, C = codes.shape[0], codes.shape[1]
    lib = native.load()
    if lib is not None:
        import ctypes

        from . import mp2_tables as _T

        codes = np.ascontiguousarray(codes, dtype=np.uint16)
        levels = np.ascontiguousarray(levels, dtype=np.int32)
        sfidx = np.ascontiguousarray(sfidx, dtype=np.uint8)
        sf = np.ascontiguousarray(_T.scalefactors(np.float64))
        nt = np.ascontiguousarray(_T.synthesis_matrixing(np.float64).T)
        dwin = np.ascontiguousarray(_T.synth_window(np.float64))
        pcm = np.empty((C, F * 36 * 32), dtype=np.int16)
        p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
        lib.cri_mp2_synthesize(
            p(codes, ctypes.c_uint16), p(levels, ctypes.c_int32),
            p(sfidx, ctypes.c_uint8), F, C,
            p(sf, ctypes.c_double), p(nt, ctypes.c_double),
            p(dwin, ctypes.c_double), p(pcm, ctypes.c_int16))
        return pcm
    sb = dequantize_np(codes, levels, sfidx)
    sb = np.transpose(sb, (1, 0, 2, 3)).reshape(C, F * 36, 32)
    return pcm16(synthesize_np(sb))


# --- JAX device path ---------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _decode_jax_impl(codes, levels, sfidx, sf_table, part_of_row, w_a, w_b):
    import jax as _j
    _, jnp = _jax()
    # the cached closures hold these as NUMPY (a jnp constant built during
    # an outer trace would leak that trace's tracers); lift per trace here —
    # numpy can't be indexed by tracers
    sf_table = jnp.asarray(sf_table)
    part_of_row = jnp.asarray(part_of_row)
    n = levels[:, :, None, :].astype(jnp.float32)
    sf = sf_table[sfidx][:, :, part_of_row, :]
    val = (2.0 * codes.astype(jnp.float32) + 1.0 - n) / jnp.where(n > 0, n, 1.0)
    sb = jnp.where(n > 0, val * sf, 0.0)                   # [F, C, 36, 32]
    F, C = sb.shape[0], sb.shape[1]
    Tn = F * 36
    T16 = -(-Tn // 16) * 16
    sb = jnp.transpose(sb, (1, 0, 2, 3)).reshape(C, Tn, 32)
    if T16 != Tn:
        sb = jnp.pad(sb, ((0, 0), (0, T16 - Tn), (0, 0)))
    # 16 time steps per row: dense [T/16, 512] operand, block-Toeplitz FIR
    # (see _w_blocks) — prev-block term is a one-row shift, not a 16-way
    # shifted concat. full-fp32 matmuls: a default-precision dot may use
    # reduced-precision multiplicands (tens of int16 LSB of error); HIGHEST
    # keeps the device within 1 LSB of the float64 reference (tests +
    # chip_smoke.py)
    x = sb.reshape(C, T16 // 16, 512)
    xp = jnp.concatenate([jnp.zeros((C, 1, 512), jnp.float32), x[:, :-1]],
                         axis=1)
    # NB: splitting the 512-dot into two matmuls + add costs one extra fp32
    # rounding per sample vs single-dot accumulation; the <=1 LSB parity
    # tests/guards are the fence.  If a future content case trips 2 LSB,
    # concatenate [xp, x] on the contraction axis against [w_a; w_b].
    out = jnp.matmul(x, w_b, precision=_j.lax.Precision.HIGHEST) \
        + jnp.matmul(xp, w_a, precision=_j.lax.Precision.HIGHEST)
    pcm = out.reshape(C, T16 * 32)[:, :Tn * 32] * 32768.0
    return jnp.clip(jnp.floor(pcm + 0.5), -32768, 32767).astype(jnp.int16)


_decode_jit = None


def decode_transform_device(codes: np.ndarray, levels: np.ndarray,
                            sfidx: np.ndarray) -> np.ndarray:
    """Full device decode: dequantise + one-matmul synthesis -> int16 [C, N].

    float32 on device; differs from the float64 numpy reference by at most
    1 LSB after int16 rounding (tests measure it).
    """
    global _decode_jit
    jax, jnp = _jax()
    if _decode_jit is None:
        # numpy constants only — see analyze_device: a jnp constant built
        # while tracing would be cached as a dead tracer for later traces
        sf_table = T.scalefactors(np.float32)
        part = np.asarray(_PART_OF_ROW)
        w_a, w_b = _w_blocks(np.float32)
        _decode_jit = jax.jit(partial(_decode_jax_impl, sf_table=sf_table,
                                      part_of_row=part, w_a=w_a, w_b=w_b))
    return np.asarray(_decode_jit(codes, levels.astype(np.int32), sfidx))


def _analyze_jax_impl(x, c_win, m_t):
    import jax as _j
    _, jnp = _jax()
    C, N = x.shape
    Tn = N // 32
    xp = jnp.concatenate([jnp.zeros((C, 480), jnp.float32), x], axis=-1)
    idx = (jnp.arange(Tn)[:, None] * 32 + 511 - jnp.arange(512)[None, :])
    frames = xp[:, idx]                                    # [C, T, 512]
    Z = frames * c_win
    Y = Z.reshape(C, Tn, 8, 64).sum(axis=2)
    return jnp.matmul(Y, m_t, precision=_j.lax.Precision.HIGHEST)


_analyze_jit = None


def analyze_device(pcm: np.ndarray) -> np.ndarray:
    """[C, N] +-1-scale float32 -> [C, N/32, 32] subband samples (device)."""
    global _analyze_jit
    jax, jnp = _jax()
    if _analyze_jit is None:
        # close over NUMPY constants: jnp.asarray here would create tracers
        # when the first caller sits inside an outer jit trace, and the
        # cached closure would leak them into every later trace
        c_win = T.analysis_window(np.float32)
        m_t = np.ascontiguousarray(T.analysis_matrix(np.float32).T)
        _analyze_jit = jax.jit(partial(_analyze_jax_impl, c_win=c_win,
                                       m_t=m_t))
    return np.asarray(_analyze_jit(np.asarray(pcm, dtype=np.float32)))


_decode_batched_jit = None


def dispatch_decode_batched(codes, levels, sfidx):
    """Async batched device decode: [B, F, C, 36, 32] -> device int16
    [B, C, F*36*32] (no host copy — callers fetch with np.asarray, so the
    slow device->host link overlaps later dispatches).

    One compiled program per (B, F, C) bucket; padded frames (levels == 0)
    dequantise to silence, so callers trim per stream after the fact.
    """
    global _decode_batched_jit
    jax, jnp = _jax()
    if _decode_batched_jit is None:
        # numpy constants only — see analyze_device: a jnp constant built
        # while tracing would be cached as a dead tracer for later traces
        sf_table = T.scalefactors(np.float32)
        part = np.asarray(_PART_OF_ROW)
        w_a, w_b = _w_blocks(np.float32)
        fn = partial(_decode_jax_impl, sf_table=sf_table, part_of_row=part,
                     w_a=w_a, w_b=w_b)
        _decode_batched_jit = jax.jit(jax.vmap(fn))
    if hasattr(levels, "astype") and levels.dtype != np.int32:
        levels = levels.astype(np.int32)
    return _decode_batched_jit(codes, levels, sfidx)


def decode_transform_device_batched(codes: np.ndarray, levels: np.ndarray,
                                    sfidx: np.ndarray) -> np.ndarray:
    """Blocking wrapper over dispatch_decode_batched (returns host numpy)."""
    return np.asarray(dispatch_decode_batched(codes, levels, sfidx))
