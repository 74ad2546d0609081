"""ADX parity tests vs the reference C++ extension (bit-exact)."""
import numpy as np
import pytest

from pycricodecs_tpu.models import adx as adxmod
from pycricodecs_tpu.utils.wav import parse_wav, write_wav
from tests.conftest import make_sine_pcm16


def _wav_bytes(samples=2048, channels=1, sr=48000, looping=False, seed=0):
    pcm = make_sine_pcm16(samples, channels, sr, seed=seed)
    # Start silent so the first block's scale is zero; the reference decoder's
    # CRI-string check reads one byte into the first block (adx.cpp:345-348)
    # and rejects files where that byte is non-zero.
    pcm[: 64 * channels] = 0
    return write_wav(pcm, channels, sr, looping=looping,
                     loop_start=128, loop_end=samples - 256)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("mode", [2, 3, 4])
def test_encode_matches_reference(oracle, channels, mode):
    wav = _wav_bytes(channels=channels, seed=channels * 10 + mode)
    ours = adxmod.encode(wav, encoding_mode=mode)
    ref = oracle.AdxEncode(wav, 4, 0x12, mode, 0x1F4, 0, 4, False)
    assert ours == ref


def _outcome(fn, *args):
    """Run fn, capturing either its result or the raised error message.

    The reference decoder rejects some of its own encodes (its CRI-string
    check reads one byte into the first audio block, adx.cpp:345-348); parity
    means we reject them identically.
    """
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001
        return ("err", str(exc))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("mode", [2, 3, 4])
def test_decode_matches_reference(oracle, channels, mode):
    wav = _wav_bytes(channels=channels, seed=7 + channels + mode)
    adx_bytes = oracle.AdxEncode(wav, 4, 0x12, mode, 0x1F4, 0, 4, False)
    ours = _outcome(adxmod.decode, adx_bytes)
    ref = _outcome(oracle.AdxDecode, bytes(adx_bytes))
    assert ours == ref


@pytest.mark.parametrize("bit_depth", [2, 3, 4, 5, 6, 8])
def test_bitdepths_roundtrip_vs_reference(oracle, bit_depth):
    # block bits (0x10*8=128) must divide by bit depth
    if 128 % bit_depth != 0:
        pytest.skip("bit depth does not fit default block size")
    wav = _wav_bytes(samples=1024, seed=bit_depth)
    ours = adxmod.encode(wav, bit_depth=bit_depth)
    ref = oracle.AdxEncode(wav, bit_depth, 0x12, 3, 0x1F4, 0, 4, False)
    assert ours == ref
    assert _outcome(adxmod.decode, ours) == _outcome(oracle.AdxDecode, bytes(ref))


@pytest.mark.parametrize("version", [3, 4, 5])
def test_versions_vs_reference(oracle, version):
    wav = _wav_bytes(samples=1536, channels=2, seed=version)
    ours = adxmod.encode(wav, version=version)
    ref = oracle.AdxEncode(wav, 4, 0x12, 3, 0x1F4, 0, version, False)
    assert ours == ref
    assert _outcome(adxmod.decode, ours) == _outcome(oracle.AdxDecode, bytes(ref))


def test_looping_encode_vs_reference(oracle):
    wav = _wav_bytes(samples=4096, channels=2, looping=True, seed=42)
    ours = adxmod.encode(wav)
    ref = oracle.AdxEncode(wav, 4, 0x12, 3, 0x1F4, 0, 4, False)
    assert ours == ref
    assert _outcome(adxmod.decode, ours) == _outcome(oracle.AdxDecode, bytes(ref))


def test_numpy_and_jax_paths_agree():
    wav = _wav_bytes(samples=1024, channels=2, seed=5)
    assert adxmod.encode(wav, use_jax=True) == adxmod.encode(wav, use_jax=False)
    enc = adxmod.encode(wav)
    assert adxmod.decode(enc, use_jax=True) == adxmod.decode(enc, use_jax=False)


def test_roundtrip_tracks_input():
    """Decoded ADPCM output stays close to the original signal."""
    wav = _wav_bytes(samples=2048, channels=1, seed=9)
    decoded = adxmod.decode(adxmod.encode(wav))
    a = parse_wav(wav).pcm16.astype(np.float64)
    b = parse_wav(decoded).pcm16.astype(np.float64)[: a.size]
    err = np.sqrt(np.mean((a - b) ** 2))
    assert err < 300.0  # 4-bit ADPCM on noisy sine stays well under this


@pytest.mark.parametrize("channels", [3, 4, 6, 8])
def test_multichannel_vs_reference(oracle, channels):
    wav = _wav_bytes(samples=2048, channels=channels, seed=channels)
    ours = adxmod.encode(wav)
    ref = oracle.AdxEncode(wav, 4, 0x12, 3, 0x1F4, 0, 4, False)
    assert ours == ref
    # NOTE: decode outcomes are not compared here — the reference decoder's
    # `Looping` member is uninitialized (adx.cpp:279) and for some channel
    # counts it reads stack garbage and rejects its own output with error -8.
    # Our decoder handles these files; verify the roundtrip tracks the input.
    decoded = adxmod.decode(ours)
    a = parse_wav(wav).pcm16.astype(np.float64)
    b = parse_wav(decoded).pcm16.astype(np.float64)[: a.size]
    # higher channels carry higher-frequency sines (harder for 4-bit ADPCM),
    # and 6/8ch headers clip the decoder history (format quirk): loose bound
    assert np.sqrt(np.mean((a - b) ** 2)) < 4000.0


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_mode2_filters_vs_reference(oracle, filt):
    wav = _wav_bytes(samples=2048, channels=2, seed=30 + filt)
    ours = adxmod.encode(wav, encoding_mode=2, filter_=filt)
    ref = oracle.AdxEncode(wav, 4, 0x12, 2, 0x1F4, filt, 4, False)
    assert ours == ref
    assert _outcome(adxmod.decode, ours) == _outcome(oracle.AdxDecode, bytes(ref))


def test_adx_host_native_paths_bit_exact(oracle):
    """decode/encode: native C++, numpy, and JAX paths all byte-identical."""
    from pycricodecs_tpu.models import adx as adxmod
    from pycricodecs_tpu.ops import adx_kernels
    from pycricodecs_tpu import native
    assert native.load() is not None

    pcm = (make_sine_pcm16(4096, 2, 48000, seed=77) // 16).astype(np.int16)
    wav = write_wav(pcm, 2, 48000)
    for mode in (2, 3, 4):
        enc_native = adxmod.encode(wav, encoding_mode=mode, use_jax=False)
        enc_jax = adxmod.encode(wav, encoding_mode=mode, use_jax=True)
        assert enc_native == enc_jax
        assert enc_native == bytes(
            oracle.AdxEncode(wav, 4, 0x12, mode, 0x1F4, 0, 4, 0))
        dec_native = adxmod.decode(enc_native, use_jax=False)
        dec_jax = adxmod.decode(enc_native, use_jax=True)
        assert dec_native == dec_jax
        assert dec_native == bytes(oracle.AdxDecode(enc_native))

    # numpy mirror agreement on raw lanes (native routed vs forced numpy)
    rng = np.random.default_rng(5)
    L, B, spb = 3, 20, 32
    blocks = rng.integers(-3000, 3000, (L, B, spb)).astype(np.int32)
    c0 = np.full(L, 0x1CB1, np.int32)
    c1 = np.full(L, -0x0D4C, np.int32)
    h = np.zeros(L, np.int32)
    a = adx_kernels.adx_encode_host(blocks, c0, c1, h, h, spb=spb,
                                    encoding_mode=3, bit_depth=4)
    b = adx_kernels.adx_encode_numpy(blocks, c0, c1, h, h, spb=spb,
                                     encoding_mode=3, bit_depth=4)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_encode_mode4_quiet_blocks_all_engines(oracle):
    """Mode-4 blocks whose residual range fits the bitdepth limit have
    Scale == 0 with non-zero codes (Power must be 0, adx.cpp:242)."""
    from pycricodecs_tpu.models import adx as adxmod

    for amp in (1, 2, 3):
        pcm = (np.sin(np.arange(4096) / 30.0) * amp).astype(np.int16)
        wav = write_wav(pcm, 1, 32000)
        ref = bytes(oracle.AdxEncode(wav, 4, 0x12, 4, 0x1F4, 0, 4, False))
        assert adxmod.encode(wav, bit_depth=4, encoding_mode=4,
                             use_jax=False) == ref
        assert adxmod.encode(wav, bit_depth=4, encoding_mode=4,
                             use_jax=True) == ref


def test_encode_loop_alignment_u16_truncation(oracle):
    """Loop alignment is stored in an unsigned short; loop fields derive
    from the truncated value (adx.cpp struct Loop)."""
    pcm = (np.sin(np.arange(100000) / 40.0) * 8000).astype(np.int16)
    wav = write_wav(pcm, 1, 48000, looping=True,
                    loop_start=70000, loop_end=90000)
    ref = bytes(oracle.AdxEncode(wav, 4, 0x12, 3, 0x1F4, 0, 4, False))
    assert adxmod.encode(wav) == ref


def test_encode_many_channel_looping(oracle):
    """Loop-record writes past the (uninit-Channels parity) header size are
    clipped, not appended -- >=5ch looping output must match byte-for-byte."""
    for ch in (5, 6, 8):
        n = 4096
        multi = np.stack([(np.sin(np.arange(n) / (10 + c)) * 6000)
                          .astype(np.int16) for c in range(ch)], 1).reshape(-1)
        wav = write_wav(multi, ch, 48000, looping=True,
                        loop_start=512, loop_end=2048)
        ref = bytes(oracle.AdxEncode(wav, 4, 0x12, 3, 0x1F4, 0, 4, False))
        assert adxmod.encode(wav) == ref, ch


def test_encode_shorter_than_one_block(oracle):
    """History seeds from the first PCM sample even when frames == 0."""
    tiny = write_wav((np.arange(10) * 100 + 1000).astype(np.int16), 1, 48000)
    ref = bytes(oracle.AdxEncode(tiny, 4, 0x12, 3, 0x1F4, 0, 4, False))
    assert adxmod.encode(tiny) == ref


def test_adx_scale_fix_quality_and_compat(oracle):
    """scale_fix=True quantises against the decoder's exact arithmetic
    (the reference encoder divides by Scale while its decoder multiplies
    by Scale+1 — its documented high-bitdepth popping, README.md:133).
    The output must stay standard ADX: the reference decoder plays it,
    all three of our encoders agree, and quality improves massively
    (bitdepth >= 12 becomes lossless for in-range content)."""
    import numpy as np
    from pycricodecs_tpu.models import adx
    from pycricodecs_tpu.utils.wav import write_wav

    sr, n = 48000, 48000
    t = np.arange(n) / sr
    pcm = np.clip(np.sin(2 * np.pi * 440 * t) * 28000,
                  -32768, 32767).astype(np.int16)
    wav = write_wav(pcm, 1, sr)

    def snr(blob):
        dec = np.frombuffer(adx.decode(blob)[44:], np.int16)[:n]
        err = dec.astype(np.int64) - pcm.astype(np.int64)
        return 10 * np.log10((pcm.astype(np.float64) ** 2).mean()
                             / max((err.astype(np.float64) ** 2).mean(),
                                   1e-9))

    for mode in (2, 3, 4):
        for bd, bs in ((4, 0x12), (8, 0x22), (12, 0x32), (15, 0x3E)):
            kw = dict(bit_depth=bd, block_size=bs, encoding_mode=mode)
            legacy = adx.encode(wav, **kw)
            fixed = adx.encode(wav, scale_fix=True, **kw)
            assert legacy == bytes(oracle.AdxEncode(
                wav, bd, bs, mode, 0x1F4, 0, 4, 0)), \
                f"default no longer byte-matches reference (mode={mode})"
            assert fixed == adx.encode(wav, scale_fix=True, use_jax=True,
                                       **kw)
            try:
                assert bytes(oracle.AdxDecode(fixed)) == adx.decode(fixed)
            except ValueError:
                # the reference decoder rejects ANY file whose first block
                # scale high byte != 0 (reproduced defect, see PARITY.md);
                # it must reject the legacy encode of the same content too,
                # i.e. the rejection is not caused by scale_fix
                with pytest.raises(ValueError):
                    oracle.AdxDecode(legacy)
                continue
            s_legacy, s_fixed = snr(legacy), snr(fixed)
            assert s_fixed >= s_legacy - 1e-6, (mode, bd)
            if mode == 3 and bd >= 8:
                # the off-by-one dominates where prediction keeps the
                # residual (and thus Scale) small; modes 2/4 gain less
                assert s_fixed > s_legacy + 20, (mode, bd, s_legacy, s_fixed)
            if mode == 3 and bd >= 12:
                assert s_fixed > 170, (bd, s_fixed)  # lossless here


def test_adx_unaligned_sample_count_decode(oracle):
    """Per-channel sample counts that are not a multiple of
    samples-per-block must decode with the tail clipped exactly. (The
    reference decoder heap-overflows here: it decodes the padded final
    block into an unpadded output buffer — (spb - ns%spb)*ch*2 bytes past
    the end, SIGABRT observed at 6 channels. Found by the randomized
    differential campaign; verified in a subprocess below.)"""
    import subprocess
    import sys as _sys

    import numpy as np
    from pycricodecs_tpu.models import adx
    from pycricodecs_tpu.utils.wav import write_wav

    sr, ch, ns = 8000, 6, 5881  # 5881 % 32 != 0
    t = np.arange(ns) / sr
    x = np.stack([np.sin(2 * np.pi * (200 + 50 * c) * t) * 0.5
                  for c in range(ch)], 1)
    pcm = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    wav = write_wav(pcm.reshape(-1), ch, sr)
    blob = adx.encode(wav, bit_depth=15, block_size=62, encoding_mode=4)
    out = adx.decode(blob)
    dec = np.frombuffer(out[44:], np.int16).reshape(-1, ch)
    assert dec.shape[0] == ns  # tail clipped, not padded
    # with the decoder-exact quantiser, bitdepth 15 carries the content
    # near-losslessly (the default encode keeps the reference's popping)
    fixed = adx.encode(wav, bit_depth=15, block_size=62, encoding_mode=4,
                       scale_fix=True)
    dec_f = np.frombuffer(adx.decode(fixed)[44:], np.int16).reshape(-1, ch)
    assert dec_f.shape[0] == ns
    # skip the initial transient: the v4 header's history area holds only
    # two channels' seeds (reproduced reference layout, adx.cpp:482), so
    # channels >= 2 start from zero history; the predictor error decays
    # geometrically and is gone by sample ~20
    assert np.abs(dec_f.astype(int) - pcm.astype(int))[32:].max() < 8

    code = ("import sys; sys.path.insert(0, '/tmp/refbuild'); "
            "import CriCodecs; "
            "CriCodecs.AdxDecode(open(r'{}', 'rb').read()); print('OK')")
    import os as _os
    import tempfile

    aligned = adx.encode(
        write_wav(pcm[: (ns // 32) * 32].reshape(-1), ch, sr),
        bit_depth=15, block_size=62, encoding_mode=4)
    paths = {}
    try:
        for label, data in (("aligned", aligned), ("unaligned", blob)):
            with tempfile.NamedTemporaryFile(suffix=".adx",
                                             delete=False) as fh:
                fh.write(data)
                paths[label] = fh.name
        # control: proves the oracle build works and aligned counts decode
        r = subprocess.run([_sys.executable, "-c",
                            code.format(paths["aligned"])],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-300:]
        # the unaligned file overflows the oracle's output buffer; with
        # glibc that aborts deterministically (SIGABRT observed). If this
        # ever starts passing, the allocator absorbed the overflow —
        # re-examine rather than delete the assertion.
        r = subprocess.run([_sys.executable, "-c",
                            code.format(paths["unaligned"])],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0, "oracle no longer crashes: re-examine"
    finally:
        for p in paths.values():
            _os.unlink(p)


def test_adx_scale_u16_truncation_parity(oracle):
    """The reference assigns the block scale to `unsigned short` BEFORE the
    0x1000 cap (adx.cpp:236-238), so residuals >= 65536*limit wrap mod
    65536. Found by the randomized differential campaign (96 kHz clipping
    content at bitdepth 2, where the 500 Hz highpass coefficients make
    residuals exceed 2^16); reproduced for byte parity in all encoders."""
    import numpy as np
    from pycricodecs_tpu.models import adx
    from pycricodecs_tpu.utils.wav import write_wav

    rng = np.random.default_rng(42)
    ns = 4096
    pcm = np.clip(rng.standard_normal(ns) * 3.0 * 32767,
                  -32768, 32767).astype(np.int16)
    wav = write_wav(pcm, 1, 96000)
    for mode in (2, 3, 4):
        ours = adx.encode(wav, bit_depth=2, block_size=10,
                          encoding_mode=mode)
        theirs = bytes(oracle.AdxEncode(wav, 2, 10, mode, 0x1F4, 0, 4, 0))
        assert ours == theirs, f"mode {mode}"
        assert ours == adx.encode(wav, bit_depth=2, block_size=10,
                                  encoding_mode=mode, use_jax=True)


def test_adx_scale_fix_does_not_inherit_u16_wrap():
    """The reproduced u16 scale wrap is a reference defect; scale_fix mode
    must cap the scale instead of wrapping it (a wrapped near-zero scale
    quantises the block into garbage). Crafted history puts the block's
    residual inside the wrap window [65536, 65536+0x1000); all three
    engines must agree in both modes."""
    import numpy as np
    from pycricodecs_tpu.models.adx import calculate_coefficients
    from pycricodecs_tpu.ops import adx_kernels as K

    c0, c1 = calculate_coefficients(0x1F4, 96000)
    pcm = np.zeros((1, 1, 32), np.int32)
    pcm[0, 0, 0] = -25000
    args = (pcm, np.array([c0], np.int32), np.array([c1], np.int32),
            np.array([-32768], np.int32), np.array([32767], np.int32))
    for sfix, expect in ((False, 1335), (True, 0x1000)):
        for engine in (K.adx_encode_numpy, K.adx_encode_host,
                       K.adx_encode_scan):
            _, sraw, _ = engine(*args, spb=32, encoding_mode=3, bit_depth=2,
                                scale_fix=sfix)
            assert int(np.asarray(sraw)[0, 0]) == expect, (engine, sfix)


@pytest.mark.parametrize("mode,bd,bs", [
    (3, 4, 0x12), (4, 4, 0x12), (2, 4, 0x12),       # standard nibble paths
    (3, 8, 0x12), (3, 2, 0x12),                      # byte / 2-bit reshapes
    (3, 5, 12), (3, 11, 13), (3, 15, 17),            # generic 3-byte spans
])
def test_adx_device_pipeline_unpack_exact(oracle, mode, bd, bs):
    """Full device ADX pipeline (raw block bytes -> device unpack ->
    fixpoint ADPCM) is sample-exact vs the host demux+scan for every
    encoding mode and bit-depth family (reference adx.cpp:189-273,
    380-414)."""
    import jax.numpy as jnp
    from pycricodecs_tpu.ops import adx_kernels as K

    pcm = make_sine_pcm16(20000, 2, 32000, seed=91)
    wav = write_wav(pcm, 2, 32000)
    blob = bytes(oracle.AdxEncode(wav, bd, bs, mode, 0x1F4, 0, 4, 0))
    h = adxmod.parse_adx_header(blob, strict_cri_check=False)
    payload = adxmod._payload_blocks(blob, h)
    pl = np.moveaxis(payload, 1, 0)                  # [C, nb, bs]
    h1, h2 = adxmod._history_init(h)
    coef = (0, 0) if mode == 2 else adxmod.calculate_coefficients(
        h.highpass_frequency, h.sample_rate)
    pcm_dev, conv = K.adx_decode_device_pipeline(
        jnp.asarray(pl), jnp.asarray(h1), jnp.asarray(h2),
        block_size=h.block_size, bit_depth=h.bit_depth,
        encoding_mode=h.encoding_mode, coef=tuple(int(x) for x in coef),
        static_coefficients=tuple(int(x)
                                  for x in adxmod.STATIC_COEFFICIENTS))
    assert bool(np.asarray(conv))
    ref = adxmod._decode_arrays(blob, h, use_jax=False)
    got = np.asarray(pcm_dev).reshape(h.channels, -1)[:, :ref.shape[1]]
    assert np.array_equal(got, ref)


def test_adx_encode_fixpoint_segmented_long_tone():
    """Long near-resonant tone banks: the GLOBAL fixpoint provably cannot
    converge (exactness propagates ~1 block/pass when quantisation
    decisions keep flipping), so streams past segment_blocks run as a scan
    of per-segment fixpoints with guaranteed convergence. This bank (2000
    blocks of a clean 440 Hz tone) never converged before round 4; it must
    now converge AND match the serial scan bit-for-bit, including across
    segment boundaries and a non-multiple tail."""
    from pycricodecs_tpu.ops import adx_kernels as K

    spb = 32
    nb = 2000                       # > segment_blocks, non-multiple tail
    sr = 48000
    t = np.arange(nb * spb) / sr
    tone = np.clip(np.sin(2 * np.pi * 440 * t) * 26000,
                   -32768, 32767).astype(np.int32)
    pcm = np.stack([tone, np.roll(tone, 7)]).reshape(2, nb, spb)
    a, b = adxmod.calculate_coefficients(0x1F4, sr)
    c0 = np.full(2, a, np.int32)
    c1 = np.full(2, b, np.int32)
    h1 = pcm[:, 0, 0].copy()
    h2 = h1.copy()
    want = K.adx_encode_numpy(pcm, c0, c1, h1, h2, spb=spb,
                              encoding_mode=3, bit_depth=4)
    codes, sraw, zero, conv = K.adx_encode_fixpoint(
        pcm, c0, c1, h1, h2, spb=spb, encoding_mode=3, bit_depth=4)
    assert bool(np.asarray(conv)), "segmented fixpoint must converge"
    assert np.array_equal(np.asarray(codes), want[0])
    assert np.array_equal(np.asarray(sraw), want[1])
    assert np.array_equal(np.asarray(zero), want[2])


@pytest.mark.parametrize("mode,bd,bs,sfix", [
    (3, 4, 0x12, False), (4, 4, 0x12, False), (2, 4, 0x12, False),
    (3, 8, 0x12, False), (3, 2, 0x12, False),        # byte / 2-bit packs
    (3, 5, 12, False), (3, 11, 13, False),           # generic 3-byte spans
    (3, 4, 0x12, True), (4, 12, 0x12, True),         # scale_fix quantiser
])
def test_adx_encode_fixpoint_matches_scan(mode, bd, bs, sfix):
    """Block-parallel fixpoint encode + on-device packer reproduce the
    serial encode scan bit-for-bit on convergence (codes, scales, zero
    mask AND packed block bytes; reference adx.cpp:215-273, 380-414)."""
    from pycricodecs_tpu.ops import adx_kernels as K
    from pycricodecs_tpu.utils.bitio import pack_fixed_codes

    spb = (bs - 2) * 8 // bd
    nb = 40
    rng = np.random.default_rng(bd * 100 + mode)
    pcm = make_sine_pcm16(nb * spb, 2, 32000, seed=bd + mode).reshape(-1, 2)
    pcm = pcm.T.reshape(2, nb, spb).astype(np.int32)
    pcm[0, 5:8] = 0                                  # zero-residual blocks
    pcm[1, 20:22] = rng.integers(-30000, 30000, (2, spb))
    if mode == 2:
        c0 = np.full(2, int(adxmod.STATIC_COEFFICIENTS[2]), np.int32)
        c1 = np.full(2, int(adxmod.STATIC_COEFFICIENTS[3]), np.int32)
    else:
        a, b = adxmod.calculate_coefficients(0x1F4, 32000)
        c0 = np.full(2, a, np.int32)
        c1 = np.full(2, b, np.int32)
    h1 = pcm[:, 0, 0].copy()
    h2 = h1.copy()
    want = K.adx_encode_numpy(pcm, c0, c1, h1, h2, spb=spb,
                              encoding_mode=mode, bit_depth=bd,
                              scale_fix=sfix)
    codes, sraw, zero, conv = K.adx_encode_fixpoint(
        pcm, c0, c1, h1, h2, spb=spb, encoding_mode=mode, bit_depth=bd,
        scale_fix=sfix)
    assert bool(np.asarray(conv))
    assert np.array_equal(np.asarray(codes), want[0])
    assert np.array_equal(np.asarray(sraw), want[1])
    assert np.array_equal(np.asarray(zero), want[2])

    # packer vs the host bit packer + scale-word assembly
    payload_dev, conv2 = K.adx_encode_device_pipeline(
        pcm, c0, c1, h1, h2, spb=spb, encoding_mode=mode, bit_depth=bd,
        block_size=bs, filter_=1 if mode == 2 else 0, scale_fix=sfix)
    assert bool(np.asarray(conv2))
    host_payload = adxmod._assemble_payload(
        want[0], want[1], want[2], frames=nb, channels=2, block_size=bs,
        bit_depth=bd, encoding_mode=mode, filter_=1 if mode == 2 else 0)
    got = np.moveaxis(np.asarray(payload_dev), 0, 1)  # [nb, C, bs]
    assert np.array_equal(got, host_payload)


@pytest.mark.parametrize("mode,bd,bs,sfix", [
    (3, 4, 0x12, False), (4, 4, 0x12, False), (2, 4, 0x12, False),
    (3, 8, 0x12, False), (3, 2, 0x12, False),
    (3, 5, 12, False), (3, 11, 13, False),
    (3, 4, 0x12, True), (4, 12, 0x12, True),
])
def test_adx_encode_serial_pallas_matches_scan(mode, bd, bs, sfix):
    """The device encode engine (the chained-block fixpoint) is
    bit-identical to the serial encode reference for every mode/bit-depth,
    including zero-residual blocks, an odd lane count, an odd block count
    and nonzero start history."""
    from pycricodecs_tpu.ops import adx_kernels as K

    spb = (bs - 2) * 8 // bd
    nb = 37                                          # odd: chunk padding
    rng = np.random.default_rng(bd * 10 + mode)
    L = 3                                            # odd: lane padding
    pcm = np.stack([
        make_sine_pcm16(nb * spb, 1, 32000, seed=bd + mode + c)
        for c in range(L)]).reshape(L, nb, spb).astype(np.int32)
    pcm[0, 5:8] = 0                                  # zero-residual blocks
    pcm[1, 20:22] = rng.integers(-30000, 30000, (2, spb))
    if mode == 2:
        c0 = np.full(L, int(adxmod.STATIC_COEFFICIENTS[2]), np.int32)
        c1 = np.full(L, int(adxmod.STATIC_COEFFICIENTS[3]), np.int32)
    else:
        a, b = adxmod.calculate_coefficients(0x1F4, 32000)
        c0 = np.full(L, a, np.int32)
        c1 = np.full(L, b, np.int32)
    h1 = pcm[:, 0, 0].copy()
    h2 = np.asarray([0, 3, -9], np.int32)
    kw = dict(spb=spb, encoding_mode=mode, bit_depth=bd, scale_fix=sfix)
    want = K.adx_encode_numpy(pcm, c0, c1, h1, h2, **kw)
    codes, sraw, zero, conv = K.adx_encode_fixpoint(
        pcm, c0, c1, h1, h2, **kw)
    assert bool(np.asarray(conv))
    assert np.array_equal(np.asarray(codes), want[0])
    assert np.array_equal(np.asarray(sraw), want[1])
    assert np.array_equal(np.asarray(zero), want[2])


@pytest.mark.parametrize("mode,bd,bs", [
    (3, 4, 0x12), (4, 4, 0x12), (2, 4, 0x12), (3, 8, 0x12), (3, 11, 13),
])
def test_adx_decode_serial_pallas_matches_scan(mode, bd, bs):
    """The device decode engine (the chained-block fixpoint) is
    bit-identical to adx_decode_scan, including mode-2 per-block
    coefficient selects, clamp saturation, an odd lane count and an odd
    block count."""
    import jax.numpy as jnp

    from pycricodecs_tpu.ops import adx_kernels as K

    spb = (bs - 2) * 8 // bd
    nb = 41
    rng = np.random.default_rng(mode * 7 + bd)
    L = 3
    q = rng.integers(-(1 << (bd - 1)), 1 << (bd - 1),
                     (L, nb, spb)).astype(np.int32)
    s = rng.integers(1, 0x1000, (L, nb)).astype(np.int32)
    a0 = np.full((L, nb), 7400, np.int32)
    a1 = np.full((L, nb), -3342, np.int32)
    if mode == 2:
        tab = np.asarray(adxmod.STATIC_COEFFICIENTS, np.int32).reshape(-1, 2)
        pick = rng.integers(0, tab.shape[0], (L, nb))
        a0 = tab[pick, 0].astype(np.int32)
        a1 = tab[pick, 1].astype(np.int32)
    h1 = np.asarray([0, 100, -31000], np.int32)
    h2 = np.asarray([0, -40, 32000], np.int32)
    got, conv = K.adx_decode_fixpoint_blocks(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(a0), jnp.asarray(a1),
        jnp.asarray(h1), jnp.asarray(h2))
    assert bool(np.asarray(conv))
    want = K.adx_decode_scan(
        jnp.asarray(q.reshape(L, -1)),
        jnp.asarray(np.repeat(s[..., None], spb, 2).reshape(L, -1)),
        jnp.asarray(np.repeat(a0[..., None], spb, 2).reshape(L, -1)),
        jnp.asarray(np.repeat(a1[..., None], spb, 2).reshape(L, -1)),
        jnp.asarray(h1), jnp.asarray(h2))
    assert np.array_equal(np.asarray(got).reshape(L, -1), np.asarray(want))


def test_tdiv_matches_c_truncation():
    """The device engines' integer division truncates toward zero like C
    over the full residual/scale range (|a| <= 2^18+2^12,
    1 <= b <= 0x1001)."""
    import jax.numpy as jnp

    from pycricodecs_tpu.ops import adx_kernels as K

    rng = np.random.default_rng(7)
    a = rng.integers(-(1 << 18) - 4096, (1 << 18) + 4097, 100000)
    b = rng.integers(1, 0x1002, 100000)
    edges_a = np.array([0, 1, -1, 4095, -4095, 4096, -4096, 266240,
                        -266240, 8191, -8191])
    edges_b = np.array([1, 1, 1, 4096, 4096, 4096, 4096, 0x1001, 0x1001,
                        2, 2])
    a = np.concatenate([a, edges_a]).astype(np.int32)
    b = np.concatenate([b, edges_b]).astype(np.int32)
    got = np.asarray(K._tdiv(jnp.asarray(a), jnp.asarray(b)))
    want = (np.abs(a.astype(np.int64)) // b) * np.sign(a)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode,looping", [(3, False), (4, True), (2, False)])
def test_adx_encode_batch_device_byte_parity(mode, looping):
    """parallel.adx_encode_batch(device=True) produces byte-identical ADX
    files to the single-stream host encoder across mixed rates/channels/
    lengths (per-lane coefficients are runtime inputs to one program)."""
    from pycricodecs_tpu import parallel

    blobs = [
        _wav_bytes(samples=6000, channels=1, sr=22050, looping=looping,
                   seed=mode),
        _wav_bytes(samples=9001, channels=2, sr=48000, looping=looping,
                   seed=mode + 1),
        _wav_bytes(samples=2048, channels=4, sr=32000, seed=mode + 2),
    ]
    got = parallel.adx_encode_batch(blobs, encoding_mode=mode, device=True)
    for blob, g in zip(blobs, got):
        assert g == adxmod.encode(blob, encoding_mode=mode)


def test_adx_encode_batch_device_nonconverged_falls_back(monkeypatch):
    """A non-converged fixpoint group reroutes to the host encoder."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.ops import adx_kernels as K

    real = K.adx_encode_device_pipeline

    def never_converges(*args, **kwargs):
        payload, _conv = real(*args, **kwargs)
        return payload, np.bool_(False)

    monkeypatch.setattr(K, "adx_encode_device_pipeline", never_converges)
    blob = _wav_bytes(samples=4096, channels=2, seed=5)
    got = parallel.adx_encode_batch([blob], device=True)
    assert got[0] == adxmod.encode(blob)


def test_adx_device_paths_gate_exotic_spb():
    """bit_depth 2 at block_size 0xFF gives spb=1012: the device engine
    statically unrolls spb (the fixpoint compile alone ran past 900 s), so
    the batch pipelines route such groups to the host lanes —
    byte-identical results, no minutes-long compile, and no device
    attempt counted as a fallback."""
    from pycricodecs_tpu import parallel

    pcm = make_sine_pcm16(1012 * 6, 2, 48000, seed=60)
    # silence the entire first block (spb=1012): the reproduced reference
    # CRI-string check reads one byte into block 0 and rejects nonzero
    pcm[:1012 * 2] = 0
    wav = write_wav(pcm, 2, 48000)
    kw = dict(bit_depth=2, block_size=0xFF, encoding_mode=3)
    want = adxmod.encode(wav, **kw)
    stats = parallel.DecodeStats()
    got_enc = parallel.adx_encode_batch([wav], device=True, stats=stats,
                                        **kw)
    assert got_enc[0] == want
    got_dec = parallel.adx_decode_batch([want], device=True, stats=stats)
    assert stats.host_fallback_streams == 0
    assert got_dec[0] == adxmod.decode(want, use_jax=False,
                                       strict_cri_check=False)
