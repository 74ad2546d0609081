"""Device-side HCA frame packer parity (ops/hca_pack_device.py).

The packer is the inverse of the device unpacker: encode tensors already on
device -> frame bytes in HBM, byte-identical to the host packer
(ops/hca_frame.py::pack_frame, reference PackFrame hca.cpp:2894-2963).
Inputs come from the shipped device encode transform so the test exercises
exactly the tensors the end-to-end pipeline feeds it.
"""
import io
import wave

import numpy as np
import pytest

from pycricodecs_tpu.ops import hca_encode_device as D
from pycricodecs_tpu.ops import hca_encode_host as H
from pycricodecs_tpu.ops import hca_frame
from pycricodecs_tpu.ops import hca_tables as T
from pycricodecs_tpu.ops.hca_pack_device import DevicePacker


def _wav(samples=8192, channels=2, rate=44100, seed=0, loop=False):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / rate
    pcm = np.zeros((channels, samples), np.float64)
    for c in range(channels):
        f0 = 180.0 * (c + 1) + 37.0 * seed
        pcm[c] = (0.5 * np.sin(2 * np.pi * f0 * t)
                  + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t)
                  + 0.08 * rng.standard_normal(samples))
    data = np.clip(pcm * 18000.0, -32768, 32767).astype('<i2')
    buf = io.BytesIO()
    w = wave.open(buf, "wb")
    w.setnchannels(channels)
    w.setsampwidth(2)
    w.setframerate(rate)
    w.writeframes(data.T.tobytes())
    w.close()
    raw = bytearray(buf.getvalue())
    if loop:
        # minimal smpl chunk: one loop over the middle half
        import struct
        smpl = struct.pack('<4sI', b'smpl', 60) + b'\x00' * 28 + \
            struct.pack('<I', 1) + b'\x00' * 4 + \
            struct.pack('<IIIIII', 0, 0, samples // 4, samples // 2, 0, 0)
        raw += smpl
        raw[4:8] = struct.pack('<I', len(raw) - 8)
    return bytes(raw)


def _encode_tensors(wav_bytes, quality):
    """Run the device encode transform exactly as encode_batch_device does,
    returning (info, per-stream host-layout tensors, device [1,F,...] args).
    """
    from pycricodecs_tpu.utils import wav as wavmod

    w = wavmod.parse_wav(wav_bytes)
    cfg = H.init_encode(w, quality, w.looping)
    info = cfg.info
    C = info.channels
    F = info.frame_count
    Fp = -(-F // 16) * 16
    pcm = np.zeros((1, C, Fp * 1024), np.int16)
    tl = H.build_timeline(cfg, w)
    pcm[0, :, :tl.shape[1]] = tl
    pairs = tuple((c, c + 1) for c in range(C - 1)
                  if info.channel_type[c] == T.STEREO_PRIMARY) \
        if info.stereo_band_count > 0 else ()
    out = D.hca_encode_transform(
        pcm,
        base_band=int(info.base_band_count),
        total_band=int(info.total_band_count),
        pairs=pairs,
        coded_counts=tuple(int(x) for x in info.coded_count),
        channel_types=tuple(int(x) for x in info.channel_type),
        hfr_group_count=int(info.hfr_group_count),
        bands_per_hfr_group=int(info.bands_per_hfr_group),
        hfr_band_count=int(cfg.hfr_band_count),
        frame_size=int(info.frame_size))
    sf, res, intensity, quant, level, boundary, delta_bits, ga, gs = \
        [np.asarray(x) for x in out]
    assert (level[0, :F] >= 0).all(), "rate-control fallback in test input"
    hfr_scales = D._host_hfr_scales(info, cfg, ga, gs)
    return info, F, (level, boundary, sf, res, intensity, hfr_scales,
                     delta_bits, quant)


CASES = [
    dict(channels=1, quality=1, samples=8192, seed=1),
    dict(channels=2, quality=1, samples=8192, seed=2),
    dict(channels=2, quality=0, samples=12288, seed=3),
    dict(channels=2, quality=4, samples=8192, seed=4),   # high HFR count
    dict(channels=6, quality=2, samples=6144, seed=5),   # intensity stereo
    dict(channels=8, quality=3, samples=4096, seed=6),
    dict(channels=2, quality=2, samples=8192, seed=7, rate=16000),
    dict(channels=1, quality=3, samples=8192, seed=8, rate=48000),
    dict(channels=2, quality=1, samples=16384, seed=9, loop=True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"ch{c['channels']}q{c['quality']}r{c.get('rate', 44100)}"
    f"{'loop' if c.get('loop') else ''}"))
def test_pack_device_matches_host(case):
    quality = case["quality"]
    wav_bytes = _wav(samples=case["samples"], channels=case["channels"],
                     rate=case.get("rate", 44100), seed=case["seed"],
                     loop=case.get("loop", False))
    info, F, tensors = _encode_tensors(wav_bytes, quality)
    level, boundary, sf, res, intensity, hfr_scales, delta_bits, quant = \
        tensors

    host = D.hca_frame_pack(info, level[0, :F], boundary[0, :F], sf[0, :F],
                            res[0, :F], intensity[0, :F], hfr_scales[0, :F],
                            delta_bits[0, :F], quant[0, :F])

    packer = DevicePacker(info)
    dev = np.asarray(packer(level, boundary, sf, res, intensity,
                            hfr_scales, delta_bits, quant))
    got = dev[0, :F].tobytes()
    assert got == host


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[4], CASES[8]],
                         ids=lambda c: (
    f"ch{c['channels']}q{c['quality']}r{c.get('rate', 44100)}"
    f"{'loop' if c.get('loop') else ''}"))
def test_encode_batch_device_pack_device(case):
    """End-to-end fused on-device encode (transform -> HFR -> packer):
    encode_batch_device(pack="device") is byte-identical to the host
    encoder, header included."""
    wav_bytes = _wav(samples=case["samples"], channels=case["channels"],
                     rate=case.get("rate", 44100), seed=case["seed"],
                     loop=case.get("loop", False))
    quality = case["quality"]
    got = D.encode_batch_device([wav_bytes], quality=quality,
                                pack="device")[0]
    want = H.encode(wav_bytes, quality=quality)
    assert got == want


def test_encode_batch_device_pack_device_multi():
    """Two different-length streams through one fused device dispatch."""
    wavs = [_wav(samples=8192, channels=2, seed=21),
            _wav(samples=14336, channels=2, seed=22)]
    got = D.encode_batch_device(wavs, quality=1, pack="device")
    for g, w in zip(got, wavs):
        assert g == H.encode(w, quality=1)


def test_pack_device_batch_consistency():
    """Two different streams packed in one [B, F] batch match their
    individually packed selves (no cross-stream leakage)."""
    wavs = [_wav(samples=8192, channels=2, seed=11),
            _wav(samples=8192, channels=2, seed=12)]
    infos, tens = [], []
    for wb in wavs:
        info, F, t = _encode_tensors(wb, 1)
        infos.append((info, F))
        tens.append(t)
    batch = [np.concatenate([a, b], axis=0)
             for a, b in zip(tens[0], tens[1])]
    packer = DevicePacker(infos[0][0])
    dev = np.asarray(packer(*batch))
    for b, (info, F) in enumerate(infos):
        host = D.hca_frame_pack(
            info, tens[b][0][0, :F], tens[b][1][0, :F], tens[b][2][0, :F],
            tens[b][3][0, :F], tens[b][4][0, :F], tens[b][5][0, :F],
            tens[b][6][0, :F], tens[b][7][0, :F])
        assert dev[b, :F].tobytes() == host


def test_pack_device_crc_slot_crossing_symbol():
    """End-of-frame contract: the host/reference writer buffer spans frame
    bits [16, fs*8), so a symbol may START in the last data byte and END
    inside the CRC slot — its leading bits are payload, the spill is
    overwritten by the CRC.  A device packer that drops such symbols whole
    loses the leading bits (regression: found by the round-3 device-encode
    differential campaign at 48 kHz q=0).  This crafts a frame whose final
    spectrum symbol crosses frame bit fs*8-16 and pins device == host."""
    info, F, _ = _encode_tensors(_wav(samples=4096, channels=2,
                                      rate=48000, seed=3), 0)
    C = info.channels
    fs = int(info.frame_size)
    G = int(info.hfr_group_count)

    # header bits for db=0 frames: sync16 + anl9 + evb7, then per channel
    # 3 (delta width) + intensity (8*4, secondary) or HFR scales (6*G)
    B0 = 32
    for c in range(C):
        B0 += 3
        if int(info.channel_type[c]) == T.STEREO_SECONDARY:
            B0 += 8 * 4
        elif G > 0:
            B0 += 6 * G
    limit = fs * 8 - 16

    # symbol widths (res 15: 11-bit abs + 1 sign bit when q != 0; res 2 and
    # 4 at q=0: 2 and 3 bits).  The final symbol must carry NONZERO leading
    # bits (q=2047 -> abs field all ones), else a drop would be invisible.
    # Its band contributes 7*11 (q=0 subframes) + 12 (subframe 7) = 89 bits;
    # choose total T with T-12 < limit < T <= fs*8, (T - B0 - 89) % 8 == 0
    T_total = limit + 1 + (-(limit + 1 - B0 - 89)) % 8
    assert limit < T_total <= fs * 8 and T_total - 12 < limit
    fill = (T_total - B0 - 89) // 8
    n11 = fill // 11          # bulk filler: res-15 bands, 11 bits each
    r = fill % 11
    if r == 1:                # 1 not reachable with widths {2, 3}
        n11 -= 1
        r = 12
    n3 = r % 2                # one width-3 band fixes parity
    n2 = (r - 3 * n3) // 2
    cc0 = int(info.coded_count[0])
    assert n11 + n2 + n3 <= cc0, "not enough bands on channel 0"

    B, Fp = 1, 16
    level = np.zeros((B, Fp), np.int32)
    boundary = np.zeros((B, Fp), np.int32)
    sf = np.zeros((B, Fp, C, 128), np.uint8)
    res = np.zeros((B, Fp, C, 128), np.uint8)
    intensity = np.zeros((B, Fp, C, 8), np.uint8)
    hfr_scales = np.zeros((B, Fp, C, max(G, 1)), np.int32)
    delta_bits = np.zeros((B, Fp, C), np.int32)
    quant = np.zeros((B, Fp, C, 8, 128), np.int16)
    res[0, 0, 0, :n11] = 15
    res[0, 0, 0, n11:n11 + n2] = 2
    if n3:
        res[0, 0, 0, n11 + n2] = 4
    cc_last = int(info.coded_count[C - 1])
    res[0, 0, C - 1, cc_last - 1] = 15
    quant[0, 0, C - 1, 7, cc_last - 1] = 2047   # all-ones abs field + sign

    host = D.hca_frame_pack(info, level[0, :1], boundary[0, :1], sf[0, :1],
                            res[0, :1], intensity[0, :1], hfr_scales[0, :1],
                            delta_bits[0, :1], quant[0, :1])
    packer = DevicePacker(info)
    dev = np.asarray(packer(level, boundary, sf, res, intensity,
                            hfr_scales, delta_bits, quant))
    assert dev[0, 0].tobytes() == host
    # the crossing really happened and is observable: the final data byte
    # carries the symbol's leading 1-bits (a whole-symbol drop zeroes them)
    lead = limit - (T_total - 12)
    assert lead > 0
    k = min(lead, 8)   # low k bits of the final data byte are the abs-field
    tail = int(np.frombuffer(host, np.uint8)[fs - 3])
    assert tail & ((1 << k) - 1) == (1 << k) - 1
