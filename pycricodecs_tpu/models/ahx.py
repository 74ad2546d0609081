"""AHX codec: MPEG-2 LSF Layer II audio in an ADX-style CRI container.

Beyond-parity capability: the reference package recognises @AHX USM chunks
(PyCriCodecs/chunk.py:22) and its ADX decoder explicitly rejects AHX files
("AHX file provided, unsupported", adx.cpp error -2), but it cannot decode or
create them.  SofDec1-era USMs carry their audio as @AHX, so demuxed streams
were dead ends.  This module decodes and encodes them.

Container layout (matches AHX files in the wild / vgmstream's parser):
ADX header magic 0x80 0x00, u16 BE data offset, encoding type 0x10 or 0x11
(instead of ADPCM's 2/3/4), block size 0, bit depth 0, 1 channel, u32 sample
rate, u32 total samples, "(c)CRI" ending at data start; then standard MPEG
Layer II frames (MPEG-2 LSF mono for type 0x11).  The byte stream after the
header is plain MPEG audio, so `decode_mp2`/`encode_mp2` below double as a
general .mp2 codec (MPEG-1 and MPEG-2 LSF, all layer-II modes).

Correctness is tested against two independent system oracles: streams made by
libtwolame decode bit-identically (<= 1 int16 LSB) to libmpg123's output, and
our encoded streams are accepted and decoded by libmpg123 (tests/test_ahx.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops import mp2_frame, mp2_kernels, mp2_tables
from ..utils import wav as wavmod

CRI_STRING = b"(c)CRI"
AHX_TYPES = (0x10, 0x11)


def ahx_container(stream: bytes, sample_rate: int, n_samples: int,
                  AhxVersion: int = 0x11) -> bytes:
    """Wrap a mono MPEG-2 LSF Layer II stream in the AHX (ADX-style)
    container (header layout mirrored by AHX.parse_header)."""
    header = bytearray(0x24)
    header[0:2] = b"\x80\x00"
    header[2:4] = (0x20).to_bytes(2, "big")     # data at 0x24
    header[4] = AhxVersion
    header[5] = 0                               # block size
    header[6] = 0                               # bit depth
    header[7] = 1                               # channels
    header[8:12] = sample_rate.to_bytes(4, "big")
    header[12:16] = n_samples.to_bytes(4, "big")
    header[16:18] = b"\x00\x00"                 # highpass
    header[18] = 0x06                           # AHX header version tag
    header[19] = 0x00                           # flags
    header[0x1E:0x24] = CRI_STRING
    footer = b"\x80\x01\x00\x0c" + b"AHXE(c)CRI\x00\x00"
    return bytes(header) + stream + footer


def decode_mp2(data: bytes, offset: int = 0, device: bool = False,
               max_frames: Optional[int] = None
               ) -> Tuple[np.ndarray, int]:
    """Decode consecutive MPEG Layer II frames -> (int16 [C, N], sample_rate).

    device=False (default) uses the vectorised float64 numpy path — the right
    engine for single files (the jit specialises on the frame count, so a
    compile would dominate).  device=True runs dequant + the one-matmul synthesis jitted
    on the accelerator (float32, for batch work); failures then propagate.
    """
    st = mp2_frame.unpack(data, offset, max_frames)
    if device:
        pcm = mp2_kernels.decode_transform_device(st.codes, st.levels,
                                                  st.sfidx)
        return pcm, st.header.sample_rate
    pcm = mp2_kernels.decode_pcm16_host(st.codes, st.levels, st.sfidx)
    return pcm, st.header.sample_rate


def _sf_indices(peak: np.ndarray) -> np.ndarray:
    """Tightest scalefactor index with SF[idx] >= peak ([..,] float -> uint8)."""
    sf = mp2_tables.scalefactors()[:63]
    # sf is strictly decreasing; count entries >= peak, idx = count - 1
    cnt = np.sum(sf[None, :] >= peak[..., None] - 1e-12, axis=-1)
    return (np.maximum(cnt, 1) - 1).astype(np.uint8)


def _class_meta(table_id: int):
    """Per-subband class lists + per-class (sample bits / frame, SNR dB)."""
    table = mp2_tables.ALLOC_TABLES[table_id]
    metas = []
    for classes in table:
        bits, snr = [0], [0.0]
        for n in classes[1:]:
            gb = mp2_tables.GROUP_BITS.get(n)
            per_gr = gb if gb is not None else 3 * mp2_tables.code_bits(n)
            bits.append(12 * per_gr)
            snr.append(20.0 * np.log10(n))
        metas.append((classes, bits, snr))
    return metas


def encode_mp2(pcm: np.ndarray, sample_rate: int,
               bitrate_kbps: Optional[int] = None,
               device: bool = False,
               joint_bound: Optional[int] = None) -> bytes:
    """Encode int16 PCM ([N] mono or [C, N]) to MPEG Layer II.

    MPEG-2 LSF for 16/22.05/24 kHz, MPEG-1 for 32/44.1/48 kHz.  Stereo input
    is coded as independent-channel stereo (mode 0), or as joint (intensity)
    stereo with ``joint_bound`` in {4, 8, 12, 16}: subbands >= joint_bound
    carry ONE shared allocation + code set quantised from the mid signal
    (l+r)/2 against its own scalefactor, while both channels transmit their
    original scalefactors — the decoder's per-channel scaling restores each
    side's envelope (ISO 11172-3 intensity semantics; our decoder and
    libmpg123 both handle it).  CBR with the standard
    padding-slot accumulator; greedy max-(SMR - SNR) bit allocation.

    device=False (default) is the float64 numpy reference path.  device=True
    runs the FULL on-device pipeline (ops/mp2_encode_device: analysis
    matmul through device bit packing) — an f32 variant whose allocation
    ranking is exactly order-equivalent to this function's dB formulation
    and whose post-analysis stages are bit-deterministic across backends;
    output bytes differ from the f64 path only through analysis rounding.
    """
    pcm = np.asarray(pcm, dtype=np.int16)
    if pcm.ndim == 1:
        pcm = pcm[None, :]
    if device:
        from ..ops import mp2_encode_device as MED
        return MED.encode_mp2_device_batch([pcm], sample_rate,
                                           bitrate_kbps,
                                           joint_bound=joint_bound)[0]
    C, N = pcm.shape
    if C not in (1, 2):
        raise ValueError("Layer II supports 1 or 2 channels.")
    if joint_bound is not None and joint_bound not in (4, 8, 12, 16):
        raise ValueError("joint_bound must be one of 4/8/12/16.")
    joint = joint_bound is not None and C == 2
    if sample_rate in mp2_tables.SAMPLE_RATES_V2:
        version, rates = 2, mp2_tables.BITRATES_V2_L2
        sr_idx = mp2_tables.SAMPLE_RATES_V2.index(sample_rate)
        if bitrate_kbps is None:
            bitrate_kbps = 80 * C
    elif sample_rate in mp2_tables.SAMPLE_RATES_V1:
        version, rates = 3, mp2_tables.BITRATES_V1_L2
        sr_idx = mp2_tables.SAMPLE_RATES_V1.index(sample_rate)
        if bitrate_kbps is None:
            bitrate_kbps = 128 * C
    else:
        raise ValueError(f"Unsupported Layer II sample rate {sample_rate}.")
    if bitrate_kbps not in rates[1:]:
        raise ValueError(f"Unsupported Layer II bitrate {bitrate_kbps} "
                         f"(valid: {sorted(rates[1:])}).")
    bitrate_idx = rates.index(bitrate_kbps)
    mode = 3 if C == 1 else (1 if joint else 0)
    mode_ext = (joint_bound // 4 - 1) if joint else 0

    # probe header for table id / sblimit (padding doesn't affect them)
    hdr = mp2_frame.parse_header(
        mp2_frame.header_word(version, bitrate_idx, sr_idx, 0, mode,
                              mode_ext).to_bytes(4, "big"))
    sblimit = hdr.sblimit
    bound = hdr.bound                                 # == sblimit if no joint
    metas = _class_meta(hdr.table_id)
    nbal_bits = sum(
        (len(m[0]) - 1).bit_length() * (C if sb < bound else 1)
        for sb, m in enumerate(metas))

    F = (N + mp2_frame.SAMPLES_PER_FRAME - 1) // mp2_frame.SAMPLES_PER_FRAME
    x = np.zeros((C, F * mp2_frame.SAMPLES_PER_FRAME), dtype=np.float64)
    x[:, :N] = pcm.astype(np.float64) / 32768.0
    S = mp2_kernels.analyze_fast(x)                    # [C, F*36, 32]
    S = S.reshape(C, F, 12, 3, 32)

    # scalefactors per (frame, ch, part, sb)
    peaks = np.abs(S).reshape(C, F, 3, 4 * 3, 32).max(axis=3)  # [C,F,3,32]
    sfidx = _sf_indices(peaks)
    sf_val = mp2_tables.scalefactors()[sfidx]                  # [C,F,3,32]

    if joint:
        # mid signal for the shared (intensity) subbands; quantised against
        # its own scalefactor so each channel's transmitted sf restores its
        # envelope on decode
        Sj = (S[0] + S[1]) * 0.5                               # [F,12,3,32]
        peaks_j = np.abs(Sj).reshape(F, 3, 4 * 3, 32).max(axis=2)
        sf_val_j = mp2_tables.scalefactors()[_sf_indices(peaks_j)]

    # scfsi per (frame, ch, sb): merge equal neighbours
    eq01 = sfidx[:, :, 0, :] == sfidx[:, :, 1, :]
    eq12 = sfidx[:, :, 1, :] == sfidx[:, :, 2, :]
    scfsi = np.zeros((C, F, 32), dtype=np.int32)
    scfsi[eq01 & eq12] = 2
    scfsi[eq01 & ~eq12] = 1
    scfsi[~eq01 & eq12] = 3
    sf_bits = np.choose(scfsi, [18, 12, 6, 12])               # per (ch,sb)
    need_db = 20.0 * np.log10(np.maximum(peaks.max(axis=2), 1e-9))  # [C,F,32]

    # CBR padding-slot accumulator (per-frame sizes fixed up front)
    slots_num = 144 * bitrate_kbps * 1000
    acc = 0
    pads = np.zeros(F, dtype=np.int32)
    for f in range(F):
        acc += slots_num % sample_rate
        if acc >= sample_rate:
            acc -= sample_rate
            pads[f] = 1
    frame_sizes = slots_num // sample_rate + pads
    budgets = frame_sizes * 8 - 32 - nbal_bits

    # greedy max-(SMR - SNR) allocation, every frame advanced in lockstep
    # (frames are independent; each picks its own argmax sequence)
    maxc = max(len(m[0]) for m in metas)
    bits_tbl = np.zeros((sblimit, maxc + 1), dtype=np.int64)
    snr_tbl = np.full((sblimit, maxc), np.inf)
    ncls = np.zeros(sblimit, dtype=np.int64)
    for sb, (classes, bits, snr) in enumerate(metas):
        k = len(classes)
        ncls[sb] = k
        bits_tbl[sb, :k] = bits
        bits_tbl[sb, k:] = bits[-1]
        snr_tbl[sb, :k] = snr
    alloc = np.zeros((F, C, sblimit), dtype=np.int64)
    spent = np.zeros(F, dtype=np.int64)
    sb_ix = np.arange(sblimit)
    first_cost = 2 + sf_bits.transpose(1, 0, 2)[:, :, :sblimit]  # [F,C,SB]
    need = need_db.transpose(1, 0, 2)[:, :, :sblimit]
    eligible = np.ones((1, C, sblimit), dtype=bool)
    if joint:
        # shared subbands allocate once through the ch0 slot: its first
        # activation pays BOTH channels' scfsi (2+2) and scalefactor bits;
        # its need covers the louder channel
        sfb = sf_bits.transpose(1, 0, 2)[:, :, :sblimit]
        first_cost = first_cost.copy()
        first_cost[:, 0, bound:] = 4 + sfb[:, 0, bound:] + sfb[:, 1, bound:]
        need = need.copy()
        need[:, 0, bound:] = np.maximum(need[:, 0, bound:],
                                        need[:, 1, bound:])
        eligible[0, 1, bound:] = False
    active = np.ones(F, dtype=bool)
    while active.any():
        cost = (bits_tbl[sb_ix, alloc + 1] - bits_tbl[sb_ix, alloc]
                + np.where(alloc == 0, first_cost, 0))
        gain = need - snr_tbl[sb_ix, np.minimum(alloc, ncls - 1)]
        ok = ((alloc + 1 < ncls) & (gain > -60.0) & eligible
              & (spent[:, None, None] + cost <= budgets[:, None, None]))
        flat = np.where(ok, gain, -np.inf).reshape(F, -1)
        best = flat.argmax(axis=1)
        active = np.isfinite(flat[np.arange(F), best])
        if not active.any():
            break
        fsel = np.nonzero(active)[0]
        ch_b, sb_b = np.unravel_index(best[fsel], (C, sblimit))
        spent[fsel] += cost[fsel, ch_b, sb_b]
        alloc[fsel, ch_b, sb_b] += 1

    # quantise: codes = clip(floor(((s/sf)*n + n - 1)/2 + .5), 0, n-1)
    levels_tbl = np.zeros((sblimit, maxc), dtype=np.int64)
    for sb, (classes, _, _) in enumerate(metas):
        levels_tbl[sb, :len(classes)] = classes
    n_lv = levels_tbl[sb_ix, alloc].transpose(1, 0, 2)     # [C,F,SB]
    nf = n_lv[:, :, None, None, :].astype(np.float64)      # [C,F,1,1,SB]
    S_q, sf_src = S, sf_val
    if joint:
        # shared subbands quantise the mid signal against its scalefactor
        # (only the ch0 slot's codes are transmitted there)
        S_q = S.copy()
        S_q[0, :, :, :, bound:] = Sj[:, :, :, bound:]
        sf_src = sf_val.copy()
        sf_src[0, :, :, bound:] = sf_val_j[:, :, bound:]
    # scalefactor part = granule // 4 (granule axis, not the 3-sample axis)
    sfq = sf_src[:, :, np.arange(12) // 4, :][:, :, :, None, :sblimit]
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.floor(((S_q[:, :, :, :, :sblimit] / sfq) * nf + nf - 1) / 2
                     + 0.5)
    codes_all = np.where(nf > 0, np.clip(q, 0, nf - 1), 0)
    codes_all = codes_all.reshape(C, F, 36, sblimit).astype(np.uint16)

    alloc_tx = alloc
    if joint:
        # transmitted matrix: both channels "active" at shared subbands so
        # pack_frames emits scfsi + scalefactors for each (the alloc and
        # sample sections read only the ch0 slot there)
        alloc_tx = alloc.copy()
        alloc_tx[:, 1, bound:] = alloc[:, 0, bound:]
    return mp2_frame.pack_frames(
        hdr, bitrate_idx, sr_idx, alloc_tx,
        scfsi.transpose(1, 0, 2)[:, :, :sblimit],
        sfidx.transpose(1, 0, 2, 3)[:, :, :, :sblimit],
        codes_all.transpose(1, 0, 2, 3), pads, frame_sizes)


# --- AHX container -----------------------------------------------------------

class AHX:
    """AHX (ADX-container MPEG-2 Layer II) decoder/encoder.

    Mirrors the `ADX` wrapper shape: static `decode(bytes) -> wav bytes` and
    `encode(wav bytes, ...) -> ahx bytes`.
    """

    @staticmethod
    def parse_header(data: bytes) -> dict:
        if len(data) < 0x18 or data[0] != 0x80 or data[1] != 0x00:
            raise ValueError("Invalid AHX file header.")
        data_offset = int.from_bytes(data[2:4], "big") + 4
        enc_type = data[4]
        if enc_type not in AHX_TYPES:
            raise ValueError("Not an AHX stream (ADX encoding type "
                             f"0x{enc_type:02x}).")
        channels = data[7]
        sample_rate = int.from_bytes(data[8:12], "big")
        total_samples = int.from_bytes(data[12:16], "big")
        if data_offset >= 12 and CRI_STRING not in data[:data_offset]:
            raise ValueError("CRI copyright string not found in AHX header.")
        return dict(data_offset=data_offset, type=enc_type,
                    channels=channels, sample_rate=sample_rate,
                    total_samples=total_samples)

    @staticmethod
    def decode(data: bytes, device: bool = False) -> bytes:
        """AHX -> WAV (PCM16)."""
        if isinstance(data, str):
            with open(data, "rb") as fh:
                data = fh.read()
        info = AHX.parse_header(bytes(data))
        pcm, sr = decode_mp2(bytes(data), info["data_offset"], device=device)
        n = info["total_samples"]
        if n:
            if pcm.shape[1] < n:   # truncated stream: zero-fill to the
                pad = np.zeros((pcm.shape[0], n - pcm.shape[1]), np.int16)
                pcm = np.concatenate([pcm, pad], axis=1)  # declared count,
            pcm = pcm[:, :n]       # like the ADX/HCA decode paths
        inter = np.ascontiguousarray(pcm.T).reshape(-1)
        return wavmod.write_wav(inter, pcm.shape[0], info["sample_rate"] or sr)

    @staticmethod
    def encode(data: bytes, bitrate_kbps: Optional[int] = None,
               AhxVersion: int = 0x11, device: bool = False) -> bytes:
        """WAV -> AHX.  Input must be mono at an MPEG-2 LSF rate
        (16000/22050/24000 Hz); resample upstream if needed."""
        if isinstance(data, str):
            with open(data, "rb") as fh:
                data = fh.read()
        wf = wavmod.parse_wav(bytes(data))
        if wf.channels != 1:
            raise ValueError("AHX is mono; got "
                             f"{wf.channels} channels.")
        if wf.sample_rate not in mp2_tables.SAMPLE_RATES_V2:
            raise ValueError("AHX requires an MPEG-2 LSF sample rate "
                             f"(16000/22050/24000), got {wf.sample_rate}.")
        if AhxVersion not in AHX_TYPES:
            raise ValueError("AhxVersion must be 0x10 or 0x11.")
        pcm = wf.pcm16
        stream = encode_mp2(pcm, wf.sample_rate, bitrate_kbps, device=device)
        return ahx_container(stream, wf.sample_rate, len(pcm), AhxVersion)

    @staticmethod
    def info(data: bytes) -> dict:
        if isinstance(data, str):
            with open(data, "rb") as fh:
                data = fh.read()
        info = AHX.parse_header(bytes(data))
        hdr = mp2_frame.parse_header(bytes(data), info["data_offset"])
        info.update(bitrate=hdr.bitrate, mpeg_version=hdr.version,
                    frame_size=hdr.frame_size, mode=hdr.mode)
        return info
