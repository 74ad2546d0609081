"""HCA codec public API: decode / encode / encrypt / decrypt / info.

Drop-in surface for PyCriCodecs.HCA (reference hca.py:20-308): accepts HCA or
WAV input (path or bytes), hex-string keys, subkeys; exposes decode(),
encode(), encrypt(), decrypt(), info(), get_frames(), get_header(), get_hca().

Decode architecture: host bitstream unpack (ops/hca_frame.py, C++ core)
emits dense SoA tensors; the transform (C++ or ops/hca_kernels.py) runs
dequantise -> noise -> HFR -> intensity stereo -> IMDCT -> overlap-add for all
frames in parallel. Output parity target: bit-exact WAV vs HcaDecode
(hca.cpp:3340-3457).
"""
from __future__ import annotations

import numpy as np

from ..ops import hca_frame, hca_kernels
from ..utils import hca_crypt
from ..utils import wav as wavmod

SAMPLES_PER_FRAME = 1024
DEFAULT_KEY = hca_crypt.DEFAULT_KEY


def loop_points(info) -> tuple:
    """(looping, loop_start, loop_end) in output samples (hca.cpp:3372-3373).

    Shared by the single-stream and batched WAV writers so the loop math
    cannot drift between them."""
    if not info.loop_flag:
        return False, 0, 0
    loop_start = (info.loop_start_frame * SAMPLES_PER_FRAME
                  + info.loop_start_delay - info.encoder_delay)
    loop_end = (info.loop_end_frame * SAMPLES_PER_FRAME
                + (SAMPLES_PER_FRAME - info.loop_end_padding)
                - info.encoder_delay)
    return True, loop_start, loop_end


def decode_range(data: bytes, start_frame: int, end_frame: int = -1,
                 key: int = 0, subkey: int = 0) -> np.ndarray:
    """Decode an arbitrary frame range [start_frame, end_frame) to PCM16.

    The seek/checkpoint analogue (SURVEY.md §5): HCA is CBR and frame-
    seekable; decoding can start at any frame after a decoder reset. As in
    the reference (hca.h:90-92), the first decoded frame lacks the previous
    frame's overlap history, so its first 128 samples differ from a
    full-stream decode; everything after matches exactly.

    Returns interleaved PCM16 [samples, channels] for the range (no encoder
    delay/padding trimming — the caller knows its frame coordinates).
    """
    data = bytes(data)
    header_size = int.from_bytes(data[6:8], "big")
    info = hca_frame.parse_header(data[:header_size])
    info.set_key(hca_crypt.scramble_subkey(key, subkey))
    if end_frame < 0 or end_frame > info.frame_count:
        end_frame = info.frame_count
    start_frame = max(0, min(start_frame, end_frame))
    frames = data[header_size + start_frame * info.frame_size:
                  header_size + end_frame * info.frame_size]
    return decode_frames_to_pcm(info, frames)


def decode_frames_to_pcm(info: hca_frame.HcaInfo, frames: bytes,
                         random_state: int = 1,
                         use_jax: bool = None) -> np.ndarray:
    """Decode raw frame data to interleaved PCM16 [total_samples, channels].

    use_jax=None auto-selects the native C++ transform for a single stream
    (device dispatch latency would dominate); True forces the device kernel.
    Both are bit-exact with each other. Banks go through
    parallel.decode_batch, which keeps the batched device path.
    """
    unp = hca_frame.unpack_frames(info, frames, random_state=random_state)
    hfr = hca_kernels.build_hfr_map(
        info.total_band_count, info.base_band_count, info.stereo_band_count,
        info.bands_per_hfr_group, info.hfr_group_count, info.version)
    pairs = hca_kernels.stereo_pairs_of(info.channel_type) \
        if info.stereo_band_count > 0 else ()
    apply_noise = bool(info.min_resolution == 0 and unp.noise_mask.any())
    apply_hfr = bool(info.bands_per_hfr_group > 0 and info.hfr_group_count > 0)
    args = (unp.qc, unp.scalefactors, unp.resolutions, unp.intensity,
            unp.noise_src, unp.noise_sci, unp.noise_mask,
            np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
            np.asarray(hfr.group_of), np.int32(hfr.zero_band))
    config = dict(base_band=int(info.base_band_count),
                  total_band=int(info.total_band_count),
                  stereo_pairs=pairs, apply_noise=apply_noise,
                  apply_hfr=apply_hfr,
                  hfr_group_count=int(info.hfr_group_count))
    out = None
    if not use_jax:
        out = hca_kernels.hca_decode_transform_host(*args, **config)
    if out is None:
        out = np.asarray(hca_kernels.hca_decode_transform(*args, **config))
    return out.reshape(-1, info.channels)  # [F, 8, 128, C] -> samples x C


def decode(data: bytes, key: int = 0, subkey: int = 0) -> bytes:
    """HCA bytes -> WAV bytes (parity with CriCodecs.HcaDecode)."""
    data = bytes(data)
    header_size = int.from_bytes(data[6:8], "big")
    info = hca_frame.parse_header(data[:header_size])
    keycode = hca_crypt.scramble_subkey(key, subkey)
    info.set_key(keycode)

    samples_per_channel = (info.frame_count * SAMPLES_PER_FRAME
                           - info.encoder_delay - info.encoder_padding)
    frames = data[header_size:header_size + info.frame_count * info.frame_size]
    if len(frames) < info.frame_count * info.frame_size:
        # decode what's available; remaining output stays zero. Deliberate
        # divergence: the reference memcpy's frame_count frames with no
        # length check (hca.cpp:3434-3435), so truncated input reads out of
        # bounds and errors on the garbage — undefined, not matchable.
        usable = len(frames) // info.frame_size
        frames = frames[:usable * info.frame_size]
    pcm = decode_frames_to_pcm(info, frames)
    # discard encoder delay, clip to output length
    pcm = pcm[info.encoder_delay:]
    out = np.zeros((samples_per_channel, info.channels), dtype=np.int16)
    n = min(samples_per_channel, pcm.shape[0])
    out[:n] = pcm[:n]

    looping, loop_start, loop_end = loop_points(info)
    return wavmod.write_wav(out.reshape(-1), info.channels, info.sample_rate,
                            looping=looping, loop_start=loop_start,
                            loop_end=loop_end)


def crypt(data: bytes, encrypt: bool, header_size: int, ciph_type: int,
          keycode: int, subkey: int = 0) -> bytes:
    """Encrypt/decrypt all frames in place (parity with CriCodecs.HcaCrypt)."""
    data = bytearray(data)
    info = hca_frame.parse_header(bytes(data[:header_size]))
    use_type = ciph_type if encrypt else info.ciph_type
    keycode = hca_crypt.scramble_subkey(keycode, subkey)
    table = hca_crypt.cipher_table(use_type, keycode)
    if encrypt:
        table = hca_crypt.invert_cipher_table(table)
    fs = info.frame_size
    nbytes = info.frame_count * fs
    frames = np.frombuffer(bytes(data[header_size:header_size + nbytes]),
                           dtype=np.uint8).reshape(info.frame_count, fs)
    frames = hca_crypt.apply_cipher_frames(frames, table, restamp_crc=True)
    data[header_size:header_size + nbytes] = frames.tobytes()
    header = hca_crypt.crypt_header(data[:header_size],
                                    ciph_type if encrypt else 0)
    data[:header_size] = header
    return bytes(data)


class HCA:
    """Public HCA class mirroring PyCriCodecs.HCA."""

    def __init__(self, stream, key: int = 0, subkey: int = 0) -> None:
        if isinstance(stream, str):
            with open(stream, "rb") as fh:
                raw = fh.read()
        else:
            raw = bytes(stream)
        if isinstance(key, str):
            key = int(key, 16)
        if isinstance(subkey, str):
            subkey = int(subkey, 16)
        self.key = key
        self.subkey = subkey
        self.hcabytes: bytes = b""
        self._raw = raw
        self.encrypted = False
        self.filetype = ""
        self.hca: dict = {}
        self.looping = False
        # drop-in attributes reference users reach for (hca.py:55-75):
        # two independent cursors over the input and empty cipher tables.
        # (BytesIO over a bytes object is copy-on-write in CPython — these
        # cost no memory until someone writes through them.)
        import io as _io
        self.stream = _io.BytesIO(raw)
        self.hcastream = _io.BytesIO(raw)
        self.enc_table = b""
        self.table = b""
        self._parse()

    # -- parsing ------------------------------------------------------------

    def _parse(self) -> None:
        raw = self._hca_buffer()
        sig = raw[:4] if len(raw) >= 4 else b""
        masked = bytes(b & 0x7F for b in sig)
        self.HcaSig = sig
        if masked == b"HCA\x00":
            self.filetype = "hca"
            self.encrypted = sig != b"HCA\x00"
            if self.encrypted and not self.key:
                self.key = DEFAULT_KEY
            if self.key < 0:
                raise ValueError("HCA key cannot be a negative.")
            if self.key > 0xFFFFFFFFFFFFFFFF:
                raise OverflowError("HCA key cannot exceed the maximum size of 8 bytes.")
            if self.subkey < 0:
                raise ValueError("HCA subkey cannot be a negative.")
            if self.subkey > 0xFFFF:
                raise OverflowError("HCA subkey cannot exceed 65535.")
            self.version = int.from_bytes(raw[4:6], "big")
            self.header_size = int.from_bytes(raw[6:8], "big")
            info = hca_frame.parse_header(raw[:self.header_size])
            if info.ciph_type == 1:
                self.encrypted = True
            self._info = info
            self.hca = dict(
                Encrypted=self.encrypted,
                Header=sig,
                version=hex(self.version),
                HeaderSize=self.header_size,
                ChannelCount=info.channels,
                SampleRate=info.sample_rate,
                FrameCount=info.frame_count,
                EncoderDelay=info.encoder_delay,
                EncoderPadding=info.encoder_padding,
                FrameSize=info.frame_size,
                MinResolution=info.min_resolution,
                MaxResolution=info.max_resolution,
                TrackCount=info.track_count,
                ChannelConfig=info.channel_config,
                TotalBandCount=info.total_band_count,
                BaseBandCount=info.base_band_count,
                StereoBandCount=info.stereo_band_count,
                BandsPerHfrGroup=info.bands_per_hfr_group,
                CipherType=info.ciph_type,
            )
            if info.loop_flag:
                self.looping = True
                self.hca.update(dict(
                    LoopStart=info.loop_start_frame,
                    LoopEnd=info.loop_end_frame,
                    LoopStartDelay=info.loop_start_delay,
                    LoopEndPadding=info.loop_end_padding,
                ))
        elif sig == b"RIFF":
            self.filetype = "wav"
            self._wav = wavmod.parse_wav(raw)
            self.looping = self._wav.looping
            # drop-in header attributes (the reference unpacks the fused
            # RIFF+fmt WavHeaderStruct, hca.py:197-232; version/header_size
            # come from interpreting bytes 4..8 as the HCA header even for
            # WAVs — mirror that so introspection code ports unchanged)
            self.version = int.from_bytes(raw[4:6], "big")
            self.header_size = int.from_bytes(raw[6:8], "big")
            w = self._wav
            from ..containers.chunk import WavHeaderStruct
            try:
                (self.riffSignature, self.riffSize, self.wave, self.fmt,
                 self.fmtSize, self.fmtType, self.fmtChannelCount,
                 self.fmtSamplingRate, self.fmtSamplesPerSec,
                 self.fmtSamplingSize, self.fmtBitCount) = \
                    WavHeaderStruct.unpack(raw[:WavHeaderStruct.size])
                if (self.wave, self.fmt) != (b"WAVE", b"fmt "):
                    raise ValueError
            except Exception:
                # fmt not at the canonical offset: fill from the real parser
                self.riffSignature, self.riffSize = b"RIFF", len(raw) - 8
                self.wave, self.fmt = b"WAVE", b"fmt "
                self.fmtSize, self.fmtType = 16, w.compression
                self.fmtChannelCount = w.channels
                self.fmtSamplingRate = w.sample_rate
                self.fmtSamplesPerSec = w.sample_rate * w.channels * 2
                self.fmtSamplingSize = w.channels * 2
                self.fmtBitCount = w.bit_depth
            self.dataSig = b"data"
            self.dataSize = w.num_samples * 2
            if w.looping:
                self.LoopCount = 1
                self.LoopStartSample = w.loop_start
                self.LoopEndSample = w.loop_end
        else:
            raise ValueError("Invalid HCA or WAV file.")

    def _hca_buffer(self) -> bytes:
        return self.hcabytes if self.hcabytes else self._raw

    # -- public API ---------------------------------------------------------

    def Pyparse_header(self) -> None:
        """Drop-in alias for the reference's header (re)parse (hca.py:78)."""
        return self._parse()

    def info(self) -> dict:
        if self.filetype == "hca":
            return self.hca
        # same key set as the reference's WAV info() (hca.py:243-245)
        return dict(RiffSignature=self.riffSignature.decode(),
                    riffSize=self.riffSize,
                    WaveSignature=self.wave.decode(),
                    fmtSignature=self.fmt.decode(), fmtSize=self.fmtSize,
                    fmtType=self.fmtType,
                    fmtChannelCount=self.fmtChannelCount,
                    fmtSamplingRate=self.fmtSamplingRate,
                    fmtSamplesPerSec=self.fmtSamplesPerSec,
                    fmtSamplingSize=self.fmtSamplingSize,
                    fmtBitCount=self.fmtBitCount,
                    dataSignature=self.dataSig.decode(),
                    dataSize=self.dataSize)

    def decode(self) -> bytes:
        if self.filetype == "wav":
            raise ValueError("Input type for decoding must be an HCA file.")
        return decode(self._hca_buffer(), key=self.key, subkey=self.subkey)

    def encode(self, force_not_looping: bool = False, encrypt: bool = False,
               keyless: bool = False, quality_level=None) -> bytes:
        from ..ops import hca_encode_host
        from ..containers.chunk import CriHcaQuality

        if self.filetype == "hca":
            raise ValueError("Input type for encoding must be a WAV file.")
        if quality_level is None:
            quality_level = CriHcaQuality.High
        if quality_level not in list(CriHcaQuality):
            raise ValueError("Chosen quality level is not valid or is not the "
                             "appropiate enumeration value.")
        self.hcabytes = hca_encode_host.encode(
            self._raw, force_not_looping=bool(force_not_looping),
            quality=quality_level.value)
        self.filetype = "hca"
        self.encrypted = False
        self._parse()
        if encrypt:
            if self.key == 0 and not keyless:
                self.key = DEFAULT_KEY
            # NOTE: the reference passes `keyless` into the subkey slot here
            # (hca.py:273) — we call with explicit keywords instead.
            self.encrypt(self.key, keyless=keyless)
        return self.get_hca()

    def encrypt(self, keycode: int = None, subkey: int = 0,
                keyless: bool = False) -> None:
        if self.encrypted:
            raise ValueError("HCA is already encrypted.")
        if keycode is None:
            keycode = self.key or DEFAULT_KEY
        self.encrypted = True
        self.hcabytes = crypt(self._hca_buffer(), True, self.header_size,
                              1 if keyless else 56, keycode, subkey)
        self._parse()

    def decrypt(self, keycode: int = None, subkey: int = 0) -> None:
        if not self.encrypted:
            raise ValueError("HCA is already decrypted.")
        if keycode is None:
            keycode = self.key or DEFAULT_KEY
        self.encrypted = False
        self.hcabytes = crypt(self._hca_buffer(), False, self.header_size,
                              0, keycode, subkey)
        self._parse()

    def get_hca(self) -> bytes:
        return self._hca_buffer()

    def get_header(self) -> bytes:
        return self._hca_buffer()[:self.header_size]

    def get_frames(self):
        buf = self._hca_buffer()
        fs = self.hca["FrameSize"]
        for i in range(self.hca["FrameCount"]):
            off = self.header_size + i * fs
            yield (i, buf[off:off + fs])
