"""All five BASELINE.md benchmark configs, one JSON line each to stdout.

`bench.py` (the driver entry point) measures config 5 only — the headline
batched bank decode. This script additionally times the four single-file
configs. Single-file latency is dispatch-dominated on a remote device, so
each config reports both cold latency and steady-state throughput.

Run: python3 bench_all.py            (real device)
     BENCH_CONFIGS=1,3 python3 bench_all.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def _sine_wav(seconds, channels, sr=48000, seed=0, loop=False):
    from pycricodecs_tpu.utils.wav import write_wav
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.1 * np.sin(2 * np.pi * 991 * t)
           + 0.02 * rng.standard_normal(n))
    pcm = np.clip(sig * 4000, -32768, 32767).astype(np.int16)
    if channels > 1:
        pcm = np.stack([np.roll(pcm, 480 * c) for c in range(channels)],
                       1).reshape(-1)
    if loop:
        return write_wav(pcm, channels, sr, looping=True,
                         loop_start=sr, loop_end=2 * sr)
    return write_wav(pcm, channels, sr)


def _time(fn, reps=5):
    fn()  # warmup/compile
    t0 = time.perf_counter()
    cold = None
    best = 1e18
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        cold = cold or dt
        best = min(best, dt)
    return best


_ORACLE = "/tmp/refbuild"

def _time_oracle(stmt, reps=7, **blobs):
    """Best-of-N seconds for one compiled-reference call, or None.

    Runs in a FRESH subprocess (the reference extension self-corrupts its
    heap across certain call sequences — CLAUDE.md campaign adjudication
    note) with inputs passed via files.  `stmt` sees CriCodecs as C and each
    kwarg as a bytes variable of that name."""
    import subprocess
    import tempfile
    if not os.path.isdir(_ORACLE):
        return None
    with tempfile.TemporaryDirectory() as td:
        loads = []
        for k, v in blobs.items():
            p = os.path.join(td, k)
            with open(p, "wb") as f:
                f.write(v)
            loads.append(f"{k} = open({p!r}, 'rb').read()")
        prog = "\n".join([
            "import sys, time",
            f"sys.path.insert(0, {_ORACLE!r})",
            "import CriCodecs as C",
            *loads,
            f"{stmt}",                      # warmup
            "best = 1e18",
            f"for _ in range({reps}):",
            "    t0 = time.perf_counter()",
            f"    {stmt}",
            "    best = min(best, time.perf_counter() - t0)",
            "print(best)",
        ])
        try:
            out = subprocess.run(
                [sys.executable, "-c", prog], capture_output=True,
                text=True, timeout=600, check=True)
            return float(out.stdout.strip().splitlines()[-1])
        except Exception as exc:  # noqa: BLE001
            print(f"-- oracle timing failed: {exc!r}", file=sys.stderr)
            return None


def _time_vs_oracle(fn, stmt, pairs=5, inner=3, **blobs):
    """(best_ours_seconds, interleaved_ratio) against the compiled oracle.

    The 1-core bench VM throttles wildly (identical runs vary 2x across
    minutes — CLAUDE.md), so a ratio of two separately-timed windows is
    noise.  This interleaves the two sides A/B within the same window: a
    persistent oracle subprocess times `stmt` (best-of-`inner`) on request,
    alternating with our own best-of-`inner`, and the ratio is the MEDIAN
    of the per-pair ratios.  Within one config the repeated stmt is safe;
    the fresh-per-config process still isolates the reference extension's
    self-corrupting call sequences.
    """
    import queue
    import statistics
    import subprocess
    import tempfile
    import threading
    fn()  # warmup/compile

    def readline_timeout(stream, timeout):
        # The reference extension wedges/crashes nondeterministically; a
        # bare readline() would hang the whole bench run (ADVICE r4).
        q = queue.Queue()
        threading.Thread(target=lambda: q.put(stream.readline()),
                         daemon=True).start()
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("oracle pipe read timed out")

    def ours_once():
        best = 1e18
        for _ in range(inner):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    if not os.path.isdir(_ORACLE):
        return min(ours_once() for _ in range(pairs)), None
    td = tempfile.mkdtemp()
    try:
        loads = []
        for k, v in blobs.items():
            p = os.path.join(td, k)
            with open(p, "wb") as f:
                f.write(v)
            loads.append(f"{k} = open({p!r}, 'rb').read()")
        prog = "\n".join([
            "import sys, time",
            f"sys.path.insert(0, {_ORACLE!r})",
            "import CriCodecs as C",
            *loads,
            f"{stmt}",                      # warmup
            "print('READY', flush=True)",
            "for line in sys.stdin:",
            "    if line.strip() != 'go':",
            "        break",
            "    best = 1e18",
            f"    for _ in range({inner}):",
            "        t0 = time.perf_counter()",
            f"        {stmt}",
            "        best = min(best, time.perf_counter() - t0)",
            "    print(best, flush=True)",
        ])
        proc = subprocess.Popen([sys.executable, "-c", prog],
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        try:
            if readline_timeout(proc.stdout, 900).strip() != "READY":
                raise RuntimeError("oracle process failed to start")
            ratios, best_ours = [], 1e18
            for _ in range(pairs):
                dt = ours_once()
                best_ours = min(best_ours, dt)
                proc.stdin.write("go\n")
                proc.stdin.flush()
                ref = float(readline_timeout(proc.stdout, 600).strip())
                ratios.append(ref / dt)
            return best_ours, statistics.median(ratios)
        finally:
            try:
                proc.stdin.close()
                proc.wait(timeout=30)
            except Exception:  # noqa: BLE001
                proc.kill()
                try:
                    proc.wait(timeout=10)  # reap: no zombie
                except Exception:  # noqa: BLE001
                    pass
    except Exception as exc:  # noqa: BLE001
        print(f"-- interleaved oracle timing failed: {exc!r}",
              file=sys.stderr)
        return min(ours_once() for _ in range(pairs)), None
    finally:
        import shutil
        shutil.rmtree(td, ignore_errors=True)


def config1():
    """ADX decode: single mono 48kHz 4-bit file -> WAV."""
    from pycricodecs_tpu.models import adx
    dur = 10.0
    blob = adx.encode(_sine_wav(dur, 1, seed=1))
    dt, ratio = _time_vs_oracle(lambda: adx.decode(blob),
                                "C.AdxDecode(blob)", blob=blob)
    return "adx_decode_single_mono", dur / dt, "audio-sec/sec", ratio


def config2():
    """HCA decode: stereo v2.0 unencrypted -> WAV."""
    from pycricodecs_tpu.models import hca
    from pycricodecs_tpu.ops import hca_encode_host
    dur = 10.0
    blob = hca_encode_host.encode(_sine_wav(dur, 2, seed=2), quality=2)
    hs = int.from_bytes(blob[6:8], "big")
    dt, ratio = _time_vs_oracle(lambda: hca.decode(blob),
                                f"C.HcaDecode(blob, {hs}, 0, 0)", blob=blob)
    return "hca_decode_single_stereo", dur / dt, "audio-sec/sec", ratio


def config3():
    """ADX encode: stereo WAV with smpl loop -> ADX, verify roundtrip."""
    from pycricodecs_tpu.models import adx
    dur = 10.0
    wav = _sine_wav(dur, 2, seed=3, loop=True)
    blob = adx.encode(wav)
    assert b"smpl" in adx.decode(blob)  # loop chunk survives the roundtrip
    dt, ratio = _time_vs_oracle(
        lambda: adx.encode(wav),
        "C.AdxEncode(wav, 4, 0x12, 3, 0x1F4, 0, 4, 0)", wav=wav)
    return "adx_encode_single_stereo_loop", dur / dt, "audio-sec/sec", ratio


def config4():
    """HCA encode + encrypt/decrypt roundtrip with the BASELINE key."""
    from pycricodecs_tpu.models import hca
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.ops.hca_frame import parse_header
    key = 0xCF222F1FE0748978
    dur = 10.0
    wav = _sine_wav(dur, 2, seed=4)
    blob = hca_encode_host.encode(wav, quality=2)
    hs = parse_header(blob).header_size
    enc = hca.crypt(blob, True, hs, 56, key)
    assert hca.crypt(enc, False, hs, 56, key) == blob

    def run():
        e = hca_encode_host.encode(wav, quality=2)
        hca.crypt(e, True, hs, 56, key)

    # parity guard for the DEVICE encoder on the card
    from pycricodecs_tpu import parallel
    dev = parallel.hca_encode_batch([wav], quality=2, device=True)
    assert dev[0] == blob, "device encoder diverged from the host encoder"
    print("-- config 4: device-encoder parity guard OK", file=sys.stderr)
    dt, ratio = _time_vs_oracle(
        run,
        f"C.HcaCrypt(bytearray(C.HcaEncode(wav, 0, 2)), 1, {hs}, 56, "
        f"{key}, 0)", pairs=3, inner=2, wav=wav)
    return "hca_encode_encrypt_single_stereo", dur / dt, "audio-sec/sec", \
        ratio


def config5():
    """Batched bank decode — delegates to bench.py (the headline metric)."""
    import bench
    bench.main()
    return None, None


def config6():
    """Batched keycode search (capability beyond the reference)."""
    import numpy as np

    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models import hca
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.ops.hca_frame import parse_header
    key = 0xCF222F1FE0748978
    blob = hca_encode_host.encode(_sine_wav(5.0, 2, seed=6), quality=2)
    hs = parse_header(blob).header_size
    enc = hca.crypt(blob, True, hs, 56, key)
    rng = np.random.default_rng(0)
    K = 200000
    cands = rng.integers(1, 1 << 63, K).astype(np.uint64)
    cands[K // 2] = np.uint64(key)
    # warm at the FULL candidate shape: the wave-scoring dispatch compiles
    # per shape bucket and its compile would otherwise land inside the
    # timed region
    parallel.find_key(enc, cands, max_frames=8)
    best = 1e18
    for _ in range(3):
        t0 = time.perf_counter()
        scores = parallel.find_key(enc, cands, max_frames=8)
        best = min(best, time.perf_counter() - t0)
    assert int(parallel.rank_keys(scores)[0]) == K // 2
    return ("hca_key_search_keys_per_sec", K / best, "keys/sec")


def config7():
    """Batched ADX bank decode (threaded native lanes)."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models import adx
    dur, n = 10.0, 64
    blob = adx.encode(_sine_wav(dur, 2, seed=7))
    blobs = [blob] * n
    parallel.adx_decode_batch(blobs[:4])
    t0 = time.perf_counter()
    out = parallel.adx_decode_batch(blobs)
    dt = time.perf_counter() - t0
    assert len(out) == n
    return ("adx_bank_decode_audio_sec_per_sec", n * dur / dt,
            "audio-sec/sec")


def config8():
    """Batched AHX bank decode (capability beyond the reference)."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models.ahx import AHX
    dur, n = 10.0, 64
    blob = AHX.encode(_sine_wav(dur, 1, sr=22050, seed=8), bitrate_kbps=96)
    blobs = [blob] * n
    warm = parallel.ahx_decode_batch(blobs[:4])   # warm the compile cache
    # device-vs-float64 parity guard (a default-precision matmul has
    # produced silently-wrong output before)
    import numpy as np
    ref = parallel.ahx_decode_batch(blobs[:1], device=False)[0]
    d = np.abs(np.frombuffer(warm[0][44:], "<i2").astype(int)
               - np.frombuffer(ref[44:], "<i2").astype(int))
    assert d.max() <= 1, f"AHX device decode diverged: {d.max()} LSB"
    t0 = time.perf_counter()
    out = parallel.ahx_decode_batch(blobs)
    dt = time.perf_counter() - t0
    assert len(out) == n
    return ("ahx_bank_decode_audio_sec_per_sec", n * dur / dt,
            "audio-sec/sec")


def config9():
    """CRILAYLA compress (hash-chain matcher vs the reference's O(n*window)
    brute force; byte-identical output)."""
    import numpy as np

    from pycricodecs_tpu.models import crilayla
    rng = np.random.default_rng(1)
    chunk = rng.integers(0, 64, 4096, dtype=np.uint8).tobytes()
    data = (chunk * 64)[:256 * 1024] + bytes(256)
    blob = crilayla.compress(data)
    assert crilayla.decompress(blob) == data
    dt, ratio = _time_vs_oracle(lambda: crilayla.compress(data),
                                "C.CriLaylaCompress(data)", pairs=3,
                                inner=2, data=data)
    return ("crilayla_compress_mb_per_sec", len(data) / 1e6 / dt, "MB/sec",
            ratio)


def config10():
    """On-device HCA decode pipeline: raw frame bytes pre-staged in device
    memory, bitstream unpack (ops/hca_unpack_device) + XLA transform on the
    device, PCM left on device — one scalar output forces completion.
    Config 5 is end-to-end; this is the device's own decode rate."""
    import jax
    import jax.numpy as jnp

    from pycricodecs_tpu.ops import hca_encode_host, hca_frame, hca_kernels
    from pycricodecs_tpu.parallel import pipeline

    n, dur = int(os.environ.get("BENCH_STREAMS", "256")), 10.0
    blob = hca_encode_host.encode(_sine_wav(dur, 2, seed=5), quality=2)
    hs = int.from_bytes(blob[6:8], "big")
    info = hca_frame.parse_header(blob[:hs])
    fs, F = info.frame_size, info.frame_count
    arr = np.frombuffer(blob[hs:hs + F * fs], np.uint8).reshape(F, fs)
    frames_np = np.broadcast_to(arr, (n, F, fs)).copy()

    pairs = hca_kernels.stereo_pairs_of(info.channel_type) \
        if info.stereo_band_count > 0 else ()
    fused = pipeline._get_fused_device_decode(info, pairs)
    assert fused is not None
    hfr = hca_kernels.build_hfr_map(
        info.total_band_count, info.base_band_count, info.stereo_band_count,
        info.bands_per_hfr_group, info.hfr_group_count, info.version)
    hfr_args = (np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
                np.asarray(hfr.group_of), np.int32(hfr.zero_band))

    @jax.jit
    def run(frames, cipher, ath, hi, hsrc, hg, hz):
        pcm, err = fused(frames, cipher, ath, hi, hsrc, hg, hz)
        return pcm, jnp.any(err)

    dev = jax.device_put(frames_np)
    cipher_dev = jax.device_put(np.asarray(info.cipher, np.uint8))
    ath_dev = jax.device_put(np.asarray(info.ath, np.int32))
    hfr_dev = (cipher_dev, ath_dev) + tuple(jax.device_put(a)
                                            for a in hfr_args)
    pcm, e = run(dev, *hfr_dev)
    assert not bool(np.asarray(e))
    # parity guard: one stream fetched and compared against the host decode
    from pycricodecs_tpu.models import hca as hcamod
    one = np.asarray(pcm[0]).reshape(-1, info.channels)
    samples = (F * 1024 - info.encoder_delay - info.encoder_padding)
    one = one[info.encoder_delay:info.encoder_delay + samples]
    ref = hcamod.decode(blob)
    ref_pcm = np.frombuffer(ref[44:], "<i2").reshape(-1, info.channels)
    assert np.array_equal(one, ref_pcm), "device pipeline diverged"
    best = 1e18
    for _ in range(5):
        t0 = time.perf_counter()
        pcm, e = run(dev, *hfr_dev)
        assert not bool(np.asarray(e))   # scalar fetch = completion barrier
        best = min(best, time.perf_counter() - t0)
    return ("hca_device_pipeline_audio_sec_per_sec_per_chip",
            n * dur / best, "audio-sec/sec/chip", None, None,
            None)


def _ahx_device_rate(mp2_stream, data_offset, n, dur, total_samples,
                     ref_wav, nch):
    """On-device Layer II decode rate for one stream broadcast to an
    n-bank: the host C++ unpack's tensors pre-staged in device memory,
    dequant + synthesis on the device, with a <=1 LSB parity guard vs
    `ref_wav` (host engine)."""
    import jax

    from pycricodecs_tpu.ops import mp2_frame, mp2_kernels

    st = mp2_frame.unpack(mp2_stream, data_offset)

    def bank(a):
        return jax.device_put(np.broadcast_to(a, (n,) + a.shape).copy())

    args = (bank(st.codes), bank(st.levels), bank(st.sfidx))

    @jax.jit
    def run(codes, lev, sfi):
        pcm = mp2_kernels.dispatch_decode_batched(codes, lev, sfi)
        return pcm, pcm[(0,) * pcm.ndim] == 12345.0

    pcm, e = run(*args)
    assert not bool(np.asarray(e))
    # pcm[0] is [C, N] channel-major; the WAV reference is interleaved
    p0 = np.asarray(pcm[0]).reshape(nch, -1)
    got = p0.T.reshape(-1)[:total_samples * nch]
    refp = np.frombuffer(ref_wav[44:], "<i2").astype(int)
    d = np.abs(got[:len(refp)].astype(int) - refp)
    assert d.max() <= 1, f"AHX device pipeline diverged: {d.max()} LSB"
    best = 1e18
    for _ in range(5):
        t0 = time.perf_counter()
        pcm, e = run(*args)
        assert not bool(np.asarray(e))   # scalar fetch = completion barrier
        best = min(best, time.perf_counter() - t0)
    return n * dur / best


def config11():
    """On-device AHX pipeline: host-unpacked Layer II tensors pre-staged in
    device memory, dequant + synthesis filterbank on the device, PCM left on
    device (config 8 is the end-to-end number).  Measures mono (the classic
    AHX shape) and, when the system twolame oracle is present, a
    joint-stereo stream (second JSON record)."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models.ahx import AHX

    n, dur = int(os.environ.get("BENCH_STREAMS", "256")), 10.0
    blob = AHX.encode(_sine_wav(dur, 1, sr=22050, seed=8), bitrate_kbps=96)
    info = AHX.parse_header(blob)
    ref = parallel.ahx_decode_batch([blob], device=False)[0]
    mono = _ahx_device_rate(blob, info["data_offset"], n, dur,
                            info["total_samples"], ref, 1)

    # joint-stereo: twolame-encoded MPEG-1 Layer II through the same path
    try:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "mpeg_oracles", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "tests", "mpeg_oracles.py"))
        mo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mo)
        ok = mo.available()
    except Exception:  # noqa: BLE001
        ok = False
    if ok:
        sr = 44100
        t = np.arange(int(sr * dur)) / sr
        pcm = np.stack([np.sin(2 * np.pi * 440 * t),
                        np.sin(2 * np.pi * 554 * t)]) * 11000
        stream = mo.twolame_encode(pcm.astype(np.int16), sr, 192,
                                   mode="joint")
        nsamp = int(sr * dur)
        refs = parallel.ahx_decode_batch([stream], device=False)[0]
        js = _ahx_device_rate(stream, 0, n, dur, nsamp, refs, 2)
        print(json.dumps({
            "metric": "ahx_device_pipeline_joint_stereo_audio_sec_per_sec_per_chip",
            "value": round(js, 2), "unit": "audio-sec/sec/chip",
            "vs_baseline": round(js / 1000.0, 4)}))
    else:
        print("-- config 11: twolame unavailable, joint-stereo skipped",
              file=sys.stderr)
    return ("ahx_device_pipeline_audio_sec_per_sec_per_chip", mono,
            "audio-sec/sec/chip")


def config12():
    """On-device HCA encode pipeline, link-independent: PCM pre-staged in
    HBM, encode transform + certified-exact HFR normalisation + frame
    packer (ops/hca_pack_device) all on-chip, finished HCA frame bytes left
    in HBM — the encode mirror of config 10.  Config 4 is the end-to-end
    host number."""
    import jax
    import jax.numpy as jnp

    from pycricodecs_tpu.ops import hca_encode_device as D
    from pycricodecs_tpu.ops import hca_encode_host as H
    from pycricodecs_tpu.ops import hca_tables as T
    from pycricodecs_tpu.ops.hca_hfr_device import _group_counts
    from pycricodecs_tpu.utils import wav as wavmod

    n, dur = int(os.environ.get("BENCH_STREAMS", "256")), 10.0
    wav_bytes = _sine_wav(dur, 2, seed=12)
    w = wavmod.parse_wav(wav_bytes)
    cfg = H.init_encode(w, 2, w.looping)
    info = cfg.info
    C = info.channels
    F = info.frame_count
    Fp = -(-F // 16) * 16
    one = np.zeros((1, C, Fp * 1024), np.int16)
    tl = H.build_timeline(cfg, w)
    one[0, :, :tl.shape[1]] = tl
    pcm_np = np.broadcast_to(one, (n, C, Fp * 1024)).copy()

    pairs = tuple((c, c + 1) for c in range(C - 1)
                  if info.channel_type[c] == T.STEREO_PRIMARY) \
        if info.stereo_band_count > 0 else ()
    counts, counts2 = _group_counts(info, int(cfg.hfr_band_count))
    kw = dict(
        base_band=int(info.base_band_count),
        total_band=int(info.total_band_count),
        pairs=pairs,
        coded_counts=tuple(int(x) for x in info.coded_count),
        channel_types=tuple(int(x) for x in info.channel_type),
        hfr_group_count=int(info.hfr_group_count),
        bands_per_hfr_group=int(info.bands_per_hfr_group),
        hfr_band_count=int(cfg.hfr_band_count),
        frame_size=int(info.frame_size),
        hfr_counts=tuple(counts), hfr_counts2=tuple(counts2))

    @jax.jit
    def run(pcm):
        frames, fb = D.hca_encode_frames(pcm, **kw)
        # scalar checksum forces full completion
        return frames, jnp.any(fb) ^ (frames[0, 0, 0] == 255)

    dev = jax.device_put(pcm_np)
    frames, flag = run(dev)
    bool(np.asarray(flag))
    # parity guard: one stream fetched and byte-compared to the host encoder
    got = H.pack_header(info) + np.asarray(frames[0, :F]).tobytes()
    want = H.encode(wav_bytes, quality=2)
    assert got == want, "device encode pipeline diverged from host"
    best = 1e18
    for _ in range(5):
        t0 = time.perf_counter()
        frames, flag = run(dev)
        bool(np.asarray(flag))           # scalar fetch = completion barrier
        best = min(best, time.perf_counter() - t0)
    return ("hca_device_encode_audio_sec_per_sec_per_chip",
            n * dur / best, "audio-sec/sec/chip", None, None,
            None)


def config13():
    """On-device ADX decode pipeline, link-independent: raw block bytes
    pre-staged in HBM, fixed-width unpack (reshape/mask — no VLC) + chained-
    block fixpoint ADPCM on-chip, PCM left in HBM.  Config 7 is the
    end-to-end host-lane number (reference hot loop adx.cpp:189-273)."""
    import jax
    import jax.numpy as jnp

    from pycricodecs_tpu.models import adx as adx_model
    from pycricodecs_tpu.ops import adx_kernels

    n, dur = int(os.environ.get("BENCH_STREAMS", "256")), 10.0
    blob = adx_model.encode(_sine_wav(dur, 2, seed=13))
    h = adx_model.parse_adx_header(blob)
    pl = np.moveaxis(adx_model._payload_blocks(blob, h), 1, 0)  # [C, nb, bs]
    nb, bs = pl.shape[1], pl.shape[2]
    L = n * h.channels
    payload_np = np.broadcast_to(pl, (n,) + pl.shape).reshape(L, nb, bs).copy()
    g_h1, g_h2 = adx_model._history_init(h)
    h1 = np.tile(g_h1, n).astype(np.int32)
    h2 = np.tile(g_h2, n).astype(np.int32)
    coef = adx_model.calculate_coefficients(h.highpass_frequency,
                                            h.sample_rate)
    kw = dict(block_size=h.block_size, bit_depth=h.bit_depth,
              encoding_mode=h.encoding_mode,
              coef=tuple(int(x) for x in coef),
              static_coefficients=tuple(int(x) for x
                                        in adx_model.STATIC_COEFFICIENTS))

    @jax.jit
    def run(payload, h1, h2):
        pcm, conv = adx_kernels.adx_decode_device_pipeline(
            payload, h1, h2, **kw)
        return pcm, conv ^ (pcm[0, 0, 0] == 12345)   # scalar completion

    dev = jax.device_put(payload_np)
    h1d, h2d = jax.device_put(h1), jax.device_put(h2)
    pcm, flag = run(dev, h1d, h2d)
    assert bool(np.asarray(flag))                     # converged
    # parity guard: one stream vs the native host decode
    ref = adx_model._decode_arrays(blob, h, use_jax=False)
    got = np.asarray(pcm[:h.channels]).reshape(h.channels, -1)
    assert np.array_equal(got[:, :ref.shape[1]], ref), \
        "ADX device pipeline diverged"
    best = 1e18
    for _ in range(5):
        t0 = time.perf_counter()
        pcm, flag = run(dev, h1d, h2d)
        assert bool(np.asarray(flag))
        best = min(best, time.perf_counter() - t0)
    return ("adx_device_pipeline_audio_sec_per_sec_per_chip",
            n * dur / best, "audio-sec/sec/chip", None, None,
            None)


def config14():
    """Heterogeneous bank decode: mixed qualities/rates/channels/lengths/
    keys through decode_batch(engine="device") — the realistic ACB workload.
    Reports mixed-bank throughput plus vs_homogeneous (a same-total-audio
    uniform bank through the same engine), isolating the grouping/shape-
    bucketing/padding overhead that single-stream broadcast banks hide."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models import hca as hcamod
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.ops.hca_frame import parse_header

    n = int(os.environ.get("BENCH_STREAMS", "96"))
    key = 0xCF222F1FE0748978
    cases = [  # (quality, channels, rate, seconds, subkey or 0)
        (0, 2, 48000, 10.0, 0), (1, 2, 44100, 8.0, 0),
        (2, 1, 32000, 6.0, 0), (2, 2, 48000, 12.0, 0x55AA),
        (3, 2, 24000, 10.0, 0), (4, 1, 48000, 4.0, 0),
        (1, 4, 48000, 6.0, 0), (2, 6, 44100, 5.0, 0x0102),
    ]
    blobs, subkeys, durs = [], [], []
    for i in range(n):
        q, ch, sr, dur, sk = cases[i % len(cases)]
        blob = hca_encode_host.encode(
            _sine_wav(dur, ch, sr=sr, seed=140 + i), quality=q)
        if sk:
            hs = parse_header(blob).header_size
            blob = hcamod.crypt(blob, True, hs, 56, key, subkey=sk)
        blobs.append(blob)
        subkeys.append(sk)
        durs.append(dur)
    total_audio = sum(durs)
    kw = dict(key=key, subkeys=subkeys, engine="device")
    out = parallel.decode_batch(blobs, **kw)      # warm every shape bucket
    # parity on EVERY stream vs the single-stream decode
    for blob, sk, got in zip(blobs, subkeys, out):
        want = hcamod.decode(blob, key=key, subkey=sk) if sk \
            else hcamod.decode(blob)
        assert got == want, "heterogeneous bank stream diverged"
    mixed_bytes = sum(len(o) - 44 for o in out)
    best = 1e18
    for _ in range(3):
        t0 = time.perf_counter()
        parallel.decode_batch(blobs, **kw)
        best = min(best, time.perf_counter() - t0)
    mixed = total_audio / best

    # homogeneous control: same machinery, same PCM OUTPUT VOLUME (where
    # the copy-back binds, throughput is bytes/s, so matching audio-seconds
    # alone would let the channel mix skew the ratio), one config
    dur0 = 10.0
    blob0 = hca_encode_host.encode(_sine_wav(dur0, 2, seed=140), quality=2)
    one_bytes = len(hcamod.decode(blob0)) - 44
    n0 = max(1, int(round(mixed_bytes / one_bytes)))
    homog = [blob0] * n0
    out0 = parallel.decode_batch(homog, engine="device")
    uniform_bytes = sum(len(o) - 44 for o in out0)
    best0 = 1e18
    for _ in range(3):
        t0 = time.perf_counter()
        parallel.decode_batch(homog, engine="device")
        best0 = min(best0, time.perf_counter() - t0)
    ratio = (mixed_bytes / best) / (uniform_bytes / best0)
    print(f"-- config 14: mixed {mixed_bytes/best/1e6:.1f} MB/s vs "
          f"homogeneous {uniform_bytes/best0/1e6:.1f} MB/s "
          f"(x{ratio:.3f})", file=sys.stderr)
    return ("hca_heterogeneous_bank_audio_sec_per_sec", mixed,
            "audio-sec/sec", None, round(ratio, 4))


def config15():
    """On-device AHX/MP2 encode pipeline, link-independent: PCM pre-staged
    in HBM, analysis matmul + lockstep greedy allocation + on-chip bit
    packing (ops/mp2_encode_device), finished Layer II frame bytes left in
    HBM — the AHX mirror of config 12.  Parity guard: one stream fetched
    and byte-compared to the numpy mirror driven by the device-computed
    spectra (the module's cross-backend determinism contract)."""
    import jax
    import jax.numpy as jnp

    from pycricodecs_tpu.ops import mp2_encode_device as E

    n, dur = int(os.environ.get("BENCH_STREAMS", "256")), 10.0
    rate, br = 22050, 96
    N = int(rate * dur) // 1152 * 1152
    t = np.arange(N) / rate
    one = np.clip((0.55 * np.sin(2 * np.pi * 440 * t)
                   + 0.2 * np.sin(2 * np.pi * 1320 * t)) * 28000,
                  -32768, 32767).astype(np.int16)[None, None, :]
    pcm_np = np.broadcast_to(one, (n, 1, N)).copy()
    cfg = E.make_config(rate, 1, br)
    F = N // 1152
    pads = E.frame_padding(cfg, F)
    kw = dict(version=cfg.version, sr_idx=cfg.sr_idx,
              bitrate_idx=cfg.bitrate_idx, mode=cfg.mode,
              table_id=cfg.table_id, sblimit=cfg.sblimit,
              channels=cfg.channels, frame_base=cfg.frame_base,
              nbal_bits=cfg.nbal_bits)

    @jax.jit
    def run(pcm, p):
        frames = E.mp2_encode_frames(pcm, p, **kw)
        return frames, frames[0, 0, 0] + frames[-1, -1, -1]

    dev = jax.device_put(pcm_np)
    pd = jax.device_put(pads)
    frames, s = run(dev, pd)
    int(np.asarray(s))
    # parity guard at bank scale: spectra must come from the SAME dispatch
    # shape (the analysis reduce order is shape/fusion-dependent), so the
    # guard drives the return_spectra variant once
    gframes, S0 = E.mp2_encode_frames(dev, pd, return_spectra=True, **kw)
    got = E.assemble_stream(np.asarray(gframes[0, :F]), cfg, pads)
    want = E.encode_from_spectra_np(np.asarray(S0)[0], cfg)
    assert got == want, "device MP2 encode diverged from the mirror"
    best = 1e18
    for _ in range(5):
        t0 = time.perf_counter()
        frames, s = run(dev, pd)
        int(np.asarray(s))               # scalar fetch = completion barrier
        best = min(best, time.perf_counter() - t0)
    return ("ahx_device_encode_audio_sec_per_sec_per_chip",
            n * dur / best, "audio-sec/sec/chip", None, None,
            None)


def config16():
    """On-device ADX encode pipeline, link-independent: PCM blocks pre-
    staged in HBM, block-parallel fixpoint quantisation + reshape/shift
    packing on-chip, raw ADX block bytes left in HBM — the encode mirror
    of config 13 (reference hot loop adx.cpp:215-273, 380-414).  Parity
    guard: one stream's payload byte-compared to the host encoder."""
    import jax
    import jax.numpy as jnp

    from pycricodecs_tpu.models import adx as adx_model
    from pycricodecs_tpu.ops import adx_kernels

    n, dur = int(os.environ.get("BENCH_STREAMS", "256")), 10.0
    wav_bytes = _sine_wav(dur, 2, seed=16)
    prep = adx_model._encode_prep(
        wav_bytes, bit_depth=4, block_size=0x12, encoding_mode=3,
        highpass_frequency=0x1F4, filter_=0, version=4,
        force_not_looping=False)
    C, F, spb = prep.blocks.shape
    L = n * C
    pcm_np = np.broadcast_to(prep.blocks, (n, C, F, spb)).reshape(
        L, F, spb).copy()
    c0 = np.full(L, prep.c0, np.int32)
    c1 = np.full(L, prep.c1, np.int32)
    h1 = np.tile(prep.h1, n).astype(np.int32)
    h2 = np.tile(prep.h2, n).astype(np.int32)
    kw = dict(spb=spb, encoding_mode=3, bit_depth=4, block_size=0x12)

    @jax.jit
    def run(pcm, c0, c1, h1, h2):
        payload, conv = adx_kernels.adx_encode_device_pipeline(
            pcm, c0, c1, h1, h2, **kw)
        return payload, conv ^ (payload[0, 0, 0] == 255)  # completion scalar

    dev = jax.device_put(pcm_np)
    args = tuple(jax.device_put(x) for x in (c0, c1, h1, h2))
    payload, flag = run(dev, *args)
    assert bool(np.asarray(flag))                      # converged
    # parity guard: one stream assembled and byte-compared to host encode
    blocks = np.ascontiguousarray(
        np.moveaxis(np.asarray(payload[:C]), 0, 1))    # [F, C, bs]
    got = adx_model._assemble_stream(
        prep, blocks, bit_depth=4, block_size=0x12, encoding_mode=3,
        highpass_frequency=0x1F4, version=4)
    want = adx_model.encode(wav_bytes)
    assert got == want, "ADX device encode pipeline diverged"
    best = 1e18
    for _ in range(5):
        t0 = time.perf_counter()
        payload, flag = run(dev, *args)
        assert bool(np.asarray(flag))
        best = min(best, time.perf_counter() - t0)
    return ("adx_device_encode_audio_sec_per_sec_per_chip",
            n * dur / best, "audio-sec/sec/chip", None, None,
            None)


def config17():
    """On-device v3 PNS-noise bank, link-independent: quality-0 mono v3
    streams (min_resolution 0 -> resolution-0 bands noise-fill on decode,
    hca.cpp:1602-1635 analogue) through config 10's harness — the unpacker
    computes the LCG noise tensors on the device and the XLA transform
    applies the fill.  Parity guard: one stream byte-compared to the host
    decode."""
    import jax
    import jax.numpy as jnp

    from pycricodecs_tpu.ops import hca_encode_host, hca_frame, hca_kernels
    from pycricodecs_tpu.parallel import pipeline
    from pycricodecs_tpu.utils.crc import crc16

    n, dur = int(os.environ.get("BENCH_STREAMS", "256")), 10.0
    # quality-1 mono full-band, no HFR groups: the v2/v3 frame bitstreams
    # coincide, so relabeling v3.0 + min_resolution=0 yields a valid PNS
    # stream (q0 produces no resolution-0 bands; q2+ adds HFR groups which
    # break the relabel). The megakernel's noise cost is mask-density-
    # independent (dense masked ops), so the rate generalises.
    sr_n = 48000
    nsamp = int(sr_n * dur)
    tt = np.arange(nsamp) / sr_n
    rng = np.random.default_rng(17)
    sig = np.clip((0.5 * np.sin(2 * np.pi * 440 * tt)
                   + 0.02 * rng.standard_normal(nsamp)) * 32767,
                  -32768, 32767).astype(np.int16)
    from pycricodecs_tpu.utils.wav import write_wav
    blob = bytearray(hca_encode_host.encode(write_wav(sig, 1, sr_n),
                                            quality=1))
    hs = int.from_bytes(blob[6:8], "big")
    info_pre = hca_frame.parse_header(bytes(blob[:hs]))
    assert info_pre.hfr_group_count == 0 \
        and info_pre.total_band_count == 128, "v3 relabel needs no-HFR"
    assert blob[4:6] == b"\x02\x00" and blob[24:28] == b"comp"
    blob[4:6] = b"\x03\x00"
    blob[30] = 0                                 # min_resolution = 0
    blob[hs - 2:hs] = crc16(bytes(blob[:hs - 2])).to_bytes(2, "big")
    blob = bytes(blob)
    info = hca_frame.parse_header(blob[:hs])
    fs, F = info.frame_size, info.frame_count
    # the noise fill must actually trigger for this bench to mean anything
    unp = hca_frame.unpack_frames(info, blob[hs:hs + F * fs])
    assert unp.noise_mask.any(), "expected PNS noise bands in the bank"
    arr = np.frombuffer(blob[hs:hs + F * fs], np.uint8).reshape(F, fs)
    frames_np = np.broadcast_to(arr, (n, F, fs)).copy()

    pairs = hca_kernels.stereo_pairs_of(info.channel_type) \
        if info.stereo_band_count > 0 else ()
    fused = pipeline._get_fused_device_decode(info, pairs)
    assert fused is not None
    hfr = hca_kernels.build_hfr_map(
        info.total_band_count, info.base_band_count, info.stereo_band_count,
        info.bands_per_hfr_group, info.hfr_group_count, info.version)
    hfr_args = (np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
                np.asarray(hfr.group_of), np.int32(hfr.zero_band))

    @jax.jit
    def run(frames, cipher, ath, hi, hsrc, hg, hz):
        pcm, err = fused(frames, cipher, ath, hi, hsrc, hg, hz)
        return pcm, jnp.any(err)

    dev = jax.device_put(frames_np)
    cipher_dev = jax.device_put(np.asarray(info.cipher, np.uint8))
    ath_dev = jax.device_put(np.asarray(info.ath, np.int32))
    extra = (cipher_dev, ath_dev) + tuple(jax.device_put(a)
                                          for a in hfr_args)
    pcm, e = run(dev, *extra)
    assert not bool(np.asarray(e))
    from pycricodecs_tpu.models import hca as hcamod
    one = np.asarray(pcm[0]).reshape(-1, info.channels)
    samples = (F * 1024 - info.encoder_delay - info.encoder_padding)
    one = one[info.encoder_delay:info.encoder_delay + samples]
    ref = hcamod.decode(blob)
    ref_pcm = np.frombuffer(ref[44:], "<i2").reshape(-1, info.channels)
    assert np.array_equal(one, ref_pcm), "noise device pipeline diverged"
    best = 1e18
    for _ in range(5):
        t0 = time.perf_counter()
        pcm, e = run(dev, *extra)
        assert not bool(np.asarray(e))   # scalar fetch = completion barrier
        best = min(best, time.perf_counter() - t0)
    return ("hca_noise_device_pipeline_audio_sec_per_sec_per_chip",
            n * dur / best, "audio-sec/sec/chip", None, None,
            None)


def config18():
    """Link-free heterogeneous bank: config 14's mixed cases (qualities,
    rates, channel counts, lengths, subkeys) decoded fully on-chip — frames
    pre-staged in HBM per (config, rate, cipher) group exactly as
    decode_batch groups them, PCM left on device, scalar completion fetch —
    against a homogeneous bank of the same total PCM through the same
    harness.  vs_homogeneous here measures grouping/bucketing/padding waste
    at chip speed; config 14 measures it through the host link."""
    import jax
    import jax.numpy as jnp

    from pycricodecs_tpu.models import hca as hcamod
    from pycricodecs_tpu.ops import hca_encode_host, hca_frame, hca_kernels
    from pycricodecs_tpu.parallel import pipeline
    from pycricodecs_tpu.utils import hca_crypt

    n = int(os.environ.get("BENCH_STREAMS", "96"))
    key = 0xCF222F1FE0748978
    cases = [  # (quality, channels, rate, seconds, subkey or 0)
        (0, 2, 48000, 10.0, 0), (1, 2, 44100, 8.0, 0),
        (2, 1, 32000, 6.0, 0), (2, 2, 48000, 12.0, 0x55AA),
        (3, 2, 24000, 10.0, 0), (4, 1, 48000, 4.0, 0),
        (1, 4, 48000, 6.0, 0), (2, 6, 44100, 5.0, 0x0102),
    ]
    blobs, subkeys, durs = [], [], []
    for i in range(n):
        q, ch, sr, dur, sk = cases[i % len(cases)]
        blob = hca_encode_host.encode(
            _sine_wav(dur, ch, sr=sr, seed=180 + i), quality=q)
        if sk:
            hs = hca_frame.parse_header(blob).header_size
            blob = hcamod.crypt(blob, True, hs, 56, key, subkey=sk)
        blobs.append(blob)
        subkeys.append(sk)
        durs.append(dur)
    total_audio = sum(durs)

    def stage(blob_list, sk_list):
        """Group + stage like decode_batch's device path; returns a list of
        per-group (fused, device args, pcm_bytes, guard info)."""
        infos = []
        for blob, sk in zip(blob_list, sk_list):
            hs = int.from_bytes(blob[6:8], "big")
            info = hca_frame.parse_header(blob[:hs])
            info.set_key(hca_crypt.scramble_subkey(key, sk))
            infos.append((info, blob, hs))
        groups: dict = {}
        for idx, (info, _b, _h) in enumerate(infos):
            groups.setdefault(
                pipeline._config_key(info)
                + (int(info.sample_rate),
                   bytes(np.asarray(info.cipher, np.uint8))),
                []).append(idx)
        staged = []
        pcm_bytes = 0
        for members in groups.values():
            info0 = infos[members[0]][0]
            fs = info0.frame_size
            fmax = pipeline._round_up(
                max(infos[i][0].frame_count for i in members), 32)
            csize = len(members)
            Bp = pipeline._batch_bucket(csize)
            frames_np = np.zeros((Bp, fmax, fs), np.uint8)
            for b, idx in enumerate(members):
                info, blob, hs = infos[idx]
                data = blob[hs:hs + info.frame_count * fs]
                arr = np.frombuffer(data, np.uint8).reshape(-1, fs)
                frames_np[b, :arr.shape[0]] = arr
            pairs = hca_kernels.stereo_pairs_of(info0.channel_type) \
                if info0.stereo_band_count > 0 else ()
            fused = pipeline._get_fused_device_decode(info0, pairs)
            assert fused is not None, "mixed group fell off the device path"

            @jax.jit
            def run(frames, cipher, ath, hi, hsrc, hg, hz, _f=fused):
                pcm, err = _f(frames, cipher, ath, hi, hsrc, hg, hz)
                flag = jnp.any(err) | (pcm[(0,) * pcm.ndim]
                                       == jnp.int16(12345))
                return pcm, flag

            hfr = hca_kernels.build_hfr_map(
                info0.total_band_count, info0.base_band_count,
                info0.stereo_band_count, info0.bands_per_hfr_group,
                info0.hfr_group_count, info0.version)
            args = (jax.device_put(frames_np),
                    jax.device_put(np.asarray(info0.cipher, np.uint8)),
                    jax.device_put(np.asarray(info0.ath, np.int32)),
                    jax.device_put(np.asarray(hfr.band_is_hfr)),
                    jax.device_put(np.asarray(hfr.src_band)),
                    jax.device_put(np.asarray(hfr.group_of)),
                    jax.device_put(np.int32(hfr.zero_band)))
            # real PCM bytes produced for the members (padding excluded)
            for idx in members:
                info = infos[idx][0]
                samples = (info.frame_count * 1024 - info.encoder_delay
                           - info.encoder_padding)
                pcm_bytes += samples * info.channels * 2
            staged.append((run, args, members, infos))
        return staged, pcm_bytes

    def measure(staged):
        # warm combine() at THIS arity (and the group programs) outside the
        # timed loop — the homogeneous control re-pays the compile at a
        # different arity otherwise
        np.asarray(combine(*[run(*args)[1] for run, args, _m, _i in staged]))
        best = 1e18
        for _ in range(5):
            t0 = time.perf_counter()
            flags = [run(*args)[1] for run, args, _m, _i in staged]
            # ONE combined-flag fetch: per-group scalar fetches would add a
            # host round trip PER GROUP, turning the ratio into a
            # round-trip counter instead of a grouping-waste measure
            assert not bool(np.asarray(combine(*flags)))
            best = min(best, time.perf_counter() - t0)
        return best

    import jax as _jax

    @_jax.jit
    def combine(*fs):
        out = fs[0]
        for f in fs[1:]:
            out = out | f
        return out

    staged, mixed_bytes = stage(blobs, subkeys)
    # parity guard: first stream of every group vs the host decode
    for run, args, members, infos in staged:
        pcm, fl = run(*args)
        assert not bool(np.asarray(fl))
        info, blob, hs = infos[members[0]]
        one = np.asarray(pcm[0]).reshape(-1, info.channels)
        samples = (info.frame_count * 1024 - info.encoder_delay
                   - info.encoder_padding)
        one = one[info.encoder_delay:info.encoder_delay + samples]
        sk = subkeys[members[0]]
        want = hcamod.decode(blob, key=key, subkey=sk) if sk \
            else hcamod.decode(blob)
        ref = np.frombuffer(want[44:], "<i2").reshape(-1, info.channels)
        assert np.array_equal(one, ref), "mixed on-chip group diverged"
    best = measure(staged)
    mixed_rate = total_audio / best

    # homogeneous control: same total PCM bytes, one config, same harness
    dur0 = 10.0
    blob0 = hca_encode_host.encode(_sine_wav(dur0, 2, seed=180), quality=2)
    info0 = hca_frame.parse_header(
        blob0[:int.from_bytes(blob0[6:8], "big")])
    one_bytes = (info0.frame_count * 1024 - info0.encoder_delay
                 - info0.encoder_padding) * info0.channels * 2
    n0 = max(1, int(round(mixed_bytes / one_bytes)))
    staged0, uniform_bytes = stage([blob0] * n0, [0] * n0)
    best0 = measure(staged0)
    ratio = (mixed_bytes / best) / (uniform_bytes / best0)
    print(f"-- config 18: mixed on-chip {mixed_bytes/best/1e6:.0f} MB/s vs "
          f"homogeneous {uniform_bytes/best0/1e6:.0f} MB/s (x{ratio:.3f})",
          file=sys.stderr)
    return ("hca_heterogeneous_onchip_audio_sec_per_sec_per_chip",
            mixed_rate, "audio-sec/sec/chip", None, round(ratio, 4))


def config19():
    """On-device STEREO MP2 encode, link-independent, in joint (intensity)
    stereo mode — the encoder-side counterpart of config 11's joint-stereo
    decode headline.  Same harness as config 15 (PCM pre-staged in HBM,
    frames left there); reports the joint-stereo rate with the
    independent-stereo rate of the same bank as `vs_homogeneous`-style
    extra (joint/independent; > 1 means the shared-subband coding is also
    cheaper to compute).  Parity guard: device bytes == numpy mirror."""
    import jax
    import jax.numpy as jnp

    from pycricodecs_tpu.ops import mp2_encode_device as E

    n, dur = int(os.environ.get("BENCH_STREAMS", "256")), 10.0
    rate, br, jb = 44100, 192, 8
    N = int(rate * dur) // 1152 * 1152
    t = np.arange(N) / rate
    l = np.clip((0.5 * np.sin(2 * np.pi * 440 * t)
                 + 0.2 * np.sin(2 * np.pi * 1320 * t)) * 26000,
                -32768, 32767).astype(np.int16)
    r = np.clip((0.45 * np.sin(2 * np.pi * 660 * t)
                 + 0.15 * np.sin(2 * np.pi * 2217 * t)) * 26000,
                -32768, 32767).astype(np.int16)
    one = np.stack([l, r])[None]
    pcm_np = np.broadcast_to(one, (n, 2, N)).copy()
    F = N // 1152

    def harness(joint_bound, channels=2):
        cfg = E.make_config(rate, channels, br, joint_bound=joint_bound)
        pads = E.frame_padding(cfg, F)
        kw = dict(version=cfg.version, sr_idx=cfg.sr_idx,
                  bitrate_idx=cfg.bitrate_idx, mode=cfg.mode,
                  table_id=cfg.table_id, sblimit=cfg.sblimit,
                  channels=cfg.channels, frame_base=cfg.frame_base,
                  nbal_bits=cfg.nbal_bits, bound=cfg.bound,
                  mode_ext=cfg.mode_ext)

        @jax.jit
        def run(pcm, p):
            frames = E.mp2_encode_frames(pcm, p, **kw)
            return frames, frames[0, 0, 0] + frames[-1, -1, -1]

        dev = jax.device_put(pcm_np[:, :channels])
        pd = jax.device_put(pads)
        frames, s = run(dev, pd)
        int(np.asarray(s))
        gframes, S0 = E.mp2_encode_frames(dev, pd, return_spectra=True,
                                          **kw)
        got = E.assemble_stream(np.asarray(gframes[0, :F]), cfg, pads)
        want = E.encode_from_spectra_np(np.asarray(S0)[0], cfg)
        assert got == want, "stereo device MP2 encode diverged from mirror"
        best = 1e18
        for _ in range(5):
            t0 = time.perf_counter()
            frames, s = run(dev, pd)
            int(np.asarray(s))           # scalar fetch = completion barrier
            best = min(best, time.perf_counter() - t0)
        return n * dur / best

    joint_rate = harness(jb)
    indep_rate = harness(None)
    # mono bank at the SAME rate/bitrate: completes the encode matrix so
    # the mono<->joint gap decomposes into channels x frame-rate terms
    # (config 15's mono headline runs at 22.05 kHz = half the frames per
    # audio-second, which is why it is not directly comparable)
    mono_rate = harness(None, channels=1)
    print(f"-- config 19: joint {joint_rate:.0f} vs independent "
          f"{indep_rate:.0f} vs mono {mono_rate:.0f} audio-sec/s/chip",
          file=sys.stderr)
    return ("ahx_device_encode_joint_stereo_audio_sec_per_sec_per_chip",
            joint_rate, "audio-sec/sec/chip", None,
            round(joint_rate / indep_rate, 4),
            {"stereo_independent_audio_sec_per_sec_per_chip":
                 round(indep_rate, 2),
             "mono_same_rate_audio_sec_per_sec_per_chip":
                 round(mono_rate, 2)})


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench_all: needs a GPU, JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 1
    want = os.environ.get("BENCH_CONFIGS",
                          "1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19")
    configs = {"1": config1, "2": config2, "3": config3, "4": config4,
               "5": config5, "6": config6, "7": config7, "8": config8,
               "9": config9, "10": config10, "11": config11,
               "12": config12, "13": config13, "14": config14,
               "15": config15, "16": config16, "17": config17,
               "18": config18, "19": config19}
    for k in want.split(","):
        k = k.strip()
        print(f"-- config {k}: {configs[k].__doc__.splitlines()[0]}",
              file=sys.stderr)
        res = configs[k]()
        if res[0] is not None:
            metric, x = res[0], res[1]
            unit = res[2] if len(res) > 2 else "audio-sec/sec"
            rec = {"metric": metric, "value": round(x, 2), "unit": unit,
                   "vs_baseline": round(x / 1000.0, 4)}
            if len(res) > 3 and res[3] is not None:
                # ours-vs-compiled-reference on the same host (oracle timed
                # in a fresh subprocess, best-of-N); > 1 means we are faster
                rec["vs_reference"] = round(res[3], 3)
            if len(res) > 4 and res[4] is not None:
                # mixed-bank throughput relative to a uniform bank of the
                # same total audio through the same engine (config 14)
                rec["vs_homogeneous"] = res[4]
            if len(res) > 5 and isinstance(res[5], dict):
                rec.update(res[5])  # config-specific companion metrics
            rec.update(platform=jax.devices()[0].platform,
                       device_kind=jax.devices()[0].device_kind,
                       device_count=len(jax.devices()))
            print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
