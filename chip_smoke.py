"""Smoke run of the system's main path on one GPU.

    python chip_smoke.py           # main phase + every other device engine
    python chip_smoke.py --four    # the main bank on 4-GPU meshes only

Phases (each prints its times; any failed check raises):

- main: a 256-stream x 10 s stereo 48 kHz HCA bank (quality 2), enciphered
  with key 0xCF222F1FE0748978, decoded through parallel.decode_batch
  (engine="auto") and parallel.decode_awb on an in-memory AWB, both
  byte-compared with the host C++ lanes; every stream must have been
  unpacked on the device.
- engines: HCA device encode, AHX device decode, ADX device decode and
  encode, and find_key, each against its host engine.
- four (--four): the main bank decoded on make_mesh((4, 1)) and
  make_mesh((2, 2)), byte-compared with the one-device result.

The card's name and power limit come from nvidia-smi. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}. The
script exits non-zero, printing no result, when JAX's first device is not
a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

KEY = 0xCF222F1FE0748978
MAIN_STREAMS, MAIN_SECONDS = 256, 10.0
ENGINE_STREAMS, ENGINE_SECONDS = 64, 10.0
KEY_CANDIDATES = 200_000


def log(msg: str) -> None:
    print(msg, flush=True)


def _pcm(rng, seconds, channels, rate, lead=0):
    """Seeded tone + noise test signal, int16 [samples * channels]; the
    first `lead` samples are silent."""
    n = int(rate * seconds)
    t = np.arange(n) / rate
    chans = []
    for _c in range(channels):
        f1, f2 = rng.uniform(110, 880), rng.uniform(900, 4000)
        sig = (0.4 * np.sin(2 * np.pi * f1 * t)
               + 0.1 * np.sin(2 * np.pi * f2 * t)
               + 0.02 * rng.standard_normal(n))
        chans.append(sig)
    pcm = np.clip(np.stack(chans, 1) * 32767, -32768, 32767)
    pcm[:lead] = 0
    return pcm.astype(np.int16).reshape(-1)


def make_wavs(n, seconds, channels, rate, seed, lead=0):
    from pycricodecs_tpu.utils.wav import write_wav

    rng = np.random.default_rng(seed)
    return [write_wav(_pcm(rng, seconds, channels, rate, lead), channels,
                      rate) for _ in range(n)]


def make_bank(n=MAIN_STREAMS, seconds=MAIN_SECONDS, seed=0, key=KEY):
    """n distinct stereo 48 kHz quality-2 HCA streams enciphered with
    `key` (cipher 56), encoded by the host encoder."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models.hca import HCA

    wavs = make_wavs(n, seconds, 2, 48000, seed)
    out = []
    for blob in parallel.hca_encode_batch(wavs, quality=2):
        h = HCA(blob)
        h.encrypt(key)
        out.append(h.get_hca())
    return out


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def memory_report(blobs, key=KEY):
    """compiled.memory_analysis() of the fused unpack+transform step at the
    bank's chunk shape."""
    import jax

    from pycricodecs_tpu.ops import hca_frame, hca_kernels
    from pycricodecs_tpu.parallel import pipeline

    blob = blobs[0]
    hs = int.from_bytes(blob[6:8], "big")
    info = hca_frame.parse_header(blob[:hs])
    pairs = hca_kernels.stereo_pairs_of(info.channel_type)
    step = pipeline._get_fused_device_decode(info, pairs)
    B = min(len(blobs), 64)
    F = -(-info.frame_count // 32) * 32
    sds = jax.ShapeDtypeStruct
    args = (sds((B, F, info.frame_size), np.uint8), sds((256,), np.uint8),
            sds((128,), np.int32), sds((128,), np.bool_),
            sds((128,), np.int32), sds((128,), np.int32), sds((), np.int32))
    compiled = step.lower(*args).compile()
    return compiled.memory_analysis()


def phase_main(n=MAIN_STREAMS, seconds=MAIN_SECONDS, reps=3):
    """Bank decode through decode_batch and decode_awb vs the host lanes."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.containers.awb import build_afs2

    blobs, t = _timed(lambda: make_bank(n, seconds))
    log(f"main: built {n} x {seconds:g} s stereo HCA bank in {t:.2f} s "
        f"({sum(map(len, blobs)) / 1e6:.1f} MB)")
    audio = n * seconds

    stats = parallel.DecodeStats()
    dev, t = _timed(lambda: parallel.decode_batch(blobs, key=KEY,
                                                  stats=stats))
    log(f"main: decode_batch(engine='auto') warm-up incl. compile {t:.2f} s")
    assert stats.device_unpack_streams == n, stats
    for i in range(reps):
        st = parallel.DecodeStats()
        dev, t = _timed(lambda: parallel.decode_batch(blobs, key=KEY,
                                                      stats=st))
        assert st.device_unpack_streams == n, st
        log(f"main: decode_batch steady run {i}: {t:.3f} s "
            f"({audio / t:.1f} audio-s/s; staging {st.unpack_seconds:.3f} "
            f"s, dispatch {st.device_seconds:.3f} s, fetch "
            f"{st.fetch_seconds:.3f} s)")
    host, t = _timed(lambda: parallel.decode_batch(blobs, key=KEY,
                                                   engine="host"))
    log(f"main: host lanes {t:.3f} s")
    bad = [i for i, (a, b) in enumerate(zip(dev, host)) if a != b]
    assert not bad, f"device != host lanes for streams {bad[:8]}"
    log(f"main: decode_batch byte-identical to the host lanes "
        f"({n} streams, device_unpack_streams={stats.device_unpack_streams})")

    awb = build_afs2(blobs)
    out, t = _timed(lambda: parallel.decode_awb(awb, key=KEY))
    log(f"main: decode_awb {t:.3f} s")
    ref = parallel.decode_awb(awb, key=KEY, engine="host")
    assert out == ref, "decode_awb device != host lanes"
    assert out == host, "decode_awb != decode_batch"
    log(f"main: decode_awb byte-identical to the host lanes ({n} members)")
    return blobs, host


def phase_engines(n=ENGINE_STREAMS, seconds=ENGINE_SECONDS,
                  candidates=KEY_CANDIDATES):
    """Every other device engine once against its host engine."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.ops import hca_frame

    # HCA device encode: byte-exact; guard-frame streams re-encode on host
    wavs = make_wavs(n, seconds, 2, 48000, seed=1)
    st = parallel.DecodeStats()
    dev, t = _timed(lambda: parallel.hca_encode_batch(
        wavs, quality=2, device=True, stats=st))
    log(f"engines: hca_encode_batch(device=True) {n} x {seconds:g} s "
        f"incl. compile {t:.2f} s; re-encoded on the host: "
        f"{st.host_fallback_streams}")
    host = parallel.hca_encode_batch(wavs, quality=2)
    assert dev == host, "HCA device encode != host encoder"
    log("engines: HCA device encode byte-identical to the host encoder")

    # AHX device decode: within 1 int16 LSB of the float64 host path
    mono = make_wavs(n, seconds, 1, 22050, seed=2)
    ahx = parallel.ahx_encode_batch(mono)
    dev, t = _timed(lambda: parallel.ahx_decode_batch(ahx))
    host = parallel.ahx_decode_batch(ahx, device=False)
    worst = 0
    for a, b in zip(dev, host):
        assert a[:44] == b[:44]
        x = np.frombuffer(a[44:], "<i2").astype(np.int32)
        y = np.frombuffer(b[44:], "<i2").astype(np.int32)
        assert x.shape == y.shape
        worst = max(worst, int(np.abs(x - y).max()))
    assert worst <= 1, f"AHX device decode off by {worst} LSB"
    log(f"engines: ahx_decode_batch {n} x {seconds:g} s mono 22.05 kHz "
        f"incl. compile {t:.2f} s; max |device - host| = {worst} LSB "
        f"(contract: <= 1)")

    # ADX device encode + decode: byte-exact, non-converged groups counted
    # a silent first block: the decoder's copyright check reads one byte
    # into block 0 and refuses nonzero audio there, like the reference
    stereo = make_wavs(n, seconds, 2, 48000, seed=3, lead=64)
    st = parallel.DecodeStats()
    enc, t = _timed(lambda: parallel.adx_encode_batch(stereo, device=True,
                                                      stats=st))
    log(f"engines: adx_encode_batch(device=True) incl. compile {t:.2f} s; "
        f"streams of non-converged groups: {st.host_fallback_streams}")
    assert enc == parallel.adx_encode_batch(stereo), \
        "ADX device encode != host encoder"
    st = parallel.DecodeStats()
    dec, t = _timed(lambda: parallel.adx_decode_batch(enc, device=True,
                                                      stats=st))
    log(f"engines: adx_decode_batch(device=True) incl. compile {t:.2f} s; "
        f"streams of non-converged groups: {st.host_fallback_streams}")
    assert dec == parallel.adx_decode_batch(enc), \
        "ADX device decode != host lanes"
    log("engines: ADX device encode and decode byte-identical to the host")

    # find_key: batched scores equal the serial scorer on a sample
    blob = make_bank(1, 2.0, seed=4)[0]
    rng = np.random.default_rng(5)
    cands = rng.integers(0, 2**63, candidates, dtype=np.int64) \
        .astype(np.uint64)
    cands[candidates // 2] = KEY
    scores, t = _timed(lambda: parallel.find_key(blob, cands, max_frames=8))
    log(f"engines: find_key over {candidates} candidates {t:.2f} s "
        f"({candidates / t:.0f} keys/s incl. compile)")
    best = int(cands[parallel.rank_keys(scores)[0]])
    assert best == KEY, f"find_key ranked {best:#x} first"
    sample = [candidates // 2] + list(rng.choice(candidates, 31,
                                                 replace=False))
    for i in sample:
        want = hca_frame.score_key(blob, int(cands[i]), max_frames=8)
        assert scores[i] == want, (i, scores[i], want)
    log(f"engines: find_key scores equal the serial scorer on "
        f"{len(sample)} sampled candidates; best key {best:#x}")


def phase_four(n=MAIN_STREAMS, seconds=MAIN_SECONDS):
    """The main bank on 4-device meshes vs one device."""
    from pycricodecs_tpu import parallel

    blobs = make_bank(n, seconds)
    one, t = _timed(lambda: parallel.decode_batch(blobs, key=KEY,
                                                  engine="device"))
    log(f"four: one-device decode incl. compile {t:.2f} s")
    for shape in ((4, 1), (2, 2)):
        mesh = parallel.make_mesh(shape)
        st = parallel.DecodeStats()
        out, t = _timed(lambda: parallel.decode_batch(
            blobs, key=KEY, mesh=mesh, stats=st))
        log(f"four: make_mesh({shape}) decode incl. compile {t:.2f} s")
        st2 = parallel.DecodeStats()
        out, t = _timed(lambda: parallel.decode_batch(
            blobs, key=KEY, mesh=mesh, stats=st2))
        log(f"four: make_mesh({shape}) steady {t:.3f} s "
            f"({n * seconds / t:.1f} audio-s/s)")
        assert st.device_unpack_streams == n, st
        bad = [i for i, (a, b) in enumerate(zip(out, one)) if a != b]
        assert not bad, f"mesh {shape} != one device for {bad[:8]}"
        log(f"four: make_mesh({shape}) byte-identical to one device "
            f"({n} streams)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 1
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    if not args.four:
        devices = devices[:1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card: {smi.stdout.strip()}")
    log(f"jax {jax.__version__}: {len(jax.devices())} x "
        f"{devices[0].device_kind}; XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}")

    t0 = time.perf_counter()
    if args.four:
        phase_four()
        count = 4
    else:
        blobs, _host = phase_main()
        log(f"main: fused step memory_analysis: {memory_report(blobs)}")
        stats = devices[0].memory_stats() or {}
        log(f"main: peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use', 'n/a')}")
        t1 = time.perf_counter()
        phase_engines()
        log(f"engines: phase {time.perf_counter() - t1:.1f} s")
        count = len(jax.devices())
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
