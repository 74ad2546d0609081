"""Benchmark: batched HCA bank decode throughput (BASELINE config 5).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Metric: decoded audio-seconds per wallclock second per device, end-to-end
(host staging + device unpack and transform + PCM copy-back + WAV bytes) for
a 256-stream HCA bank. vs_baseline is measured against the BASELINE.json
north-star of 1000x realtime. Needs a GPU: it exits non-zero otherwise.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_X_REALTIME = 1000.0


def main():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"bench: needs a GPU, JAX found {platform!r}", file=sys.stderr)
        return 1
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.utils.wav import write_wav

    n_streams = int(os.environ.get("BENCH_STREAMS", "256"))
    duration_s = float(os.environ.get("BENCH_SECONDS", "10.0"))
    sr = 48000
    samples = int(sr * duration_s)

    rng = np.random.default_rng(0)
    t = np.arange(samples) / sr
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.1 * np.sin(2 * np.pi * 991 * t)
           + 0.02 * rng.standard_normal(samples))
    pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int16)
    stereo = np.stack([pcm, np.roll(pcm, 480)], 1).reshape(-1)
    wav = write_wav(stereo, 2, sr)
    print(f"encoding {duration_s:.0f}s stereo reference stream...",
          file=sys.stderr)
    hca_blob = hca_encode_host.encode(wav, quality=2)
    blobs = [hca_blob] * n_streams
    audio_seconds = n_streams * duration_s

    engine = parallel.pick_hca_engine()
    print(f"platform={platform} kind={jax.devices()[0].device_kind} "
          f"devices={len(jax.devices())} engine={engine}", file=sys.stderr)
    # warmup at the real batch shape (compiles once; persistent cache reuses)
    t0 = time.perf_counter()
    parallel.decode_batch(blobs)
    print(f"warmup (incl. compile): {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    # parity guard: the device engine against the host C++ lanes
    n_guard = 4
    dev = parallel.decode_batch(blobs[:n_guard], engine="device")
    host = parallel.decode_batch(blobs[:n_guard], engine="host")
    assert dev == host, "device engine diverged from the host lanes"
    print(f"device-engine parity guard: {n_guard} streams bit-exact",
          file=sys.stderr)

    # Interleaved reference measurement: each timing window decodes the
    # SAME bank with us and a sample with the compiled reference, so their
    # ratio is robust to a host that slows down between runs.
    oracle = None
    try:
        sys.path.insert(0, "/tmp/refbuild")
        import CriCodecs as oracle  # noqa: N813
    except ImportError:
        print("reference oracle not built; skipping interleaved ratio",
              file=sys.stderr)
    hs = int.from_bytes(hca_blob[6:8], "big")
    n_ref = int(os.environ.get("BENCH_REF_FILES", "24"))

    best = 0.0
    best_ratio = 0.0
    for _ in range(int(os.environ.get("BENCH_RUNS", "5"))):
        stats = parallel.DecodeStats()
        t0 = time.perf_counter()
        out = parallel.decode_batch(blobs, stats=stats)
        elapsed = time.perf_counter() - t0
        assert len(out) == n_streams
        best = max(best, audio_seconds / elapsed)
        ratio_note = ""
        if oracle is not None:
            t1 = time.perf_counter()
            for _i in range(n_ref):
                oracle.HcaDecode(hca_blob, hs, 0, 0)
            ref_elapsed = time.perf_counter() - t1
            ref_x = (n_ref * duration_s) / ref_elapsed
            ratio = (audio_seconds / elapsed) / ref_x
            best_ratio = max(best_ratio, ratio)
            ratio_note = (f" | oracle {ref_x:.0f}x in-window ->"
                          f" ratio {ratio:.2f}")
        print(f"  run: {elapsed:.3f}s -> {audio_seconds/elapsed:.1f}x realtime"
              f" (unpack {stats.unpack_seconds:.2f}s dispatch+H2D"
              f" {stats.device_seconds:.2f}s D2H-bound tail"
              f" {stats.fetch_seconds:.2f}s){ratio_note}", file=sys.stderr)
    pcm_bytes = sum(len(o) for o in out)
    print(f"stage breakdown: PCM out {pcm_bytes/1e6:.0f}MB, engine={engine}",
          file=sys.stderr)

    extra = {}
    if best_ratio > 0:
        # audio-sec/s per core vs the reference decoding the same stream in
        # the same measurement windows (single-stream loop, same host)
        extra["vs_reference_interleaved"] = round(best_ratio, 3)
    # device-only number: raw frames pre-staged in device memory,
    # unpack+transform on the device, PCM left on the device
    import bench_all
    res = bench_all.config10()   # tuple; [1] = audio-sec/s
    x = res[1]
    print(f"on-device pipeline (bit-exact): {x:.0f}x realtime",
          file=sys.stderr)
    extra["device_pipeline_x_realtime"] = round(x, 2)

    print(json.dumps({
        "metric": "hca_bank_decode_audio_sec_per_sec_per_chip",
        "value": round(best, 2),
        "unit": "audio-sec/sec/chip",
        "vs_baseline": round(best / BASELINE_X_REALTIME, 4),
        "platform": platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
