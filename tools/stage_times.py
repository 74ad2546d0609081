"""Per-stage device times of the HCA bank decode. Needs a GPU.

    python tools/stage_times.py [--streams 256] [--reps 5] [--trace DIR]

On the chip_smoke bank (stereo 48 kHz quality 2, keyed), for one 64-stream
chunk held in device memory it times, with block_until_ready:

- the bitstream unpack,
- the transform (dequant .. overlap-add) on the unpacked tensors,
- the fused unpack+transform step the pipeline dispatches,

checks that the device transform gives the host C++ transform's PCM, then
times parallel.decode_batch over the whole bank. With --trace it also writes
a profiler trace of one fused step (after the wall-time runs, since tracing
slows the host) and prints the device time per kernel name.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def _time_device(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return ts


def _fmt(ts):
    return (f"median {statistics.median(ts) * 1e3:.3f} ms "
            f"(min {min(ts) * 1e3:.3f}, n={len(ts)})")


def trace_summary(path, top=12):
    """Device time per kernel name from a jax.profiler trace directory:
    (busy seconds, [(name, seconds)] largest first)."""
    import glob

    from jax.profiler import ProfileData

    totals, spans = {}, []
    for f in glob.glob(os.path.join(path, "plugins", "profile", "*",
                                    "*.xplane.pb")):
        for plane in ProfileData.from_file(f).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    totals[ev.name] = totals.get(ev.name, 0.0) \
                        + ev.duration_ns * 1e-9
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return busy * 1e-9, ranked


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.ops import hca_frame, hca_kernels
    from pycricodecs_tpu.ops import hca_unpack_device
    from pycricodecs_tpu.parallel import pipeline
    from pycricodecs_tpu.utils import hca_crypt

    if jax.devices()[0].platform != "gpu":
        print("stage_times: needs a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}; XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)

    key = chip_smoke.KEY
    blobs = chip_smoke.make_bank(args.streams)
    hs = int.from_bytes(blobs[0][6:8], "big")
    info = hca_frame.parse_header(blobs[0][:hs])
    info.set_key(hca_crypt.scramble_subkey(key, 0))
    fs, C = info.frame_size, info.channels
    B = min(64, len(blobs))
    F = -(-info.frame_count // 32) * 32
    frames = np.zeros((B, F, fs), np.uint8)
    for b in range(B):
        data = blobs[b][hs:hs + info.frame_count * fs]
        frames[b, :info.frame_count] = np.frombuffer(
            data, np.uint8).reshape(-1, fs)
    pairs = hca_kernels.stereo_pairs_of(info.channel_type)
    hfr = hca_kernels.build_hfr_map(
        info.total_band_count, info.base_band_count, info.stereo_band_count,
        info.bands_per_hfr_group, info.hfr_group_count, info.version)
    hfr_args = tuple(jax.device_put(a) for a in (
        np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
        np.asarray(hfr.group_of), np.int32(hfr.zero_band)))
    frames_d = jax.device_put(frames)
    cipher = jax.device_put(np.asarray(info.cipher, np.uint8))
    ath = jax.device_put(np.asarray(info.ath, np.int32))
    print(f"chunk: {B} streams x {F} frames x {fs} B, {C} channels",
          flush=True)

    up = hca_unpack_device.DeviceUnpacker(info)
    flat = frames_d.reshape(B * F, fs)
    t0 = time.perf_counter()
    out = jax.block_until_ready(up._jit(flat, cipher, ath, B=B))
    print(f"unpack: first call incl. compile {time.perf_counter() - t0:.2f} s",
          flush=True)
    ts = _time_device(lambda: up._jit(flat, cipher, ath, B=B), args.reps)
    print(f"unpack: {_fmt(ts)}", flush=True)
    assert not np.asarray(out[4]).any()

    qc, sf, res, inten = out[:4]
    cfg = dict(base_band=int(info.base_band_count),
               total_band=int(info.total_band_count), stereo_pairs=pairs,
               apply_noise=False,
               apply_hfr=bool(info.bands_per_hfr_group > 0
                              and info.hfr_group_count > 0),
               hfr_group_count=int(info.hfr_group_count),
               hfr_static=hca_kernels.hfr_static_of(hfr)
               if info.hfr_group_count > 0 else None)
    z = jnp.zeros((1,) * 5, jnp.uint8)

    def transform():
        return hca_kernels.hca_decode_transform_batched(
            qc.reshape(B, F, C, 8, 128), sf.reshape(B, F, C, 128),
            res.reshape(B, F, C, 128), inten.reshape(B, F, C, 8),
            z, z, jnp.zeros((1,) * 5, bool), *hfr_args, **cfg)

    pcm = np.asarray(transform())
    print(f"transform (XLA): {_fmt(_time_device(transform, args.reps))}",
          flush=True)
    # device transform vs the host C++ transform (fp32, no FMA) on stream 0
    host = hca_kernels.hca_decode_transform_host(
        np.asarray(qc).reshape(B, F, C, 8, 128)[0],
        np.asarray(sf).reshape(B, F, C, 128)[0],
        np.asarray(res).reshape(B, F, C, 128)[0],
        np.asarray(inten).reshape(B, F, C, 8)[0], None, None, None,
        np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
        np.asarray(hfr.group_of), int(hfr.zero_band),
        base_band=cfg["base_band"], total_band=cfg["total_band"],
        stereo_pairs=pairs, apply_noise=False, apply_hfr=cfg["apply_hfr"],
        hfr_group_count=cfg["hfr_group_count"])
    diff = np.abs(pcm[0].astype(np.int32) - host.astype(np.int32))
    print(f"transform parity device vs host C++ (stream 0): "
          f"{int((diff > 0).sum())} of {diff.size} samples differ, "
          f"max {int(diff.max())} LSB", flush=True)

    step = pipeline._get_fused_device_decode(info, pairs)

    def fused():
        return step(frames_d, cipher, ath, *hfr_args)

    print(f"fused step: {_fmt(_time_device(fused, args.reps))}", flush=True)

    parallel.decode_batch(blobs, key=key)                    # compile
    walls = []
    for _ in range(args.reps):
        st = parallel.DecodeStats()
        t0 = time.perf_counter()
        parallel.decode_batch(blobs, key=key, stats=st)
        walls.append(time.perf_counter() - t0)
        assert st.device_unpack_streams == len(blobs)
    audio = len(blobs) * chip_smoke.MAIN_SECONDS
    print(f"decode_batch {len(blobs)} streams: wall {_fmt(walls)} -> "
          f"{audio / statistics.median(walls):.1f} audio-s/s", flush=True)

    if args.trace:
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(fused())
        busy, ranked = trace_summary(args.trace)
        print(f"trace: fused step device busy {busy * 1e3:.3f} ms; "
              f"top kernels:", flush=True)
        for name, sec in ranked:
            print(f"    {sec * 1e3:9.3f} ms  {name[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
