"""Batched / sharded decode pipelines.

This is the framework's analogue of data/sequence parallelism (SURVEY.md
§2.4): thousands of independent HCA/ADX streams per device batch, sharded over
a `jax.sharding.Mesh`:

- the stream axis B shards over the "dp" mesh axis (embarrassingly parallel);
- the frame/time axis F can shard over "sp": the IMDCT overlap-add couples
  neighbouring frames through a one-step shift, covered by a one-frame halo
  exchanged with `ppermute` — no custom collectives needed.

The engine of each (codec, stage) comes from `pycricodecs_tpu.backend`.

Entry points:
    decode_batch(blobs, key=...)         -> list of WAV bytes
    decode_awb / decode_acb              -> bank decode (BASELINE config 5)
    encode_batch(wavs, ...)              -> list of ADX blobs (batched ADX)
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import backend
from ..models import hca as hca_model
from ..ops import hca_frame, hca_kernels
from ..utils import hca_crypt
from ..utils import wav as wavmod

SAMPLES_PER_FRAME = 1024


@dataclass
class DecodeStats:
    """Per-call pipeline observability (SURVEY.md §5): stage timings + counts."""
    streams: int = 0
    groups: int = 0
    frames: int = 0
    failed_streams: int = 0
    bytes_in: int = 0
    samples_out: int = 0
    unpack_seconds: float = 0.0
    device_seconds: float = 0.0   # dispatch + H2D (async overlap included)
    fetch_seconds: float = 0.0    # device->host transfers
    total_seconds: float = 0.0
    device_unpack_streams: int = 0  # streams whose bitstream decode ran on device
    # streams a device entry point handed to the host lanes after its device
    # attempt (non-converged ADX groups, HCA encode guard frames)
    host_fallback_streams: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


_cache_ready = False

# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is not set: one
# fixed directory in the checkout (listed in .gitignore), so repeated runs of
# the same shapes skip compilation.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def _ensure_compile_cache() -> None:
    """Enable JAX's persistent compilation cache (decode shapes are
    bucketed, so repeat workloads hit it). Where JAX_COMPILATION_CACHE_DIR
    is set, JAX reads it itself and nothing is set here;
    PYCRICODECS_NO_JAX_CACHE=1 turns the cache off."""
    global _cache_ready
    if _cache_ready:
        return
    _cache_ready = True
    if os.environ.get("PYCRICODECS_NO_JAX_CACHE") \
            or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


class trace:
    """Optional xprof tracing for pipeline calls (SURVEY.md §5).

    with parallel.trace("/tmp/xprof"):
        parallel.decode_batch(blobs)

    Wraps jax.profiler.trace; view with xprof/tensorboard. No-op if the
    profiler is unavailable on the backend.
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._cm = None

    def __enter__(self):
        try:
            self._cm = jax.profiler.trace(self.log_dir)
            self._cm.__enter__()
        except Exception:
            self._cm = None
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            return self._cm.__exit__(*exc)
        return False


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "sp")) -> Mesh:
    """Build a device mesh. Default: all devices on the "dp" (stream) axis."""
    devices = np.array(jax.devices())
    if shape is None:
        shape = (len(devices), 1)
    devices = devices[:int(np.prod(shape))].reshape(tuple(shape))
    return Mesh(devices, axis_names=tuple(axis_names))


def _batch_bucket(csize: int) -> int:
    """Batch-shape bucket: 1.5x-pow2 ladder (1,2,3,4,6,8,12,16,24,32,...).

    Every distinct batch shape is a fresh device compile, so buckets bound
    the cache; pow2 buckets wasted up to 33% of a mixed bank's elements
    (config 18's 12-stream groups padded to 16 — measured utilisation
    0.726, the dominant term in vs_homogeneous 0.883). The half-step
    ladder caps the padded size at 1.5x worst-case (pow2: 2x), exact at
    every rung, for at most 2x the compile-cache entries."""
    if csize <= 4:
        return csize
    p = 1 << (csize - 1).bit_length()          # next pow2 >= csize
    return p - (p >> 2) if csize <= p - (p >> 2) else p


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def pick_hca_engine(plat: Optional[str] = None) -> str:
    """Bank-decode engine for engine="auto": the device on a GPU, the
    native C++ lanes on the CPU (XLA on the CPU when the native library
    cannot be built)."""
    from .. import native
    eng = backend.engine("hca", "decode", plat)
    if eng == "host" and native.load() is None:
        return "device"
    return eng


def _config_key(info: hca_frame.HcaInfo) -> tuple:
    return (info.channels, info.version, info.frame_size,
            info.min_resolution, info.max_resolution, info.total_band_count,
            info.base_band_count, info.stereo_band_count,
            info.bands_per_hfr_group, info.hfr_group_count,
            info.channel_config, info.track_count, info.ath_type)


def decode_batch(blobs: Sequence[bytes], key: int = 0, subkey: int = 0,
                 subkeys: Optional[Sequence[int]] = None,
                 mesh: Optional[Mesh] = None,
                 return_arrays: bool = False,
                 on_error: str = "raise",
                 engine: str = "auto",
                 stats: Optional[DecodeStats] = None) -> List[bytes]:
    """Decode many HCA streams in device batches.

    Streams are grouped by transform configuration; each group is unpacked
    host-side (C++ core, threaded), frame-padded to a common length, stacked
    to [B, F, C, 8, 128] tensors and decoded in a single device dispatch,
    optionally sharded over `mesh` ("dp" = stream axis).

    on_error: "raise" aborts the whole batch on any corrupt stream;
    "isolate" keeps going — failed streams come back as the exception object
    instead of bytes (per-stream error isolation, SURVEY.md §5).

    engine: "device" = batched device unpack + transform; "host" =
    per-stream native C++ decode lanes; "auto" = pick_hca_engine() (the
    device on a GPU, the host lanes on the CPU; a mesh always means the
    device). Both engines are bit-exact. A device failure raises: it is
    never answered by the host lanes.

    Returns WAV bytes per stream (or (pcm16 array, info) when return_arrays).
    """
    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    if engine not in ("auto", "device", "host"):
        raise ValueError("engine must be 'auto', 'device' or 'host'")
    if engine == "auto":
        # an explicit mesh is a request for the sharded device path
        engine = "device" if mesh is not None else pick_hca_engine()
    _ensure_compile_cache()
    t_start = time.perf_counter()
    infos = []
    failures: dict = {}
    for i, blob in enumerate(blobs):
        blob = bytes(blob)
        try:
            hs = int.from_bytes(blob[6:8], "big")
            info = hca_frame.parse_header(blob[:hs])
        except Exception as exc:  # noqa: BLE001
            if on_error == "raise":
                raise
            failures[i] = exc
            infos.append(None)
            continue
        sk = subkeys[i] if subkeys is not None else subkey
        info.set_key(hca_crypt.scramble_subkey(key, sk))
        infos.append((info, blob, hs))

    groups: dict = {}
    for idx, entry in enumerate(infos):
        if entry is None:
            continue
        # cipher + sample rate join the group key: the device unpacker ships
        # one cipher/ATH per dispatch (they are dynamic inputs, so per-key
        # sub-batches reuse the same compiled program), and per-stream
        # subkeys therefore still ride the device path — each key simply
        # decodes in its own sub-batch
        groups.setdefault(
            _config_key(entry[0])
            + (int(entry[0].sample_rate),
               bytes(np.asarray(entry[0].cipher, np.uint8))),
            []).append(idx)

    results: List = [None] * len(blobs)
    if engine == "host":
        t0 = time.perf_counter()
        _decode_host_lanes(infos, results, failures, on_error)
        if stats is not None:
            stats.unpack_seconds += time.perf_counter() - t0
    else:
        for group in groups.values():
            if on_error == "raise":
                _decode_group(group, infos, results, mesh, stats)
                continue
            try:
                _decode_group(group, infos, results, mesh, stats)
            except Exception:  # noqa: BLE001
                # a stream in this group is corrupt: fall back to per-stream
                # decode so one bad member doesn't take down its group
                for idx in group:
                    try:
                        _decode_group([idx], infos, results, mesh, stats)
                    except Exception as exc:  # noqa: BLE001
                        failures[idx] = exc

    out = []
    for i, entry in enumerate(infos):
        if entry is None or i in failures:
            out.append(failures[i])
            continue
        (info, _blob, _hs), item = entry, results[i]
        if return_arrays:
            out.append((item, info))
        else:
            looping, loop_start, loop_end = hca_model.loop_points(info)
            out.append(wavmod.write_wav(
                item.reshape(-1), info.channels, info.sample_rate,
                looping=looping, loop_start=loop_start, loop_end=loop_end))
    if stats is not None:
        stats.streams += len(blobs)
        stats.groups += len(groups)
        stats.failed_streams += len(failures)
        stats.bytes_in += sum(len(b) for b in blobs)
        stats.frames += sum(e[0].frame_count for e in infos if e is not None)
        stats.samples_out += sum(
            int(np.size(r)) for r in results if r is not None)
        stats.total_seconds += time.perf_counter() - t_start
    return out


def _decode_host_lanes(infos, results, failures, on_error) -> None:
    """Host engine: per-stream native C++ unpack+transform lanes, threaded
    across streams (the engine on the CPU, and the parity reference for the
    device engine)."""
    import concurrent.futures as _cf

    def one(idx_entry):
        idx, (info, blob, hs) = idx_entry
        frames = blob[hs:hs + info.frame_count * info.frame_size]
        if len(frames) < info.frame_count * info.frame_size:
            frames = frames[:len(frames) // info.frame_size * info.frame_size]
        pcm = hca_model.decode_frames_to_pcm(info, frames, use_jax=False)
        # same trim/pad as the device path: drop encoder delay, zero-fill
        # any frames missing from a truncated stream (silence, like the
        # zero-padded batch tensor decodes to)
        samples = (info.frame_count * SAMPLES_PER_FRAME
                   - info.encoder_delay - info.encoder_padding)
        pcm = pcm[info.encoder_delay:info.encoder_delay + samples]
        if pcm.shape[0] < samples:
            full = np.zeros((samples, info.channels), dtype=np.int16)
            full[:pcm.shape[0]] = pcm
            pcm = full
        return idx, pcm

    work = [(i, e) for i, e in enumerate(infos) if e is not None]
    max_workers = min(8, os.cpu_count() or 1)
    with _cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {pool.submit(one, w): w[0] for w in work}
        for fut in _cf.as_completed(futures):
            idx = futures[fut]
            try:
                i, pcm = fut.result()
                results[i] = pcm
            except Exception as exc:  # noqa: BLE001
                if on_error == "raise":
                    for other in futures:
                        other.cancel()
                    raise
                failures[idx] = exc


_fused_device_decode_cache: dict = {}


def _crc16_rows(arr: np.ndarray) -> np.ndarray:
    """CRC16 per row of [N, size] u8 (utils.crc handles native dispatch)."""
    from ..utils import crc as crcmod
    return crcmod.crc16_batch(arr)


def _get_fused_device_decode(info0, pairs, mesh=None):
    """Fused device unpack+transform jit for one config, or None when the
    config needs the host unpacker (degenerate band configs).

    With a `mesh`, the fused fn is manually partitioned via shard_map, each
    device decoding its local block: streams shard over the first mesh
    axis, frames over the second, with a one-frame input halo (ppermute)
    covering the overlap-add's one-step cross-frame coupling.  Exception:
    v3 PNS noise configs on a frame-sharded mesh stay on GSPMD — the
    per-stream LCG prefix sums span the full frame axis and must not be
    localised.
    """
    from ..ops import hca_unpack_device

    sp_name = None
    if mesh is not None:
        if len(mesh.axis_names) > 1 and mesh.devices.shape[1] > 1:
            sp_name = mesh.axis_names[1]
        if info0.min_resolution == 0 and sp_name is not None:
            # noise path + frame sharding: GSPMD shards the LCG cumsums
            mesh = None
            sp_name = None
    mesh_key = None
    if mesh is not None:
        mesh_key = (tuple(mesh.axis_names), tuple(mesh.devices.shape),
                    tuple(int(d.id) for d in mesh.devices.flat))
    # cipher + ATH are dynamic inputs to the unpacker; only the
    # identity-cipher flag (it skips the decipher pass) is compiled in
    key = (_config_key(info0),
           bool(np.array_equal(np.asarray(info0.cipher, np.uint8),
                               np.arange(256, dtype=np.uint8))),
           pairs, mesh_key)
    hit = _fused_device_decode_cache.get(key)
    if hit is not None:
        return hit or None
    try:
        up = hca_unpack_device.DeviceUnpacker(info0)
    except ValueError:
        _fused_device_decode_cache[key] = False
        return None
    base_band = int(info0.base_band_count)
    total_band = int(info0.total_band_count)
    apply_hfr = bool(info0.bands_per_hfr_group > 0
                     and info0.hfr_group_count > 0)
    hfr_group_count = int(info0.hfr_group_count)
    hfr_static = hca_kernels.hfr_static_of(hca_kernels.build_hfr_map(
        int(info0.total_band_count), int(info0.base_band_count),
        int(info0.stereo_band_count), int(info0.bands_per_hfr_group),
        hfr_group_count, int(info0.version))) if apply_hfr else None

    def core(frames, cipher, ath, hfr_is, hfr_src, hfr_group, hfr_zero):
        B, F, fs = frames.shape
        qc, sf, res, inten, err, nsrc, nsci, nmask = up._unpack(
            frames.reshape(B * F, fs), cipher, ath, B=B)
        if up.need_noise:
            noise_args = (nsrc.reshape(B, F, up.C, 8, 128),
                          nsci.reshape(B, F, up.C, 8, 128),
                          nmask.reshape(B, F, up.C, 8, 128))
        else:
            noise_args = (jnp.zeros((1,) * 5, jnp.uint8),
                          jnp.zeros((1,) * 5, jnp.uint8),
                          jnp.zeros((1,) * 5, bool))
        pcm = hca_kernels.hca_decode_transform_batched(
            qc.reshape(B, F, up.C, 8, 128),
            sf.reshape(B, F, up.C, 128),
            res.reshape(B, F, up.C, 128),
            inten.reshape(B, F, up.C, 8),
            *noise_args,
            hfr_is, hfr_src, hfr_group, hfr_zero,
            base_band=base_band, total_band=total_band,
            stereo_pairs=pairs, apply_noise=up.need_noise,
            apply_hfr=apply_hfr,
            hfr_group_count=hfr_group_count, hfr_static=hfr_static)
        return pcm, err.reshape(B, F)

    if mesh is None:
        fused = jax.jit(core)
    else:
        dp = mesh.axis_names[0]
        nsp = mesh.devices.shape[1] if sp_name is not None else 1

        def local(frames, cipher, ath, hfr_is, hfr_src, hfr_group, hfr_zero):
            if sp_name is not None:
                # one-frame input halo: the OLA couples frame f to f-1 only,
                # so each shard redundantly decodes its left neighbour's
                # last frame and drops that frame's output.  Shard 0's halo
                # is a zero frame, which IMDCTs to silence — exactly the
                # empty carry the stream head needs.
                halo = jax.lax.ppermute(
                    frames[:, -1:], sp_name,
                    [(i, i + 1) for i in range(nsp - 1)])
                frames = jnp.concatenate([halo, frames], axis=1)
            pcm, err = core(frames, cipher, ath, hfr_is, hfr_src,
                            hfr_group, hfr_zero)
            if sp_name is not None:
                pcm = pcm[:, 1:]
                err = err[:, 1:]
            return pcm, err

        rep = P()
        fused = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(dp, sp_name, None), rep, rep, rep, rep, rep, rep),
            out_specs=(P(dp, sp_name, None, None, None), P(dp, sp_name)),
            check_vma=False))

    _fused_device_decode_cache[key] = fused
    return fused


def _decode_group(group, infos, results, mesh, stats=None) -> None:
    info0 = infos[group[0]][0]
    C = info0.channels
    fmax = max(infos[i][0].frame_count for i in group)
    B = len(group)
    # Bucket batch/frame axes: keeps the number of distinct compiled shapes
    # small and makes shardings divide evenly. Padding decodes to silence and is sliced away per stream below.
    fmax = _round_up(fmax, 32)
    if mesh is not None and len(mesh.devices.shape) > 1 \
            and mesh.devices.shape[1] > 1:
        fmax = _round_up(fmax, 32 * mesh.devices.shape[1])

    # Chunk the stream axis: each chunk is dispatched asynchronously (host
    # unpack of chunk i+1 and its H2D overlap the device->host fetch of
    # earlier chunks).
    chunk = 64
    if mesh is not None:
        chunk = _round_up(chunk, mesh.devices.shape[0])
    if B <= chunk:
        chunk_sizes = [B]
    else:
        chunk_sizes = [chunk] * (B // chunk)
        if B % chunk:
            chunk_sizes.append(B % chunk)

    hfr = hca_kernels.build_hfr_map(
        info0.total_band_count, info0.base_band_count,
        info0.stereo_band_count, info0.bands_per_hfr_group,
        info0.hfr_group_count, info0.version)
    pairs = hca_kernels.stereo_pairs_of(info0.channel_type) \
        if info0.stereo_band_count > 0 else ()
    need_noise = info0.min_resolution == 0
    hfr_args = (np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
                np.asarray(hfr.group_of), np.int32(hfr.zero_band))

    # Each chunk's fetch is handed to a worker thread the moment it is
    # dispatched: the host staging + H2D of chunk i+1 overlaps the PCM
    # copy-back of chunk i instead of serialising behind it.
    import concurrent.futures as _cf
    fetch_pool = _cf.ThreadPoolExecutor(max_workers=2)
    try:
        _decode_group_inner(group, infos, results, mesh, stats, fetch_pool,
                            chunk_sizes, chunk, B, fmax, C, info0, hfr,
                            pairs, need_noise, hfr_args)
    finally:
        # an exception mid-group (isolate mode retries per stream) must not
        # leak the pool's threads or in-flight device PCM fetches
        fetch_pool.shutdown(wait=True)


def _decode_group_inner(group, infos, results, mesh, stats, fetch_pool,
                        chunk_sizes, chunk, B, fmax, C, info0, hfr, pairs,
                        need_noise, hfr_args):
    pending = []  # (fetched_future, [(batch_row, stream_idx), ...])
    real_frames = {}  # stream idx -> frames actually present in the blob
    start = 0
    t_unpack = 0.0
    t_device = 0.0
    # Device-side unpack: raw frame bytes go to the device and the whole
    # bitstream decode runs there (ops/hca_unpack_device.py) — the host only
    # validates sync+CRC and stacks bytes. ~10x less H2D than the SoA
    # tensors. Works under meshes too (frames shard (dp, sp)), and covers
    # the v3 PNS noise path (LCG chain parallelised with prefix sums +
    # affine jumps). Host unpack: degenerate band layouts, or
    # PYCRICODECS_HOST_UNPACK=1.
    dev_decode = None
    if os.environ.get("PYCRICODECS_HOST_UNPACK") != "1":
        # groups are keyed by (config, sample_rate, cipher) so every member
        # shares the cipher/ATH shipped with the dispatch; different keys or
        # rates land in their own sub-batches against the same compiled
        # program (cipher/ATH are dynamic unpacker inputs)
        dev_decode = _get_fused_device_decode(info0, pairs, mesh=mesh)
    for csize in chunk_sizes:
        members = group[start:start + csize]
        start += csize
        Bp = _batch_bucket(csize)
        if B > chunk:
            Bp = chunk  # uniform chunk shape -> one compiled executable
        if mesh is not None:
            Bp = _round_up(Bp, mesh.devices.shape[0])

        if dev_decode is not None:
            fs = info0.frame_size
            t0 = time.perf_counter()
            frames_np = np.zeros((Bp, fmax, fs), dtype=np.uint8)
            for b, idx in enumerate(members):
                info, blob, hs = infos[idx]
                data = blob[hs:hs + info.frame_count * fs]
                n = len(data) // fs
                real_frames[idx] = n
                arr = np.frombuffer(data, np.uint8,
                                    count=n * fs).reshape(n, fs)
                if not (arr[:, :2] == 0xFF).all():
                    raise hca_frame.HcaError("Frame sync lost")
                frames_np[b, :n] = arr
            # one batched CRC sweep; zero padding rows have CRC 0
            if _crc16_rows(frames_np.reshape(-1, fs)).any():
                raise hca_frame.HcaError("Frame checksum mismatch")
            t_unpack += time.perf_counter() - t0
            t0 = time.perf_counter()
            frames_in = frames_np
            cipher_in = np.asarray(info0.cipher, np.uint8)
            ath_in = np.asarray(info0.ath, np.int32)
            hfr_in = hfr_args
            if mesh is not None:
                spec = [mesh.axis_names[0], None, None]
                if len(mesh.axis_names) > 1 and mesh.devices.shape[1] > 1:
                    spec[1] = mesh.axis_names[1]
                frames_in = jax.device_put(
                    frames_np, NamedSharding(mesh, P(*spec)))
                rep = NamedSharding(mesh, P())
                cipher_in = jax.device_put(cipher_in, rep)
                ath_in = jax.device_put(ath_in, rep)
                hfr_in = tuple(jax.device_put(a, rep) for a in hfr_args)
            out_dev, err_dev = dev_decode(frames_in, cipher_in, ath_in,
                                          *hfr_in)
            t_device += time.perf_counter() - t0

            def fetch_dev(o=out_dev, e=err_dev):
                err = np.asarray(e)
                if err.any():
                    raise hca_frame.HcaError("Unpack error (device)")
                return np.asarray(o)

            pending.append((fetch_pool.submit(fetch_dev),
                            list(enumerate(members))))
            if stats is not None:
                stats.device_unpack_streams += len(members)
            continue

        qc = np.zeros((Bp, fmax, C, 8, 128), dtype=np.int16)
        sf = np.zeros((Bp, fmax, C, 128), dtype=np.uint8)
        res = np.zeros((Bp, fmax, C, 128), dtype=np.uint8)
        inten = np.zeros((Bp, fmax, C, 8), dtype=np.uint8)
        if need_noise:
            noise_src = np.broadcast_to(np.arange(128, dtype=np.int32),
                                        (Bp, fmax, C, 8, 128)).copy()
            noise_sci = np.zeros((Bp, fmax, C, 8, 128), dtype=np.uint8)
            noise_mask = np.zeros((Bp, fmax, C, 8, 128), dtype=bool)
        else:
            noise_src = np.zeros((1,) * 5, dtype=np.int32)
            noise_sci = np.zeros((1,) * 5, dtype=np.uint8)
            noise_mask = np.zeros((1,) * 5, dtype=bool)

        t0 = time.perf_counter()
        for b, idx in enumerate(members):
            info, blob, hs = infos[idx]
            frames = blob[hs:hs + info.frame_count * info.frame_size]
            real_frames[idx] = len(frames) // info.frame_size
            # the unpacker writes straight into this stream's slice of the
            # stacked batch tensors (no intermediate copies)
            dest = hca_frame.UnpackedFrames(
                qc=qc[b], scalefactors=sf[b], resolutions=res[b],
                intensity=inten[b],
                noise_src=noise_src[b] if need_noise else noise_src,
                noise_sci=noise_sci[b] if need_noise else noise_sci,
                noise_mask=noise_mask[b] if need_noise else noise_mask,
                random_state=1)
            hca_frame.unpack_frames(info, frames, out=dest)
        t_unpack += time.perf_counter() - t0

        config = dict(base_band=int(info0.base_band_count),
                      total_band=int(info0.total_band_count),
                      stereo_pairs=pairs,
                      apply_noise=bool(need_noise and noise_mask.any()),
                      hfr_static=(hca_kernels.hfr_static_of(hfr)
                                  if info0.bands_per_hfr_group > 0
                                  and info0.hfr_group_count > 0 else None),
                      apply_hfr=bool(info0.bands_per_hfr_group > 0
                                     and info0.hfr_group_count > 0),
                      hfr_group_count=int(info0.hfr_group_count))
        if need_noise:
            # ship band indices as uint8: 1/4 the H2D bytes of the int32 the
            # unpacker writes
            noise_src = noise_src.astype(np.uint8)
        args = (qc, sf, res, inten, noise_src, noise_sci, noise_mask) + hfr_args
        if mesh is not None:
            batch_axis = mesh.axis_names[0]
            # qc/sf/res/inten are always [Bp, fmax, ...]; the noise tensors
            # only when need_noise (otherwise size-1 placeholders that must
            # stay replicated — shape[0] == Bp is not a safe test at Bp == 1)
            batch_shaped = [True] * 4 + [need_noise] * 3
            shardings = []
            for a, is_batch in zip(args[:7], batch_shaped):
                spec = [None] * np.ndim(a)
                if is_batch:
                    spec[0] = batch_axis
                    if np.ndim(a) >= 2 and len(mesh.axis_names) > 1 \
                            and mesh.devices.shape[1] > 1:
                        spec[1] = mesh.axis_names[1]
                shardings.append(NamedSharding(mesh, P(*spec)))
            for a in args[7:]:
                shardings.append(NamedSharding(mesh, P()))
            args = tuple(jax.device_put(a, s)
                         for a, s in zip(args, shardings))
        t0 = time.perf_counter()
        out_dev = hca_kernels.hca_decode_transform_batched(*args, **config)
        t_device += time.perf_counter() - t0
        pending.append((fetch_pool.submit(np.asarray, out_dev),
                        list(enumerate(members))))

    t0 = time.perf_counter()
    for fut, members in pending:
        out = fut.result()
        for b, idx in members:
            info = infos[idx][0]
            samples = (info.frame_count * SAMPLES_PER_FRAME
                       - info.encoder_delay - info.encoder_padding)
            pcm = out[b].reshape(-1, info.channels)
            pcm = pcm[info.encoder_delay:info.encoder_delay + samples]
            # owned copy: a view would pin the whole fetched chunk buffer
            pcm = pcm.copy()
            # truncated stream: the reference zeroes everything past the
            # last real frame (hca.cpp:3428-3430); the padded batch rows
            # decode to silence EXCEPT the first one, where the last real
            # frame's IMDCT carry bleeds through the overlap-add — zero it
            # so the device engine matches the host lanes byte-for-byte
            usable = (real_frames[idx] * SAMPLES_PER_FRAME
                      - info.encoder_delay)
            if usable < pcm.shape[0]:
                pcm[max(usable, 0):] = 0
            results[idx] = pcm
    if stats is not None:
        stats.unpack_seconds += t_unpack
        stats.device_seconds += t_device
        stats.fetch_seconds += time.perf_counter() - t0


def decode_awb(awb_obj_or_bytes, key: int = 0, mesh: Optional[Mesh] = None,
               decode_non_hca: bool = True,
               engine: str = "auto") -> List[bytes]:
    """Decode every HCA member of an AWB bank in one device batch."""
    from ..containers.awb import AWB
    from ..models.adx import decode as adx_decode

    awb = awb_obj_or_bytes if isinstance(awb_obj_or_bytes, AWB) \
        else AWB(awb_obj_or_bytes)
    members = list(awb.getfiles())
    hca_idx = [i for i, m in enumerate(members)
               if bytes(m[:4]) in (b"HCA\x00", b"\xC8\xC3\xC1\x00")]
    decoded = decode_batch([members[i] for i in hca_idx], key=key,
                           subkey=awb.subkey, mesh=mesh, engine=engine)
    out: List = [None] * len(members)
    for i, wav_bytes in zip(hca_idx, decoded):
        out[i] = wav_bytes
    ahx_idx = []
    for i, m in enumerate(members):
        if out[i] is not None:
            continue
        m = bytes(m)
        if decode_non_hca and m[:2] == b"\x80\x00" and len(m) > 4:
            if m[4] in (0x10, 0x11):        # AHX rides the ADX magic
                ahx_idx.append(i)
                continue
            try:
                out[i] = adx_decode(m, strict_cri_check=False)
                continue
            except Exception:
                pass                         # malformed: pass through raw
        out[i] = m
    if ahx_idx:
        for i, wav_bytes in zip(ahx_idx, ahx_decode_batch(
                [bytes(members[i]) for i in ahx_idx], on_error="isolate")):
            out[i] = wav_bytes if wav_bytes is not None else bytes(members[i])
    return out


def decode_acb(acb_obj_or_bytes, key: int = 0,
               mesh: Optional[Mesh] = None,
               engine: str = "auto") -> List[bytes]:
    """Decode an ACB's waveform bank in one device batch (BASELINE config 5)."""
    from ..containers.acb import ACB

    acb = acb_obj_or_bytes if isinstance(acb_obj_or_bytes, ACB) \
        else ACB(acb_obj_or_bytes)
    return decode_awb(acb.awb, key=key, mesh=mesh, engine=engine)


def adx_decode_batch(blobs: Sequence[bytes],
                     device: bool = False,
                     mesh: Optional[Mesh] = None,
                     stats: Optional[DecodeStats] = None) -> List[bytes]:
    """Decode many ADX streams.

    Default engine is the threaded native C++ lane scan. device=True uses
    the chained-block fixpoint (adx_kernels.adx_decode_fixpoint_blocks),
    provably exact on convergence; a non-converged group is decoded by the
    host lanes instead and counted in `stats.host_fallback_streams`.

    With a `mesh` the device engine is forced and the lane axis
    (streams x channels) shards over the first mesh axis; a 2-D mesh also
    shards the block axis over the second (GSPMD turns the fixpoint's
    block-shift into a collective-permute; the convergence flag reduces
    across shards).
    """
    import math

    from ..models import adx as adx_model
    from ..ops import adx_kernels

    if mesh is not None:
        device = True
    if not device:
        from .. import native
        if native.load() is not None:
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor() as pool:
                return list(pool.map(
                    lambda b: adx_model.decode(b, use_jax=False), blobs))

    _ensure_compile_cache()
    parsed = []
    for blob in blobs:
        blob = bytes(blob)
        parsed.append((adx_model.parse_adx_header(blob), blob))

    groups: dict = {}
    for idx, (h, _blob) in enumerate(parsed):
        spb = h.samples_per_block
        nblocks = math.ceil(h.sample_count / spb) if h.sample_count else 0
        bucket = _round_up(max(nblocks, 1), 64)
        # highpass/sample-rate join the key: the AR(2) coefficients are
        # compile-time constants of the on-device unpack
        key = (h.encoding_mode, h.bit_depth, h.block_size, h.version,
               h.highpass_frequency, h.sample_rate, bucket)
        groups.setdefault(key, []).append(idx)

    results: List = [None] * len(blobs)
    for (mode, bit_depth, block_size, version, hfreq, srate,
         bucket), members in groups.items():
        spb = (block_size - 2) * 8 // bit_depth
        if spb > 256:
            # exotic geometry (bd<=2 with huge blocks, up to spb=1012): the
            # device engine statically unrolls spb, so the compile alone
            # runs for minutes — host lanes are the engine of record here
            for idx in members:
                h, blob = parsed[idx]
                results[idx] = adx_model.decode(blob, use_jax=False,
                                                strict_cri_check=False)
            continue
        nlanes = sum(parsed[i][0].channels for i in members)
        lanes_p, bucket_p = nlanes, bucket
        if mesh is not None:
            lanes_p = _round_up(nlanes, mesh.devices.shape[0])
            if len(mesh.devices.shape) > 1 and mesh.devices.shape[1] > 1:
                bucket_p = _round_up(bucket, mesh.devices.shape[1])
        nlanes, bucket = lanes_p, bucket_p
        N = bucket * spb
        # raw block bytes straight to the device: the fixed-width unpack is
        # reshape/mask work (ops/adx_kernels.adx_unpack_device), and raw u8
        # is ~16x less H2D than the four int32 lane tensors the host demux
        # used to ship
        payload = np.zeros((nlanes, bucket, block_size), dtype=np.uint8)
        h1 = np.zeros(nlanes, dtype=np.int32)
        h2 = np.zeros(nlanes, dtype=np.int32)
        lane = 0
        lane_spans = []
        for idx in members:
            h, blob = parsed[idx]
            ch = h.channels
            pl = adx_model._payload_blocks(blob, h)      # [nb, C, bs]
            nb = pl.shape[0]
            payload[lane:lane + ch, :nb] = np.moveaxis(pl, 1, 0)
            g_h1, g_h2 = adx_model._history_init(h)
            h1[lane:lane + ch] = g_h1
            h2[lane:lane + ch] = g_h2
            lane_spans.append((idx, lane, ch, nb * spb))
            lane += ch
        coef = (0, 0) if mode == 2 else adx_model.calculate_coefficients(
            hfreq, srate)
        if mesh is not None:
            spec = [mesh.axis_names[0], None, None]
            if len(mesh.axis_names) > 1 and mesh.devices.shape[1] > 1:
                spec[1] = mesh.axis_names[1]
            payload = jax.device_put(
                payload, NamedSharding(mesh, P(*spec)))
            lane_s = NamedSharding(mesh, P(mesh.axis_names[0]))
            h1 = jax.device_put(h1, lane_s)
            h2 = jax.device_put(h2, lane_s)
        # block-parallel fixpoint decode (lanes = streams x channels x
        # blocks); provably exact when converged — the rare non-converged
        # case (1-LSB limit cycles) falls back to the serial native decode
        pcm_dev, conv = adx_kernels.adx_decode_device_pipeline(
            payload, h1, h2, block_size=block_size, bit_depth=bit_depth,
            encoding_mode=mode, coef=tuple(int(x) for x in coef),
            static_coefficients=tuple(
                int(x) for x in adx_model.STATIC_COEFFICIENTS))
        if bool(np.asarray(conv)):
            pcm = np.asarray(pcm_dev).reshape(nlanes, N)
        else:
            if stats is not None:
                stats.host_fallback_streams += len(members)
            for idx in members:
                h, blob = parsed[idx]
                results[idx] = adx_model.decode(blob, use_jax=False,
                                                strict_cri_check=False)
            continue
        for idx, lane0, ch, n in lane_spans:
            h, _blob = parsed[idx]
            count = h.sample_count
            interleaved = np.zeros(count * ch, dtype=np.int16)
            have = min(count, n)
            interleaved.reshape(count, ch)[:have] = pcm[lane0:lane0 + ch, :have].T
            results[idx] = wavmod.write_wav(
                interleaved, ch, h.sample_rate, looping=h.looping,
                loop_start=h.loop_start_sample, loop_end=h.loop_end_sample)
    return results


def adx_encode_batch(wav_blobs: Sequence[bytes], *, bit_depth: int = 4,
                     block_size: int = 0x12, encoding_mode: int = 3,
                     highpass_frequency: int = 0x1F4, filter_: int = 0,
                     version: int = 4, force_not_looping: bool = False,
                     scale_fix: bool = False,
                     device: bool = False,
                     mesh: Optional[Mesh] = None,
                     stats: Optional[DecodeStats] = None) -> List[bytes]:
    """Encode many WAVs to ADX.

    Default engine is the threaded native C++ encoder (adx.cpp:416-506
    semantics per stream). device=True runs the chained-block fixpoint
    encoder + on-device packer (adx_kernels.adx_encode_device_pipeline):
    every block of every stream quantises in parallel from guessed decoder
    states and iterates to the provably-exact serial fixpoint; raw block
    bytes leave the chip, headers are host-assembled. Per-lane AR(2)
    coefficients are runtime inputs, so mixed sample rates share one
    compiled program (unlike decode, whose unpack bakes them in).
    Non-converged groups fall back to the host encoder and are counted in
    `stats.host_fallback_streams`.

    With a `mesh` the device engine is forced and the lane axis
    (streams x channels) shards over the first mesh axis; a 2-D mesh also
    shards the block axis over the second.
    """
    import math

    from ..models import adx as adx_model
    from ..ops import adx_kernels

    if mesh is not None:
        device = True
    kw = dict(bit_depth=bit_depth, block_size=block_size,
              encoding_mode=encoding_mode,
              highpass_frequency=highpass_frequency, filter_=filter_,
              version=version, force_not_looping=force_not_looping,
              scale_fix=scale_fix)
    if not device:
        from .. import native
        if native.load() is not None:
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor() as pool:
                return list(pool.map(
                    lambda b: adx_model.encode(b, **kw), wav_blobs))
        return [adx_model.encode(b, **kw) for b in wav_blobs]

    _ensure_compile_cache()
    preps = [adx_model._encode_prep(
        bytes(b), bit_depth=bit_depth, block_size=block_size,
        encoding_mode=encoding_mode, highpass_frequency=highpass_frequency,
        filter_=filter_, version=version,
        force_not_looping=force_not_looping) for b in wav_blobs]

    results: List = [None] * len(wav_blobs)
    groups: dict = {}
    for idx, prep in enumerate(preps):
        if prep.frames == 0:
            results[idx] = adx_model.encode(bytes(wav_blobs[idx]), **kw)
            continue
        groups.setdefault(_round_up(prep.frames, 64), []).append(idx)

    spb = (block_size - 2) * 8 // bit_depth
    if spb > 256:
        # the device engine statically unrolls spb (minutes of compile
        # at spb ~1000, see adx_decode_batch's gate): host encoder
        return [adx_model.encode(bytes(b), **kw) for b in wav_blobs]
    for bucket, members in groups.items():
        nlanes = sum(preps[i].channels for i in members)
        if mesh is not None:
            nlanes = _round_up(nlanes, mesh.devices.shape[0])
            if len(mesh.devices.shape) > 1 and mesh.devices.shape[1] > 1:
                bucket = _round_up(bucket, mesh.devices.shape[1])
        pcm = np.zeros((nlanes, bucket, spb), dtype=np.int32)
        h1 = np.zeros(nlanes, dtype=np.int32)
        h2 = np.zeros(nlanes, dtype=np.int32)
        c0 = np.zeros(nlanes, dtype=np.int32)
        c1 = np.zeros(nlanes, dtype=np.int32)
        lane = 0
        lane_spans = []
        for idx in members:
            prep = preps[idx]
            ch = prep.channels
            pcm[lane:lane + ch, :prep.frames] = prep.blocks
            h1[lane:lane + ch] = prep.h1
            h2[lane:lane + ch] = prep.h2
            c0[lane:lane + ch] = prep.c0
            c1[lane:lane + ch] = prep.c1
            lane_spans.append((idx, lane, ch))
            lane += ch
        if mesh is not None:
            spec = [mesh.axis_names[0], None, None]
            if len(mesh.axis_names) > 1 and mesh.devices.shape[1] > 1:
                spec[1] = mesh.axis_names[1]
            pcm = jax.device_put(pcm, NamedSharding(mesh, P(*spec)))
            lane_s = NamedSharding(mesh, P(mesh.axis_names[0]))
            h1, h2, c0, c1 = (jax.device_put(a, lane_s)
                              for a in (h1, h2, c0, c1))
        payload_dev, conv = adx_kernels.adx_encode_device_pipeline(
            pcm, c0, c1, h1, h2, spb=spb, encoding_mode=encoding_mode,
            bit_depth=bit_depth, block_size=block_size, filter_=filter_,
            scale_fix=scale_fix)
        if not bool(np.asarray(conv)):
            if stats is not None:
                stats.host_fallback_streams += len(members)
            for idx in members:
                results[idx] = adx_model.encode(bytes(wav_blobs[idx]), **kw)
            continue
        payload = np.asarray(payload_dev)
        for idx, lane0, ch in lane_spans:
            prep = preps[idx]
            blocks = np.moveaxis(
                payload[lane0:lane0 + ch, :prep.frames], 0, 1)
            results[idx] = adx_model._assemble_stream(
                prep, np.ascontiguousarray(blocks), bit_depth=bit_depth,
                block_size=block_size, encoding_mode=encoding_mode,
                highpass_frequency=highpass_frequency, version=version)
    return results


def find_key(data: bytes, candidates, subkey: int = 0,
             max_frames: int = 16) -> np.ndarray:
    """Score many candidate keycodes against one encrypted HCA stream.

    A capability beyond the reference (which only scores a single key via
    clHCA_TestBlock): the bitstream half of the test runs per (key, frame)
    in the threaded C++ core, and all surviving pairs are scored through
    ONE batched device dispatch of the float decode transform
    (ops/hca_kernels.hca_decode_wave) — key search is embarrassingly
    parallel and maps directly onto the stream-batch axis.

    Returns int64 scores aligned with `candidates`, same scale as
    hca_frame.score_key (summed clHCA_TestBlock frame scores): -1 =
    rejected; among the rest the LOWEST positive total is the most
    plausible (1 per frame = clean decode, clips inflate the total, 0 =
    all-silent/inconclusive). Use `rank_keys(scores)` / `best_key` below.
    """
    from ..ops import hca_frame, hca_kernels
    from ..utils import hca_crypt

    _ensure_compile_cache()
    data = bytes(data)
    header_size = int.from_bytes(data[6:8], "big")
    info = hca_frame.parse_header(data[:header_size])
    F = min(max_frames, info.frame_count)
    frames = data[header_size:header_size + F * info.frame_size]
    F = len(frames) // info.frame_size
    candidates = list(candidates)
    K = len(candidates)
    scores = np.full(K, -1, dtype=np.int64)
    if K == 0 or F == 0:
        return scores

    if info.ciph_type == 56:
        keys_u64 = np.asarray(candidates, dtype=np.uint64)
        if subkey:
            factor = np.uint64(hca_crypt.scramble_subkey(1, subkey))
            with np.errstate(over="ignore"):
                keys_u64 = keys_u64 * factor   # mod 2^64 (hca.cpp:3309-3311)
        tables = hca_crypt.cipher_tables_56_batch(keys_u64)
    else:
        tables = np.empty((K, 256), dtype=np.uint8)
        for i, key in enumerate(candidates):
            tables[i] = hca_crypt.cipher_table(
                info.ciph_type, hca_crypt.scramble_subkey(int(key), subkey))

    # phase 1: status-only reject over the first frames (no SoA tensors —
    # at 100k+ candidates the full spectra would be gigabytes); most wrong
    # keys fail the bitstream checks here
    reject_frames = frames[:min(2, F) * info.frame_size]
    pre = hca_frame.test_frames_native(info, reject_frames, tables,
                                       want_soa=False)
    if pre is None:  # no toolchain: exact but serial fallback
        for i, key in enumerate(candidates):
            scores[i] = hca_frame.score_key(data, int(key), subkey=subkey,
                                            max_frames=max_frames)
        return scores
    alive = (pre[0] >= 0).all(axis=1)                   # [K]
    alive_idx = np.nonzero(alive)[0]
    if alive_idx.size == 0:
        return scores

    # phase 2: full unpack + scoring for the surviving candidates only
    status, qc, sfs, ress, intens = hca_frame.test_frames_native(
        info, frames, tables[alive_idx], want_soa=True)
    Ka = alive_idx.size

    frame_scores = np.zeros((Ka, F), dtype=np.int64)
    frame_scores[status < 0] = -1
    live = (status == 1).reshape(-1)
    n_live = int(live.sum())
    noise_kw = {}
    if n_live and info.min_resolution == 0:
        # v3.0 PNS noise: the reference's TestBlock runs the full transform
        # including noise fill, with the LCG threading across each key's
        # transformed frames. Rebuild the band lists from the native
        # unpack's (sf, res) and advance the LCG per key.
        C_ = info.channels
        ident = np.broadcast_to(np.arange(128, dtype=np.int32),
                                (n_live, C_, 8, 128)).copy()
        nsci = np.zeros((n_live, C_, 8, 128), dtype=np.uint8)
        nmask = np.zeros((n_live, C_, 8, 128), dtype=bool)
        row = 0
        for k in range(Ka):
            rnd = 1
            for f in range(F):
                if status[k, f] != 1:
                    continue
                ridx = k * F + f
                frame_noise = [hca_frame.noise_lists(
                    sfs[ridx, c], ress[ridx, c], info.coded_count[c])
                    for c in range(C_)]
                rnd = hca_frame.fill_noise_frame(
                    info, sfs[ridx], frame_noise, rnd,
                    ident[row], nsci[row], nmask[row])
                row += 1
        noise_kw = dict(noise_src=ident, noise_sci=nsci, noise_mask=nmask)
    if n_live:
        hfr = hca_kernels.build_hfr_map(
            info.total_band_count, info.base_band_count,
            info.stereo_band_count, info.bands_per_hfr_group,
            info.hfr_group_count, info.version)
        pairs = hca_kernels.stereo_pairs_of(info.channel_type) \
            if info.stereo_band_count > 0 else ()
        # bucket the survivor batch to powers of two: every distinct batch
        # shape is a fresh device compile otherwise
        n_pad = max(64, 1 << (n_live - 1).bit_length())

        def pad(a, pre_selected=False):
            out = np.zeros((n_pad,) + a.shape[1:], dtype=a.dtype)
            out[:n_live] = a if pre_selected else a[live]
            return out

        if noise_kw:
            noise_kw = {k: pad(v, pre_selected=True)[:, None]
                        for k, v in noise_kw.items()}
        wave = hca_kernels.hca_decode_wave(
            pad(qc)[:, None], pad(sfs)[:, None], pad(ress)[:, None],
            pad(intens)[:, None],
            np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
            np.asarray(hfr.group_of), np.int32(hfr.zero_band),
            # NOT hfr_static: on the scorer's [K, 1, ...] shapes (a tiny
            # frame axis) the dynamic-gather HFR path beat the 0/1 matmuls
            # on earlier hardware; not yet measured on the GPU
            base_band=int(info.base_band_count),
            total_band=int(info.total_band_count), stereo_pairs=pairs,
            apply_hfr=bool(info.bands_per_hfr_group > 0
                           and info.hfr_group_count > 0),
            hfr_group_count=int(info.hfr_group_count), **noise_kw)
        wave = np.asarray(wave)[:n_live]  # [N, C, 8, 128]
        C = info.channels
        n_samp = 8 * 128
        clips = (np.abs(wave) > 1.0).reshape(wave.shape[0], -1).sum(axis=1)
        scaled = np.trunc(wave.astype(np.float64) * 32768.0).astype(np.int64)
        blank = (np.abs(wave) <= 1.0) & ((scaled == 0) | (scaled == -1))
        blanks = blank.reshape(wave.shape[0], -1).sum(axis=1)
        chblank = blank.reshape(wave.shape[0], C, -1).sum(axis=2)
        sc = np.ones(wave.shape[0], dtype=np.int64)      # default: plausible
        cl = np.where(clips == 1, 2, clips)
        sc = np.where(cl > 1, cl, sc)
        all_blank = blanks == C * n_samp
        sc = np.where((cl <= 1) & all_blank, 0, sc)
        if C >= 2:
            half = (cl <= 1) & ~all_blank \
                & (chblank[:, 0] == n_samp) & (chblank[:, 1] != n_samp)
            sc = np.where(half, 3, sc)
        frame_scores.reshape(-1)[live] = sc
    rejected = (frame_scores < 0).any(axis=1)
    alive_scores = frame_scores.sum(axis=1)
    alive_scores[rejected] = -1
    scores[alive_idx] = alive_scores
    return scores


def rank_keys(scores) -> np.ndarray:
    """Order candidate indices best-first from find_key/score_key totals.

    Accepted keys (score > 0) rank by ascending total (1 x tested frames =
    a clean decode; clipped frames inflate the total); all-silent keys
    (score == 0, inconclusive) follow; rejected keys (negative) come last.
    """
    s = np.asarray(scores, dtype=np.int64)
    grp = np.where(s > 0, 0, np.where(s == 0, 1, 2))
    return np.lexsort((s, grp))


def ahx_decode_batch(blobs: Sequence[bytes], device: Optional[bool] = None,
                     mesh: Optional[Mesh] = None,
                     on_error: str = "raise") -> List[bytes]:
    """Decode many AHX (or bare MPEG Layer II) streams -> WAV bytes.

    Streams are unpacked host-side (vectorised bit gathers), grouped by
    (channels, frame-count bucket), and each group runs as ONE batched
    [B, F, C, 36, 32] device dispatch — the synthesis filterbank is a single
    matmul per group (ops/mp2_kernels.py); device->host PCM fetches ride a
    worker pool so later groups' dispatches overlap them.  device=None
    (default) picks the engine from `backend` (the device on a GPU, the
    host path on the CPU); device=False decodes each stream through the
    unpadded float64 numpy reference instead (no buckets — the padding only
    exists to bound compiled-shape count).  The engines agree within 1
    int16 LSB (f32 device matmul vs f64 host; both within 1 LSB of
    libmpg123), same as the single-file AHX.decode path, which is host-f64
    too.

    With a `mesh`, the stream axis shards over the first mesh axis (the
    streams are independent, so no collectives are needed).  on_error:
    "raise" aborts on the first corrupt stream, "isolate" returns None for
    corrupt streams and decodes the rest.
    """
    from ..models import ahx as ahx_model
    from ..ops import mp2_frame, mp2_kernels
    from ..utils.sniff import sniff

    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    if device is None:
        device = backend.engine("ahx", "decode") == "device"
    _ensure_compile_cache()
    # per stream: (Mp2Stream, nframes, total, rate) or None
    parsed: List = [None] * len(blobs)
    for i, blob in enumerate(blobs):
        blob = bytes(blob)
        try:
            offset, total, rate = 0, 0, 0
            try:
                is_ahx = sniff(blob) == "ahx"
            except ValueError:
                is_ahx = False
            if is_ahx:
                info = ahx_model.AHX.parse_header(blob)
                offset = info["data_offset"]
                total = info["total_samples"]
                rate = info["sample_rate"]     # container rate wins, as in
                                               # AHX.decode
            st = mp2_frame.unpack(blob, offset)
            parsed[i] = (st, st.nframes, total, rate or st.header.sample_rate)
        except Exception:
            if on_error == "raise":
                raise
            parsed[i] = None

    results: List = [None] * len(blobs)

    def _finish(idx, pcm_c_by_n):
        _st, nframes, total, rate = parsed[idx]
        n = nframes * mp2_frame.SAMPLES_PER_FRAME
        if total:
            n = min(n, total)
        chunk = pcm_c_by_n[:, :n]
        interleaved = np.ascontiguousarray(chunk.T).reshape(-1)
        results[idx] = wavmod.write_wav(interleaved, chunk.shape[0], rate)

    if not device:
        for idx, p in enumerate(parsed):
            if p is None:
                continue
            st = p[0]
            _finish(idx, mp2_kernels.decode_pcm16_host(
                st.codes, st.levels, st.sfidx))
        return results

    groups: dict = {}
    for idx, p in enumerate(parsed):
        if p is None:
            continue
        st, nframes = p[0], p[1]
        groups.setdefault((st.header.nch, _round_up(nframes, 64)),
                          []).append(idx)

    import concurrent.futures as _cf
    fetch_pool = _cf.ThreadPoolExecutor(max_workers=2)
    try:
        pending = []
        for (nch, bucket), members in groups.items():
            B = len(members)
            Bp = B if mesh is None else _round_up(B, mesh.devices.shape[0])
            codes = np.zeros((Bp, bucket, nch, 36, 32), dtype=np.uint16)
            levels = np.zeros((Bp, bucket, nch, 32), dtype=np.int32)
            sfidx = np.zeros((Bp, bucket, nch, 3, 32), dtype=np.uint8)
            for row, idx in enumerate(members):
                st = parsed[idx][0]
                codes[row, :st.nframes] = st.codes
                levels[row, :st.nframes] = st.levels
                sfidx[row, :st.nframes] = st.sfidx
            args = (codes, levels, sfidx)
            if mesh is not None:
                spec = NamedSharding(mesh, P(mesh.axis_names[0]))
                args = tuple(jax.device_put(a, spec) for a in args)
            out_dev = mp2_kernels.dispatch_decode_batched(*args)
            pending.append((fetch_pool.submit(np.asarray, out_dev), members))
        for fut, members in pending:
            pcm = fut.result()                            # [Bp, C, T*32]
            for row, idx in enumerate(members):
                _finish(idx, pcm[row])
    finally:
        fetch_pool.shutdown(wait=True)
    return results


def encode_batch(wavs: Sequence[bytes], **adx_kwargs) -> List[bytes]:
    """Encode WAV inputs to ADX, one stream at a time.

    ADX encode is a serial clamped recurrence per stream — the same
    single-core economics as adx_decode_batch, so the native per-stream
    path wins; this is a convenience wrapper, not a device batch."""
    from ..models import adx as adx_model

    return [adx_model.encode(w, **adx_kwargs) for w in wavs]


def hca_encode_batch(wavs: Sequence[bytes], quality: int = 1,
                     force_not_looping: bool = False,
                     max_workers: int = 0, device: bool = False,
                     mesh: Optional[Mesh] = None,
                     pack: str = "auto",
                     stats: Optional[DecodeStats] = None) -> List[bytes]:
    """Encode many WAVs to HCA concurrently.

    device=True runs the numeric pipeline on the accelerator
    (ops/hca_encode_device, byte-identical output): streams are grouped by
    (channels, sample_rate) and each group encodes as one jitted dispatch;
    pack="device" keeps the frame packer + HFR normalisation on device too
    (only finished frame bytes are fetched — see
    hca_encode_device.hca_encode_frames), "host" fetches tensors and packs
    natively, "auto" picks by platform (`backend`).  Streams the device
    path re-encodes on the host are counted in `stats.host_fallback_streams`.
    Otherwise each stream's encode is frame-vectorised numpy with a
    threaded C++ packer, fanned out over a thread pool.
    """
    import concurrent.futures as cf

    from ..ops import hca_encode_host

    if mesh is not None and not device:
        raise ValueError("hca_encode_batch: mesh sharding requires "
                         "device=True (the host path is per-stream)")
    if device:
        from ..utils import wav as wavmod
        from ..ops import hca_encode_device

        _ensure_compile_cache()
        groups: dict = {}
        for i, blob in enumerate(wavs):
            w = wavmod.parse_wav(bytes(blob))
            groups.setdefault((w.channels, w.sample_rate), []).append(i)
        results: List = [None] * len(wavs)
        for members in groups.values():
            encoded = hca_encode_device.encode_batch_device(
                [wavs[i] for i in members], quality=quality,
                force_not_looping=force_not_looping, mesh=mesh, pack=pack,
                stats=stats)
            for i, blob in zip(members, encoded):
                results[i] = blob
        return results

    if max_workers <= 0:
        max_workers = min(len(wavs), os.cpu_count() or 1)
    if max_workers <= 1 or len(wavs) <= 1:
        return [hca_encode_host.encode(w, force_not_looping=force_not_looping,
                                       quality=quality) for w in wavs]
    with cf.ThreadPoolExecutor(max_workers) as pool:
        return list(pool.map(
            lambda w: hca_encode_host.encode(
                w, force_not_looping=force_not_looping, quality=quality),
            wavs))


def ahx_encode_batch(wavs: Sequence[bytes],
                     bitrate_kbps: Optional[int] = None,
                     device: bool = False, mesh: Optional[Mesh] = None,
                     container: str = "auto",
                     max_workers: int = 0,
                     joint_bound: Optional[int] = None) -> List[bytes]:
    """Encode many WAVs to AHX / raw MPEG Layer II concurrently.

    device=True runs the FULL on-device pipeline (ops/mp2_encode_device:
    analysis matmul -> lockstep greedy allocation -> device bit
    packing, frames left in HBM until fetch): streams group by (channels,
    sample_rate) and each group is one jitted dispatch; with a `mesh` the
    stream axis shards over the first mesh axis (pure-jnp pipeline, GSPMD).
    device=False fans the float64 host encoder over a thread pool.

    container: "ahx" wraps each stream in the AHX container (mono MPEG-2
    LSF only, AHX.encode semantics), "mp2" returns raw Layer II streams,
    "auto" picks AHX when the input is mono at an LSF rate.
    """
    import concurrent.futures as cf

    from ..models import ahx as ahx_model
    from ..ops import mp2_tables
    from ..utils import wav as wavmod

    if container not in ("auto", "ahx", "mp2"):
        raise ValueError("container must be 'auto', 'ahx' or 'mp2'")
    if mesh is not None and not device:
        raise ValueError("ahx_encode_batch: mesh sharding requires "
                         "device=True (the host path is per-stream)")

    parsed = [wavmod.parse_wav(bytes(b)) for b in wavs]

    def wrap(stream: bytes, w) -> bytes:
        use_ahx = container == "ahx" or (
            container == "auto" and w.channels == 1
            and w.sample_rate in mp2_tables.SAMPLE_RATES_V2)
        if use_ahx:
            if w.channels != 1 or w.sample_rate not in \
                    mp2_tables.SAMPLE_RATES_V2:
                raise ValueError("AHX container requires mono PCM at an "
                                 "MPEG-2 LSF rate (16000/22050/24000).")
            return ahx_model.ahx_container(stream, w.sample_rate,
                                           w.pcm16.size)
        return stream

    def pcm_of(w):
        return w.pcm16.reshape(-1, w.channels).T

    if device:
        from ..ops import mp2_encode_device

        _ensure_compile_cache()
        groups: dict = {}
        for i, w in enumerate(parsed):
            groups.setdefault((w.channels, w.sample_rate), []).append(i)
        results: List = [None] * len(wavs)
        for (_, rate), members in groups.items():
            streams = mp2_encode_device.encode_mp2_device_batch(
                [pcm_of(parsed[i]) for i in members], rate,
                bitrate_kbps, mesh=mesh, joint_bound=joint_bound)
            for i, stream in zip(members, streams):
                results[i] = wrap(stream, parsed[i])
        return results

    def one(i: int) -> bytes:
        w = parsed[i]
        stream = ahx_model.encode_mp2(pcm_of(w), w.sample_rate, bitrate_kbps,
                                      joint_bound=joint_bound)
        return wrap(stream, w)

    if max_workers <= 0:
        max_workers = min(len(wavs), os.cpu_count() or 1)
    if max_workers <= 1 or len(wavs) <= 1:
        return [one(i) for i in range(len(wavs))]
    with cf.ThreadPoolExecutor(max_workers) as pool:
        return list(pool.map(one, range(len(wavs))))
