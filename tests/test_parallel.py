"""Batched bank decode + mesh sharding tests (8 virtual CPU devices)."""
import jax
import numpy as np
import pytest

from pycricodecs_tpu import parallel
from pycricodecs_tpu.containers.acb import ACBBuilder
from pycricodecs_tpu.models import hca as hcamod
from pycricodecs_tpu.utils.wav import write_wav
from tests.conftest import make_sine_pcm16


def _tracks(oracle, n, channels=2, samples=8192):
    out = []
    for i in range(n):
        wav = write_wav(make_sine_pcm16(samples, channels, 48000, seed=500 + i),
                        channels, 48000)
        out.append(bytes(oracle.HcaEncode(wav, 0, 2)))
    return out


def test_decode_batch_matches_single(oracle):
    blobs = _tracks(oracle, 5)
    batched = parallel.decode_batch(blobs)
    for blob, wav_bytes in zip(blobs, batched):
        assert wav_bytes == hcamod.decode(blob)


def test_decode_batch_host_engine_matches_device(oracle):
    # engine router: host C++ lanes and the batched device path are bit-exact
    blobs = (_tracks(oracle, 2) + _tracks(oracle, 1, channels=1)
             + _tracks(oracle, 1, samples=4096))
    host = parallel.decode_batch(blobs, engine="host")
    device = parallel.decode_batch(blobs, engine="device")
    for blob, h, d in zip(blobs, host, device):
        assert h == d == hcamod.decode(blob)


def test_decode_batch_device_unpack_bit_exact(oracle, monkeypatch):
    """The device bitstream unpacker must be byte-identical to the host
    unpacker through the full decode_batch path, and must actually engage."""
    blobs = (_tracks(oracle, 3) + _tracks(oracle, 2, channels=1)
             + _tracks(oracle, 1, samples=4096))
    stats = parallel.DecodeStats()
    dev = parallel.decode_batch(blobs, engine="device", stats=stats)
    assert stats.device_unpack_streams == len(blobs)
    monkeypatch.setenv("PYCRICODECS_HOST_UNPACK", "1")
    stats2 = parallel.DecodeStats()
    host_unpack = parallel.decode_batch(blobs, engine="device", stats=stats2)
    assert stats2.device_unpack_streams == 0
    assert dev == host_unpack
    for blob, d in zip(blobs, dev):
        assert d == hcamod.decode(blob)


def test_decode_batch_device_unpack_mixed_subkeys(oracle):
    """Mixed per-stream subkeys decode on the device too: each cipher gets its own
    sub-batch against the SAME compiled program (cipher/ATH are dynamic
    unpacker inputs)."""
    from pycricodecs_tpu.models.hca import HCA
    key = 0xCF222F1FE0748978
    plain = _tracks(oracle, 2)
    enc = []
    for sk, blob in zip((1, 2), plain):
        h = HCA(blob)
        h.encrypt(key, subkey=sk)
        enc.append(h.get_hca())
    stats = parallel.DecodeStats()
    out = parallel.decode_batch(enc, key=key, subkeys=[1, 2], stats=stats,
                                engine="device")
    assert stats.device_unpack_streams == 2
    assert stats.groups == 2
    for blob, wav_bytes in zip(plain, out):
        assert wav_bytes == hcamod.decode(blob)


def test_decode_batch_device_unpack_corrupt_stream_isolated(oracle):
    """A CRC-corrupt stream raises (or isolates) exactly like the host
    unpacker when the device path handles the group."""
    blobs = _tracks(oracle, 3)
    bad = bytearray(blobs[1])
    bad[-10] ^= 0xFF  # corrupt a frame body -> CRC mismatch
    blobs[1] = bytes(bad)
    out = parallel.decode_batch(blobs, engine="device", on_error="isolate")
    assert isinstance(out[1], Exception)
    assert out[0] == hcamod.decode(blobs[0])
    assert out[2] == hcamod.decode(blobs[2])


def test_decode_batch_host_engine_isolation(oracle):
    blobs = _tracks(oracle, 3)
    blobs[1] = blobs[1][:8]  # truncated header: unparseable
    out = parallel.decode_batch(blobs, engine="host", on_error="isolate")
    assert isinstance(out[1], Exception)
    assert out[0] == hcamod.decode(blobs[0])
    assert out[2] == hcamod.decode(blobs[2])


def test_decode_batch_mixed_configs(oracle):
    # different channel counts force separate groups
    blobs = _tracks(oracle, 2, channels=2) + _tracks(oracle, 2, channels=1)
    batched = parallel.decode_batch(blobs)
    for blob, wav_bytes in zip(blobs, batched):
        assert wav_bytes == hcamod.decode(blob)


def test_decode_batch_mixed_lengths(oracle):
    blobs = (_tracks(oracle, 2, samples=4096) + _tracks(oracle, 1, samples=16384)
             + _tracks(oracle, 1, samples=6144))
    batched = parallel.decode_batch(blobs)
    for blob, wav_bytes in zip(blobs, batched):
        assert wav_bytes == hcamod.decode(blob)


def test_decode_batch_sharded_dp(oracle):
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    mesh = parallel.make_mesh((8, 1))
    blobs = _tracks(oracle, 11)  # odd count exercises batch padding
    batched = parallel.decode_batch(blobs, mesh=mesh)
    for blob, wav_bytes in zip(blobs, batched):
        assert wav_bytes == hcamod.decode(blob)


def test_decode_batch_sharded_dp_sp(oracle):
    mesh = parallel.make_mesh((4, 2))  # frame axis sharded too (halo exchange)
    blobs = _tracks(oracle, 6)
    batched = parallel.decode_batch(blobs, mesh=mesh)
    for blob, wav_bytes in zip(blobs, batched):
        assert wav_bytes == hcamod.decode(blob)


def test_decode_batch_sharded_pallas_engines(oracle):
    """Mesh-sharded device decode (unpack + transform under shard_map):
    manual partitioning — streams over dp, frames over sp with the
    one-frame ppermute halo — must stay byte-exact. This is the path a
    multi-GPU mesh runs."""
    mesh = parallel.make_mesh((4, 2))
    blobs = _tracks(oracle, 5) + _tracks(oracle, 1, samples=4096)
    stats = parallel.DecodeStats()
    batched = parallel.decode_batch(blobs, mesh=mesh, engine="device",
                                    stats=stats)
    assert stats.device_unpack_streams == len(blobs)
    for blob, wav_bytes in zip(blobs, batched):
        assert wav_bytes == hcamod.decode(blob)


def test_decode_acb_bank(oracle):
    blobs = _tracks(oracle, 4)
    acb_blob = ACBBuilder(blobs).build()
    mesh = parallel.make_mesh((8, 1))
    decoded = parallel.decode_acb(acb_blob, mesh=mesh)
    assert len(decoded) == 4
    for blob, wav_bytes in zip(blobs, decoded):
        assert wav_bytes == hcamod.decode(blob)


def test_decode_batch_encrypted(oracle):
    key = 0xCF222F1FE0748978
    blobs = _tracks(oracle, 3)
    enc = [hcamod.crypt(b, True, int.from_bytes(b[6:8], "big"), 56, key, 0)
           for b in blobs]
    batched = parallel.decode_batch(enc, key=key)
    for blob, wav_bytes in zip(blobs, batched):
        assert wav_bytes == hcamod.decode(blob)


def test_adx_decode_batch(oracle):
    from pycricodecs_tpu.models import adx as adxmod
    blobs = []
    for i, (ch, samples) in enumerate([(1, 4096), (2, 4096), (2, 9000), (1, 2048)]):
        pcm = make_sine_pcm16(samples, ch, 48000, seed=700 + i)
        pcm[:64 * ch] = 0
        wav = write_wav(pcm, ch, 48000)
        blobs.append(bytes(oracle.AdxEncode(wav, 4, 0x12, 3, 0x1F4, 0, 4, False)))
    batched = parallel.adx_decode_batch(blobs)
    for blob, wav_bytes in zip(blobs, batched):
        assert wav_bytes == adxmod.decode(blob)


def test_adx_decode_batch_device_fixpoint(oracle):
    """The block-parallel fixpoint device engine must match the host path
    byte-for-byte across encoding modes, versions and loop content."""
    from pycricodecs_tpu.models import adx as adxmod
    blobs = []
    for i, (ch, samples, mode, ver) in enumerate(
            [(2, 12000, 3, 4), (1, 9000, 2, 4), (2, 7000, 4, 4),
             (1, 4096, 3, 3)]):
        pcm = make_sine_pcm16(samples, ch, 32000, seed=900 + i)
        # quiet lead-in: the reference decoder (reproduced for parity)
        # rejects files whose first block scale high byte != 0
        pcm[:64 * ch] = 0
        wav = write_wav(pcm, ch, 32000)
        blobs.append(adxmod.encode(wav, encoding_mode=mode, version=ver))
    dev = parallel.adx_decode_batch(blobs, device=True)
    for blob, wav_bytes in zip(blobs, dev):
        assert wav_bytes == adxmod.decode(blob)


def test_adx_batch_sharded_mesh():
    """ADX decode+encode sharded under a 2-D mesh (lanes over dp, blocks
    over sp): byte-identical to the single-stream host path. Covers the
    lane padding to the mesh size and the block-axis halo the fixpoint's
    start-state shift becomes under GSPMD."""
    from pycricodecs_tpu.models import adx as adxmod
    mesh = parallel.make_mesh((4, 2))
    blobs = []
    for i, (ch, samples, mode) in enumerate(
            [(2, 12000, 3), (1, 9000, 2), (2, 7000, 4)]):
        pcm = make_sine_pcm16(samples, ch, 32000, seed=1300 + i)
        pcm[:64 * ch] = 0
        blobs.append(adxmod.encode(write_wav(pcm, ch, 32000),
                                   encoding_mode=mode))
    dev = parallel.adx_decode_batch(blobs, mesh=mesh)
    for blob, wav_bytes in zip(blobs, dev):
        assert wav_bytes == adxmod.decode(blob)

    wavs = []
    for i, (ch, samples) in enumerate([(1, 6000), (2, 9001), (2, 2048)]):
        pcm = make_sine_pcm16(samples, ch, 44100, seed=1400 + i)
        pcm[:64 * ch] = 0
        wavs.append(write_wav(pcm, ch, 44100))
    enc = parallel.adx_encode_batch(wavs, mesh=mesh)
    for wav, blob in zip(wavs, enc):
        assert blob == adxmod.encode(wav)


def test_adx_fixpoint_kernel_exact_vs_scan():
    """Direct kernel check incl. hostile max-scale clamp-heavy content and
    per-block mode-2 filter switches."""
    from pycricodecs_tpu.ops import adx_kernels as K
    rng = np.random.default_rng(11)
    L, nb, spb = 5, 120, 32
    N = nb * spb
    codes = np.where(rng.random((L, N)) < 0.5, 7, -8).astype(np.int32)
    scales = np.repeat(rng.integers(1, 4097, (L, nb)), spb,
                       axis=1).astype(np.int32)
    filts = [(0, 0), (0x0F00, 0), (0x1CC0, -0x0D00), (0x1880, -0x0C40)]
    sel = rng.integers(0, 4, (L, nb))
    c0 = np.repeat(np.vectorize(lambda k: filts[k][0])(sel), spb,
                   axis=1).astype(np.int32)
    c1 = np.repeat(np.vectorize(lambda k: filts[k][1])(sel), spb,
                   axis=1).astype(np.int32)
    h1 = rng.integers(-32768, 32768, L).astype(np.int32)
    h2 = rng.integers(-32768, 32768, L).astype(np.int32)
    ref = np.asarray(K.adx_decode_scan(codes, scales, c0, c1, h1, h2))
    out, conv = K.adx_decode_fixpoint(codes, scales, c0, c1, h1, h2, spb=spb)
    assert bool(np.asarray(conv))
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_adx_fixpoint_nonconverged_falls_back(oracle, monkeypatch):
    """A non-converged fixpoint result must be discarded for the serial
    scan; decode_batch output stays exact either way."""
    from pycricodecs_tpu.models import adx as adxmod
    from pycricodecs_tpu.ops import adx_kernels as K
    pcm = make_sine_pcm16(8192, 2, 48000, seed=44)
    pcm[:128] = 0
    blob = adxmod.encode(write_wav(pcm, 2, 48000))

    real = K.adx_decode_device_pipeline
    calls = {"n": 0}

    def never_converges(*a, **kw):
        calls["n"] += 1
        out, _conv = real(*a, **kw)
        import jax.numpy as jnp
        return out, jnp.bool_(False)

    monkeypatch.setattr(K, "adx_decode_device_pipeline", never_converges)
    out = parallel.adx_decode_batch([blob], device=True)
    assert calls["n"] == 1
    assert out[0] == adxmod.decode(blob)

    # kernel-level: max_passes=1 on long content cannot converge
    rng = np.random.default_rng(5)
    L, nb, spb = 2, 400, 32
    codes = rng.integers(-8, 8, (L, nb * spb)).astype(np.int32)
    scales = np.repeat(rng.integers(64, 2048, (L, nb)), spb,
                       axis=1).astype(np.int32)
    c0 = np.full((L, nb * spb), 0x1CB1, np.int32)
    c1 = np.full((L, nb * spb), -0x0D4C, np.int32)
    h1 = np.full(L, 10000, np.int32)
    h2 = np.full(L, -5000, np.int32)
    _out, conv = K.adx_decode_fixpoint(codes, scales, c0, c1, h1, h2,
                                       spb=spb, max_passes=1)
    assert not bool(np.asarray(conv))


def test_decode_batch_error_isolation(oracle):
    blobs = _tracks(oracle, 3)
    corrupt = bytearray(blobs[1])
    corrupt[2000] ^= 0xFF  # break a frame CRC
    mixed = [blobs[0], bytes(corrupt), blobs[2], b"not an hca"]
    out = parallel.decode_batch(mixed, on_error="isolate")
    assert out[0] == hcamod.decode(blobs[0])
    assert isinstance(out[1], Exception)
    assert out[2] == hcamod.decode(blobs[2])
    assert isinstance(out[3], Exception)
    with pytest.raises(Exception):
        parallel.decode_batch(mixed, on_error="raise")


def test_hca_encode_batch(oracle):
    from pycricodecs_tpu.utils.wav import write_wav as ww
    wavs = [ww(make_sine_pcm16(6144, 2, 48000, seed=900 + i), 2, 48000)
            for i in range(5)]
    blobs = parallel.hca_encode_batch(wavs, quality=1)
    for wav, blob in zip(wavs, blobs):
        assert blob == bytes(oracle.HcaEncode(wav, 0, 1))


def test_hca_encode_batch_device(oracle):
    from pycricodecs_tpu.utils.wav import write_wav as ww
    wavs = [ww(make_sine_pcm16(5120 + 1024 * i, 2, 48000, seed=950 + i), 2, 48000)
            for i in range(3)]
    blobs = parallel.hca_encode_batch(wavs, quality=2, device=True)
    for wav, blob in zip(wavs, blobs):
        assert blob == bytes(oracle.HcaEncode(wav, 0, 2))


def test_decode_stats(oracle):
    blobs = _tracks(oracle, 3)
    stats = parallel.pipeline.DecodeStats()
    parallel.decode_batch(blobs, stats=stats)
    d = stats.as_dict()
    assert d["streams"] == 3 and d["groups"] == 1 and d["failed_streams"] == 0
    assert d["frames"] > 0 and d["samples_out"] > 0
    assert d["total_seconds"] > 0


def test_find_key_batched_matches_score_key(oracle):
    """parallel.find_key == hca_frame.score_key per candidate, and the true
    key wins. Uses an encrypted stream (cipher type 56) with decoys."""
    import numpy as np
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models import hca as hcamod
    from pycricodecs_tpu.ops import hca_frame
    from pycricodecs_tpu.ops.hca_frame import parse_header
    from pycricodecs_tpu.ops import hca_encode_host
    from tests.conftest import make_sine_pcm16
    from pycricodecs_tpu.utils.wav import write_wav

    true_key = 0xCF222F1FE0748978
    wav = write_wav(make_sine_pcm16(16384, 2, 48000, seed=42), 2, 48000)
    blob = hca_encode_host.encode(wav, quality=2)
    hs = parse_header(blob).header_size
    enc = hcamod.crypt(blob, True, hs, 56, true_key)

    rng = np.random.default_rng(0)
    candidates = [int(x) for x in rng.integers(1, 1 << 63, 40)]
    candidates.insert(17, true_key)
    scores = parallel.find_key(enc, candidates, max_frames=8)
    assert scores.shape == (41,)
    assert int(parallel.rank_keys(scores)[0]) == 17
    # exact agreement with the serial scorer on a sample of candidates
    for i in (0, 5, 17, 33):
        assert scores[i] == hca_frame.score_key(enc, candidates[i],
                                                max_frames=8), i


def test_ahx_decode_batch_sharded():
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models.ahx import AHX
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.conftest import make_sine_pcm16

    mesh8 = parallel.make_mesh((8, 1))

    blobs = [AHX.encode(write_wav(
        make_sine_pcm16(22050 + 1111 * i, 1, 22050, seed=40 + i), 1, 22050),
        bitrate_kbps=96) for i in range(5)]   # odd count exercises padding
    sharded = parallel.ahx_decode_batch(blobs, mesh=mesh8)
    plain = parallel.ahx_decode_batch(blobs, device=False)
    import numpy as np
    for a, b in zip(sharded, plain):
        assert a[:44] == b[:44]
        x = np.frombuffer(a[44:], "<i2").astype(int)
        y = np.frombuffer(b[44:], "<i2").astype(int)
        assert x.shape == y.shape and np.abs(x - y).max() <= 1


def test_ahx_decode_batch_error_isolation():
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models.ahx import AHX
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.conftest import make_sine_pcm16
    import numpy as np
    import pytest

    good = AHX.encode(write_wav(make_sine_pcm16(22050, 1, 22050, seed=50),
                                1, 22050), bitrate_kbps=96)
    blobs = [good, b"\xff\xf5garbage-not-a-frame", good]
    with pytest.raises(ValueError):
        parallel.ahx_decode_batch(blobs)
    out = parallel.ahx_decode_batch(blobs, on_error="isolate")
    assert out[1] is None
    assert out[0] == out[2] and out[0][:4] == b"RIFF"


def test_ahx_decode_batch_numpy_with_mesh_and_mixed_rates():
    """device=False ignores mesh padding; mixed sample rates share buckets."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models.ahx import AHX
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.conftest import make_sine_pcm16
    import numpy as np

    mesh = parallel.make_mesh((8, 1))
    blobs = [AHX.encode(write_wav(make_sine_pcm16(sr, 1, sr, seed=60 + i),
                                  1, sr), bitrate_kbps=96)
             for i, sr in enumerate((22050, 24000, 16000))]
    ref = [AHX.decode(b) for b in blobs]
    assert parallel.ahx_decode_batch(blobs, device=False, mesh=mesh) == ref
    dev = parallel.ahx_decode_batch(blobs, mesh=mesh)
    for a, b in zip(dev, ref):
        assert a[:44] == b[:44]   # per-stream container rate in the header
        x = np.frombuffer(a[44:], "<i2").astype(int)
        y = np.frombuffer(b[44:], "<i2").astype(int)
        assert x.shape == y.shape and np.abs(x - y).max() <= 1


def test_find_key_v3_noise_matches_score_key(oracle):
    """v3.0 (min_resolution=0) key scoring runs the PNS noise fill with the
    LCG threading across frames — the batched host reconstruction in
    find_key must agree exactly with the serial test_block path."""
    import numpy as np
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models import hca as hcamod
    from pycricodecs_tpu.ops import hca_frame
    from pycricodecs_tpu.ops.hca_frame import parse_header
    from tests.test_hca import _relabel_v3, _wav, _hdr_size

    true_key = 0xCF222F1FE0748978
    hca_v2 = bytes(oracle.HcaEncode(_wav(channels=1, seed=77), 0, 0))
    hca_v3 = _relabel_v3(hca_v2)
    hs = _hdr_size(hca_v3)
    enc = hcamod.crypt(hca_v3, True, hs, 56, true_key)
    info = parse_header(enc[:hs])
    assert info.min_resolution == 0

    rng = np.random.default_rng(1)
    candidates = [int(x) for x in rng.integers(1, 1 << 63, 24)]
    candidates.insert(5, true_key)
    scores = parallel.find_key(enc, candidates, max_frames=8)
    assert int(parallel.rank_keys(scores)[0]) == 5
    for i in (0, 5, 12):
        assert scores[i] == hca_frame.score_key(enc, candidates[i],
                                                max_frames=8), i


def test_rank_keys_orders_clipped_keys_below_clean():
    import numpy as np
    from pycricodecs_tpu import parallel

    # totals: clean key = 1 x 8 frames; clipped survivor = big; silent = 0
    scores = np.array([40, 8, -1, 0, 9])
    order = parallel.rank_keys(scores)
    assert list(order[:2]) == [1, 4]    # lowest positive totals first
    assert order[2] == 0                # heavy clipping ranks after
    assert order[3] == 3 and order[4] == 2  # silent, then rejected


def test_decode_batch_single_stream_sp_mesh():
    """A lone stream under a (1, sp) sequence-parallel mesh: the size-1
    noise placeholders must stay replicated, not get a dp/sp sharding."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.models import hca as hcamod
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.conftest import make_sine_pcm16
    import numpy as np

    wav = write_wav(make_sine_pcm16(16384, 2, 48000, seed=70), 2, 48000)
    blob = hca_encode_host.encode(wav, quality=2)
    mesh = parallel.make_mesh((1, 8))
    out = parallel.decode_batch([blob], mesh=mesh)
    single = hcamod.decode(blob)
    assert out[0][:44] == single[:44]
    a = np.frombuffer(out[0][44:], "<i2").astype(int)
    b = np.frombuffer(single[44:], "<i2").astype(int)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_decode_awb_mixed_members_isolated():
    """AHX members decode, malformed ADX-magic members pass through raw."""
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.containers.awb import build_afs2
    from pycricodecs_tpu.models.ahx import AHX
    from pycricodecs_tpu.models import adx as adxmod
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.conftest import make_sine_pcm16

    hca_m = hca_encode_host.encode(
        write_wav(make_sine_pcm16(8192, 2, 48000, seed=71), 2, 48000),
        quality=2)
    ahx_m = AHX.encode(write_wav(make_sine_pcm16(22050, 1, 22050, seed=72),
                                 1, 22050), bitrate_kbps=96)
    adx_m = adxmod.encode(write_wav(make_sine_pcm16(4096, 1, 32000, seed=73),
                                    1, 32000))
    bad_m = b"\x80\x00" + b"\x07" * 62        # ADX magic, garbage body
    bank = build_afs2([hca_m, ahx_m, adx_m, bad_m])
    out = parallel.decode_awb(bank)
    assert out[0][:4] == b"RIFF" and out[1][:4] == b"RIFF"
    assert out[2][:4] == b"RIFF"
    assert out[3].startswith(bad_m)            # raw pass-through (padded)


def test_hca_encode_batch_device_sharded(oracle):
    """Device encode with the stream axis sharded over the mesh is
    byte-identical to the host encoder (odd count exercises the padding)."""
    mesh = parallel.make_mesh((8, 1))
    wavs = [write_wav(make_sine_pcm16(8192, 2, 48000, seed=900 + i),
                      2, 48000) for i in range(9)]
    sharded = parallel.hca_encode_batch(wavs, quality=2, device=True,
                                        mesh=mesh)
    for wav, blob in zip(wavs, sharded):
        assert blob == bytes(oracle.HcaEncode(wav, 0, 2))


@pytest.mark.parametrize("plat,want", [("cpu", "host"), ("gpu", "device")])
def test_pick_hca_engine_follows_platform(plat, want):
    """engine="auto": the batched device engine on a GPU, the native C++
    lanes on the CPU (where the device engine is XLA-on-CPU)."""
    from pycricodecs_tpu import native
    if native.load() is None:
        pytest.skip("native core unavailable")
    assert parallel.pick_hca_engine(plat) == want


def test_batch_bucket_ladder():
    """1.5x-pow2 batch buckets: exact small sizes, half-step ladder above,
    monotone, and the padded size bounded by 1.5x (pow2 padded up to 2x —
    config 18's 12->16 was the dominant heterogeneous-bank cost)."""
    from pycricodecs_tpu.parallel.pipeline import _batch_bucket

    for c in range(1, 5):
        assert _batch_bucket(c) == c
    assert _batch_bucket(12) == 12
    assert _batch_bucket(5) == 6 and _batch_bucket(7) == 8
    assert _batch_bucket(13) == 16 and _batch_bucket(17) == 24
    assert _batch_bucket(96) == 96 and _batch_bucket(97) == 128
    prev = 0
    for c in range(1, 600):
        b = _batch_bucket(c)
        assert b >= c and b >= prev
        assert b * 2 <= 3 * c, (c, b)          # padded <= 1.5x
        prev = b
