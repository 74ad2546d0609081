"""Command-line interface (a capability the reference package lacks).

    python -m pycricodecs_tpu decode music.hca -o music.wav --key 0x...
    python -m pycricodecs_tpu encode music.wav -o music.hca --format hca
    python -m pycricodecs_tpu extract archive.cpk -o outdir
    python -m pycricodecs_tpu bank-decode bank.acb -o outdir
    python -m pycricodecs_tpu find-key enc.hca --range 0x1000 65536
    python -m pycricodecs_tpu info file.adx
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _int0(x: str) -> int:
    return int(x, 0)


def _sniff(data: bytes) -> str:
    from .utils.sniff import sniff
    try:
        return sniff(data)
    except ValueError as exc:
        raise SystemExit(str(exc))


def cmd_decode(args) -> None:
    from .models import adx, hca

    data = open(args.input, "rb").read()
    kind = _sniff(data)
    if kind == "adx":
        wav = adx.decode(data)
    elif kind == "hca":
        wav = hca.decode(data, key=args.key, subkey=args.subkey)
    elif kind == "ahx":
        from .models.ahx import AHX
        wav = AHX.decode(data)
    else:
        raise SystemExit(f"decode expects ADX/AHX/HCA input, got {kind}")
    out = args.output or os.path.splitext(args.input)[0] + ".wav"
    open(out, "wb").write(wav)
    print(out)


def cmd_encode(args) -> None:
    from .models import adx
    from .ops import hca_encode_host

    data = open(args.input, "rb").read()
    if _sniff(data) != "wav":
        raise SystemExit("encode expects a WAV input")
    if args.format == "adx":
        blob = adx.encode(data, bit_depth=args.bitdepth,
                          encoding_mode=args.mode,
                          scale_fix=args.scale_fix)
        ext = ".adx"
    elif args.format == "ahx":
        from .models.ahx import AHX
        blob = AHX.encode(data, bitrate_kbps=args.bitrate)
        ext = ".ahx"
    else:
        blob = hca_encode_host.encode(data, quality=args.quality)
        if args.key:
            from .models import hca
            from .ops.hca_frame import parse_header
            hs = parse_header(blob).header_size
            blob = hca.crypt(blob, True, hs, 56, args.key, args.subkey)
        ext = ".hca"
    out = args.output or os.path.splitext(args.input)[0] + ext
    open(out, "wb").write(blob)
    print(out)


def cmd_extract(args) -> None:
    from .containers.acb import ACB
    from .containers.awb import AWB
    from .containers.cpk import CPK
    from .containers.usm import USM

    data = open(args.input, "rb").read()
    kind = _sniff(data)
    out = args.output or os.path.splitext(args.input)[0]
    if kind == "cpk":
        CPK(args.input).extract(dirname=out)
    elif kind == "acb":
        ACB(data).extract(decode=args.decode, key=args.key, dirname=out)
    elif kind == "awb":
        AWB(data).extract(decode=args.decode, key=args.key, dirname=out)
    elif kind == "usm":
        usm = USM(args.input, key=args.key if args.key else False)
        usm.extract(dirname=out, decode=args.decode, key=args.key,
                    subkey=args.subkey)
    else:
        raise SystemExit(f"extract expects CPK/ACB/AWB/USM, got {kind}")
    print(out)


def cmd_bank_decode(args) -> None:
    from . import parallel

    data = open(args.input, "rb").read()
    kind = _sniff(data)
    out = args.output or os.path.splitext(args.input)[0] + "_wav"
    os.makedirs(out, exist_ok=True)
    if kind == "acb":
        wavs = parallel.decode_acb(data, key=args.key)
    elif kind == "awb":
        wavs = parallel.decode_awb(data, key=args.key)
    else:
        raise SystemExit(f"bank-decode expects ACB/AWB, got {kind}")
    for i, wav in enumerate(wavs):
        if isinstance(wav, (bytes, bytearray)):
            open(os.path.join(out, f"{i}.wav"), "wb").write(wav)
    print(out)


def cmd_build(args) -> None:
    """Build a container from a directory (cpk/awb/acb) or video+audio (usm)."""
    ext = os.path.splitext(args.output)[1].lower().lstrip(".")
    if ext == "cpk":
        from .containers.cpk import CPKBuilder
        CPKBuilder(args.input, args.output, CpkMode=args.cpk_mode,
                   encrypt=args.encrypt, compress=args.compress)
    elif ext == "awb":
        from .containers.awb import AWBBuilder
        AWBBuilder(args.input, subkey=args.subkey).build(args.output)
    elif ext == "acb":
        from .containers.acb import ACBBuilder
        names, tracks = [], []
        for fn in sorted(os.listdir(args.input)):
            path = os.path.join(args.input, fn)
            if os.path.isfile(path):
                names.append(os.path.splitext(fn)[0])
                tracks.append(open(path, "rb").read())
        if not tracks:
            raise SystemExit(f"no files in {args.input}")
        blob = ACBBuilder(tracks, name=os.path.splitext(
            os.path.basename(args.output))[0], cue_names=names).build()
        open(args.output, "wb").write(blob)
    elif ext == "usm":
        from .containers.usm import USMBuilder
        if not args.audio:
            builder = USMBuilder(args.input, key=args.key or False)
        else:
            builder = USMBuilder(args.input, args.audio,
                                 key=args.key or False,
                                 audio_codec=args.codec,
                                 encryptAudio=bool(args.key and args.encrypt))
        open(args.output, "wb").write(builder.build())
    else:
        raise SystemExit("build output must end in .cpk/.awb/.acb/.usm")
    print(args.output)


def cmd_find_key(args) -> None:
    import numpy as np

    from . import parallel

    data = open(args.input, "rb").read()
    if args.candidates:
        with open(args.candidates) as fh:
            cands = [int(line.strip(), 0) for line in fh
                     if line.strip() and not line.startswith("#")]
        cands = np.asarray(cands, dtype=np.uint64)
    elif args.range:
        start, count = args.range
        cands = np.uint64(start) + np.arange(count, dtype=np.uint64)
    else:
        raise SystemExit("pass --candidates FILE or --range START COUNT")
    scores = parallel.find_key(data, cands, subkey=args.subkey,
                               max_frames=args.max_frames)
    order = parallel.rank_keys(scores)[:args.top]
    for i in order:
        if scores[i] < 0:
            break
        print(f"0x{int(cands[i]):016X}  score={int(scores[i])}")
    if scores.max() < 0:
        print("no plausible key found", file=sys.stderr)
        raise SystemExit(1)


def cmd_info(args) -> None:
    data = open(args.input, "rb").read()
    kind = _sniff(data)
    if kind == "hca":
        from .models.hca import HCA
        print(json.dumps(HCA(data, key=args.key).info(), default=str,
                         indent=2))
    elif kind == "adx":
        from .models.adx import parse_adx_header
        h = parse_adx_header(data, strict_cri_check=False)
        print(json.dumps({k: getattr(h, k) for k in (
            "version", "encoding_mode", "block_size", "bit_depth", "channels",
            "sample_rate", "sample_count", "looping")}, default=str, indent=2))
    elif kind == "ahx":
        from .models.ahx import AHX
        print(json.dumps(AHX.info(data), default=str, indent=2))
    elif kind == "ivf":
        from .containers.ivf import IVF
        print(json.dumps(IVF(data).info(), default=str, indent=2))
    elif kind == "usm":
        from .containers.usm import USM
        u = USM(args.input, key=args.key if args.key else False)
        u.demux()
        print(json.dumps([{k: str(v) for k, v in t.items()}
                          for t in u.get_metadata()[:1]], indent=2))
    else:
        print(json.dumps({"format": kind, "size": len(data)}, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="pycricodecs_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, key=True):
        p.add_argument("input")
        p.add_argument("-o", "--output", default=None)
        if key:
            p.add_argument("--key", type=_int0, default=0)
            p.add_argument("--subkey", type=_int0, default=0)

    p = sub.add_parser("decode", help="ADX/AHX/HCA -> WAV")
    common(p)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("encode", help="WAV -> ADX/AHX/HCA")
    p.add_argument("--scale-fix", action="store_true", dest="scale_fix",
                   help="ADX: decoder-exact quantiser (fixes the "
                        "reference's high-bitdepth popping; output stays "
                        "standard ADX)")
    common(p)
    p.add_argument("--format", choices=("adx", "ahx", "hca"), default="hca")
    p.add_argument("--bitrate", type=int, default=None,
                   help="AHX/MP2 bitrate in kbps (default 80)")
    p.add_argument("--quality", type=int, default=1,
                   help="HCA quality 0 (highest) .. 4")
    p.add_argument("--bitdepth", type=int, default=4)
    p.add_argument("--mode", type=int, default=3, choices=(2, 3, 4))
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("extract", help="CPK/ACB/AWB/USM -> files")
    common(p)
    p.add_argument("--decode", action="store_true",
                   help="decode audio members to WAV while extracting")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("bank-decode", help="ACB/AWB -> WAVs (one device batch)")
    common(p)
    p.set_defaults(fn=cmd_bank_decode)

    p = sub.add_parser("build", help="dir -> CPK/AWB/ACB, or IVF(+WAV) -> USM")
    p.add_argument("input", help="directory (cpk/awb/acb) or IVF video (usm)")
    p.add_argument("-o", "--output", required=True,
                   help="output file; extension picks the container")
    p.add_argument("--audio", help="audio track for USM (WAV/ADX/HCA)")
    p.add_argument("--codec", default="adx", choices=["adx", "hca"],
                   help="USM audio codec")
    p.add_argument("--cpk-mode", type=int, default=1, choices=[0, 1, 2, 3])
    p.add_argument("--compress", action="store_true",
                   help="CRILAYLA-compress CPK members")
    p.add_argument("--encrypt", action="store_true",
                   help="encrypt CPK tables / USM streams")
    p.add_argument("--key", type=_int0, default=0)
    p.add_argument("--subkey", type=_int0, default=0)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("find-key", help="batched keycode search")
    common(p, key=False)
    p.add_argument("--subkey", type=_int0, default=0)
    p.add_argument("--candidates", default=None,
                   help="file with one keycode per line")
    p.add_argument("--range", nargs=2, type=_int0, default=None,
                   metavar=("START", "COUNT"))
    p.add_argument("--max-frames", type=int, default=16)
    p.add_argument("--top", type=int, default=5)
    p.set_defaults(fn=cmd_find_key)

    p = sub.add_parser("info", help="print header/metadata")
    common(p)
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
