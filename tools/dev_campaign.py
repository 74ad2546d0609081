"""Differential campaign: decode_batch(engine="device") vs the compiled
reference oracle (/tmp/refbuild, see CLAUDE.md for the build recipe).

150 cases: channels 1-8 x qualities 0-4 x six content kinds, random rates
and lengths, every fifth case keyed+subkeyed (cipher 56), through the
device unpack and transform. Byte-compares WAV output per case.

Run: timeout 5400 python3 tools/dev_campaign.py | tee /tmp/dev_campaign.log
"""
import io, sys, wave as wavemod
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from pycricodecs_tpu.ops import hca_encode_host
from pycricodecs_tpu.models import hca as hcamod
from pycricodecs_tpu.utils import hca_crypt
from pycricodecs_tpu import parallel
sys.path.insert(0, "/tmp/refbuild")
import CriCodecs

SEED = 20260819


def wav_bytes(pcm16, ch, sr):
    b = io.BytesIO(); w = wavemod.open(b, "wb"); w.setnchannels(ch)
    w.setsampwidth(2); w.setframerate(sr)
    w.writeframes(pcm16.tobytes()); w.close()
    return b.getvalue()


KINDS = ["sine", "noise", "sweep", "impulse", "square", "mix"]


def content(kind, n, sr, rng):
    t = np.arange(n) / sr
    if kind == "sine":
        return 0.5 * np.sin(2 * np.pi * rng.uniform(80, 9000) * t)
    if kind == "noise":
        return 0.4 * rng.standard_normal(n)
    if kind == "sweep":
        return 0.5 * np.sin(2 * np.pi *
                            np.cumsum(np.linspace(50, sr / 2.2, n)) / sr)
    if kind == "impulse":
        s = np.zeros(n); s[::977] = 0.9; return s
    if kind == "square":
        return 0.6 * np.sign(np.sin(2 * np.pi * 523 * t))
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * rng.standard_normal(n)
            + 0.2 * np.sign(np.sin(2 * np.pi * 97 * t)))


fails = total = 0
case = 0
for ch in (1, 2, 4, 6, 8):
    for q in (0, 1, 2, 3, 4):
        for kind in KINDS:
            rng = np.random.default_rng([SEED, case])
            sr = int(rng.choice([16000, 32000, 44100, 48000]))
            dur = float(rng.uniform(0.2, 1.0))
            keyed = case % 5 == 0
            n = int(sr * dur)
            sig = content(kind, n, sr, rng)
            pcm = np.stack([sig * (1 - 0.07 * c) for c in range(ch)], 1)
            pcm16 = np.clip(pcm * 32767, -32768, 32767).astype("<i2")
            blob = hca_encode_host.encode(wav_bytes(pcm16, ch, sr),
                                          quality=q)
            key = sub = 0
            if keyed:
                key = int(rng.integers(1, 2**56))
                sub = int(rng.integers(0, 2**16))
                hs0 = int.from_bytes(blob[6:8], "big")
                blob = hcamod.crypt(blob, True, hs0, 56, key, sub)
            ours = parallel.decode_batch([blob], key=key, subkey=sub,
                                         engine="device")[0]
            hs = int.from_bytes(blob[6:8], "big")
            k = hca_crypt.scramble_subkey(key, sub) if sub else key
            ref = bytes(CriCodecs.HcaDecode(blob, hs, k, 0))
            ok = ours == ref
            fails += not ok
            total += 1
            tag = f"ch={ch} q={q} {kind} sr={sr} dur={dur:.2f}" \
                + (f" key={key:#x}/{sub:#x}" if keyed else "")
            print(f"case {case}: {tag}: "
                  f"{'BYTE-EXACT' if ok else 'DIVERGED'}", flush=True)
            case += 1
print(f"CAMPAIGN {'CLEAN' if not fails else f'{fails} DIVERGENCES'} "
      f"({total} cases)", flush=True)
