# Copied from larynx_tpu/dsp/ipa_synth.py; only the package name in its imports differs.
"""Formant synthesis of IPA phoneme example audio.

The reference served third-party phoneme recordings from ``larynx/wav/``
(larynx/server.py:386-438, files from ipachart.com).  This module instead
*synthesizes* an audible example for every phoneme the voices use, driven
by the articulatory features in :mod:`larynx_tpu_torch.text.ipa`:

* vowels / diphthongs: a glottal-pulse harmonic source shaped by formant
  resonances derived from (height, backness, roundedness);
* consonants: manner-specific recipes (burst + locus transition for
  plosives, shaped noise for fricatives, murmur for nasals, amplitude
  modulation for trills, ...), each followed by a short [a] so the
  consonant is heard in context.

Pure numpy, host-side, offline asset generation — not a serving hot path.
All filtering happens in the frequency domain (single FFT per segment).
"""

import typing

import numpy as np

from larynx_tpu_torch.text import ipa

SAMPLE_RATE = 22050

# height -> F1 (Hz)
_F1 = {
    "close": 290.0,
    "near-close": 400.0,
    "close-mid": 450.0,
    "mid": 500.0,
    "open-mid": 585.0,
    "near-open": 690.0,
    "open": 780.0,
}
# backness -> F2 (Hz); rounding lowers F2/F3
_F2 = {"front": 2100.0, "central": 1450.0, "back": 900.0}

_FORMANT_BW = (90.0, 110.0, 160.0, 220.0)
_FORMANT_GAIN = (1.0, 0.55, 0.28, 0.18)

# fricative noise band per place: (center Hz, bandwidth Hz, amplitude)
_FRIC_BAND = {
    "bilabial": (1000.0, 1400.0, 0.35),
    "labiodental": (4500.0, 5000.0, 0.35),
    "dental": (5200.0, 6000.0, 0.35),
    "alveolar": (6000.0, 2600.0, 0.9),
    "postalveolar": (3200.0, 1800.0, 0.9),
    "alveolopalatal": (3900.0, 2200.0, 0.85),
    "retroflex": (2800.0, 1600.0, 0.85),
    "palatal": (3500.0, 2600.0, 0.6),
    "velar": (1500.0, 900.0, 0.6),
    "uvular": (1150.0, 700.0, 0.6),
    "pharyngeal": (1300.0, 900.0, 0.5),
    "glottal": (0.0, 0.0, 0.5),  # aspiration through vowel formants
    "postalveolar-velar": (2300.0, 2600.0, 0.8),  # Swedish sj
}

# plosive burst center per place
_BURST = {
    "bilabial": 800.0,
    "labiodental": 1400.0,
    "dental": 4200.0,
    "alveolar": 3900.0,
    "retroflex": 2600.0,
    "palatal": 3100.0,
    "velar": 1700.0,
    "uvular": 1300.0,
    "glottal": 0.0,
}

# approximant loci (F1, F2, F3)
_APPROX = {
    ("alveolar", False): (310.0, 1060.0, 1380.0),  # ɹ: the low F3 is the cue
    ("retroflex", False): (300.0, 1350.0, 1500.0),
    ("palatal", False): (280.0, 2250.0, 3000.0),
    ("velar", False): (300.0, 1400.0, 2400.0),
    ("labiovelar", False): (300.0, 700.0, 2300.0),
    ("labiopalatal", False): (280.0, 1900.0, 2500.0),
    ("labiodental", False): (300.0, 1100.0, 2300.0),
    ("alveolar", True): (360.0, 1300.0, 2700.0),  # laterals
    ("palatal", True): (280.0, 2000.0, 2800.0),
    ("velar", True): (320.0, 1100.0, 2500.0),
}


def _formants(part: typing.Tuple[str, str, bool]) -> typing.Tuple[float, ...]:
    height, backness, rounded = part
    f1 = _F1[height]
    f2 = _F2[backness]
    # front vowels spread F2 with aperture: [i] 2250 -> [a] 1750
    if backness == "front":
        f2 -= 0.7 * (f1 - 290.0)
    f3, f4 = 2700.0, 3500.0
    if rounded:
        f2 *= 0.85
        f3 *= 0.92
    return f1, f2, f3, f4


def _voiced_source(
    n: int, sr: int, f0_start: float = 128.0, f0_end: float = 96.0
) -> np.ndarray:
    """Band-limited glottal-ish pulse train with falling pitch."""
    f0 = np.linspace(f0_start, f0_end, n)
    phase = 2.0 * np.pi * np.cumsum(f0) / sr
    n_harm = int(5000.0 / max(f0_start, f0_end))
    k = np.arange(1, n_harm + 1)[:, None]
    out = np.sum(np.sin(k * phase[None, :]) / k, axis=0)
    return (out / np.max(np.abs(out) + 1e-9)).astype(np.float32)


def _filter_formants(
    x: np.ndarray,
    sr: int,
    formants: typing.Sequence[float],
    gains: typing.Sequence[float] = _FORMANT_GAIN,
    bws: typing.Sequence[float] = _FORMANT_BW,
) -> np.ndarray:
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / sr)
    h = np.zeros_like(freqs)
    for f, g, bw in zip(formants, gains, bws):
        h += g / (1.0 + ((freqs - f) / (bw / 2.0)) ** 2)
    h += 0.01
    out = np.fft.irfft(spec * h, n=len(x))
    return (out / (np.max(np.abs(out)) + 1e-9)).astype(np.float32)


def _noise_band(n: int, sr: int, fc: float, bw: float, rng) -> np.ndarray:
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    if fc > 0:
        mask = np.exp(-0.5 * ((freqs - fc) / (bw / 2.0 + 1e-9)) ** 2) + 0.02
    else:
        mask = np.ones_like(freqs)
    out = np.fft.irfft(spec * mask, n=n)
    return (out / (np.max(np.abs(out)) + 1e-9)).astype(np.float32)


def _env(n: int, attack: float = 0.02, release: float = 0.06, sr: int = SAMPLE_RATE):
    env = np.ones(n, dtype=np.float32)
    a = min(int(attack * sr), n // 2)
    r = min(int(release * sr), n // 2)
    if a:
        env[:a] = np.linspace(0.0, 1.0, a)
    if r:
        env[-r:] = np.linspace(1.0, 0.0, r)
    return env


def _vowel_segment(
    parts: typing.Sequence[typing.Tuple[str, str, bool]],
    dur: float,
    sr: int,
    nasalized: bool = False,
    rhotic: bool = False,
) -> np.ndarray:
    """Steady vowel or formant glide across `parts` (diphthong)."""
    n = int(dur * sr)
    src = _voiced_source(n, sr)
    keyframes = [list(_formants(p)) for p in parts]
    if rhotic:
        for kf in keyframes:
            kf[2] = 1690.0  # lowered F3 = rhotacization
    if len(keyframes) == 1:
        out = _filter_formants(src, sr, keyframes[0])
    else:
        # overlap-add Hann frames with linearly interpolated formants
        frame = int(0.046 * sr) // 2 * 2
        hop = frame // 2
        win = np.hanning(frame).astype(np.float32)
        out = np.zeros(n, dtype=np.float32)
        for start in range(0, n - frame + 1, hop):
            t = start / max(n - frame, 1)
            pos = t * (len(keyframes) - 1)
            i = min(int(pos), len(keyframes) - 2)
            frac = pos - i
            fmts = [
                (1 - frac) * a + frac * b
                for a, b in zip(keyframes[i], keyframes[i + 1])
            ]
            out[start : start + frame] += win * _filter_formants(
                src[start : start + frame] * win, sr, fmts
            )
        out /= np.max(np.abs(out)) + 1e-9
    if nasalized:
        # add a nasal murmur pole and damp the upper formants
        nasal = _filter_formants(src, sr, (270.0, 2300.0), gains=(1.0, 0.1),
                                 bws=(120.0, 300.0))
        out = 0.6 * out + 0.4 * nasal
        out /= np.max(np.abs(out)) + 1e-9
    return out * _env(n, sr=sr)


_A = ("open", "front", False)
_I = ("close", "front", False)


def _consonant_segment(p: "ipa.Phoneme", sr: int, rng) -> np.ndarray:
    """The consonant itself (no following vowel)."""
    place, manner, voiced = p.place, p.manner, p.voiced

    if manner in ("plosive", "implosive"):
        closure = np.zeros(int(0.06 * sr), dtype=np.float32)
        if voiced:  # voice bar during closure
            closure = 0.15 * _filter_formants(
                _voiced_source(len(closure), sr), sr, (150.0,), gains=(1.0,),
                bws=(80.0,),
            )
        nb = int(0.018 * sr)
        fc = _BURST.get(place, 2000.0)
        amp = 0.9 if manner == "plosive" else 0.5
        burst = (
            amp * _noise_band(nb, sr, fc, 800.0, rng) * _env(nb, 0.001, 0.012, sr)
            if fc > 0
            else np.zeros(nb, dtype=np.float32)
        )
        return np.concatenate([closure, burst])

    if manner == "affricate":
        closure = np.zeros(int(0.04 * sr), dtype=np.float32)
        fc, bw, amp = _FRIC_BAND.get(place, (3000.0, 1800.0, 0.8))
        nf = int(0.14 * sr)
        fric = amp * _noise_band(nf, sr, fc, bw, rng) * _env(nf, 0.004, 0.03, sr)
        if voiced:
            buzz = 0.4 * _filter_formants(
                _voiced_source(nf, sr), sr, (200.0,), gains=(1.0,), bws=(100.0,)
            )
            fric = 0.7 * fric + buzz
        return np.concatenate([closure, fric])

    if manner == "fricative":
        fc, bw, amp = _FRIC_BAND.get(place, (3000.0, 1800.0, 0.7))
        nf = int(0.24 * sr)
        if place == "glottal":  # aspiration through open-vowel formants
            fric = 0.6 * _filter_formants(
                _noise_band(nf, sr, 0.0, 0.0, rng), sr, _formants(_A)
            )
        else:
            fric = amp * _noise_band(nf, sr, fc, bw, rng)
        if voiced:
            buzz = 0.45 * _filter_formants(
                _voiced_source(nf, sr), sr, (220.0,), gains=(1.0,), bws=(100.0,)
            )
            fric = 0.65 * fric + buzz
        return fric * _env(nf, 0.02, 0.03, sr)

    if manner == "nasal":
        nn = int(0.22 * sr)
        murmur = _filter_formants(
            _voiced_source(nn, sr), sr, (250.0, 2200.0), gains=(1.0, 0.06),
            bws=(100.0, 300.0),
        )
        return 0.8 * murmur * _env(nn, 0.02, 0.02, sr)

    if manner == "trill":
        nt = int(0.22 * sr)
        loci = (300.0, 1300.0, 2400.0) if place != "uvular" else (300.0, 1100.0, 1900.0)
        body = _filter_formants(_voiced_source(nt, sr), sr, loci)
        t = np.arange(nt) / sr
        am = 0.55 + 0.45 * np.square(np.sin(np.pi * 27.0 * t))
        return body * am.astype(np.float32) * _env(nt, sr=sr)

    if manner == "flap":
        # [a] with one short closure dip in the middle
        na = int(0.09 * sr)
        seg = _vowel_segment([_A], 0.09, sr)
        dip = _env(na, 0.0, 0.0, sr)
        mid, half = na // 2, int(0.012 * sr)
        dip[max(mid - half, 0) : mid + half] = 0.1
        return seg * dip

    # approximants (incl. laterals): hold the loci briefly
    lateral = manner.startswith("lateral")
    loci = _APPROX.get((place, lateral), (300.0, 1500.0, 2500.0))
    nap = int(0.12 * sr)
    return 0.8 * _filter_formants(
        _voiced_source(nap, sr), sr, loci
    ) * _env(nap, 0.02, 0.01, sr)


def synthesize_example(
    p: "ipa.Phoneme", sample_rate: int = SAMPLE_RATE, seed: int = 0
) -> np.ndarray:
    """Synthesize one phoneme example as float32 audio in [-1, 1]."""
    sr = sample_rate
    rng = np.random.default_rng(seed)
    if p.kind in ("vowel", "diphthong"):
        dur = (0.55 if p.kind == "vowel" else 0.6) * (1.5 if p.long else 1.0)
        audio = _vowel_segment(
            p.vowel_parts, dur, sr, nasalized=p.nasalized, rhotic=p.rhotic
        )
    else:
        pieces = []
        if p.prenasal:
            nn = int(0.09 * sr)
            pieces.append(
                0.7
                * _filter_formants(
                    _voiced_source(nn, sr), sr, (250.0,), gains=(1.0,),
                    bws=(100.0,),
                )
                * _env(nn, sr=sr)
            )
        base = _consonant_segment(p, sr, rng)
        if p.long:
            base = np.concatenate([base, base])
        pieces.append(base)
        if p.palatalized:
            pieces.append(0.7 * _vowel_segment([_I], 0.06, sr))
        pieces.append(_vowel_segment([_A], 0.22, sr))
        audio = np.concatenate(pieces)
    peak = np.max(np.abs(audio)) + 1e-9
    return (0.89 * audio / peak).astype(np.float32)


def write_examples(
    symbols: typing.Iterable[str],
    out_dir,
    sample_rate: int = SAMPLE_RATE,
) -> typing.Dict[str, str]:
    """Synthesize example WAVs for `symbols` into `out_dir`.

    Returns {symbol: wav file name}.  Identical feature bundles share one
    file (e.g. every language's /a/ maps to the same stem), and existing
    files are kept.
    """
    from pathlib import Path

    from larynx_tpu_torch.audio import audio_float_to_int16
    from larynx_tpu_torch.io.wavfile import write as wav_write

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mapping: typing.Dict[str, str] = {}
    for symbol in symbols:
        p = ipa.parse_phoneme(symbol)
        if p is None:
            continue
        name = f"{p.stem}.wav"
        path = out_dir / name
        if not path.is_file():
            audio = synthesize_example(p, sample_rate)
            with open(path, "wb") as f:
                wav_write(f, sample_rate, audio_float_to_int16(audio))
        mapping[symbol] = name
    return mapping
