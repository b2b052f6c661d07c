"""The counting functions against the bound column of the port's kernel
table (PERF.md, on the H100's published peaks), and the whole models'
FLOPs per second of audio."""

import json
from pathlib import Path

import pytest

from portbench.counts import model, mrf, peaks, wn
from portbench.kinds import glow_tts, hifi_gan, waveglow

HERE = Path(__file__).resolve().parent
UL = ((3, 7, 11), ((1, 3, 5),) * 3, 2)  # universal_large's resblocks


def mrf_bound_ms(b, t, c, itemsize=2):
    taps = mrf.section_taps(*UL)
    return 1e3 * peaks.bound_s(mrf.section_flops(b, t, c, taps),
                               mrf.section_bytes(b, t, c, *UL, itemsize), itemsize)


def wn_bound_ms(b, t, first, last, itemsize, ch=256, cc=640):
    rs = ch if last else 2 * ch
    n_weights = 2 * ch * ch * 3 + 2 * ch * cc + rs * ch + 2 * ch + rs
    return 1e3 * peaks.bound_s(wn.layer_flops(b, t, ch, cc, rs),
                               wn.layer_bytes(b, t, ch, cc, rs, first, last, n_weights, itemsize),
                               itemsize)


def test_taps():
    assert mrf.section_taps(*UL) == 126


@pytest.mark.parametrize("c,t,want", [(128, 65536, 2.189), (64, 131072, 1.094),
                                      (32, 262144, 0.547)])
def test_bf16_mrf_main_path_bounds(c, t, want):
    assert mrf_bound_ms(8, t, c) == pytest.approx(want, abs=5e-4)


def test_bf16_mrf_main_path_sum():
    total = sum(mrf_bound_ms(8, t, c) for c, t in ((128, 65536), (64, 131072), (32, 262144)))
    assert total == pytest.approx(3.830, abs=1e-3)


def test_bf16_wn_stack_bound():
    stack = sum(wn_bound_ms(4, 32768, i == 0, i == 7, 2) for i in range(8))
    assert stack == pytest.approx(1.789, abs=1e-3)


def test_f32_wn_middle_layer_bound():
    assert wn_bound_ms(4, 32768, False, False, 4) == pytest.approx(1.354, abs=1e-3)


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_flops_per_audio_second():
    """~53 GFLOP of HiFi-GAN universal_large and ~450 of WaveGlow 256 per
    second of audio; GlowTTS ~2 at ~6.5 frames per id."""
    frames = 22050 / 256  # one second of audio
    ul = _config("glowtts-harvard.hifigan-ul")
    wg = _config("glowtts-harvard.waveglow-256")
    assert hifi_gan.hifigan_flops(ul["vocoder"], frames) / 1e9 == pytest.approx(53, rel=0.03)
    assert waveglow.waveglow_flops(wg["vocoder"], frames) / 1e9 == pytest.approx(450, rel=0.03)
    ids = frames / 6.5
    glow = (glow_tts.glow_encode_flops(ul["acoustic"], ids)
            + glow_tts.glow_decode_flops(ul["acoustic"], frames)) / 1e9
    assert 1.0 < glow < 3.0
    assert model.request_flops(ul, ids, frames) > hifi_gan.hifigan_flops(ul["vocoder"], frames)
