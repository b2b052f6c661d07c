#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (larynx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build every CUDA kernel of the port
     from the sources in this checkout (one nvcc per source, all at once).
  2. each kernel against its plain PyTorch version at the main path's
     shapes, with times for the kernel, the plain version and a cuDNN
     yardstick, and the card's lower bound for the same work.
  3. the main path: ``larynx_tpu_torch.text_to_speech`` at full width
     (GlowTTS harvard dims + HiFi-GAN universal_large, random weights from
     a fixed seed) on eight pangram sentences, with and without the
     denoiser, with the kernels' launch counts read around each run; a
     ragged batch of ten other sentences, which the vocoder splits into
     groups, is also synthesised on the CPU path and compared row by row.
The last two lines are the kernels JSON and the device JSON.  Needs one
CUDA device and nvcc; imports nothing of JAX.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM data sheet, dense: TF32 on the tensor cores, HBM3.  The MRF kernel
# forms each f32 product as three TF32 tensor-core products (3xTF32), so its
# bound counts three TF32 operations per f32 FLOP of the section.
TF32_PEAK_FLOPS = 495e12
TF32_PER_F32 = 3
HBM_BYTES_PER_S = 3.35e12

# the 46-symbol en-us inventory of the harvard voice's phonemes.txt
PHONEMES = (
    "_ | ‖ # ˈ ˌ aɪ aʊ b d d͡ʒ eɪ f h i j k l m n oʊ p s t t͡ʃ u v w z æ ð ŋ ɑ ɔ ɔɪ ə ɚ ɛ ɡ ɪ ɹ ʃ ʊ ʌ ʒ θ"
).split()
PANGRAM = (
    "The beige hue on the waters of the loch impressed all, including the "
    "French queen, before she heard that symphony again, just as young "
    "Arthur wanted."
)
LENGTH_SCALE = 6.0  # random weights emit ~1 frame per id; real voices ~6
AUDIO = {
    "filter_length": 1024, "hop_length": 256, "win_length": 1024, "mel_channels": 80,
    "sample_rate": 22050, "sample_bytes": 2, "channels": 1, "mel_fmin": 0.0,
    "mel_fmax": 8000.0, "ref_level_db": 20.0, "spec_gain": 1.0, "signal_norm": True,
    "min_level_db": -100.0, "max_norm": 1.0, "clip_norm": True, "symmetric_norm": True,
    "do_dynamic_range_compression": True, "convert_db_to_amp": True,
}
VOICE = "en-us_harvard-glow_tts"
# ten sentences of one text bucket (33-64 ids), out of length order
RAGGED = (
    "The birch canoe slid on the smooth planks.",
    "Cats and dogs each hate the other.",
    "The beige hue on the waters of the loch impressed all.",
    "Rice is often served in round bowls.",
    "A large size in stockings is hard to sell.",
    "The pipe began to rust while new.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "It's easy to tell the depth of a well.",
    "Thieves who rob friends deserve jail.",
)

# MRF kernel against its plain version: max-abs tolerance.  The kernel forms
# each f32 product as three TF32 tensor-core products (~2^-21 relative) and
# sums up to 11 * 128 of them per conv output in another order than cuDNN
# (TF32 off), over six chained convs per resblock: ~1e-5 on values of O(5).
# 1e-4 leaves room for that and catches any indexing or masking fault,
# which is O(1).
MRF_TOLERANCE = 1e-4
# CUDA path against the port's CPU path, int16 audio: sums in other orders
# move the float audio by ~1e-6, i.e. under one step of 32767.
AUDIO_TOLERANCE_LSB = 2


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_stage(gen, c, kernel_sizes, dilations, convs_per_unit):
    """A stage's resblocks in the port's layout, with the init's scale."""
    def conv(k):
        bound = 1.0 / (c * k) ** 0.5
        return {
            "w": (torch.rand((c, c, k), generator=gen) * 2 - 1) * bound,
            "b": (torch.rand(c, generator=gen) * 2 - 1) * bound,
        }

    if convs_per_unit == 2:
        return [{"convs1": [conv(k) for _ in d], "convs2": [conv(k) for _ in d]}
                for k, d in zip(kernel_sizes, dilations)]
    return [{"convs": [conv(k) for _ in d]} for k, d in zip(kernel_sizes, dilations)]


R1 = ((3, 7, 11), ((1, 3, 5),) * 3, 2)  # universal_large: ResBlock1
R2 = ((3, 5, 7), ((1, 2), (2, 6), (3, 12)), 1)  # vctk_small: ResBlock2


def check_mrf(mrf_block, main_cases):
    """Phase 2: mrf_section against mrf_section_plain, first at the shapes the
    main path gives it, then at a 512-frame mel, ResBlock2 and a ragged T."""
    from larynx_tpu_torch.weights import tree_to

    cases = list(main_cases) + [  # (label, C, geometry, B, T, on the main path)
        ("universal_large stage 2, 512-frame mel", 128, R1, 8, 32768, False),
        ("universal_large stage 3, 512-frame mel", 64, R1, 8, 65536, False),
        ("universal_large stage 4, 512-frame mel", 32, R1, 8, 131072, False),
        ("vctk_small stage 1, 512-frame mel", 128, R2, 8, 4096, False),
        ("ragged T", 128, R1, 2, 1000, False),
    ]
    gen = torch.Generator().manual_seed(0)
    rows = []
    for label, c, (ks, dils, cpu), b, t, main in cases:
        stage = mrf_block.pack_mrf_stage(
            tree_to(random_stage(gen, c, ks, dils, cpu), "cuda"), ks, dils, cpu)
        w, bias = stage.w_flat, stage.b_flat
        x = torch.randn((b, t, c), generator=gen).cuda()
        out = mrf_block.mrf_section(x, stage)
        torch.cuda.synchronize()
        ref = mrf_block.mrf_section_plain(x, w, bias, ks, dils, cpu)
        err = (out - ref).abs().max().item()
        if not err <= MRF_TOLERANCE:
            raise AssertionError(f"mrf_section {label}: max abs err {err} > {MRF_TOLERANCE}")

        convs = list(mrf_block._unpacked_convs(w, bias, c, ks, dils, cpu))
        xc = x.transpose(1, 2).contiguous()

        def cudnn_chain():  # the section's convs alone, one cuDNN call each
            for _r, _u, unit in convs:
                for cw, cb, d in unit:
                    torch.nn.functional.conv1d(xc, cw, cb, padding=(cw.shape[-1] - 1) // 2 * d,
                                               dilation=d)

        taps = cpu * sum(k * len(d) for k, d in zip(ks, dils))
        ops_s = TF32_PER_F32 * 2.0 * b * t * c * c * taps / TF32_PEAK_FLOPS
        bytes_s = 4.0 * (2 * b * t * c + stage.frags.numel() + bias.numel()) / HBM_BYTES_PER_S
        row = {
            "case": label, "C": c, "B": b, "T": t, "convs_per_unit": cpu, "main_path": main,
            "max_abs_err": err,
            "ms": time_ms(lambda: mrf_block.mrf_section(x, stage)),
            "plain_ms": time_ms(lambda: mrf_block.mrf_section_plain(x, w, bias, ks, dils, cpu)),
            "library_ms": time_ms(cudnn_chain),
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
        }
        rows.append(row)
        log(f"mrf_section {label}: C={c} B={b} T={t} max_abs_err={err:.3g} (tol {MRF_TOLERANCE}) "
            f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"cuDNN conv chain {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms")
    return rows


def stage_voices(root: Path):
    """A voices dir: GlowTTS harvard dims + hifi_gan/universal_large, random."""
    from larynx_tpu_torch.convert.native import save_params
    from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
    from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
    from larynx_tpu_torch.weights import init_params

    glow_cfg, voc_cfg = GlowTTSConfig(), HiFiGanConfig()
    voice_dir = root / "en-us" / "harvard-glow_tts"
    voice_dir.mkdir(parents=True)
    model = {k: getattr(glow_cfg, k) for k in glow_cfg.__dataclass_fields__}
    (voice_dir / "config.json").write_text(json.dumps({"audio": AUDIO, "model": model}))
    (voice_dir / "phonemes.txt").write_text("".join(f"{i} {p}\n" for i, p in enumerate(PHONEMES)))
    save_params(voice_dir / "generator.npz", init_params(torch.Generator().manual_seed(0), glow_cfg))

    voc_dir = root / "hifi_gan" / "universal_large"
    voc_dir.mkdir(parents=True)
    voc_model = {
        "resblock": voc_cfg.resblock,
        "upsample_rates": list(voc_cfg.upsample_rates),
        "upsample_kernel_sizes": list(voc_cfg.upsample_kernel_sizes),
        "upsample_initial_channel": voc_cfg.upsample_initial_channel,
        "resblock_kernel_sizes": list(voc_cfg.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(d) for d in voc_cfg.resblock_dilation_sizes],
    }
    (voc_dir / "config.json").write_text(
        json.dumps({"model": voc_model, "audio": {"num_mels": 80, "sampling_rate": 22050}})
    )
    save_params(voc_dir / "generator.npz", init_params(torch.Generator().manual_seed(1), voc_cfg))


def vocode_plan(engine, jobs, length_scale):
    """The rows' mel lengths, their mel bucket and the engine's own vocoder
    group plan [(start, rows, frames)] for one batch of jobs."""
    from larynx_tpu_torch.runtime.engine import MAX_VOCODE_AREA

    enc, _ = engine.encode_launch([j["ids"] for j in jobs], length_scale)
    y_lengths = enc[4].cpu().numpy()[: len(jobs)]
    m = engine.policy.mel_bucket(int(y_lengths.max()))
    plan = engine._ragged_group_plan(np.sort(y_lengths)[::-1], len(jobs), m, MAX_VOCODE_AREA)
    return y_lengths, m, plan


def plan_main_path(root: Path):
    """The main path's batch: its jobs, its engine, the rows' mel lengths and
    the (B, T, C) that each vocoder call gives mrf_section, from the engine's
    own group plan."""
    import larynx_tpu_torch

    jobs = larynx_tpu_torch._build_jobs(" ".join([PANGRAM] * 8), VOICE, "high",
                                        custom_voices_dir=root, no_download=True)
    engine = larynx_tpu_torch._get_engine(jobs[0]["tts_model"], jobs[0]["vocoder_model"],
                                          torch.device("cuda"))
    y_lengths, m, plan = vocode_plan(engine, jobs, LENGTH_SCALE)
    log(f"main path: {len(jobs)} sentences, {[len(j['ids']) for j in jobs]} ids, "
        f"y_lengths {y_lengths.tolist()}, mel bucket {m}, vocoder groups (start, rows, frames) {plan}")

    cfg = engine.vocoder_cfg
    cases = []
    for start, rows, frames in plan:
        t = frames
        for i, rate in enumerate(cfg.upsample_rates):
            t *= rate
            c = cfg.upsample_initial_channel // 2 ** (i + 1)
            if c <= 128:
                cases.append((f"main path, rows {start}-{start + rows - 1}, stage {i + 1}",
                              c, R1, rows, t, True))
    return jobs, engine, y_lengths, cases


def main_path(root: Path, mrf_block, jobs, engine, y_lengths):
    """Phase 3: text_to_speech at full width on the card."""
    import larynx_tpu_torch
    from larynx_tpu_torch.dsp.stft import num_frames
    from larynx_tpu_torch.runtime.engine import postprocess

    text = " ".join([PANGRAM] * 8)
    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality="high", custom_voices_dir=root,
                  no_download=True, tts_settings={"length_scale": LENGTH_SCALE})

    for strength in (0.0, 0.005):  # warm-up: cuDNN/cuFFT plans, the denoiser bias
        list(larynx_tpu_torch.text_to_speech(text, device="cuda", denoiser_strength=strength,
                                             **kwargs))
    launches = {}
    for label, strength in (("no denoiser", 0.0), ("denoiser 0.005", 0.005)):
        mrf_block.mrf_section.launches = 0
        calls_before = engine.generator_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        results = list(larynx_tpu_torch.text_to_speech(text, device="cuda",
                                                       denoiser_strength=strength, **kwargs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        n_launch = mrf_block.mrf_section.launches
        calls = engine.generator_calls - calls_before

        if len(results) != 8:
            raise AssertionError(f"{label}: {len(results)} results, expected 8")
        for res, y in zip(results, y_lengths):
            n = int(y) * 256
            if strength > 0:
                n = num_frames(n, 1024, 256) * 256 + 1024
            audio = res.audio
            if audio.dtype != np.int16 or audio.shape != (n,):
                raise AssertionError(f"{label}: audio {audio.dtype} {audio.shape}, expected ({n},)")
            if np.abs(audio.astype(np.int32)).max() < 1000 or audio.astype(np.float64).std() < 10:
                raise AssertionError(f"{label}: silent audio")
        if calls < 1 or n_launch != 3 * calls:
            raise AssertionError(f"{label}: {n_launch} mrf_section launches for {calls} generator calls")
        audio_s = sum(r.audio.shape[0] for r in results) / 22050
        launches[label] = n_launch
        log(f"main path, {label}: wall {wall:.4f} s, audio {audio_s:.2f} s, RTF {wall / audio_s:.6f}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"generator calls {calls}, mrf_section launches {n_launch}")

    # where the time goes: the engine's stages on the same batch, host clock
    # around synchronised work, mean of 3
    ids = [j["ids"] for j in jobs]
    n = len(ids)

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(3):
            out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - start) / 3

    (enc, _g), t_enc = timed(lambda: engine.encode_launch(ids, LENGTH_SCALE))
    y_host, t_sync = timed(lambda: enc[4].cpu().numpy())
    (mel, z_mask), t_dec = timed(lambda: engine.decode_launch(enc, y_host, None, n, batch_index=0))
    _, t_voc = timed(lambda: engine.vocode_collect(
        engine.vocode_launch(mel, z_mask, n, 0.0, y_lengths=y_host), mel.shape[0]))
    _, t_voc_dn = timed(lambda: engine.vocode_collect(
        engine.vocode_launch(mel, z_mask, n, 0.005, y_lengths=y_host), mel.shape[0]))
    mel_pp = postprocess(mel, z_mask, engine.audio_settings).transpose(1, 2)
    _, t_gen = timed(lambda: engine._generate(mel_pp))
    log(f"stage times (ms, B={n}, mel bucket {mel.shape[1]}): encode {t_enc:.3f}, "
        f"y_lengths to host {t_sync:.3f}, flow decode {t_dec:.3f}, "
        f"vocode+int16+copy {t_voc:.3f} (of which generator {t_gen:.3f}), "
        f"vocode with denoiser {t_voc_dn:.3f}")

    # ten distinct sentences in one batch, through the CUDA path and the
    # port's CPU path: each row goes through the engine's length sort, a
    # vocoder group of the plan and back to document order (length_scale 1
    # keeps the CPU run short)
    ragged = " ".join(RAGGED)
    rjobs = larynx_tpu_torch._build_jobs(ragged, VOICE, "high", custom_voices_dir=root,
                                         no_download=True)
    lengths = [len(j["ids"]) for j in rjobs]
    r_lengths, r_m, r_plan = vocode_plan(engine, rjobs, 1.0)
    if len(engine.policy.group_by_text_bucket(lengths, 16)) != 1 or len(r_plan) < 2:
        raise AssertionError(f"ragged batch: ids {lengths}, vocoder plan {r_plan}: "
                             "expected one batch in two or more vocoder groups")
    short = dict(kwargs, tts_settings={"noise_scale": 0.0}, max_batch=16)
    gpu = [r.audio for r in larynx_tpu_torch.text_to_speech(ragged, device="cuda", **short)]
    cpu = [r.audio for r in larynx_tpu_torch.text_to_speech(ragged, device="cpu", **short)]
    if len(gpu) != len(RAGGED) or len(cpu) != len(RAGGED):
        raise AssertionError(f"ragged batch: {len(gpu)} CUDA and {len(cpu)} CPU results")
    worst = 0
    for i, (a, b, y) in enumerate(zip(gpu, cpu, r_lengths)):
        if a.shape != b.shape or a.shape != (int(y) * 256,):
            raise AssertionError(f"ragged row {i}: shapes {a.shape}/{b.shape}, y_length {y}")
        worst = max(worst, int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()))
    if worst > AUDIO_TOLERANCE_LSB:
        raise AssertionError(f"CUDA vs CPU path, ragged batch: max diff {worst} LSB")
    log(f"CUDA vs CPU path, ragged batch of {len(RAGGED)}: ids {lengths}, y_lengths "
        f"{r_lengths.tolist()}, mel bucket {r_m}, vocoder groups {r_plan}, max diff {worst} LSB "
        f"(tol {AUDIO_TOLERANCE_LSB})")
    return launches["no denoiser"]


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    from larynx_tpu_torch.ops import build, mrf_block

    start = time.perf_counter()
    build.build(["mrf_section"])
    ptxas = sorted({line.split(":", 1)[1].strip()
                    for line in build.BUILD_LOGS.get("mrf_section", "").splitlines()
                    if "registers" in line})
    log(f"built mrf_section in {time.perf_counter() - start:.1f} s; ptxas: "
        + ("; ".join(ptxas) or "already built"))

    # plain references and the main path run in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with tempfile.TemporaryDirectory() as tmp:
        stage_voices(Path(tmp))
        jobs, engine, y_lengths, main_cases = plan_main_path(Path(tmp))
        rows = check_mrf(mrf_block, main_cases)
        launches = main_path(Path(tmp), mrf_block, jobs, engine, y_lengths)

    main_rows = [r for r in rows if r["main_path"]]
    kernels = [{
        "name": "mrf_section",
        "route": "cuda",
        "source": "larynx_tpu_torch/csrc/mrf_section.cu",
        "replaces": "larynx_tpu/ops/mrf_block.py:272; larynx_tpu/ops/mrf_block.py:382",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # the main path's generator call(s) without the denoiser: stages 2-4
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "cases": rows,
    }]
    if any(r["bound_by"] != "operations" for r in main_rows):
        raise AssertionError("expected the MRF section to be bound by operations")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
