#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (larynx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build every CUDA kernel of the port
     from the sources in this checkout (one nvcc per source, all at once).
  2. each kernel against its plain PyTorch version at the main paths'
     shapes, with times for the kernel, the plain version and a
     cuDNN/cuBLAS yardstick, and the card's lower bound for the same work:
     mrf_section (HiFi-GAN: whole sections, and single resblock units at
     C=128 with a ragged T of odd tile count and a T under one stride) and
     wn_layer (WaveGlow: every mode, ragged T with an odd tile count and a
     one-step tail, and a whole 8-layer WN stack), each row with its share
     of the bound.
  3. the HiFi-GAN path: ``larynx_tpu_torch.text_to_speech`` at full width
     (GlowTTS harvard dims + HiFi-GAN universal_large, random weights from
     a fixed seed) on eight pangram sentences, with and without the
     denoiser, with the kernels' launch counts read around each run (one
     MRF launch per resblock unit: 27 per generator call); a
     ragged batch of ten other sentences, which the vocoder splits into
     groups, is also synthesised on the CPU path and compared row by row.
  4. the WaveGlow path: the same with ``vocoder_or_quality="waveglow"``
     (WaveGlow wn_256 at full width, random weights with perturbed coupling
     end convs), and the ragged batch on CUDA and CPU with a zero prior.
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
# WN layer kernel against its plain version: max-abs tolerance, on O(1)
# inputs with the init's weight scales (0.05, 0.01).  The kernel forms each
# f32 product as three TF32 tensor-core products (~2^-21 relative) and sums
# 1408 of them per pre-gate value and 256 per rs value in another order
# than cuDNN/cuBLAS (TF32 off): ~2e-5 after one layer and after a whole
# 8-layer stack.  1e-4 leaves room for that and catches any indexing,
# halo or mode fault, which is O(0.1) or more.
WN_TOLERANCE = 1e-4
# Coupling end-conv scale of the staged WaveGlow: the init's end_w = 0
# makes every coupling the identity, so the audio would not depend on the
# WN stacks.  At 0.001 the skip sums (O(1.6) per channel over 256 channels)
# give log_s of O(0.04): exp(-log_s) over 12 flows stays finite.
WG_END_SCALE = 0.001
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


def unit_design_bytes(stage, b, t):
    """HBM bytes that the per-unit launches move for one section: each unit
    reads its input and writes its output once (a chain's last unit after
    the first chain also reads out), plus the weight stages once; the
    residual re-read and the tiles' halos come from L2."""
    from larynx_tpu_torch.ops.mrf_block import MODE_OUT_ADD, unit_launches

    act = 4.0 * b * t * stage.b_flat.shape[-1]
    io = sum(act * (3 if mode == MODE_OUT_ADD else 2) for *_, mode, _s in unit_launches(stage))
    return io + 4.0 * (stage.wpack.numel() + stage.b_flat.numel())


def check_mrf(mrf_block, main_cases):
    """Phase 2: mrf_section against mrf_section_plain, first at the shapes the
    main path gives it, then at a 512-frame mel, ResBlock2 and a ragged T;
    then single universal_large units (one-unit stages, one launch each)
    against mrf_unit_plain at C=128: each unit kind at the main path's
    shape, a ragged T with an odd tile count and a T under one stride."""
    from larynx_tpu_torch.weights import tree_to

    cases = list(main_cases) + [  # (label, C, geometry, B, T, on the main path)
        ("universal_large stage 2, 512-frame mel", 128, R1, 8, 32768, False),
        ("universal_large stage 3, 512-frame mel", 64, R1, 8, 65536, False),
        ("universal_large stage 4, 512-frame mel", 32, R1, 8, 131072, False),
        ("vctk_small stage 1, 512-frame mel", 128, R2, 8, 4096, False),
        ("ragged T", 128, R1, 2, 1000, False),
    ]
    b_main, t_main = next((b, t) for _l, c, _g, b, t, _m in main_cases if c == 128)
    units = [  # (label, k, d, B, T): stride 126, 122, 118
        ("unit (3,1), main shape", 3, 1, b_main, t_main),
        ("unit (7,3), main shape", 7, 3, b_main, t_main),
        ("unit (11,5), main shape", 11, 5, b_main, t_main),
        ("unit (11,5), ragged T, 13 tiles", 11, 5, 3, 118 * 13 - 50),
        ("unit (7,3), T under one stride", 7, 3, 2, 100),
    ]
    gen = torch.Generator().manual_seed(0)
    rows = []
    for label, c, (ks, dils, cpu), b, t, main in cases + [
            (label, 128, ((k,), ((d,),), 2), b, t, False) for label, k, d, b, t in units]:
        stage = mrf_block.pack_mrf_stage(
            tree_to(random_stage(gen, c, ks, dils, cpu), "cuda"), ks, dils, cpu)
        w, bias = stage.w_flat, stage.b_flat
        x = torch.randn((b, t, c), generator=gen).cuda()
        out = mrf_block.mrf_section(x, stage)
        torch.cuda.synchronize()
        convs = list(mrf_block._unpacked_convs(w, bias, c, ks, dils, cpu))
        if len(convs) == 1:  # a single unit: its own plain version
            def plain():
                return mrf_block.mrf_unit_plain(x, convs[0][2])
        else:
            def plain():
                return mrf_block.mrf_section_plain(x, w, bias, ks, dils, cpu)
        err = (out - plain()).abs().max().item()
        if not err <= MRF_TOLERANCE:
            raise AssertionError(f"mrf_section {label}: max abs err {err} > {MRF_TOLERANCE}")
        xc = x.transpose(1, 2).contiguous()

        def cudnn_chain():  # the convs alone, one cuDNN call each
            for _r, _u, unit in convs:
                for cw, cb, d in unit:
                    torch.nn.functional.conv1d(xc, cw, cb, padding=(cw.shape[-1] - 1) // 2 * d,
                                               dilation=d)

        taps = cpu * sum(k * len(d) for k, d in zip(ks, dils))
        ops_s = TF32_PER_F32 * 2.0 * b * t * c * c * taps / TF32_PEAK_FLOPS
        bytes_s = 4.0 * (2 * b * t * c + stage.wpack.numel() + bias.numel()) / HBM_BYTES_PER_S
        design = unit_design_bytes(stage, b, t)
        row = {
            "case": label, "C": c, "B": b, "T": t, "convs_per_unit": cpu, "main_path": main,
            "units": len(convs), "max_abs_err": err,
            "ms": time_ms(lambda: mrf_block.mrf_section(x, stage)),
            "plain_ms": time_ms(plain),
            "library_ms": time_ms(cudnn_chain),
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
            "unit_hbm_gb": design / 1e9, "unit_hbm_ms": 1e3 * design / HBM_BYTES_PER_S,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"mrf_section {label}: C={c} B={b} T={t} units {len(convs)} max_abs_err={err:.3g} "
            f"(tol {MRF_TOLERANCE}) kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"cuDNN conv chain {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}), {row['bound_share']:.1%} of bound; per-unit HBM traffic "
            f"{row['unit_hbm_gb']:.3f} GB = {row['unit_hbm_ms']:.3f} ms at 3.35 TB/s")
    return rows


def stage_voices(root: Path):
    """A voices dir: GlowTTS harvard dims, hifi_gan/universal_large and
    waveglow/wn_256 (sigma 0.9) plus waveglow/wn_256_sigma0 (the same
    weights, sigma 0), all random."""
    import dataclasses

    from larynx_tpu_torch.convert.native import save_params
    from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
    from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
    from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
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

    wg_cfg = WaveGlowConfig()
    gen = torch.Generator().manual_seed(2)
    wg = init_params(gen, wg_cfg)
    for flow in wg["flows"]:
        end_w = flow["wn"]["end_w"]
        flow["wn"]["end_w"] = (torch.randn(end_w.shape, generator=gen) * WG_END_SCALE).numpy()
    for name, sigma in (("wn_256", wg_cfg.sigma), ("wn_256_sigma0", 0.0)):
        wg_dir = root / "waveglow" / name
        wg_dir.mkdir(parents=True)
        (wg_dir / "config.json").write_text(json.dumps(dataclasses.asdict(
            dataclasses.replace(wg_cfg, sigma=sigma))))
        if sigma:
            save_params(wg_dir / "generator.npz", wg)
        else:
            (wg_dir / "generator.npz").symlink_to(root / "waveglow" / "wn_256" / "generator.npz")


def vocode_plan(engine, jobs, length_scale):
    """The rows' mel lengths, their mel bucket and the engine's own vocoder
    group plan [(start, rows, frames)] for one batch of jobs."""
    from larynx_tpu_torch.runtime.engine import MAX_VOCODE_AREA, waveglow_area

    enc, _ = engine.encode_launch([j["ids"] for j in jobs], length_scale)
    y_lengths = enc[4].cpu().numpy()[: len(jobs)]
    m = engine.policy.mel_bucket(int(y_lengths.max()))
    area = waveglow_area() if engine.vocoder_kind == "waveglow" else MAX_VOCODE_AREA
    plan = engine._ragged_group_plan(np.sort(y_lengths)[::-1], len(jobs), m, area)
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


def plan_waveglow_path(root: Path):
    """The WaveGlow path's batch (the same pangram x8), its engine and the
    (B, T) that each vocoder group call gives the WN layers."""
    import larynx_tpu_torch

    jobs = larynx_tpu_torch._build_jobs(" ".join([PANGRAM] * 8), VOICE, "waveglow",
                                        custom_voices_dir=root, no_download=True)
    engine = larynx_tpu_torch._get_engine(jobs[0]["tts_model"], jobs[0]["vocoder_model"],
                                          torch.device("cuda"))
    y_lengths, m, plan = vocode_plan(engine, jobs, LENGTH_SCALE)
    cfg = engine.vocoder_cfg
    shapes = sorted({(rows, frames * cfg.upsample_stride // cfg.groups) for _s, rows, frames in plan})
    log(f"waveglow path: y_lengths {y_lengths.tolist()}, mel bucket {m}, vocoder groups "
        f"(start, rows, frames) {plan}, WN layer shapes (B, T) {shapes}")
    return jobs, engine, y_lengths, plan, shapes


def random_wn_layer(wn_layer, gen, rs_out, ch=256, cc=640):
    """One WN layer packed on the card, with the init's scales."""
    def n(*shape, scale=0.05):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    return wn_layer.pack_wn_layer(n(2 * ch, ch, 3), n(2 * ch, scale=0.01), n(2 * ch, cc),
                                  n(2 * ch, scale=0.01), n(rs_out, ch), n(rs_out, scale=0.01))


def wn_cost(b, t, layer, first, last, rs_mode=False, ch=256, cc=640):
    """(ops seconds, bytes seconds) of one WN layer at the card's peaks: the
    products the kernel runs (3 TF32 operations per f32 FLOP) and the bytes
    it must move (each input read once, each output written once; the f32
    weights once, not the kernel's TF32 hi/lo copy of them)."""
    rs_out = layer.b_rs.numel()
    flops = 2.0 * b * t * (2 * ch * (3 * ch + cc) + ch * rs_out)
    act = b * t * ch
    if rs_mode:
        io = act + b * t * cc + b * t * rs_out
    else:
        io = act + b * t * cc + act + (0 if first else act) + (0 if last else act)
    weights = (layer.w_in.numel() + layer.w_cond.numel() + layer.w_rs.numel()
               + layer.bias_a.numel() + rs_out)
    return TF32_PER_F32 * flops / TF32_PEAK_FLOPS, 4.0 * (io + weights) / HBM_BYTES_PER_S


def check_wn(wn_layer, main_shapes):
    """Phase 2b: the WN layer kernel (K3 in every mode, K4) against its plain
    version: single layers at the main path's (B, T) and at a ragged T, and
    a whole 8-layer stack (dilations 1..128) at the main path's shape."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(3)
    b0, t0 = main_shapes[0]
    cases = [  # (label, B, T, dilation, first, last, K4 rs_out or None, on the main path)
        ("main path, first layer", b0, t0, 1, True, False, None, True),
        ("main path, middle layer", b0, t0, 8, False, False, None, True),
        ("main path, last layer", b0, t0, 128, False, True, None, True),
        ("K4 rs, main shape", b0, t0, 4, False, False, 512, False),
        ("ragged T, middle layer", 2, 1000, 128, False, False, None, False),
        ("ragged T, first and last layer", 3, 777, 32, True, True, None, False),
        ("ragged T, K4 rs 256", 2, 1000, 64, False, False, 256, False),
        ("B=1, T=64*16+1 (one-step tail), middle layer", 1, 1025, 16, False, False, None, False),
    ]
    rows = []
    for label, b, t, d, first, last, k4, main in cases:
        layer = random_wn_layer(wn_layer, gen, k4 or (256 if last else 512))
        h = torch.randn((b, t, 256), generator=gen).cuda()
        cond = torch.randn((b, t, 640), generator=gen).cuda()
        skip = None if first else torch.randn((b, t, 256), generator=gen).cuda()
        plain_args = (layer.w_in, layer.w_cond, layer.bias_a, layer.w_rs, layer.b_rs, d)

        def kernel():  # K4 returns rs, K3 (h_new, skip_new)
            if k4:
                return (wn_layer.fused_wn_layer(h, cond, layer, d),)
            return wn_layer.fused_wn_layer_state(h, cond, skip, layer, d, first, last)

        def plain():
            if k4:
                return (wn_layer.wn_layer_plain(h, cond, *plain_args),)
            return wn_layer.wn_layer_state_plain(h, cond, skip, *plain_args, first, last)

        err = max((k - p).abs().max().item() for k, p in zip(kernel(), plain()))
        torch.cuda.synchronize()
        if not err <= WN_TOLERANCE:
            raise AssertionError(f"wn_layer {label}: max abs err {err} > {WN_TOLERANCE}")
        acts = torch.rand((b, t, 256), generator=gen).cuda()
        hc = h.transpose(1, 2).contiguous()

        def library():  # the layer's products alone: cuDNN conv + two cuBLAS GEMMs
            F.conv1d(hc, layer.w_in, padding=d, dilation=d)
            F.linear(cond, layer.w_cond)
            F.linear(acts, layer.w_rs)

        ops_s, bytes_s = wn_cost(b, t, layer, first, last, rs_mode=bool(k4))
        row = {
            "case": label, "B": b, "T": t, "dilation": d, "first": first, "last": last,
            "rs_out": layer.b_rs.numel(), "mode": "K4" if k4 else "K3", "main_path": main,
            "max_abs_err": err, "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"wn_layer {label}: B={b} T={t} d={d} max_abs_err={err:.3g} (tol {WN_TOLERANCE}) "
            f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, cuDNN+cuBLAS products "
            f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
            f"{row['bound_share']:.1%} of bound")

    # a whole WN stack at each main-path shape: h and skip after 8 layers
    stacks = []
    for b, t in main_shapes:
        layers = [random_wn_layer(wn_layer, gen, 256 if i == 7 else 512) for i in range(8)]
        h0 = (torch.randn((b, t, 256), generator=gen) * 0.1).cuda()
        cond = torch.randn((b, t, 640), generator=gen).cuda()
        acts = torch.rand((b, t, 256), generator=gen).cuda()

        def stack(fn):
            h, skip = h0, None
            for i, layer in enumerate(layers):
                h, skip = fn(h, cond, skip, layer, 2**i, i == 0, i == 7)
            return h, skip

        def kernel_layer(h, cond, skip, layer, d, first, last):
            return wn_layer.fused_wn_layer_state(h, cond, skip, layer, d, first, last)

        def plain_layer(h, cond, skip, layer, d, first, last):
            return wn_layer.wn_layer_state_plain(h, cond, skip, layer.w_in, layer.w_cond,
                                                 layer.bias_a, layer.w_rs, layer.b_rs, d, first,
                                                 last)

        def library():
            hc = h0.transpose(1, 2).contiguous()
            for i, layer in enumerate(layers):
                F.conv1d(hc, layer.w_in, padding=2**i, dilation=2**i)
                F.linear(cond, layer.w_cond)
                F.linear(acts, layer.w_rs)

        (hk, sk), (hp, sp) = stack(kernel_layer), stack(plain_layer)
        err = max((hk - hp).abs().max().item(), (sk - sp).abs().max().item())
        if not err <= WN_TOLERANCE:
            raise AssertionError(f"wn_layer 8-layer stack B={b} T={t}: max abs err {err}")
        costs = [wn_cost(b, t, layer, i == 0, i == 7) for i, layer in enumerate(layers)]
        ops_s, bytes_s = sum(c[0] for c in costs), sum(c[1] for c in costs)
        row = {
            "case": "main path, 8-layer WN stack", "B": b, "T": t, "launches": 8,
            "max_abs_err": err, "ms": time_ms(lambda: stack(kernel_layer)),
            "plain_ms": time_ms(lambda: stack(plain_layer)), "library_ms": time_ms(library),
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        stacks.append(row)
        log(f"wn_layer 8-layer stack B={b} T={t} (dilations 1..128): max_abs_err={err:.3g} "
            f"(tol {WN_TOLERANCE}) kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"cuDNN+cuBLAS products {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms, "
            f"{row['bound_share']:.1%} of bound")
    return rows, stacks


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
    # one launch per resblock unit of every stage the kernel takes (C <= 128)
    cfg = engine.vocoder_cfg
    kernel_stages = sum(1 for i in range(len(cfg.upsample_rates))
                        if cfg.upsample_initial_channel // 2 ** (i + 1) <= 128)
    per_call = kernel_stages * sum(len(d) for d in cfg.resblock_dilation_sizes)
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
        if calls < 1 or n_launch != per_call * calls:
            raise AssertionError(f"{label}: {n_launch} mrf_section launches for {calls} generator "
                                 f"calls, expected {per_call} per call")
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


def probe_log_s(engine, mel_pp, z):
    """One WaveGlow call with every coupling's log_s watched: the largest
    |log_s| and whether the audio is finite."""
    from larynx_tpu_torch.models.waveglow import model as wg_model

    seen = []
    wn = wg_model._wn

    def watched(p, cfg, x0, spect_g):
        out = wn(p, cfg, x0, spect_g)
        seen.append(out[..., x0.shape[-1]:].abs().max().item())
        return out

    wg_model._wn = watched
    try:
        audio = engine._generate(mel_pp, z)
    finally:
        wg_model._wn = wn
    return max(seen), bool(torch.isfinite(audio).all())


def waveglow_path(root: Path, wn_layer, mrf_block, jobs, engine, y_lengths, plan):
    """Phase 4: text_to_speech with the WaveGlow vocoder at full width."""
    import larynx_tpu_torch
    from larynx_tpu_torch.dsp.stft import num_frames
    from larynx_tpu_torch.runtime.engine import postprocess

    text = " ".join([PANGRAM] * 8)
    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality="waveglow", custom_voices_dir=root,
                  no_download=True, tts_settings={"length_scale": LENGTH_SCALE})
    for strength in (0.0, 0.005):  # warm-up, and the denoiser's bias vocode
        list(larynx_tpu_torch.text_to_speech(text, device="cuda", denoiser_strength=strength,
                                             **kwargs))

    # the couplings' log_s on the main path's first vocoder group
    ids = [j["ids"] for j in jobs]
    n = len(ids)
    with torch.inference_mode():
        enc, _g = engine.encode_launch(ids, LENGTH_SCALE)
        y_host = enc[4].cpu().numpy()
        mel, z_mask = engine.decode_launch(enc, y_host, None, n, batch_index=0)
        _start, rows, frames = plan[0]
        mel_pp = postprocess(mel[:rows, :frames], z_mask[:rows, :frames],
                             engine.audio_settings).transpose(1, 2)
        z = engine._waveglow_prior(rows, frames, z_mask[:rows, :frames], None, 0)
        max_log_s, finite = probe_log_s(engine, mel_pp, z)
    if not finite or not max_log_s < 1.0:
        raise AssertionError(f"waveglow: finite audio {finite}, largest |log_s| {max_log_s}")
    log(f"waveglow: largest |log_s| over the 12 flows of group 0: {max_log_s:.4g} "
        f"(end_w scale {WG_END_SCALE}), audio finite")

    launches = {}
    for label, strength in (("no denoiser", 0.0), ("denoiser 0.005", 0.005)):
        wn_layer.fused_wn_layer_state.launches = 0
        wn_layer.fused_wn_layer.launches = 0
        mrf_block.mrf_section.launches = 0
        calls_before = engine.generator_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        results = list(larynx_tpu_torch.text_to_speech(text, device="cuda",
                                                       denoiser_strength=strength, **kwargs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        n_k3 = wn_layer.fused_wn_layer_state.launches
        calls = engine.generator_calls - calls_before

        if len(results) != 8:
            raise AssertionError(f"waveglow {label}: {len(results)} results, expected 8")
        for res, y in zip(results, y_lengths):
            n_samples = int(y) * 256
            if strength > 0:
                n_samples = num_frames(n_samples, 1024, 256) * 256 + 1024
            audio = res.audio
            if audio.dtype != np.int16 or audio.shape != (n_samples,):
                raise AssertionError(f"waveglow {label}: audio {audio.dtype} {audio.shape}, "
                                     f"expected ({n_samples},)")
            if np.abs(audio.astype(np.int32)).max() < 1000 or audio.astype(np.float64).std() < 10:
                raise AssertionError(f"waveglow {label}: silent audio")
        if calls != len(plan) or n_k3 != 96 * calls:
            raise AssertionError(f"waveglow {label}: {n_k3} wn_layer launches for {calls} "
                                 f"vocoder calls (plan {plan})")
        if wn_layer.fused_wn_layer.launches or mrf_block.mrf_section.launches:
            raise AssertionError(f"waveglow {label}: K4 or MRF launched on the WaveGlow path")
        audio_s = sum(r.audio.shape[0] for r in results) / 22050
        launches[label] = n_k3
        log(f"waveglow path, {label}: wall {wall:.4f} s, audio {audio_s:.2f} s, "
            f"RTF {wall / audio_s:.6f}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, vocoder calls {calls}, "
            f"wn_layer launches {n_k3}")

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(3):
            out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - start) / 3

    (enc, _g), t_enc = timed(lambda: engine.encode_launch(ids, LENGTH_SCALE))
    (mel, z_mask), t_dec = timed(lambda: engine.decode_launch(enc, y_host, None, n, batch_index=0))
    _, t_voc = timed(lambda: engine.vocode_collect(
        engine.vocode_launch(mel, z_mask, n, 0.0, y_lengths=y_host), mel.shape[0]))
    _, t_voc_dn = timed(lambda: engine.vocode_collect(
        engine.vocode_launch(mel, z_mask, n, 0.005, y_lengths=y_host), mel.shape[0]))
    _, t_gen = timed(lambda: engine._generate(mel_pp, z))
    log(f"waveglow stage times (ms, B={n}, mel bucket {mel.shape[1]}): encode {t_enc:.3f}, "
        f"flow decode {t_dec:.3f}, vocode with the WN stacks (+int16+copy, {len(plan)} group "
        f"calls) {t_voc:.3f}, of which one group's WaveGlow infer {t_gen:.3f}, "
        f"vocode with denoiser {t_voc_dn:.3f}")

    # the ragged batch on CUDA and CPU, with GlowTTS noise 0 and a zero
    # prior (the sigma-0 copy of the vocoder): both devices see one latent
    ragged = " ".join(RAGGED)
    voc = "waveglow/wn_256_sigma0"
    rjobs = larynx_tpu_torch._build_jobs(ragged, VOICE, voc, custom_voices_dir=root,
                                         no_download=True)
    r_engine = larynx_tpu_torch._get_engine(rjobs[0]["tts_model"], rjobs[0]["vocoder_model"],
                                            torch.device("cuda"))
    r_lengths, r_m, r_plan = vocode_plan(r_engine, rjobs, 1.0)
    if len(r_plan) < 2:
        raise AssertionError(f"waveglow ragged batch: vocoder plan {r_plan}, expected >= 2 groups")
    short = dict(kwargs, vocoder_or_quality=voc, tts_settings={"noise_scale": 0.0}, max_batch=16)
    gpu = [r.audio for r in larynx_tpu_torch.text_to_speech(ragged, device="cuda", **short)]
    start = time.perf_counter()
    cpu = [r.audio for r in larynx_tpu_torch.text_to_speech(ragged, device="cpu", **short)]
    t_cpu = time.perf_counter() - start
    worst = 0
    for i, (a, b, y) in enumerate(zip(gpu, cpu, r_lengths)):
        if a.shape != b.shape or a.shape != (int(y) * 256,):
            raise AssertionError(f"waveglow ragged row {i}: shapes {a.shape}/{b.shape}, y {y}")
        if np.abs(a.astype(np.int32)).max() < 1000:
            raise AssertionError(f"waveglow ragged row {i}: silent audio")
        worst = max(worst, int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()))
    if len(gpu) != len(RAGGED) or len(cpu) != len(RAGGED) or worst > AUDIO_TOLERANCE_LSB:
        raise AssertionError(f"waveglow CUDA vs CPU path: {len(gpu)}/{len(cpu)} rows, "
                             f"max diff {worst} LSB")
    log(f"waveglow CUDA vs CPU path, ragged batch of {len(RAGGED)} (sigma 0, noise 0): "
        f"y_lengths {r_lengths.tolist()}, mel bucket {r_m}, vocoder groups {r_plan}, "
        f"max diff {worst} LSB (tol {AUDIO_TOLERANCE_LSB}), CPU side {t_cpu:.1f} s")
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

    from larynx_tpu_torch.ops import build, mrf_block, wn_layer

    start = time.perf_counter()
    build.build(["mrf_section", "wn_layer"])
    for name in ("mrf_section", "wn_layer"):
        lines = build.BUILD_LOGS.get(name, "").splitlines()
        ptxas = sorted({line.split(":", 1)[-1].split(" for the function")[0].strip()
                        for line in lines
                        if "registers" in line or "spill" in line or "Performance Loss" in line})
        log(f"built {name} in {time.perf_counter() - start:.1f} s; ptxas: "
            + ("; ".join(ptxas) or "already built"))
        if any("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
               for line in lines):
            raise AssertionError(f"{name}: the kernel spills registers")
        if any("C7510" in line or "C7512" in line for line in lines):
            raise AssertionError(f"{name}: ptxas serialized the wgmma pipeline (C75xx)")
    log(f"wn_layer: dynamic shared memory {wn_layer._library().wn_layer_smem_bytes()} bytes "
        "per block, 384 threads, clusters of 2 blocks")
    mrf_lib = mrf_block._library()
    for c, k, d in ((128, 3, 1), (128, 7, 3), (128, 11, 5), (128, 7, 12), (64, 11, 5), (32, 11, 5)):
        rows = mrf_block.unit_rows(k, d)
        got = (mrf_lib.mrf_unit_smem_bytes(c, rows), mrf_lib.mrf_unit_b_stages(c, rows))
        if got != (mrf_block.unit_smem_bytes(c, rows), mrf_block.unit_b_stages(c, rows)):
            raise AssertionError(f"mrf_section (C={c}, k={k}, d={d}): kernel smem and ring {got}, "
                                 "ops/mrf_block.py mirrors another")
        log(f"mrf_section: unit (k={k}, d={d}) at C={c}: {rows} input rows, dynamic shared memory "
            f"{got[0]} bytes per block, {got[1]}-stage weight ring, 384 threads, stride "
            f"{mrf_block.unit_stride(k, 2)} rows")

    # plain references and the main path run in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with tempfile.TemporaryDirectory() as tmp:
        stage_voices(Path(tmp))
        jobs, engine, y_lengths, main_cases = plan_main_path(Path(tmp))
        wg_jobs, wg_engine, wg_y, wg_plan, wg_shapes = plan_waveglow_path(Path(tmp))
        rows = check_mrf(mrf_block, main_cases)
        wn_rows, wn_stacks = check_wn(wn_layer, wg_shapes)
        launches = main_path(Path(tmp), mrf_block, jobs, engine, y_lengths)
        wn_launches = waveglow_path(Path(tmp), wn_layer, mrf_block, wg_jobs, wg_engine, wg_y,
                                    wg_plan)

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
    log(f"mrf_section, main path's {len(main_rows)} sections: kernel {kernels[0]['ms']:.3f} ms, "
        f"bound {kernels[0]['bound_ms']:.3f} ms ({kernels[0]['bound_ms'] / kernels[0]['ms']:.1%}), "
        f"cuDNN conv chains {kernels[0]['library_ms']:.3f} ms")
    # the WaveGlow path's vocoder calls without the denoiser: per group, 12
    # flows of one 8-layer WN stack, each stack timed whole at the group's shape
    stack_of = {(r["B"], r["T"]): r for r in wn_stacks}
    cfg = wg_engine.vocoder_cfg
    group_stacks = [stack_of[(rows_g, frames * cfg.upsample_stride // cfg.groups)]
                    for _s, rows_g, frames in wg_plan]
    kernels.append({
        "name": "wn_layer",
        "route": "cuda",
        "source": "larynx_tpu_torch/csrc/wn_layer.cu",
        "replaces": "larynx_tpu/ops/wn_layer.py:258; larynx_tpu/ops/wn_layer.py:332",
        "launches": wn_launches,
        "max_abs_err": max(r["max_abs_err"] for r in wn_rows + wn_stacks),
        "ms": sum(cfg.flows * r["ms"] for r in group_stacks),
        "plain_ms": sum(cfg.flows * r["plain_ms"] for r in group_stacks),
        "bound_ms": sum(cfg.flows * r["bound_ms"] for r in group_stacks),
        "bound_by": "operations",
        "library_ms": sum(cfg.flows * r["library_ms"] for r in group_stacks),
        "cases": wn_rows + wn_stacks,
    })
    if any(r["bound_by"] != "operations" for r in wn_rows + wn_stacks):
        raise AssertionError("expected the WN layer to be bound by operations")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
