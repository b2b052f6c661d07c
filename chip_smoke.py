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
     of the bound; the bf16 MRF kernel (csrc/mrf_bf16.cu, one launch per
     section at C <= 64, per unit at C = 128) at the main path's sections,
     the stream's one-row windows, ragged T with an odd tile count, T under
     one tile, ResBlock2 and C=8, each row with the HBM bytes and the L2
     weight bytes that its plan moves; the flow WN kernel (csrc/flow_wn.cu,
     GlowTTS's coupling WaveNet layers) at B=8 over ul_batch8's mel buckets
     (rows ending mid-tile, wholly padded tile pairs), B=1, a speaker bias
     and dilation 2, one launch a layer, each 4-layer stack timed against
     its bound, the plain version and the torch route, and its counters
     equal across graphed ``synthesize_batch`` calls.
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
  5. streaming: ``stream_text_to_speech`` on the pangram, with and without
     the denoiser: time to first audio, time and MRF launches per chunk,
     and the chunks against a one-window run, the CPU path's stream and the
     batch path.
  6. the batch scheduler: 24 threads each send one sentence at length
     scale 6 through ``text_to_speech(..., scheduler=...)`` with its own
     seed; several batches, fewer than sentences, each row against the
     same request alone, eight rows at noise 0 against the CPU path's
     scheduler, and the per-row noise's prefix invariance on the card.
  7. the CLI: WAV on stdout and ``--stream`` PCM, in process (launches
     counted) and as ``python -m larynx_tpu_torch`` in a subprocess,
     against the float32 library calls.
  8. the MRF kernel against its plain version at every shape that the
     scheduler's batches and the CLI gave it and phase 2 did not check.
  9. the bfloat16 paths: ``text_to_speech`` at the CUDA default (bf16
     vocoder) with HiFi-GAN and with WaveGlow, ``half=True``,
     ``stream_text_to_speech`` at the default and with ``half=True``, and the
     CLI with ``--half`` in process; each with its launch counts (11 MRF
     launches a universal_large call: 9 unit launches at C=128, one for
     each section at C=64 and C=32) and
     against its float32 run of the same rows at noise 0 (correlation >
     0.999, RMS level within 1% of full scale), and a small batch on CUDA
     in bf16 against the CPU path in bf16 by the same bar.
 10. the bf16 MRF kernel at every shape phase 9 gave it that phase 2's bf16
     rows did not check.
 11. the HTTP server: ``larynx_tpu_torch.server.create_app`` behind aiohttp's
     AppRunner on 127.0.0.1 with ``device="cuda"``, in float32: ``/api/tts``
     (GET, POST) and MaryTTS ``/process`` against ``text_to_speech`` and
     ``/api/stream`` against ``stream_text_to_speech`` (0 LSB, time to first
     body byte), ``/api/stream?vocoder=waveglow`` through the unfused
     fallback against ``WaveGlowVocoder.mels_to_audio`` (0 LSB),
     ``vocoder=waveglow`` and ``vocoder=griffin_lim`` (spectral
     convergence), eight concurrent requests in fewer batches
     (``/api/stats``), the other routes, each path's kernel launches;
     ``HiFiGanVocoder`` / ``WaveGlowVocoder.mels_to_audio`` (bucketed and
     chunked) against the engine; Griffin-Lim CUDA against CPU at one
     injected phase; ``/api/tts`` per-request wall against the library at
     the CUDA default too; the CLI's ``--daemon --device cuda`` and
     ``--stop-daemon`` as subprocesses; then both kernels against their
     plain versions at every shape the phase gave them.  A library call
     that a route is compared with bit for bit decodes at the exact mel
     bucket, as the server's scheduler does (``exact_mel_buckets``).
 12. the pipelined batch path and multi-speaker GlowTTS, in float32:
     bench.py's chapter (16 pangrams, two units of one voice) cold and warm,
     with the mel-bucket estimator's state, the host wall against the same
     units run one by one, and the card's busy time (torch.profiler);
     bench.py's three-voice SSML document interleaved and consecutive, each
     one pooled HiFi-GAN vocode (27 MRF launches), and per unit with
     ``LARYNX_TPU_VOCODE_POOL=0``; the document through a pooled WaveGlow;
     every sentence within 1 LSB of the unit-by-unit run and in document
     order; a multi-speaker voice (8 speakers) through the engine: a batch
     of 8 speakers against the CPU path, the stream, the per-model
     ``phonemes_to_mels`` and the missing speaker id's ValueError; then both
     kernels at every shape the phase gave them.
 13. Tacotron2 and checkpoint import, in float32: a Tacotron2 voice at
     NVIDIA's hparams (random weights, the gate held off so that every decode
     runs its 1000 steps) through ``text_to_speech`` with HiFi-GAN
     universal_large (27 MRF launches) and WaveGlow (96 WN launches) and
     ``/api/tts``, through the engine's autoregressive batch path (one vocoder
     group call a sentence), and the stream through the unfused fallback (one
     chunk, the same audio); the engine's blocked decode alone, its time,
     stop reads and kernel launches per step and the card's busy share over it; the
     CUDA path against the CPU path under the same prenet keep masks (one
     ``_decoder_step`` from identical states, the whole decode's mel per 100
     steps, the audio by correlation); the same Tacotron2 and universal_large
     weights as NVIDIA/HiFi-GAN-named ``generator.pth`` files, loaded with
     ``backend="pytorch"``: equal trees, 0 LSB from the ``.npz`` voice; the
     decoder step kernel (``csrc/tacotron2_step.cu``) against its plain
     version at t2wg_batch8's shapes (B=8, text buckets 64-192) and at B=1,
     bit for bit against itself and a batch row alone, its time a step
     against the step's bound, the plain version and the cuBLAS step as a
     CUDA graph, and its launches a block; then both other kernels at every
     shape the phase gave them.
 14. training, in float32: ``python -m larynx_tpu_torch.train`` (``main``) at
     the harvard dimensions on 96 wavs that the port's ``text_to_speech``
     writes (batch 32, ids padded to 192, mels to 1024 x 80, ``--ddi``, 3
     steps) and ``train_vocoder`` at ``--quality high`` (batch 16, 8192-sample
     segments, 5 steps), with finite losses, peak memory and step times split
     into MAS, forward, backward and optimizer and into generator, D and G;
     one step's losses and gradients on CUDA against the CPU path (GlowTTS
     B=4 at the card's MAS path, which the CPU's search reproduces on the
     card's inputs; HiFi-GAN B=2); the written voice and vocoder dirs through
     ``text_to_speech`` (27 MRF launches) and the saved voice's
     reverse(forward(mel)); then the MRF kernel at the shapes it gave.
 15. training, part 2, in float32 on phase 14's corpus: ``train_vocoder
     --family waveglow`` at wn_256 (batch 16, 8192-sample segments, 5 steps)
     and ``train --family tacotron2`` at NVIDIA's hparams (batch 32, ids 192,
     mels 1024 x 80, 3 steps), with finite host-float histories, peak memory
     and step times split into forward, backward and Adam (WaveGlow) and into
     masks, encode, teacher decode, postnet + loss, backward and optimizer
     (Tacotron2, with the teacher decode's launches per step and the card's
     busy share); one step's losses and gradients on CUDA against the CPU
     path in float64 (WaveGlow B=1 x 8 frames with perturbed end convs;
     Tacotron2 B=2, 32 ids, 64 frames, injected masks); the BatchNorm running
     statistics moved; the written dirs through ``text_to_speech`` (96 WN
     launches per group call, 27 MRF per sentence); then both kernels at the
     shapes they gave.
 16. the multi-device layer.  ``serving_mesh()`` is None on one card.  A
     ``ServingMesh`` of four positions on cuda:0 (and, on a machine with
     more cards, ``serving_mesh()``'s mesh of distinct cards) against the
     single-device engine, HiFi-GAN universal_large in bf16 (the CUDA
     default) and float32: the row shard (pangram x8), the time shard (one
     pangram, 1024-frame bucket) and the rows x time grid (three pangrams),
     each plain and denoised where the JAX engine's bounds name it, with the
     route counters and 27 (f32) or 11 (bf16) MRF launches per position;
     the stream on the first position (the single device's bytes); ``make_sharded_synthesis``
     at noise 0 against the engine's batch path; WaveGlow wn_256's grid (96
     WN launches per window); the latency model's predicted speed-up on N
     cards.  Training: (a) ``python -m torch.distributed.run
     --nproc-per-node 1 -m larynx_tpu_torch.train`` (an NCCL group of one)
     against the same run without torchrun, bit for bit where two runs
     without a group are; (b) two ranks on cuda:0 over gloo, the GlowTTS
     step data parallel 2 and model parallel 2, HiFi-GAN's and Tacotron2's
     data parallel 2 (running statistics too), against world 1 on the card
     at the full widths and batches of phases 14-15, with step times; then
     both kernels at every shape the mesh's positions and windows gave them.
Phases 2-8 and 11-15 run in float32 (``LARYNX_TPU_VOCODER_PRECISION=f32``: the
CUDA default is a bf16 vocoder); phase 2 also holds the bf16 instantiations
against their plain bf16 versions (<= 2 bf16 ULPs of the output's scale).
The MRF rows of phase 2 include the stream path's chunk windows (B=1).
The last two lines are the kernels JSON and the device JSON.  Needs one
CUDA device and nvcc; imports nothing of JAX.
"""

import contextlib
import json
import os
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
BF16_PEAK_FLOPS = 989e12  # dense bf16 tensor cores: one operation per bf16 FLOP
HBM_BYTES_PER_S = 3.35e12
PRECISION_ENV = "LARYNX_TPU_VOCODER_PRECISION"

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
# more Harvard sentences, shorter, for the scheduler's pool
SHORT_SENTENCES = (
    "Smoky fires lack flame and heat.",
    "The boy was there when the sun rose.",
    "Help the woman get back to her feet.",
    "The soft cushion broke the man's fall.",
    "Kick the ball straight and follow through.",
    "The small pup gnawed a hole in the sock.",
    "Glue the sheet to the dark blue background.",
    "The salt breeze came across from the sea.",
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
# bf16 kernels against their plain bf16 versions (which round at the same
# points, on float32 copies): both sum exact bf16 products in f32 in other
# orders, so a value at a rounding boundary lands one bf16 ULP apart and
# carries into the chained convs of a section; at most 2 ULPs of the
# output's scale, 2^(floor(log2 max|ref|) - 7), per launch.  The 8-layer WN
# stack carries such flips through h and skip for 8 layers: 4 ULPs.
BF16_ULPS = 2
BF16_STACK_ULPS = 4
# T of the WaveGlow stacks at B=1 that the server, the fallback stream, the
# trained voice and the mesh grid give the WN kernel (PERF.md section 6),
# held in bf16 too, where the CUDA default runs them
WN_B1_T = (2816, 8192, 12288, 14592, 16384, 24576, 32768)
# (B, T) at which the bf16 WN kernel's launch plan is held against its
# mirror: the main path, the B=1 stacks, ragged T with 13 and 39 tiles,
# T under one tile
WN_PLAN_SHAPES = ((4, 32768),) + tuple((1, t) for t in WN_B1_T) + (
    (1, 64 * 13 - 5), (3, 777), (2, 40))
# bf16 paths against their float32 runs, and CUDA bf16 against CPU bf16: an
# LSB bound does not hold in bf16, so the JAX package's bar for its bf16
# vocoder (tests/test_mixed_precision.py): correlation and RMS level.
BF16_CORRELATION = 0.999
BF16_LEVEL = 0.01 * 32767
# half=True against float32 at the float32 durations: bf16 GlowTTS moves the
# mel itself.  The JAX package's own half run sits at 0.9988 against its f32
# run on the small test voice (tests/test_torch_mixed_precision.py), under
# the vocoder's 0.999, and full depth (6 encoder layers, 12 flow blocks)
# drifts further; a wrong rounding point or dtype decorrelates far more.
BF16_HALF_CORRELATION = 0.99
# Coupling end-conv scale of the staged WaveGlow: the init's end_w = 0
# makes every coupling the identity, so the audio would not depend on the
# WN stacks.  At 0.001 the skip sums (O(1.6) per channel over 256 channels)
# give log_s of O(0.04): exp(-log_s) over 12 flows stays finite.
WG_END_SCALE = 0.001
# CUDA path against the port's CPU path, int16 audio: sums in other orders
# move the float audio by ~1e-6, i.e. under one step of 32767.
AUDIO_TOLERANCE_LSB = 2
# Chunked stream against its one-window run (the JAX package's bound): the
# halo makes each chunk's samples the one-window run's, up to the summation
# order of a shorter conv, so a few samples may round to the next step.
STREAM_WINDOW_LSB = 1
STREAM_WINDOW_SHARE = 1e-3
STREAM_SEED = 5
CHUNK_FRAMES = 64
# concurrent requests in the scheduler phase: three batches of max_batch 8
SCHEDULER_REQUESTS = 24
# Griffin-Lim through the server: its spectral convergence against the
# target magnitudes, as a share of a random phase's
GL_PROGRESS = 0.85
# Phase 12: bench.py's multilingual SSML document and its chapter, on three
# GlowTTS voices at the harvard dimensions (bench.py's 64-symbol superset of
# the inventories) with their own random weights, sharing universal_large
SSML = """<speak>
  <voice name="en-us_bench_en-glow_tts">The beige hue on the waters of
  the loch impressed all. Just as young Arthur wanted.</voice>
  <break time="300ms"/>
  <voice name="de-de_bench_de-glow_tts"><s lang="de">Falsches Üben von
  Xylophonmusik quält jeden größeren Zwerg.</s></voice>
  <voice name="sw_bench_sw-glow_tts"><s lang="sw">Gari langu
  linaloangama limejaa na mikunga.</s></voice>
  <voice name="en-us_bench_en-glow_tts">Before she heard that symphony
  again. Including the French queen.</voice>
</speak>"""
BOOK = " ".join([PANGRAM] * 16)
BENCH_EN = "en-us_bench_en-glow_tts"
BENCH_VOICES = {BENCH_EN: 10, "de-de_bench_de-glow_tts": 11, "sw_bench_sw-glow_tts": 12}
BENCH_SYMBOLS = 64
# The repo names no released multi-speaker voice: this phase's choice, the
# harvard dimensions with 8 speakers and a 256-wide speaker embedding
MULTI_VOICE = "en-us_bench_multi-glow_tts"
MULTI_SPEAKERS = 8
MULTI_GIN = 256
# A row vocoded in a pooled launch against the same row in its own unit's
# launch (the JAX package's bound, tests/test_pipeline.py): only the padded
# width it is computed at changes
POOL_LSB = 1
# Phase 13: a Tacotron2 voice at NVIDIA's hparams (Tacotron2Config's defaults),
# random weights from this seed, the harvard voice's phonemes
T2_VOICE = "en-us_harvard-tacotron2"
T2_SEED = 20
# With random weights the gate's logit sits near 0, so where it first
# crosses the threshold is left to chance; at bias -50 no row stops and every
# decode runs all its steps (the pangram's 151 ids: text bucket 192, 1000)
T2_GATE_BIAS = -50.0
# _decoder_step, CUDA against the CPU path from identical states and inputs,
# TF32 off: the products sum up to 1536 float32 terms in other orders
# (~1e-7 relative on values of O(1)), and the softmax over 192 positions
# and the cell's nonlinearities keep that scale; 1e-5 catches any gate
# order, mask or layout fault, which is O(0.1)
T2_STEP_TOLERANCE = 1e-5
# The whole 1000-step decode's mel, CUDA against CPU, under the same keep
# masks: measured on the H100 (PERF.md, PR 9), the largest error per 100
# steps stays at 2.0e-8 to 2.2e-8 from the first block to the last, on mels
# of |0.062|: the random LSTMs contract, so the error does not grow.  1e-6
# is 45 times that; a mask, gate or layout fault moves the mel by O(1e-2).
T2_DECODE_TOLERANCE = 1e-6
# The audio of those mels (the CUDA text_to_speech against the CPU mel
# vocoded on the CPU): measured 1 - 1.5e-9, 1 LSB.
T2_AUDIO_CORRELATION = 0.9999
# The decoder step kernel (csrc/tacotron2_step.cu) against its plain version
# (ops/tacotron2_step.py::decode_steps_plain, cuBLAS in float32, TF32 off)
# over a block of 32 steps at the benchmark's voice (NVIDIA's widths, the mel
# projection x30 with a bias of -3.5 to -7.5: mels over a voice's range), on
# t2wg_batch8's shapes (B 8, the text buckets 64-192) and at B=1: the two
# sum up to 2560 products in other orders and feed each frame back through
# the prenet; the largest error relative to each output's scale, the bound
# of tests/test_torch_tacotron2_step.py::CARD_TOL
T2_KERNEL_SHAPES = ((8, 64), (8, 96), (8, 128), (8, 192), (1, 96), (1, 192))
T2_KERNEL_STEPS = 32
T2_KERNEL_TOLERANCE = 2e-4


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


def timed(fn):
    """(the last result, host-clocked ms per call) of fn run 3 times
    between synchronisations."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(3):
        out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - start) / 3


def ulps_of_scale(out, ref) -> float:
    """max |out - ref| in bf16 ULPs of ref's scale, 2^(floor(log2 max|ref|) - 7)."""
    ref = ref.float()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    return (out.float() - ref).abs().max().item() / ulp


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


def design_bytes(mrf_block, stage, b, t):
    """(HBM bytes, L2 weight bytes) that the kernel's plan moves for one
    section: the floors besides its operations.  Section plan (bf16, C <=
    64): x read once and the output written once (the later chains' re-reads
    of x come from L2), the weights once; each tile streams every weight
    stage of the section from L2.  Unit plan (float32; bf16 at C = 128): each
    unit reads its input and writes its output once (a chain's last unit
    after the first chain also reads out; in bf16 the chains' sum is f32 and
    the last chain writes bf16), plus the weight stages once (the residual
    re-read and the tiles' halos come from L2); each block streams its unit's
    weight stages from L2."""
    e = stage.w_flat.element_size()
    c = stage.b_flat.shape[-1]
    cpu = stage.convs_per_unit
    a = float(b * t * c)
    weights = e * (stage.wpack.numel() + stage.b_flat.numel())
    if e == 2 and mrf_block.bf16_plan(c) == "section":
        r, _s, _p = mrf_block.bf16_tile(c, stage.kernel_sizes, stage.dilations_per_block, cpu)
        return 2 * e * a + weights, b * -(-t // r) * e * stage.wpack.numel()
    n_chains = len(stage.kernel_sizes)
    io = l2 = 0.0
    for r, _u, k, d, _w, _b, _src, _dst, mode, _s in mrf_block.unit_launches(stage):
        io += e * a  # the unit's input
        if mode == mrf_block.MODE_TO_SCRATCH:
            io += e * a
        elif e == 4:
            io += 4 * a + (4 * a if mode == mrf_block.MODE_OUT_ADD else 0)
        else:
            io += ((4 * a if mode == mrf_block.MODE_OUT_ADD else 0)
                   + (e * a if r == n_chains - 1 else 4 * a))
        stride = (mrf_block.bf16_tile(c, (k,), ((d,),), cpu)[0] if e == 2
                  else mrf_block.unit_stride(k, cpu))
        unit_weights = e * (2 if e == 4 else 1) * cpu * k * max(c, 32 // e) * c  # TF32 hi, lo
        l2 += b * -(-t // stride) * unit_weights
    return io + weights, l2


def stream_cases(engine):
    """The (label, C, geometry, B, T, False) each stream chunk gives
    mrf_section: one row, a window of CHUNK_FRAMES + 2 * halo frames (the
    denoiser widens the halo by fft // hop + 1), at stages 2-4."""
    from larynx_tpu_torch.runtime.engine import stream_halo_frames

    cfg, settings = engine.vocoder_cfg, engine.audio_settings
    halo = stream_halo_frames(cfg)
    stft_frames = settings.filter_length // settings.hop_length + 1
    cases = []
    for label, h in (("stream chunk", halo), ("stream chunk, denoiser", halo + stft_frames)):
        window = CHUNK_FRAMES + 2 * h
        t = window
        for i, rate in enumerate(cfg.upsample_rates):
            t *= rate
            c = cfg.upsample_initial_channel // 2 ** (i + 1)
            if c <= 128:
                cases.append((f"{label} ({window} frames), stage {i + 1}", c, R1, 1, t, False))
    return cases


def phase2_mrf_cases(main_cases, stream):
    """Phase 2's mrf_section cases: the main path's shapes and the stream
    path's chunk windows, then a 512-frame mel, ResBlock2 and a ragged T;
    and single universal_large units at C=128: each unit kind at the main
    path's shape, a ragged T with an odd tile count and a T under one
    stride."""
    cases = list(main_cases) + list(stream) + [  # (label, C, geometry, B, T, on the main path)
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
    return cases, units


def check_mrf(mrf_block, cases, units=(), dtype=torch.float32):
    """mrf_section against mrf_section_plain at each case's (C, geometry, B,
    T), and single units (one-unit stages, one launch each) against
    mrf_unit_plain at C=128; a row of times and bound for each.  In bf16
    the weights and x are bf16, the plain version rounds where the kernel
    does, the yardstick is a chain of cuDNN bf16 convs and the bound counts
    one operation per FLOP at the bf16 peak and 2-byte elements."""
    from larynx_tpu_torch.weights import cast, tree_to

    bf16 = dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    rows = []
    for label, c, (ks, dils, cpu), b, t, main in cases + [
            (label, 128, ((k,), ((d,),), 2), b, t, False) for label, k, d, b, t in units]:
        stage = mrf_block.pack_mrf_stage(
            cast(tree_to(random_stage(gen, c, ks, dils, cpu), "cuda"), dtype), ks, dils, cpu)
        w, bias = stage.w_flat, stage.b_flat
        x = torch.randn((b, t, c), generator=gen).cuda().to(dtype)
        before = mrf_block.mrf_section.launches
        out = mrf_block.mrf_section(x, stage)
        torch.cuda.synchronize()
        launches = mrf_block.mrf_section.launches - before
        convs = list(mrf_block._unpacked_convs(w, bias, c, ks, dils, cpu))
        if len(convs) == 1:  # a single unit: its own plain version
            def plain():
                return mrf_block.mrf_unit_plain(x, convs[0][2])
        else:
            def plain():
                return mrf_block.mrf_section_plain(x, w, bias, ks, dils, cpu)
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        ulps = ulps_of_scale(out, ref) if bf16 else None
        if (bf16 and not ulps <= BF16_ULPS) or (not bf16 and not err <= MRF_TOLERANCE):
            raise AssertionError(f"mrf_section {dtype} {label}: max abs err {err}, "
                                 f"{ulps} bf16 ULPs of scale")
        xc = x.transpose(1, 2).contiguous()

        def cudnn_chain():  # the convs alone, one cuDNN call each
            for _r, _u, unit in convs:
                for cw, cb, d in unit:
                    torch.nn.functional.conv1d(xc, cw, cb, padding=(cw.shape[-1] - 1) // 2 * d,
                                               dilation=d)

        taps = cpu * sum(k * len(d) for k, d in zip(ks, dils))
        flops = 2.0 * b * t * c * c * taps
        ops_s = flops / BF16_PEAK_FLOPS if bf16 else TF32_PER_F32 * flops / TF32_PEAK_FLOPS
        e = x.element_size()
        bytes_s = e * (2 * b * t * c + stage.wpack.numel() + bias.numel()) / HBM_BYTES_PER_S
        design, l2_weights = design_bytes(mrf_block, stage, b, t)
        row = {
            "case": label, "dtype": str(dtype).replace("torch.", ""), "C": c, "B": b, "T": t,
            "convs_per_unit": cpu, "main_path": main, "stream_path": label.startswith("stream"),
            "units": len(convs), "max_abs_err": err, "bf16_ulps_of_scale": ulps,
            "ms": time_ms(lambda: mrf_block.mrf_section(x, stage)),
            "plain_ms": time_ms(plain),
            "library_ms": time_ms(cudnn_chain),
            "ops_ms": 1e3 * ops_s, "bytes_ms": 1e3 * bytes_s,
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
            "launches": launches,
            "design_hbm_gb": design / 1e9, "design_hbm_ms": 1e3 * design / HBM_BYTES_PER_S,
            "l2_weight_gb": l2_weights / 1e9,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        tol = f"{ulps:.3g} bf16 ULPs of scale (tol {BF16_ULPS})" if bf16 else f"(tol {MRF_TOLERANCE})"
        log(f"mrf_section {row['dtype']} {label}: C={c} B={b} T={t} units {len(convs)} "
            f"max_abs_err={err:.3g} {tol} kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"cuDNN conv chain {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}), {row['bound_share']:.1%} of bound; {launches} launch(es); the "
            f"design's HBM traffic {row['design_hbm_gb']:.3f} GB = {row['design_hbm_ms']:.3f} ms "
            f"at 3.35 TB/s, weight stages from L2 {row['l2_weight_gb']:.3f} GB")
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


def stage_bench_voices(root: Path):
    """Phase 12's voices beside stage_voices' ones: bench.py's three GlowTTS
    voices (seeds 10, 11, 12) and the multi-speaker voice (seed 13), each
    with a phoneme table that covers every symbol the port's frontend gives
    its sentences of SSML and BOOK; returns the tables' sizes."""
    import unicodedata

    from larynx_tpu_torch.convert.native import save_params
    from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
    from larynx_tpu_torch.text import ids as text_ids
    from larynx_tpu_torch.text.frontend import sentences
    from larynx_tpu_torch.weights import init_params

    symbols = {voice: set() for voice in BENCH_VOICES}
    for text, ssml in ((SSML, True), (BOOK, False)):
        for sentence in sentences(text, lang="en-us", ssml=ssml, explicit_lang=False):
            for word in sentence:
                for p in word.phonemes or []:
                    p = unicodedata.normalize("NFC", p)
                    p = text_ids.SIMPLE_PUNCTUATION.get(p, p)
                    symbols[sentence.voice or BENCH_EN].update(
                        text_ids._split_separate(p, text_ids.DEFAULT_SEPARATE))
    sizes = {}
    voices = dict(BENCH_VOICES, **{MULTI_VOICE: 13})
    for voice, seed in voices.items():
        base = PHONEMES if voice.startswith("en-us") else ["_", "|", "‖", "#"]
        table = base + sorted(symbols.get(voice, set()) - set(base))
        multi = voice == MULTI_VOICE
        cfg = GlowTTSConfig(num_symbols=len(PHONEMES), n_speakers=MULTI_SPEAKERS,
                            gin_channels=MULTI_GIN) if multi else GlowTTSConfig(
                                num_symbols=BENCH_SYMBOLS)
        if len(table) > cfg.num_symbols:
            raise AssertionError(f"{voice}: {len(table)} symbols, more than {cfg.num_symbols}")
        lang, rest = voice.split("_", 1)
        path = root / lang / rest
        path.mkdir(parents=True)
        model = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
        (path / "config.json").write_text(json.dumps({"audio": AUDIO, "model": model}))
        (path / "phonemes.txt").write_text("".join(f"{i} {p}\n" for i, p in enumerate(table)))
        save_params(path / "generator.npz", init_params(torch.Generator().manual_seed(seed), cfg))
        sizes[voice] = len(table)
    return sizes


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


def check_wn_bf16_plan(wn_layer):
    """The bf16 WN kernel's launch plan as the kernel computes it on this
    card against ops/wn_layer.py::bf16_launch_plan, at WN_PLAN_SHAPES."""
    fit = wn_layer.bf16_active_clusters()
    for b, t in WN_PLAN_SHAPES:
        for rs_out in (512, 256):
            got = wn_layer.bf16_geometry(b, t, 640, rs_out)
            p = wn_layer.bf16_launch_plan(b, t, 640, rs_out, fit)
            want = [p["grid"], p["cluster"], fit, p["tiles_per_block"], p["stage_bytes"],
                    p["stages_per_tile"], p["ring_stages"], p["smem_bytes"]]
            if got != want:
                raise AssertionError(f"wn_bf16 plan at B={b} T={t} rs {rs_out}: kernel {got}, "
                                     f"ops/wn_layer.py mirrors {want}")
        log(f"wn_bf16 plan, B={b} T={t}: {p['tiles']} tiles in {p['items']} items of "
            f"{p['cluster']}, grid {p['grid']} blocks ({p['clusters']} clusters), at most "
            f"{p['tiles_per_block']} tiles a block, {p['ring_stages']} weight stages of "
            f"{p['stage_bytes']} bytes in flight, {p['stages_per_tile']} a tile (rs 256), dynamic "
            f"shared memory {p['smem_bytes']} bytes, L2 weight bytes a launch "
            f"{p['l2_weight_bytes'] / 1e9:.4f} GB")
    log(f"wn_bf16: {fit} clusters of {wn_layer.BF16_CLUSTER} blocks fit at once "
        f"(cudaOccupancyMaxActiveClusters): {fit * wn_layer.BF16_CLUSTER} of "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")


def wn_bf16_traffic(wn_layer, b, t, layer, ms):
    """A bf16 row's L2 weight bytes (the kernel's plan) and their rate."""
    fit = wn_layer.bf16_active_clusters()
    l2 = wn_layer.bf16_launch_plan(b, t, layer.w_cond.shape[1], layer.b_rs.numel(),
                                   fit)["l2_weight_bytes"]
    return {"l2_weight_gb": l2 / 1e9, "l2_weight_tb_s": l2 / (ms * 1e-3) / 1e12}


def random_wn_layer(wn_layer, gen, rs_out, ch=256, cc=640, dtype=torch.float32):
    """One WN layer packed on the card, with the init's scales."""
    def n(*shape, scale=0.05):
        return (torch.randn(shape, generator=gen) * scale).cuda().to(dtype)

    return wn_layer.pack_wn_layer(n(2 * ch, ch, 3), n(2 * ch, scale=0.01), n(2 * ch, cc),
                                  n(2 * ch, scale=0.01), n(rs_out, ch), n(rs_out, scale=0.01))


def wn_cost(b, t, layer, first, last, rs_mode=False, ch=256, cc=640):
    """(ops seconds, bytes seconds) of one WN layer at the card's peaks: the
    products the kernel runs (f32: 3 TF32 operations per FLOP; bf16: one
    operation per FLOP at the bf16 peak) and the bytes it must move (each
    input read once, each output written once; the weights once in their
    dtype, not the kernel's TF32 hi/lo copy of them)."""
    rs_out = layer.b_rs.numel()
    flops = 2.0 * b * t * (2 * ch * (3 * ch + cc) + ch * rs_out)
    act = b * t * ch
    if rs_mode:
        io = act + b * t * cc + b * t * rs_out
    else:
        io = act + b * t * cc + act + (0 if first else act) + (0 if last else act)
    weights = (layer.w_in.numel() + layer.w_cond.numel() + layer.w_rs.numel()
               + layer.bias_a.numel() + rs_out)
    e = layer.w_in.element_size()
    ops = flops / BF16_PEAK_FLOPS if e == 2 else TF32_PER_F32 * flops / TF32_PEAK_FLOPS
    return ops, e * (io + weights) / HBM_BYTES_PER_S


def check_wn(wn_layer, main_shapes, dtype=torch.float32):
    """Phase 2b: the WN layer kernel (K3 in every mode, K4) against its plain
    version: single layers at the main path's (B, T) and at a ragged T, and
    a whole 8-layer stack (dilations 1..128) at the main path's shape.  In
    bf16 the main path's three layers and the stack, each held to bf16 ULPs
    of its output's scale."""
    import torch.nn.functional as F

    bf16 = dtype == torch.bfloat16
    name = str(dtype).replace("torch.", "")
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
    if bf16:  # the bf16 kernel's plan: an odd tile count in one row, T under one tile
        cases += [
            ("ragged T, 13 tiles, middle layer", 1, 64 * 13 - 5, 128, False, False, None, False),
            ("T under one tile, middle layer", 2, 40, 8, False, False, None, False),
            ("T under one tile, last layer", 1, 63, 128, False, True, None, False),
        ]
    rows = []
    for label, b, t, d, first, last, k4, main in cases:
        layer = random_wn_layer(wn_layer, gen, k4 or (256 if last else 512), dtype=dtype)
        h = torch.randn((b, t, 256), generator=gen).cuda().to(dtype)
        cond = torch.randn((b, t, 640), generator=gen).cuda().to(dtype)
        skip = None if first else torch.randn((b, t, 256), generator=gen).cuda().to(dtype)
        plain_args = (layer.w_in, layer.w_cond, layer.bias_a, layer.w_rs, layer.b_rs, d)

        def kernel():  # K4 returns rs, K3 (h_new, skip_new)
            if k4:
                return (wn_layer.fused_wn_layer(h, cond, layer, d),)
            return wn_layer.fused_wn_layer_state(h, cond, skip, layer, d, first, last)

        def plain():
            if k4:
                return (wn_layer.wn_layer_plain(h, cond, *plain_args),)
            return wn_layer.wn_layer_state_plain(h, cond, skip, *plain_args, first, last)

        pairs = list(zip(kernel(), plain()))
        torch.cuda.synchronize()
        err = max((k.float() - p.float()).abs().max().item() for k, p in pairs)
        ulps = max(ulps_of_scale(k, p) for k, p in pairs) if bf16 else None
        if (bf16 and not ulps <= BF16_ULPS) or (not bf16 and not err <= WN_TOLERANCE):
            raise AssertionError(f"wn_layer {name} {label}: max abs err {err}, {ulps} bf16 ULPs")
        acts = torch.rand((b, t, 256), generator=gen).cuda().to(dtype)
        hc = h.transpose(1, 2).contiguous()

        def library():  # the layer's products alone: cuDNN conv + two cuBLAS GEMMs
            F.conv1d(hc, layer.w_in, padding=d, dilation=d)
            F.linear(cond, layer.w_cond)
            F.linear(acts, layer.w_rs)

        ops_s, bytes_s = wn_cost(b, t, layer, first, last, rs_mode=bool(k4))
        row = {
            "case": label, "dtype": name, "B": b, "T": t, "dilation": d, "first": first,
            "last": last, "rs_out": layer.b_rs.numel(), "mode": "K4" if k4 else "K3",
            "main_path": main, "max_abs_err": err, "bf16_ulps_of_scale": ulps,
            "ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": time_ms(library),
            "ops_ms": 1e3 * ops_s, "bytes_ms": 1e3 * bytes_s,
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["hbm_gb"] = bytes_s * HBM_BYTES_PER_S / 1e9
        traffic = ""
        if bf16:
            row.update(wn_bf16_traffic(wn_layer, b, t, layer, row["ms"]))
            traffic = (f", HBM {row['hbm_gb']:.4f} GB, L2 weights {row['l2_weight_gb']:.4f} GB at "
                       f"{row['l2_weight_tb_s']:.3f} TB/s")
        rows.append(row)
        tol = f"{ulps:.3g} bf16 ULPs of scale (tol {BF16_ULPS})" if bf16 else f"(tol {WN_TOLERANCE})"
        log(f"wn_layer {name} {label}: B={b} T={t} d={d} max_abs_err={err:.3g} {tol} "
            f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, cuDNN+cuBLAS products "
            f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
            f"{row['bound_share']:.1%} of bound{traffic}")

    return rows, wn_stack_rows(wn_layer, main_shapes, gen, dtype, "main path, 8-layer WN stack")


FLOW_WN_ITERS = 20  # a stack takes ~0.3 ms: 3 timed runs spread by 2x
# the flow decodes that the engines launched (one a decode_launch, one a
# mesh position) and the flow WaveNet layers they should run, all of them and
# those on the kernel (count_flow_decodes); each path's kernel launches,
# counted from 0 around its own run (flow_wn_start, flow_wn_read)
FLOW_DECODES = {"decodes": 0, "layers": 0, "kernel_layers": 0}
FLOW_WN_LAUNCHES = {}
_FLOW_WN_AT = {}
_FLOW_COUNTERS = ("engine.flow_wn_layers", "engine.flow_wn_kernel_layers")


def count_flow_decodes():
    """Count every engine's flow decodes in FLOW_DECODES from here on: each
    runs n_blocks_dec x n_block_layers WaveNet layers, on the kernel where
    the engine runs GlowTTS in float32 on CUDA at the kernel's geometry
    (bf16 with ``half``, and the CPU, on torch ops)."""
    import threading

    from larynx_tpu_torch.ops import flow_wn
    from larynx_tpu_torch.runtime.engine import MeshEncodeOutput, SynthesisEngine

    launch = SynthesisEngine.decode_launch
    lock = threading.Lock()

    def counted(self, enc_out, *args, **kwargs):
        n = len(self.mesh.positions) if isinstance(enc_out, MeshEncodeOutput) else 1
        layers = n * self.glow_cfg.n_blocks_dec * self.glow_cfg.n_block_layers
        kernel = (self.device.type == "cuda" and self.dtype == torch.float32
                  and flow_wn.packs(self.glow_cfg.dec_channels, self.glow_cfg.kernel_size_dec))
        with lock:
            FLOW_DECODES["decodes"] += n
            FLOW_DECODES["layers"] += layers
            FLOW_DECODES["kernel_layers"] += layers if kernel else 0
        return launch(self, enc_out, *args, **kwargs)

    SynthesisEngine.decode_launch = counted


def flow_wn_start():
    """Set a path's flow WN counts to 0, just before its run."""
    from larynx_tpu_torch.runtime import trace

    counters = trace.counters()
    _FLOW_WN_AT.update(FLOW_DECODES, **{n: counters.get(n, 0) for n in _FLOW_COUNTERS})


def flow_wn_read(label: str) -> int:
    """The flow WN kernel launches of the run since :func:`flow_wn_start`,
    kept under ``label`` in FLOW_WN_LAUNCHES.  Raises unless the port's
    counters saw each decode's layers, n_blocks_dec x n_block_layers (48 at
    the harvard dims), all of them on the kernel in float32 on CUDA."""
    from larynx_tpu_torch.runtime import trace

    counters = trace.counters()
    moved = {n: counters.get(n, 0) - _FLOW_WN_AT[n] for n in _FLOW_COUNTERS}
    want = {n: FLOW_DECODES[n] - _FLOW_WN_AT[n] for n in FLOW_DECODES}
    if not (want["decodes"] > 0 and moved["engine.flow_wn_layers"] == want["layers"]
            and moved["engine.flow_wn_kernel_layers"] == want["kernel_layers"]):
        raise AssertionError(f"flow_wn, {label}: counters {moved} for {want}")
    launches = FLOW_WN_LAUNCHES[label] = moved["engine.flow_wn_kernel_layers"]
    log(f"flow_wn, {label}: {want['decodes']} flow decode(s), {launches} kernel launches of "
        f"{moved['engine.flow_wn_layers']} WaveNet layers")
    return launches


def check_flow_wn(engine, ids, y_lengths):
    """The flow WN kernel: each of a 4-layer stack's layers against the plain
    version (one launch a layer) at ``ops/flow_wn.py::CHECK_CASES`` and at
    the main path's own batch (its rows' squeezed lengths at its squeezed
    bucket), the stack timed whole (kernel, plain version, the torch route's
    cuDNN convs and GEMMs) beside its bound on the valid steps; then
    ``engine.flow_wn_kernel_layers`` = ``engine.flow_wn_layers`` across
    graphed ``synthesize_batch`` calls of ``ids`` -> rows."""
    from larynx_tpu_torch.models.glow_tts import flows
    from larynx_tpu_torch.ops import flow_wn
    from larynx_tpu_torch.runtime import trace

    h, layers, cfg = flow_wn.KERNEL_CHANNELS, 4, engine.glow_cfg
    log(f"flow_wn: dynamic shared memory {flow_wn._library().flow_wn_smem_bytes()} bytes per "
        "block, 384 threads, clusters of 2 blocks")
    m = engine.policy.mel_bucket(int(max(y_lengths)))
    own = (f"main path's own batch, mel bucket {m}", engine.policy.batch_bucket(len(ids)),
           m // cfg.n_sqz, cfg.kernel_size_dec, cfg.dilation_rate, False,
           tuple(int(y) // cfg.n_sqz for y in y_lengths)
           + (0,) * (engine.policy.batch_bucket(len(ids)) - len(y_lengths)))
    rows = []
    for label, b, t, taps, rate, with_g, lengths in (own,) + flow_wn.CHECK_CASES:
        p = flow_wn.random_stack(taps, seed=b * t, layers=layers, device="cuda")
        torch_p = {k: v for k, v in p.items() if k != "flow_wn"}
        x, mask, g = flow_wn.random_inputs(lengths, t, seed=t, with_g=with_g, layers=layers,
                                           device="cuda")
        err = flow_wn.check_stack(p, x, mask, g, rate)
        if not err <= flow_wn.CHECK_TOLERANCE:
            raise AssertionError(f"flow_wn {label}: relative error {err} "
                                 f"(tol {flow_wn.CHECK_TOLERANCE})")
        flops = 2 * sum(lengths) * layers * (2 * h * taps * h + h * 2 * h)
        row = {
            "case": label, "B": b, "T": t, "taps": taps, "dilation_rate": rate, "g": with_g,
            "valid_steps": sum(lengths), "main_path": label == own[0],
            "max_rel_err": err,
            "ms": time_ms(lambda: flows.wavenet(p, x, mask, rate, g), FLOW_WN_ITERS),
            "plain_ms": time_ms(lambda: flow_wn.wavenet_plain(p, x, mask, rate, g), FLOW_WN_ITERS),
            "library_ms": time_ms(lambda: flows.wavenet(torch_p, x, mask, rate, g), FLOW_WN_ITERS),
            "bound_ms": 1e3 * TF32_PER_F32 * flops / TF32_PEAK_FLOPS,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"flow_wn {label}: B={b} T'={t} k={taps} rate={rate} valid {sum(lengths)} steps, "
            f"relative err {err:.3g} (tol {flow_wn.CHECK_TOLERANCE}); 4-layer stack: kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, torch route (cuDNN, cuBLAS) "
            f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms on the valid steps "
            f"({row['bound_share']:.1%})")
    engine.synthesize_batch(ids, noise_scale=0.667, length_scale=LENGTH_SCALE)  # may capture
    replays = trace.counters().get("engine.glow_graph_replays", 0)
    flow_wn_start()
    engine.synthesize_batch(ids, noise_scale=0.667, length_scale=LENGTH_SCALE)
    torch.cuda.synchronize()
    flow_wn_read(f"engine.synthesize_batch, {len(ids)} rows, graphed")
    if trace.counters().get("engine.glow_graph_replays", 0) == replays:
        raise AssertionError("flow_wn: the engine's synthesize_batch replayed no graph")
    return rows


def wn_stack_rows(wn_layer, shapes, gen, dtype, label):
    """A whole WN stack (dilations 1..128) at each (B, T) of ``shapes``: h
    and skip after 8 layers against the plain version, with times and bound."""
    import torch.nn.functional as F

    bf16 = dtype == torch.bfloat16
    name = str(dtype).replace("torch.", "")
    stacks = []
    for b, t in shapes:
        layers = [random_wn_layer(wn_layer, gen, 256 if i == 7 else 512, dtype=dtype)
                  for i in range(8)]
        h0 = (torch.randn((b, t, 256), generator=gen) * 0.1).cuda().to(dtype)
        cond = torch.randn((b, t, 640), generator=gen).cuda().to(dtype)
        acts = torch.rand((b, t, 256), generator=gen).cuda().to(dtype)

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
        err = max((hk.float() - hp.float()).abs().max().item(),
                  (sk.float() - sp.float()).abs().max().item())
        ulps = max(ulps_of_scale(hk, hp), ulps_of_scale(sk, sp)) if bf16 else None
        if (bf16 and not ulps <= BF16_STACK_ULPS) or (not bf16 and not err <= WN_TOLERANCE):
            raise AssertionError(f"wn_layer {name} 8-layer stack B={b} T={t}: max abs err {err}, "
                                 f"{ulps} bf16 ULPs")
        costs = [wn_cost(b, t, layer, i == 0, i == 7) for i, layer in enumerate(layers)]
        ops_s, bytes_s = sum(c[0] for c in costs), sum(c[1] for c in costs)
        row = {
            "case": label, "dtype": name, "B": b, "T": t, "launches": 8,
            "max_abs_err": err, "bf16_ulps_of_scale": ulps,
            "ms": time_ms(lambda: stack(kernel_layer)),
            "plain_ms": time_ms(lambda: stack(plain_layer)), "library_ms": time_ms(library),
            "ops_ms": 1e3 * ops_s, "bytes_ms": 1e3 * bytes_s,
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["hbm_gb"] = bytes_s * HBM_BYTES_PER_S / 1e9
        traffic = ""
        if bf16:
            l2 = sum(wn_bf16_traffic(wn_layer, b, t, layer, 1.0)["l2_weight_gb"] for layer in layers)
            row.update({"l2_weight_gb": l2, "l2_weight_tb_s": l2 / row["ms"]})
            traffic = (f", HBM {row['hbm_gb']:.4f} GB, L2 weights {l2:.4f} GB at "
                       f"{row['l2_weight_tb_s']:.3f} TB/s")
        stacks.append(row)
        tol = (f"{ulps:.3g} bf16 ULPs of scale (tol {BF16_STACK_ULPS})" if bf16
               else f"(tol {WN_TOLERANCE})")
        log(f"wn_layer {name} {label} B={b} T={t} (dilations 1..128): max_abs_err={err:.3g} "
            f"{tol} kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"cuDNN+cuBLAS products {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms, "
            f"{row['bound_share']:.1%} of bound{traffic}")
    return stacks


def mrf_launches_per_call(cfg, dtype=torch.float32) -> int:
    """MRF kernel launches of one generator call, over the stages the kernel
    takes (C <= 128): one per resblock unit, except one per section where
    the bf16 kernel runs the section plan (C <= 64)."""
    from larynx_tpu_torch.ops.mrf_block import bf16_plan

    units = sum(len(d) for d in cfg.resblock_dilation_sizes)
    n = 0
    for i in range(len(cfg.upsample_rates)):
        c = cfg.upsample_initial_channel // 2 ** (i + 1)
        if c <= 128:
            n += 1 if dtype == torch.bfloat16 and bf16_plan(c) == "section" else units
    return n


@contextlib.contextmanager
def recording_mrf_shapes(shapes: set):
    """While open, add the (C, B, T) of every mrf_section call that the
    HiFi-GAN generator makes, from any thread, to ``shapes``; the wrapper
    and its launch count are left as they are."""
    from larynx_tpu_torch.models.hifi_gan import model as hifi_gan_model

    section = hifi_gan_model.mrf_section

    def recorded(x, stage):
        shapes.add((x.shape[2], x.shape[0], x.shape[1]))
        return section(x, stage)

    hifi_gan_model.mrf_section = recorded
    try:
        yield shapes
    finally:
        hifi_gan_model.mrf_section = section


def path_mrf_cases(checked, path_shapes):
    """Phase 8's mrf_section cases: each (C, B, T) that a path in
    ``path_shapes`` gave the kernel (universal_large, ResBlock1) and no
    earlier case checked."""
    seen = {(c, b, t): label for label, c, geometry, b, t, _m in checked if geometry is R1}
    cases = []
    for path, shapes in path_shapes.items():
        for c, b, t in sorted(shapes, reverse=True):
            if (c, b, t) in seen:
                log(f"mrf_section {path}, C={c} B={b} T={t}: checked as '{seen[(c, b, t)]}'")
            else:
                seen[(c, b, t)] = f"{path}, C={c} B={b} T={t}"
                cases.append((seen[(c, b, t)], c, R1, b, t, False))
    return cases


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
    per_call = mrf_launches_per_call(engine.vocoder_cfg)
    launches = {}
    for label, strength in (("no denoiser", 0.0), ("denoiser 0.005", 0.005)):
        mrf_block.mrf_section.launches = 0
        flow_wn_start()
        calls_before = engine.generator_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        start = time.perf_counter()
        results = list(larynx_tpu_torch.text_to_speech(text, device="cuda",
                                                       denoiser_strength=strength, **kwargs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        n_launch = mrf_block.mrf_section.launches
        flow_wn_read("text_to_speech, pangram x8" + (f", {label}" if strength else ""))
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
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB above what the "
            f"cached engines held before the run), generator calls {calls}, mrf_section launches "
            f"{n_launch}")

    # where the time goes: the engine's stages on the same batch, host clock
    # around synchronised work, mean of 3
    ids = [j["ids"] for j in jobs]
    n = len(ids)

    _, t_front = timed(lambda: larynx_tpu_torch._build_jobs(
        text, VOICE, "high", custom_voices_dir=root, no_download=True))
    (enc, _g), t_enc = timed(lambda: engine.encode_launch(ids, LENGTH_SCALE))
    y_host, t_sync = timed(lambda: enc[4].cpu().numpy())
    (mel, z_mask), t_dec = timed(lambda: engine.decode_launch(enc, y_host, None, n, batch_index=0))
    _, t_voc = timed(lambda: engine.vocode_collect(
        engine.vocode_launch(mel, z_mask, n, 0.0, y_lengths=y_host), mel.shape[0]))
    _, t_voc_dn = timed(lambda: engine.vocode_collect(
        engine.vocode_launch(mel, z_mask, n, 0.005, y_lengths=y_host), mel.shape[0]))
    mel_pp = postprocess(mel, z_mask, engine.audio_settings).transpose(1, 2)
    _, t_gen = timed(lambda: engine._generate(mel_pp))
    log(f"stage times (ms, B={n}, mel bucket {mel.shape[1]}): frontend (text to ids, host) "
        f"{t_front:.3f}, encode {t_enc:.3f}, "
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
        flow_wn_start()
        calls_before = engine.generator_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        start = time.perf_counter()
        results = list(larynx_tpu_torch.text_to_speech(text, device="cuda",
                                                       denoiser_strength=strength, **kwargs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        n_k3 = wn_layer.fused_wn_layer_state.launches
        calls = engine.generator_calls - calls_before
        flow_wn_read("text_to_speech, pangram x8, waveglow" + (f", {label}" if strength else ""))

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
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB above what the "
            f"cached engines held before the run), vocoder calls {calls}, wn_layer launches {n_k3}")

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


def lsb(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def stream_path(root: Path, mrf_block, engine, n_frames: int):
    """Phase 5: stream_text_to_speech on the pangram at full width, without
    and with the denoiser: time to first audio after a warm run, time and
    MRF launches per chunk, and the chunks against the one-window run, the
    CPU path's stream and the batch path.  Returns the MRF launches of one
    stream without the denoiser."""
    import larynx_tpu_torch

    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality="high", custom_voices_dir=root,
                  no_download=True, seed=STREAM_SEED)
    per_call = mrf_launches_per_call(engine.vocoder_cfg)
    n_chunks = -(-n_frames // CHUNK_FRAMES)

    def stream(device="cuda", noise_scale=0.667, **extra):
        # the CUDA and CPU generators draw other numbers from one seed: the
        # two devices are compared at noise_scale 0
        settings = {"length_scale": LENGTH_SCALE, "noise_scale": noise_scale}
        return larynx_tpu_torch.stream_text_to_speech(PANGRAM, device=device, tts_settings=settings,
                                                      **kwargs, **extra)

    launches = {}
    for label, strength in (("no denoiser", 0.0), ("denoiser 0.005", 0.005)):
        list(stream(denoiser_strength=strength))  # warm: cuDNN/cuFFT plans, the bias
        mrf_block.mrf_section.launches = 0
        flow_wn_start()
        torch.cuda.synchronize()
        start = time.perf_counter()
        it = stream(denoiser_strength=strength)
        chunks = [next(it)]
        ttfa = time.perf_counter() - start
        chunks += list(it)
        total = time.perf_counter() - start
        n_launch = mrf_block.mrf_section.launches
        flow_wn_read("stream_text_to_speech, pangram" + (f", {label}" if strength else ""))
        if len(chunks) != n_chunks or n_launch != per_call * n_chunks:
            raise AssertionError(f"stream, {label}: {len(chunks)} chunks and {n_launch} MRF "
                                 f"launches, expected {n_chunks} and {per_call * n_chunks}")
        streamed = np.concatenate(chunks)
        if streamed.dtype != np.int16 or streamed.shape != (n_frames * 256,):
            raise AssertionError(f"stream, {label}: {streamed.dtype} {streamed.shape}")
        if np.abs(streamed.astype(np.int32)).max() < 1000:
            raise AssertionError(f"stream, {label}: silent audio")
        launches[label] = n_launch

        whole = np.concatenate(list(stream(denoiser_strength=strength, chunk_frames=10**6)))
        diff = np.abs(streamed.astype(np.int32) - whole.astype(np.int32))
        share = float(np.mean(diff != 0))
        if whole.shape != streamed.shape or diff.max() > STREAM_WINDOW_LSB or \
                not share < STREAM_WINDOW_SHARE:
            raise AssertionError(f"stream, {label}: chunked vs one window {diff.max()} LSB, "
                                 f"{share:.2e} of samples differ")
        quiet = np.concatenate(list(stream(noise_scale=0.0, denoiser_strength=strength)))
        cpu = np.concatenate(list(stream("cpu", noise_scale=0.0, denoiser_strength=strength)))
        if cpu.shape != quiet.shape or lsb(cpu, quiet) > AUDIO_TOLERANCE_LSB:
            raise AssertionError(f"stream, {label}: CUDA vs CPU {lsb(cpu, quiet)} LSB")

        start = time.perf_counter()
        batch = next(iter(larynx_tpu_torch.text_to_speech(
            PANGRAM, device="cuda", denoiser_strength=strength,
            tts_settings={"length_scale": LENGTH_SCALE}, **kwargs))).audio
        first_sentence = time.perf_counter() - start
        a, b = streamed.astype(np.float64), batch.astype(np.float64)
        corr = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
        if batch.shape != streamed.shape or not corr > 0.9999:
            raise AssertionError(f"stream, {label}: batch path {batch.shape}, correlation {corr}")
        log(f"stream, {label}: {n_frames} frames in {len(chunks)} chunks of {CHUNK_FRAMES}, "
            f"time to first audio {1e3 * ttfa:.3f} ms (batch path's first sentence "
            f"{1e3 * first_sentence:.3f} ms), whole stream {1e3 * total:.3f} ms, "
            f"{1e3 * (total - ttfa) / (len(chunks) - 1):.3f} ms per later chunk, "
            f"{1e3 * total / len(chunks):.3f} ms per chunk overall, MRF launches {n_launch} "
            f"({n_launch // len(chunks)} per chunk); chunked vs one window {diff.max()} LSB "
            f"({share:.2e} of samples differ, tol {STREAM_WINDOW_LSB} / {STREAM_WINDOW_SHARE}), "
            f"CUDA vs CPU stream at noise 0 {lsb(cpu, quiet)} LSB (tol {AUDIO_TOLERANCE_LSB}), "
            f"batch path correlation {corr:.6f}")
    # where the time to first audio goes: each step of the stream's first
    # chunk alone, host clock around synchronised work, mean of 3
    from larynx_tpu_torch.runtime.engine import stream_halo_frames

    _, t_front = timed(lambda: larynx_tpu_torch._build_jobs(
        PANGRAM, VOICE, "high", custom_voices_dir=root, no_download=True))
    ids = larynx_tpu_torch._build_jobs(PANGRAM, VOICE, "high", custom_voices_dir=root,
                                       no_download=True)[0]["ids"]
    (enc, _g), t_enc = timed(lambda: engine.encode_launch([ids], LENGTH_SCALE))
    y_host = enc[4].cpu().numpy()
    (mel, z_mask), t_dec = timed(lambda: engine.decode_launch(enc, y_host, None, 1,
                                                              seed=STREAM_SEED))
    window = CHUNK_FRAMES + 2 * stream_halo_frames(engine.vocoder_cfg)
    with torch.inference_mode():
        _, t_chunk = timed(lambda: engine._vocode_stream(mel, z_mask, 0, window, None, None,
                                                         False).cpu())
    log(f"stream, time to first audio by step (ms, host clock, mean of 3): frontend "
        f"{t_front:.3f}, encode {t_enc:.3f}, flow decode (B=1, mel bucket {mel.shape[1]}) "
        f"{t_dec:.3f}, one {window}-frame chunk + copy {t_chunk:.3f}")
    return launches["no denoiser"]


def scheduler_path(root: Path, mrf_block, engine, shapes: set):
    """Phase 6: one BatchScheduler(max_batch=8), SCHEDULER_REQUESTS threads
    each sending one sentence at LENGTH_SCALE through text_to_speech with
    its own seed, enough for several batches; each row against the same
    request alone, then the first eight requests at noise 0 through a CUDA
    and a CPU scheduler against each other, then the per-row noise's
    invariance on the card.  Adds the (C, B, T) that the batches give
    mrf_section to ``shapes``; returns the MRF launches."""
    import threading

    import larynx_tpu_torch
    from larynx_tpu_torch.runtime.engine import stream_halo_frames
    from larynx_tpu_torch.runtime.scheduler import BatchScheduler

    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality="high", custom_voices_dir=root,
                  no_download=True)
    # Alone, a row is vocoded at its own mel bucket; in a batch, in a group as
    # wide as its longest row's bucket.  Past its end the vocoder sees
    # silence frames up to that width, then the conv's zero padding, so a
    # row less than one receptive field (stream_halo_frames) short of its
    # bucket ends differently alone and in a batch, by design (the JAX
    # engine's too).  The phase takes eight sentences clear of that.
    pool = RAGGED + SHORT_SENTENCES
    jobs = larynx_tpu_torch._build_jobs(" ".join(pool), VOICE, "high", custom_voices_dir=root,
                                        no_download=True)
    y = engine.encode_launch([j["ids"] for j in jobs], LENGTH_SCALE)[0][4].cpu().numpy()
    y = y[: len(jobs)]
    halo = stream_halo_frames(engine.vocoder_cfg)
    clear = [i for i, n in enumerate(y) if engine.policy.mel_bucket(int(n)) - n >= halo][:8]
    if len(jobs) != len(pool) or len(clear) < 8:
        raise AssertionError(f"scheduler: mel lengths {y.tolist()} leave {len(clear)} "
                             f"sentences {halo} frames short of their bucket")
    requests = [clear[i % len(clear)] for i in range(SCHEDULER_REQUESTS)]  # indices into pool

    def run(scheduler, indices, device="cuda", noise_scale=0.667):
        barrier = threading.Barrier(len(indices))
        settings = {"length_scale": LENGTH_SCALE, "noise_scale": noise_scale}
        out = {}

        def request(i):
            barrier.wait()
            out[i] = next(iter(larynx_tpu_torch.text_to_speech(
                pool[requests[i]], scheduler=scheduler, seed=100 + i, device=device,
                tts_settings=settings, **kwargs))).audio

        threads = [threading.Thread(target=request, args=(i,)) for i in indices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    n = SCHEDULER_REQUESTS
    warm = BatchScheduler(max_batch=8, max_wait_ms=50.0)
    run(warm, range(n))
    warm.shutdown()
    scheduler = BatchScheduler(max_batch=8, max_wait_ms=50.0)
    per_call = mrf_launches_per_call(engine.vocoder_cfg)
    mrf_block.mrf_section.launches = 0
    flow_wn_start()
    calls_before = engine.generator_calls
    torch.cuda.synchronize()
    start = time.perf_counter()
    with recording_mrf_shapes(shapes):
        together = run(scheduler, range(n))
    wall = time.perf_counter() - start
    n_launch = mrf_block.mrf_section.launches
    flow_wn_read(f"scheduler, {n} requests")
    calls = engine.generator_calls - calls_before
    scheduler.shutdown()
    if len(together) != n or scheduler.jobs_run != n or \
            not -(-n // 8) <= scheduler.batches_run < n:
        raise AssertionError(f"scheduler: {len(together)} results, {scheduler.batches_run} "
                             f"batches for {scheduler.jobs_run} jobs")
    if calls < scheduler.batches_run or n_launch != per_call * calls:
        raise AssertionError(f"scheduler: {n_launch} MRF launches for {calls} generator calls")
    worst = 0
    for i in range(n):
        alone = BatchScheduler(max_batch=8)
        solo = run(alone, [i])[i]
        alone.shutdown()
        if solo.shape != together[i].shape or np.abs(solo.astype(np.int32)).max() < 1000:
            raise AssertionError(f"scheduler row {i}: {together[i].shape} vs alone {solo.shape}")
        worst = max(worst, lsb(solo, together[i]))
    if worst > AUDIO_TOLERANCE_LSB:
        raise AssertionError(f"scheduler: a seeded row is {worst} LSB from its solo run")

    # batched rows against the port's CPU path: the eight sentences at noise 0
    # (the two devices' generators draw other numbers from one seed)
    quiet, t_quiet = {}, {}
    for device in ("cuda", "cpu"):
        s = BatchScheduler(max_batch=8, max_wait_ms=50.0)
        start = time.perf_counter()
        quiet[device] = run(s, range(8), device=device, noise_scale=0.0)
        t_quiet[device] = time.perf_counter() - start
        s.shutdown()
        if len(quiet[device]) != 8 or s.batches_run >= 8:
            raise AssertionError(f"scheduler at noise 0 on {device}: {len(quiet[device])} "
                                 f"results in {s.batches_run} batches")
    cpu_worst = 0
    for i in range(8):
        a, b = quiet["cuda"][i], quiet["cpu"][i]
        if a.shape != b.shape or np.abs(a.astype(np.int32)).max() < 1000:
            raise AssertionError(f"scheduler at noise 0, row {i}: CUDA {a.shape}, CPU {b.shape}")
        cpu_worst = max(cpu_worst, lsb(a, b))
    if cpu_worst > AUDIO_TOLERANCE_LSB:
        raise AssertionError(f"scheduler at noise 0: CUDA vs CPU {cpu_worst} LSB")

    # the same rows as engine calls of eight, without the threads, the
    # frontend or the scheduler's queue
    rows = [jobs[k]["ids"] for k in requests]

    def engine_only():
        for k in range(0, n, 8):
            engine.synthesize_batch(rows[k : k + 8], length_scale=LENGTH_SCALE, seed=1)

    _, t_engine = timed(engine_only)

    c = engine.glow_cfg.mel_channels
    a = engine.row_noise([9], 1, 256, c, batch_index=0)[0]
    wide = engine.row_noise([9], 1, 1024, c, batch_index=3)[0]
    row5 = engine.row_noise([None, 1, 2, None, 4, 9, None, 7], 8, 512, c, batch_index=11)[5]
    if a.device.type != "cuda" or not (torch.equal(a, wide[:256]) and torch.equal(a, row5[:256])):
        raise AssertionError("scheduler: a seeded row's noise changed with its bucket or row")
    audio_s = sum(r.shape[0] for r in together.values()) / 22050
    log(f"scheduler: {n} requests of {len(clear)} sentences (y_lengths "
        f"{[int(y[k]) for k in clear]}, length_scale {LENGTH_SCALE}) from {n} threads in "
        f"{scheduler.batches_run} batches, {calls} generator calls, wall {wall:.4f} s, "
        f"{n / wall:.2f} sentences/s, {audio_s:.2f} s of audio (RTF {wall / audio_s:.6f}), "
        f"MRF launches {n_launch}, mrf_section shapes (C, B, T) {sorted(shapes)}; the same rows "
        f"as {-(-n // 8)} synthesize_batch calls {t_engine:.3f} ms; each seeded row vs alone "
        f"max {worst} LSB (tol {AUDIO_TOLERANCE_LSB}); 8 rows at noise 0, CUDA vs CPU "
        f"scheduler {cpu_worst} LSB (tol {AUDIO_TOLERANCE_LSB}; CUDA {t_quiet['cuda']:.3f} s, "
        f"CPU {t_quiet['cpu']:.1f} s); a seeded row's noise over 256 frames bit for bit at "
        f"buckets 256/1024 and at row 0 of 1 / row 5 of 8")
    return n_launch


def cli_path(root: Path, mrf_block, engine, n_frames: int, shapes: set):
    """Phase 7: the CLI, WAV on stdout and --stream PCM, each first in
    process (``__main__.main`` with stdout captured, its MRF launches read
    around it and the (C, B, T) it gives mrf_section added to ``shapes``),
    then as ``python -m larynx_tpu_torch`` in a subprocess from the checkout
    root; every output against the library call with the same arguments,
    float32 on both sides (the CLI turns TF32 off, as this script does).
    Returns each mode's launches."""
    import io

    import larynx_tpu_torch
    from larynx_tpu_torch import __main__ as cli
    from larynx_tpu_torch.io import wavfile

    argv = [PANGRAM, "--voice", VOICE, "--voices-dir", str(root), "--quality", "high", "--seed",
            "7", "--length-scale", str(LENGTH_SCALE), "--denoiser-strength", "0.005",
            "--no-download"]
    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality="high", custom_voices_dir=root,
                  no_download=True, seed=7, denoiser_strength=0.005, device="cuda",
                  tts_settings={"length_scale": LENGTH_SCALE, "noise_scale": 0.667})
    wav_ref = next(iter(larynx_tpu_torch.text_to_speech(PANGRAM, **kwargs))).audio
    pcm_ref = np.concatenate(list(larynx_tpu_torch.stream_text_to_speech(PANGRAM, **kwargs)))
    per_call = mrf_launches_per_call(engine.vocoder_cfg)
    here = Path(__file__).resolve().parent

    def decode(mode, data):
        if mode == "--stream":
            return 22050, np.frombuffer(data, dtype=np.int16)
        if data[:4] != b"RIFF":
            raise AssertionError(f"cli {mode}: no RIFF header")
        return wavfile.read(io.BytesIO(data))

    launches = {}
    for mode, extra, ref, calls in (
            ("WAV on stdout", [], wav_ref, 1),
            ("--stream", ["--stream"], pcm_ref, -(-n_frames // CHUNK_FRAMES))):
        stdout = sys.stdout
        sys.stdout = io.TextIOWrapper(io.BytesIO())
        mrf_block.mrf_section.launches = 0
        flow_wn_start()
        try:
            with recording_mrf_shapes(shapes):
                cli.main(argv + extra)
            sys.stdout.flush()
            in_process = sys.stdout.buffer.getvalue()
        finally:
            sys.stdout = stdout
        n_launch = mrf_block.mrf_section.launches
        flow_wn_read(f"cli, pangram, {mode}")
        if n_launch != per_call * calls:
            raise AssertionError(f"cli {mode}: {n_launch} MRF launches, expected {per_call * calls}")
        launches[mode] = n_launch

        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "larynx_tpu_torch"] + argv + extra, cwd=here,
                              capture_output=True, timeout=300)
        wall = time.perf_counter() - start
        if proc.returncode != 0:
            raise AssertionError(f"cli {mode}: exit {proc.returncode}\n"
                                 f"{proc.stderr.decode()[-2000:]}")
        diffs = {}
        for where, data in (("in process", in_process), ("subprocess", proc.stdout)):
            rate, audio = decode(mode, data)
            if rate != 22050 or audio.shape != ref.shape or lsb(audio, ref) > AUDIO_TOLERANCE_LSB:
                raise AssertionError(
                    f"cli {mode}, {where}: rate {rate}, shape {audio.shape} vs {ref.shape}, "
                    f"{lsb(audio, ref) if audio.shape == ref.shape else '-'} LSB")
            diffs[where] = lsb(audio, ref)
        log(f"cli {mode}: {len(proc.stdout)} bytes, 22050 Hz, {ref.shape[0]} samples, from the "
            f"float32 library call {diffs['in process']} LSB in process and "
            f"{diffs['subprocess']} LSB as a subprocess (tol {AUDIO_TOLERANCE_LSB}), MRF launches "
            f"in process {n_launch}, subprocess wall {wall:.2f} s")
    log(f"cli: mrf_section shapes (C, B, T) {sorted(shapes)}")
    return launches


def pin_precision(value):
    """Set (or, for None, clear) the vocoder precision override."""
    if value is None:
        os.environ.pop(PRECISION_ENV, None)
    else:
        os.environ[PRECISION_ENV] = value


def audibly_identical(x, y, where: str, shift_free: bool = False, n_sqz: int = 2,
                      correlation: float = BF16_CORRELATION):
    """The JAX package's bar for bf16 audio (correlation > 0.999, RMS level
    within 1% of full scale) -> the correlation (None if not compared).
    ``shift_free``: a ``half`` run, whose ceil'd bf16 durations may each
    move by a frame: lengths within 1% (at least 2 * n_sqz frames) and the
    level; the correlation bar where the lengths agree."""
    rms = lambda a: float(np.sqrt(np.mean(a.astype(np.float64) ** 2)))  # noqa: E731
    limit = max(2 * n_sqz * 256, y.shape[0] // 100)
    if x.shape != y.shape and not (shift_free and abs(x.shape[0] - y.shape[0]) <= limit):
        raise AssertionError(f"{where}: shapes {x.shape} vs {y.shape}")
    if abs(rms(x) - rms(y)) >= BF16_LEVEL:
        raise AssertionError(f"{where}: RMS {rms(x):.1f} vs {rms(y):.1f}")
    if x.shape != y.shape:
        return None
    corr = float(np.corrcoef(x.astype(np.float64), y.astype(np.float64))[0, 1])
    if not corr > correlation:
        raise AssertionError(f"{where}: correlation {corr} (tol > {correlation})")
    return corr


def bf16_path(root: Path, mrf_block, wn_layer, y_lengths, wg_plan, shapes: set):
    """Phase 9: the bf16 paths at full width.  Each path's kernel launches
    are counted from 0 around its own run; each path's audio is held
    against its float32 run of the same rows at noise 0.  Adds the (C, B,
    T) that the stream and the CLI give mrf_section to ``shapes``.  Returns
    the launches and the measurements."""
    import io

    import larynx_tpu_torch
    from larynx_tpu_torch import __main__ as cli
    from larynx_tpu_torch.io import wavfile

    text = " ".join([PANGRAM] * 8)
    base = dict(custom_voices_dir=root, no_download=True, voice_or_lang=VOICE)
    out = {"launches": {}}

    def tts(voc, device="cuda", noise_scale=0.667, precision=None, **kwargs):
        pin_precision(precision)
        try:
            settings = {"length_scale": LENGTH_SCALE, "noise_scale": noise_scale}
            return [r.audio for r in larynx_tpu_torch.text_to_speech(
                kwargs.pop("text", text), vocoder_or_quality=voc, device=device,
                tts_settings=settings, **base, **kwargs)]
        finally:
            pin_precision(None)

    def engine(voc, half=False):
        jobs = larynx_tpu_torch._build_jobs(PANGRAM, VOICE, voc, custom_voices_dir=root,
                                            no_download=True)
        return larynx_tpu_torch._get_engine(jobs[0]["tts_model"], jobs[0]["vocoder_model"],
                                            torch.device("cuda"), half=half)

    # JAX's bf16 leaky-ReLU (F.leaky_relu with the bf16 slope) on the card
    # as on the CPU, bit for bit
    from larynx_tpu_torch.models.nn import leaky_relu

    x = (torch.randn(1 << 20, generator=torch.Generator().manual_seed(4)) * 3).to(torch.bfloat16)
    if not torch.equal(leaky_relu(x.cuda()).cpu(), leaky_relu(x)):
        raise AssertionError("bf16 leaky_relu: CUDA and CPU round differently")

    per_call = mrf_launches_per_call(engine("high").vocoder_cfg, torch.bfloat16)
    for label, voc, half in (("HiFi-GAN, CUDA default (bf16 vocoder)", "high", False),
                             ("WaveGlow, CUDA default (bf16 vocoder)", "waveglow", False),
                             ("HiFi-GAN, half=True", "high", True)):
        eng = engine(voc, half)
        if eng.voc_dtype != torch.bfloat16 or eng.dtype != (torch.bfloat16 if half else
                                                            torch.float32):
            raise AssertionError(f"bf16 {label}: engine dtypes {eng.dtype}, {eng.voc_dtype}")
        tts(voc, half=half, seed=1)  # warm: cuDNN plans, bf16 params on the card
        tts(voc, half=half, seed=1, denoiser_strength=0.005)  # the bias, in bf16
        mrf_block.mrf_section.launches = 0
        wn_layer.fused_wn_layer_state.launches = 0
        flow_wn_start()
        calls_before = eng.generator_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        start = time.perf_counter()
        audios = tts(voc, half=half, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        n_mrf, n_wn = mrf_block.mrf_section.launches, wn_layer.fused_wn_layer_state.launches
        calls = eng.generator_calls - calls_before
        flow_wn_read(f"text_to_speech, pangram x8, {label}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        run_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        for a, y in zip(audios, y_lengths):
            if a.dtype != np.int16 or np.abs(a.astype(np.int32)).max() < 1000:
                raise AssertionError(f"bf16 {label}: {a.dtype} audio, peak {np.abs(a).max()}")
            if not half and a.shape != (int(y) * 256,):
                raise AssertionError(f"bf16 {label}: {a.shape}, y_length {y}")
        if len(audios) != 8 or calls < 1 or (voc == "waveglow" and (
                n_wn != 96 * calls or calls != len(wg_plan) or n_mrf)) or (
                voc != "waveglow" and (n_mrf != per_call * calls or n_wn)):
            raise AssertionError(f"bf16 {label}: {len(audios)} results, {calls} vocoder calls, "
                                 f"{n_mrf} MRF and {n_wn} WN launches")
        # against float32 at noise 0 (the WaveGlow prior drawn from one seed)
        quiet = tts(voc, half=half, seed=1, noise_scale=0.0)
        full = tts(voc, seed=1, noise_scale=0.0, precision="f32")
        corrs = [audibly_identical(a, b, f"bf16 {label}, row {i} vs f32", shift_free=half)
                 for i, (a, b) in enumerate(zip(quiet, full))]
        audio_s = sum(a.shape[0] for a in audios) / 22050
        key = "half" if half else voc
        out["launches"][key] = n_wn if voc == "waveglow" else n_mrf
        out[key] = {"wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
                    "peak_gib": peak, "run_peak_gib": run_peak, "calls": calls,
                    "corr_vs_f32": corrs}
        compared = [c for c in corrs if c is not None]
        log(f"bf16 path, {label}: wall {wall:.4f} s, audio {audio_s:.2f} s, RTF "
            f"{wall / audio_s:.6f}, peak device memory {peak:.2f} GiB ({run_peak:.2f} GiB above "
            f"what the cached engines held before the run), vocoder calls {calls}, "
            f"MRF launches {n_mrf}, WN launches {n_wn}; against float32 at noise 0: correlation "
            f"min {min(compared, default=float('nan')):.6f} over {len(compared)} of 8 rows (tol > {BF16_CORRELATION}"
            f"{'; rows whose bf16 durations moved a frame held to length and level' if half else ''}"
            f"), level within {BF16_LEVEL:.0f}")

    # half at the float32 durations: bf16 GlowTTS and vocoder, the f32
    # engine's ceil'd durations, noise 0, against the f32 engine
    pin_precision("f32")
    try:
        e32 = engine("high")
    finally:
        pin_precision(None)
    e16 = engine("high", half=True)
    ids = [j["ids"] for j in larynx_tpu_torch._build_jobs(text, VOICE, "high",
                                                           custom_voices_dir=root,
                                                           no_download=True)]
    with torch.inference_mode():
        enc32, _ = e32.encode_launch(ids, LENGTH_SCALE)
        enc16, _ = e16.encode_launch(ids, LENGTH_SCALE)
        y = enc32[4].cpu().numpy()

        def at_f32_durations(e, enc):
            parts, rows = e.synthesize_launch(enc, y, None, len(ids), noise_scale=0.0)
            return e.crop_rows(e.vocode_collect(parts, rows), y, len(ids), 0.0)

        a16 = at_f32_durations(e16, enc16[:3] + enc32[3:5] + enc16[5:])
        a32 = at_f32_durations(e32, enc32)
    corrs = [audibly_identical(a, b, f"bf16 half=True at the f32 durations, row {i}",
                               correlation=BF16_HALF_CORRELATION)
             for i, (a, b) in enumerate(zip(a16, a32))]
    out["half"]["corr_vs_f32_at_f32_durations"] = corrs
    y16 = enc16[4].cpu().numpy()[: len(ids)]
    log(f"bf16 path, HiFi-GAN, half=True at the f32 durations, noise 0: correlation min "
        f"{min(corrs):.6f} (tol > {BF16_HALF_CORRELATION}), level within {BF16_LEVEL:.0f}; "
        f"bf16 y_lengths {y16.tolist()} against f32 {y[: len(ids)].tolist()}")

    # streams: the CUDA default and half=True, time to first audio after a warm run
    n_frames = int(y_lengths[0])
    n_chunks = -(-n_frames // CHUNK_FRAMES)
    def stream(noise_scale=0.667, **kwargs):
        settings = {"length_scale": LENGTH_SCALE, "noise_scale": noise_scale}
        return larynx_tpu_torch.stream_text_to_speech(
            PANGRAM, vocoder_or_quality="high", device="cuda", tts_settings=settings,
            seed=STREAM_SEED, **base, **kwargs)

    pin_precision("f32")  # the engine is picked as the stream is read
    try:
        full = np.concatenate(list(stream(noise_scale=0.0)))
    finally:
        pin_precision(None)
    for label, half in (("CUDA default (bf16 vocoder)", False), ("half=True", True)):

        list(stream(half=half))
        mrf_block.mrf_section.launches = 0
        flow_wn_start()
        torch.cuda.synchronize()
        with recording_mrf_shapes(shapes):
            start = time.perf_counter()
            it = stream(half=half)
            chunks = [next(it)]
            ttfa = time.perf_counter() - start
            chunks += list(it)
            total = time.perf_counter() - start
        n_launch = mrf_block.mrf_section.launches
        flow_wn_read(f"stream_text_to_speech, pangram, {label}")
        streamed = np.concatenate(chunks)
        if n_launch != per_call * len(chunks) or (not half and len(chunks) != n_chunks):
            raise AssertionError(f"bf16 stream, {label}: {len(chunks)} chunks, {n_launch} MRF "
                                 "launches")
        quiet = np.concatenate(list(stream(noise_scale=0.0, half=half)))
        corr = audibly_identical(quiet, full, f"bf16 stream, {label} vs f32", shift_free=half)
        key = "stream half" if half else "stream"
        out["launches"][key] = n_launch
        out[key] = {"ttfa_ms": 1e3 * ttfa, "total_ms": 1e3 * total, "chunks": len(chunks),
                    "corr_vs_f32": corr}
        log(f"bf16 stream, {label}: {streamed.shape[0] // 256} frames in {len(chunks)} chunks, "
            f"time to first audio {1e3 * ttfa:.3f} ms, whole stream {1e3 * total:.3f} ms, MRF "
            f"launches {n_launch}; against the float32 stream at noise 0: correlation "
            f"{'-' if corr is None else f'{corr:.6f}'} (tol > {BF16_CORRELATION}), level within "
            f"{BF16_LEVEL:.0f}")

    # the CLI with --half, once in process, against the library's half=True call
    argv = [PANGRAM, "--voice", VOICE, "--voices-dir", str(root), "--quality", "high", "--seed",
            "7", "--length-scale", str(LENGTH_SCALE), "--no-download", "--half"]
    ref = tts("high", half=True, seed=7, text=PANGRAM, denoiser_strength=0.005)[0]
    stdout = sys.stdout
    sys.stdout = io.TextIOWrapper(io.BytesIO())
    mrf_block.mrf_section.launches = 0
    flow_wn_start()
    try:
        with recording_mrf_shapes(shapes):
            cli.main(argv)
        sys.stdout.flush()
        data = sys.stdout.buffer.getvalue()
    finally:
        sys.stdout = stdout
    n_launch = mrf_block.mrf_section.launches
    flow_wn_read("cli --half, pangram WAV")
    rate, audio = wavfile.read(io.BytesIO(data))
    if rate != 22050 or audio.shape != ref.shape or lsb(audio, ref) > AUDIO_TOLERANCE_LSB or \
            n_launch != per_call:
        raise AssertionError(f"bf16 cli --half: rate {rate}, {audio.shape} vs {ref.shape}, "
                             f"{n_launch} MRF launches")
    out["launches"]["cli --half"] = n_launch
    log(f"bf16 cli --half, in process: {audio.shape[0]} samples, {lsb(audio, ref)} LSB from the "
        f"library's half=True call (tol {AUDIO_TOLERANCE_LSB}), MRF launches {n_launch}")

    # CUDA bf16 against the CPU path in bf16, a small batch at noise 0
    for voc in ("high", "waveglow/wn_256_sigma0"):
        small = " ".join(RAGGED[:2])
        settings = {"noise_scale": 0.0}
        gpu = [r.audio for r in larynx_tpu_torch.text_to_speech(
            small, vocoder_or_quality=voc, device="cuda", tts_settings=settings, **base)]
        start = time.perf_counter()
        pin_precision("bf16")
        try:
            cpu = [r.audio for r in larynx_tpu_torch.text_to_speech(
                small, vocoder_or_quality=voc, device="cpu", tts_settings=settings, **base)]
        finally:
            pin_precision(None)
        t_cpu = time.perf_counter() - start
        corrs = [audibly_identical(a, b, f"bf16 CUDA vs CPU, {voc}, row {i}")
                 for i, (a, b) in enumerate(zip(gpu, cpu))]
        if len(gpu) != 2 or len(cpu) != 2:
            raise AssertionError(f"bf16 CUDA vs CPU, {voc}: {len(gpu)}/{len(cpu)} rows")
        out[f"cuda vs cpu {voc}"] = corrs
        log(f"bf16 CUDA vs CPU path, {voc}, 2 sentences at noise 0: correlation min "
            f"{min(corrs):.6f} (tol > {BF16_CORRELATION}), level within {BF16_LEVEL:.0f}, "
            f"CPU side {t_cpu:.1f} s")
    log(f"bf16: mrf_section shapes (C, B, T) of the streams and the CLI {sorted(shapes)}")
    return out


@contextlib.contextmanager
def exact_mel_buckets():
    """While open, every engine decodes at the exact mel bucket: its
    frames-per-token estimator reads as cold and learns nothing.  The
    estimators' values are restored on exit."""
    import larynx_tpu_torch
    from larynx_tpu_torch.runtime.engine import SynthesisEngine

    engines = [e for e in list(larynx_tpu_torch._ENGINE_CACHE.values()) if e is not None]
    saved = [(e, e._frames_per_token) for e in engines]
    observe = SynthesisEngine._observe_frames_per_token
    SynthesisEngine._observe_frames_per_token = lambda self, *args: None
    for e in engines:
        e._frames_per_token = 0.0
    try:
        yield
    finally:
        SynthesisEngine._observe_frames_per_token = observe
        for e, value in saved:
            e._frames_per_token = value


@contextlib.contextmanager
def counting_vocode_launches(calls: list):
    """While open, append the ``n_valid`` of every engine vocode_launch."""
    from larynx_tpu_torch.runtime.engine import SynthesisEngine

    launch = SynthesisEngine.vocode_launch

    def counted(self, mel, z_mask, n_valid, *args, **kwargs):
        calls.append(n_valid)
        return launch(self, mel, z_mask, n_valid, *args, **kwargs)

    SynthesisEngine.vocode_launch = counted
    try:
        yield calls
    finally:
        SynthesisEngine.vocode_launch = launch


def device_busy_ms(fn, counts=None, kernel_names=None):
    """(fn's result, host wall ms, the card's busy ms) of one traced run:
    the union of the device intervals (kernels, copies, memsets) in
    torch.profiler's trace, so that a copy that overlaps a kernel counts
    once; None when the trace holds no device activity.  ``counts`` (a
    Counter), when given, gets the number of intervals of each kind and, as
    ``host_sync``, of the host's waits for the card (synchronisations and
    blocking copies); ``kernel_names`` (a Counter) the kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - start)
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if counts is not None:
        counts.update(e["cat"] for e in events
                      if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
        counts["host_sync"] += sum(1 for e in events if e.get("cat") == "cuda_runtime" and (
            "Synchronize" in e.get("name", "") or e.get("name") == "cudaMemcpy"))
    if kernel_names is not None:
        kernel_names.update(e["name"] for e in events
                            if e.get("ph") == "X" and e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    return out, wall, (busy / 1e3 if spans else None)


def run_jobs_path(root: Path, mrf_block, wn_layer, mrf_shapes: set, wn_shapes: set):
    """Phase 12, float32: text_to_speech's pipelined batch path on
    bench.py's SSML document (three voices, one HiFi-GAN) and chapter, the
    pooled WaveGlow path, and a multi-speaker voice through the engine.
    Each document against the same sentences run unit by unit through
    public engine calls (encode_launch, the lengths read at once,
    synthesize_launch, vocode_collect), under cuDNN's deterministic
    algorithms.  Adds the shapes that the CUDA runs give the kernels to
    ``mrf_shapes`` and ``wn_shapes``; returns launches and measurements."""
    import larynx_tpu_torch
    from larynx_tpu_torch.runtime.engine import stream_halo_frames

    sizes = stage_bench_voices(root)
    log(f"run_jobs: bench voices staged, phoneme tables {sizes} (the port's frontend on the "
        f"SSML document and the chapter); {MULTI_VOICE}: {MULTI_SPEAKERS} speakers, "
        f"gin_channels {MULTI_GIN}")
    cuda = torch.device("cuda")
    quiet = {"noise_scale": 0.0, "length_scale": LENGTH_SCALE}
    out = {"launches": {}, "ms": {}}
    timings = {}

    def tts(text, vocoder="high", ssml=True, interleaved=True, pool=True):
        os.environ["LARYNX_TPU_VOCODE_POOL"] = "1" if pool else "0"
        try:
            return list(larynx_tpu_torch.text_to_speech(
                text, voice_or_lang=BENCH_EN, vocoder_or_quality=vocoder, ssml=ssml,
                custom_voices_dir=root, no_download=True, tts_settings=quiet,
                interleaved_batching=interleaved, device="cuda"))
        finally:
            os.environ.pop("LARYNX_TPU_VOCODE_POOL", None)

    def unit_by_unit(text, vocoder="high", ssml=True, interleaved=True):
        """(texts, audio, units) of the document's units, each run alone:
        encode, the lengths read, synthesize_launch at the exact bucket,
        vocode_collect, the SSML pauses."""
        jobs = larynx_tpu_torch._build_jobs(text, BENCH_EN, vocoder, ssml=ssml,
                                            custom_voices_dir=root, no_download=True)
        units = larynx_tpu_torch._plan_units(jobs, 8, cuda, interleaved=interleaved)
        audio = [None] * len(jobs)
        for j, (engine, indices) in enumerate(units):
            n = len(indices)
            enc, g = engine.encode_launch([jobs[i]["ids"] for i in indices], LENGTH_SCALE)
            y = enc.lengths.numpy()
            parts, rows = engine.synthesize_launch(enc, y, g, n, noise_scale=0.0, batch_index=j)
            crops = engine.crop_rows(engine.vocode_collect(parts, rows), y, n, 0.0)
            for i, a in zip(indices, crops):
                audio[i] = larynx_tpu_torch._pad_pauses(jobs[i], a)
        return [job["result"].text for job in jobs], audio, units

    def agree(results, ref, where):
        texts, audio, _units = ref
        if [r.text for r in results] != texts:
            raise AssertionError(f"{where}: results out of document order")
        worst = 0
        for i, (r, a) in enumerate(zip(results, audio)):
            if r.audio.shape != a.shape or np.abs(a.astype(np.int32)).max() < 1000:
                raise AssertionError(f"{where}, sentence {i}: {r.audio.shape} vs {a.shape}")
            worst = max(worst, lsb(r.audio, a))
        if worst > POOL_LSB:
            diffs = [lsb(r.audio, a) for r, a in zip(results, audio)]
            raise AssertionError(f"{where}: {diffs} LSB from the unit-by-unit run (tol {POOL_LSB})")
        return worst

    def engine_of(voice, vocoder="high"):
        """The cached engine that text_to_speech runs the voice on."""
        models = dict(custom_voices_dir=root, no_download=True)
        return larynx_tpu_torch._get_engine(larynx_tpu_torch.get_tts_model(voice, **models),
                                            larynx_tpu_torch.get_vocoder_model(vocoder, **models),
                                            cuda)

    def generator_calls(vocoder):
        return sum(engine_of(voice, vocoder).generator_calls for voice in BENCH_VOICES)

    per_call = mrf_launches_per_call(engine_of(BENCH_EN).vocoder_cfg)
    torch.backends.cudnn.deterministic = True
    try:
        # b. the chapter: 16 sentences, two units of 8 through one voice; the
        # voice's engine is fresh (its estimator cold) on the first run
        en = engine_of(BENCH_EN)
        if en._frames_per_token != 0.0:
            raise AssertionError("book: the voice's estimator is not cold")
        for label in ("cold", "warm"):
            calls = []
            mrf_block.mrf_section.launches = 0
            flow_wn_start()
            gen_before = en.generator_calls
            with counting_vocode_launches(calls), recording_mrf_shapes(mrf_shapes):
                results, t = timed_once(lambda: tts(BOOK, ssml=False))
            n_mrf, gen = mrf_block.mrf_section.launches, en.generator_calls - gen_before
            flow_wn_read(f"text_to_speech, chapter of 16 pangrams, {label}")
            if calls != [16] or n_mrf != per_call * gen:
                raise AssertionError(f"book, {label}: vocode launches {calls}, {n_mrf} MRF "
                                     f"launches for {gen} generator calls; expected one "
                                     "pooled launch of 16 rows")
            timings[f"book {label}"] = t
            out[f"book {label}"] = {"frames_per_token": en._frames_per_token,
                                    "bucket_mispredicts": en._bucket_mispredicts}
            log(f"run_jobs book, {label} run: {len(results)} sentences, one pooled vocode "
                f"launch of {calls[0]} rows, {gen} generator calls, {n_mrf} MRF launches; "
                f"estimator frames_per_token {en._frames_per_token:.6f}, bucket_mispredicts "
                f"{en._bucket_mispredicts}; wall {t:.3f} ms")
        out["launches"]["text_to_speech, chapter of 16 pangrams"] = n_mrf
        ref = unit_by_unit(BOOK, ssml=False)
        worst = agree(results, ref, "book")
        walls = {"text_to_speech": [], "unit by unit": []}
        for _ in range(3):
            walls["text_to_speech"].append(timed_once(lambda: tts(BOOK, ssml=False))[1])
            walls["unit by unit"].append(timed_once(lambda: unit_by_unit(BOOK, ssml=False))[1])
        _, traced_wall, busy = device_busy_ms(lambda: tts(BOOK, ssml=False))
        _, ref_traced_wall, ref_busy = device_busy_ms(lambda: unit_by_unit(BOOK, ssml=False))
        med = {k: float(np.median(v)) for k, v in walls.items()}
        out["ms"].update({"book text_to_speech": med["text_to_speech"],
                          "book unit by unit": med["unit by unit"],
                          "book traced wall": traced_wall, "book busy": busy,
                          "book unit by unit traced wall": ref_traced_wall,
                          "book unit by unit busy": ref_busy})
        share = lambda b, w: "not measured" if b is None else f"{b:.3f} ms, {b / w:.1%}"  # noqa
        log(f"run_jobs book: {worst} LSB from the unit-by-unit run (tol {POOL_LSB}); host wall "
            f"(median of 3) text_to_speech {med['text_to_speech']:.3f} ms "
            f"{walls['text_to_speech']}, unit by unit {med['unit by unit']:.3f} ms "
            f"{walls['unit by unit']}; the card busy (torch.profiler, the union of kernel, "
            f"copy and memset intervals) {share(busy, traced_wall)} of a traced wall of "
            f"{traced_wall:.3f} ms; unit by unit {share(ref_busy, ref_traced_wall)} of "
            f"{ref_traced_wall:.3f} ms")


        # a. the SSML document: pooled, interleaved and consecutive, and per unit
        for interleaved in (True, False):
            tts(SSML, interleaved=interleaved)  # warm: the engines, cuDNN plans
        ssml_units = {}
        for interleaved in (True, False):
            ref = unit_by_unit(SSML, interleaved=interleaved)
            ssml_units[interleaved] = ref[2]
            calls = []
            mrf_block.mrf_section.launches = 0
            flow_wn_start()
            gen_before = generator_calls("high")
            with counting_vocode_launches(calls), recording_mrf_shapes(mrf_shapes):
                results, t = timed_once(lambda: tts(SSML, interleaved=interleaved))
            gen = generator_calls("high") - gen_before
            n_mrf = mrf_block.mrf_section.launches
            label = "interleaved" if interleaved else "consecutive"
            flow_wn_read(f"text_to_speech, SSML ({label}), pooled")
            if calls != [len(results)] or gen != 1 or n_mrf != per_call:
                raise AssertionError(f"SSML {label}: vocode launches {calls}, generator calls "
                                     f"{gen}, MRF launches {n_mrf}: expected one pooled launch "
                                     f"of all {len(results)} rows, {per_call} MRF launches")
            worst = agree(results, ref, f"SSML {label}, pooled")
            out["launches"][f"text_to_speech, SSML ({label}), pooled"] = n_mrf
            timings[f"SSML {label} pooled"] = t
            log(f"run_jobs SSML, {label}: {len(results)} sentences in {len(ref[2])} units over "
                f"3 voices, one pooled vocode_launch of {calls[0]} rows, {gen} generator call, "
                f"{n_mrf} MRF launches; {worst} LSB from the unit-by-unit run (tol {POOL_LSB}); "
                f"wall {t:.3f} ms")
        calls = []
        mrf_block.mrf_section.launches = 0
        flow_wn_start()
        gen_before = generator_calls("high")
        with counting_vocode_launches(calls), recording_mrf_shapes(mrf_shapes):
            results, t = timed_once(lambda: tts(SSML, pool=False))
        gen = generator_calls("high") - gen_before
        n_mrf = mrf_block.mrf_section.launches
        flow_wn_read("text_to_speech, SSML, LARYNX_TPU_VOCODE_POOL=0")
        units = ssml_units[True]
        if len(calls) != len(units) or n_mrf != per_call * gen:
            raise AssertionError(f"SSML, LARYNX_TPU_VOCODE_POOL=0: vocode launches {calls} for "
                                 f"{len(units)} units, {n_mrf} MRF launches, {gen} calls")
        worst = agree(results, unit_by_unit(SSML), "SSML, per unit")
        timings["SSML interleaved per unit"] = t
        out["launches"]["text_to_speech, SSML, LARYNX_TPU_VOCODE_POOL=0"] = n_mrf
        log(f"run_jobs SSML, LARYNX_TPU_VOCODE_POOL=0: {len(calls)} vocode launches "
            f"({calls} rows), {gen} generator calls, {n_mrf} MRF launches, {worst} LSB from "
            f"the unit-by-unit run; wall {t:.3f} ms")

        # c. the SSML document through WaveGlow (sigma 0: a zero prior, so the
        # pooled and the per-unit runs are comparable), pooled
        wg = "waveglow/wn_256_sigma0"
        tts(SSML, vocoder=wg)  # warm
        ref = unit_by_unit(SSML, vocoder=wg)
        calls = []
        wn_layer.fused_wn_layer_state.launches = 0
        flow_wn_start()
        gen_before = generator_calls(wg)
        with counting_vocode_launches(calls), recording_wn_shapes(wn_shapes):
            results, t = timed_once(lambda: tts(SSML, vocoder=wg))
        gen = generator_calls(wg) - gen_before
        n_wn = wn_layer.fused_wn_layer_state.launches
        flow_wn_read("text_to_speech, SSML, waveglow pooled")
        if calls != [len(results)] or n_wn != 96 * gen:
            raise AssertionError(f"SSML waveglow: vocode launches {calls}, {n_wn} WN launches "
                                 f"for {gen} group calls")
        worst = agree(results, ref, "SSML waveglow, pooled")
        out["launches"]["text_to_speech, SSML, waveglow pooled"] = n_wn
        timings["SSML waveglow pooled"] = t
        log(f"run_jobs SSML, WaveGlow ({wg}): one pooled vocode_launch of {calls[0]} rows in "
            f"{gen} group calls, {n_wn} WN launches (96 per call); {worst} LSB from the "
            f"unit-by-unit run (tol {POOL_LSB}); wall {t:.3f} ms")
    finally:
        torch.backends.cudnn.deterministic = False

    # d. multi-speaker GlowTTS through the engine
    tts_model = larynx_tpu_torch.get_tts_model(MULTI_VOICE, custom_voices_dir=root,
                                               no_download=True)
    vocoder = larynx_tpu_torch.get_vocoder_model("high", custom_voices_dir=root,
                                                 no_download=True)
    engine = larynx_tpu_torch._get_engine(tts_model, vocoder, cuda)
    cpu_engine = larynx_tpu_torch._get_engine(tts_model, vocoder, torch.device("cpu"))
    jobs = larynx_tpu_torch._build_jobs(" ".join(SHORT_SENTENCES), MULTI_VOICE, "high",
                                        custom_voices_dir=root, no_download=True)
    ids = [job["ids"] for job in jobs]
    speakers = list(range(MULTI_SPEAKERS))
    mrf_block.mrf_section.launches = 0
    calls = engine.generator_calls
    with recording_mrf_shapes(mrf_shapes):
        engine.synthesize_batch(ids, noise_scale=0.0, speaker_ids=speakers)  # warm
        mrf_block.mrf_section.launches = 0
        flow_wn_start()
        calls = engine.generator_calls
        gpu, t_gpu = timed_once(lambda: engine.synthesize_batch(ids, noise_scale=0.0,
                                                                speaker_ids=speakers))
    n_mrf, calls = mrf_block.mrf_section.launches, engine.generator_calls - calls
    flow_wn_read(f"engine.synthesize_batch, multi-speaker, {len(speakers)} speakers (g)")
    cpu, t_cpu = timed_once(lambda: cpu_engine.synthesize_batch(ids, noise_scale=0.0,
                                                                speaker_ids=speakers))
    worst = 0
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if a.shape != b.shape or np.abs(a.astype(np.int32)).max() < 1000:
            raise AssertionError(f"multi-speaker row {i}: CUDA {a.shape}, CPU {b.shape}")
        worst = max(worst, lsb(a, b))
    if worst > AUDIO_TOLERANCE_LSB or n_mrf != per_call * calls:
        raise AssertionError(f"multi-speaker synthesize_batch: CUDA vs CPU {worst} LSB, "
                             f"{n_mrf} MRF launches for {calls} generator calls")
    out["launches"]["engine.synthesize_batch, multi-speaker, 8 speakers"] = n_mrf
    out["ms"].update({"multi-speaker synthesize_batch": t_gpu,
                      "multi-speaker synthesize_batch cpu": t_cpu})
    first = ids[0]
    mels = [engine.phonemes_to_mels(first, noise_scale=0.0, length_scale=LENGTH_SCALE,
                                    speaker_id=k) for k in (0, 5)]
    if mels[0].shape == mels[1].shape and np.abs(mels[0] - mels[1]).max() < 1e-2:
        raise AssertionError("multi-speaker: speakers 0 and 5 give the same mel")
    k = 3
    model_mel = tts_model.phonemes_to_mels(first, settings={
        "noise_scale": 0.0, "length_scale": LENGTH_SCALE, "speaker_id": k}, device="cuda")
    engine_mel = engine.phonemes_to_mels(first, noise_scale=0.0, length_scale=LENGTH_SCALE,
                                         speaker_id=k)
    mel_err = float(np.abs(model_mel - engine_mel).max()) if model_mel.shape == \
        engine_mel.shape else float("inf")
    if not mel_err <= 1e-5:
        raise AssertionError(f"multi-speaker: GlowTextToSpeech.phonemes_to_mels is {mel_err} "
                             "from the engine's")
    with recording_mrf_shapes(mrf_shapes):
        stream = np.concatenate(list(engine.synthesize_stream(
            first, noise_scale=0.0, length_scale=LENGTH_SCALE, speaker_ids=[k],
            chunk_frames=CHUNK_FRAMES)))
        whole = np.concatenate(list(engine.synthesize_stream(
            first, noise_scale=0.0, length_scale=LENGTH_SCALE, speaker_ids=[k],
            chunk_frames=10**6)))
        batch_row = engine.synthesize_batch([first], noise_scale=0.0,
                                            length_scale=LENGTH_SCALE, speaker_ids=[k])[0]
    diff = np.abs(stream.astype(np.int32) - whole.astype(np.int32))
    a, b = stream.astype(np.float64), batch_row.astype(np.float64)
    corr = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)) \
        if a.shape == b.shape else float("nan")
    if stream.shape != whole.shape or diff.max() > STREAM_WINDOW_LSB or \
            not np.mean(diff != 0) < STREAM_WINDOW_SHARE or not corr > 0.9999:
        raise AssertionError(f"multi-speaker stream: {stream.shape} vs {whole.shape}, "
                             f"{diff.max()} LSB, correlation with the batch row {corr}")
    try:
        engine.synthesize_batch(ids[:1], noise_scale=0.0)
        raise AssertionError("multi-speaker: no speaker id did not raise")
    except ValueError as err:
        missing = str(err)
    log(f"run_jobs multi-speaker ({MULTI_SPEAKERS} speakers, gin {MULTI_GIN}): "
        f"synthesize_batch of {len(ids)} sentences with speakers {speakers} at noise 0 and "
        f"length scale 1: CUDA vs CPU {worst} LSB (tol {AUDIO_TOLERANCE_LSB}), CUDA "
        f"{t_gpu:.3f} ms, CPU {t_cpu:.1f} ms, MRF launches {n_mrf}; speakers 0 and 5 give "
        f"other mels; GlowTextToSpeech.phonemes_to_mels(speaker_id={k}) {mel_err:.3g} from "
        f"the engine's; stream (speaker {k}) vs one window {diff.max()} LSB, correlation with "
        f"the batch row {corr:.6f}; no speaker id: ValueError ({missing})")
    out["ms"].update(timings)
    log("run_jobs walls (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
    return out


def timed_once(fn):
    """(fn's result, host-clocked ms) of one call between synchronisations."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, 1e3 * (time.perf_counter() - start)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ServedApp:
    """The port's ``create_app`` behind aiohttp's ``AppRunner`` on 127.0.0.1
    at a free port, its event loop in a thread of its own; requests go over
    HTTP from the caller's threads, and synthesis runs in the app's
    executor and scheduler threads."""

    def __init__(self, settings):
        import asyncio
        import threading

        from aiohttp import web

        from larynx_tpu_torch.server.app import create_app

        self.port = free_port()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.app = create_app(settings)
        self.runner = web.AppRunner(self.app)
        self._run(self.runner.setup())
        self._run(web.TCPSite(self.runner, "127.0.0.1", self.port).start())

    def _run(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=120)

    def close(self):
        self._run(self.runner.cleanup())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=60)

    def open(self, path, data=None, **params):
        """The response of GET (POST with ``data``) ``path?params``; fails on
        a status other than 200."""
        import urllib.error
        import urllib.parse
        import urllib.request

        url = f"http://127.0.0.1:{self.port}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        try:
            return urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=900)
        except urllib.error.HTTPError as err:
            raise AssertionError(f"{path}: HTTP {err.code}: {err.read()[:2000]!r}") from None

    def body(self, path, data=None, **params) -> bytes:
        with self.open(path, data, **params) as resp:
            if resp.status != 200:
                raise AssertionError(f"{path}: HTTP {resp.status}")
            return resp.read()

    def wav(self, path, data=None, **params) -> np.ndarray:
        import io

        from larynx_tpu_torch.io import wavfile

        rate, audio = wavfile.read(io.BytesIO(self.body(path, data, **params)))
        if rate != 22050 or audio.dtype != np.int16:
            raise AssertionError(f"{path}: {rate} Hz {audio.dtype}")
        return audio


@contextlib.contextmanager
def recording_wn_shapes(shapes: set):
    """While open, add the (B, T) of every WN layer call that WaveGlow's
    ``infer`` makes, from any thread, to ``shapes``."""
    from larynx_tpu_torch.models.waveglow import model as wg_model

    layer = wg_model.fused_wn_layer_state

    def recorded(h, *args, **kwargs):
        shapes.add((h.shape[0], h.shape[1]))
        return layer(h, *args, **kwargs)

    wg_model.fused_wn_layer_state = recorded
    try:
        yield shapes
    finally:
        wg_model.fused_wn_layer_state = layer


def spectral_convergence(audio, target, fft=1024, hop=256) -> float:
    """Gain-invariant spectral convergence of float audio [T] against linear
    magnitudes [n_freq, frames]: ||a |STFT| - target|| / ||target|| at the
    best gain a (peak normalisation and the un-normalised overlap-add scale
    the waveform)."""
    from larynx_tpu_torch.dsp.stft import stft_magnitude_phase

    mag, _ = stft_magnitude_phase(torch.as_tensor(audio, dtype=torch.float32)[None].cpu(), fft, hop)
    mag, ref = mag[0].double(), torch.as_tensor(target).double().cpu()
    n = min(mag.shape[-1], ref.shape[-1])
    mag, ref = mag[:, :n], ref[:, :n]
    alpha = (mag * ref).sum() / (mag * mag).sum()
    return float(torch.linalg.norm(alpha * mag - ref) / torch.linalg.norm(ref))


def correlation(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel())[0, 1])


def pid_running(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def server_path(root: Path, mrf_block, wn_layer, engine, wg_engine, mrf_shapes: set,
                wn_shapes: set):
    """Phase 11: the port's HTTP server on the card, float32, on the staged
    full-width voices, each route against the library call it wraps; the
    scheduler through the server; the per-model surfaces against the
    engine; Griffin-Lim CUDA against CPU; the CLI's daemon.  Adds the (C, B,
    T) and (B, T) that the server's paths give the two kernels to the shape
    sets.  Returns the launches and the measurements."""
    import threading

    import larynx_tpu_torch
    import larynx_tpu_torch.dsp.mel as dspmel
    import larynx_tpu_torch.dsp.stft as dsp
    from larynx_tpu_torch.runtime import engine as engine_module
    from larynx_tpu_torch.runtime.engine import postprocess
    from larynx_tpu_torch.server.app import ServerSettings

    strength = 0.005  # the server's default denoiser strength
    quiet = {"noise_scale": 0.0, "length_scale": LENGTH_SCALE}
    lib = dict(voice_or_lang=VOICE, custom_voices_dir=root, no_download=True, device="cuda",
               denoiser_strength=strength, tts_settings=quiet)
    per_call = mrf_launches_per_call(engine.vocoder_cfg)
    out = {"launches": {}, "ms": {}}

    # Griffin-Lim's voice: the random weights' normalised mels fill the clip
    # range [-1, 1], which spec_gain 1 maps to amplitudes up to 1e20 whose
    # squares overflow float32 (in the JAX package too; a trained voice stays
    # far below); the same weights at spec_gain 20 give amplitudes under 10
    gl_voice = "en-us_harvard_gl-glow_tts"
    gl_dir = root / "en-us" / "harvard_gl-glow_tts"
    gl_dir.mkdir(exist_ok=True)
    config = json.loads((root / "en-us" / "harvard-glow_tts" / "config.json").read_text())
    config["audio"]["spec_gain"] = 20.0
    (gl_dir / "config.json").write_text(json.dumps(config))
    for name in ("phonemes.txt", "generator.npz"):
        if not (gl_dir / name).exists():
            (gl_dir / name).symlink_to(root / "en-us" / "harvard-glow_tts" / name)

    def library(text, vocoder="high", voice=VOICE):
        # the server's routes run through its scheduler, which decodes at
        # the exact mel bucket; the library call is held to the same shapes
        # so that the two compare bit for bit
        with exact_mel_buckets():
            return np.concatenate([r.audio for r in larynx_tpu_torch.text_to_speech(
                text, vocoder_or_quality=vocoder,
                vocoder_settings={"denoiser_strength": strength},
                **dict(lib, voice_or_lang=voice))])

    # the server's defaults are this phase's settings: noise 0, LENGTH_SCALE,
    # so /process (which takes no settings) is comparable
    server = ServedApp(ServerSettings(voices_dir=str(root), quality="high", noise_scale=0.0,
                                      length_scale=LENGTH_SCALE, device="cuda"))
    try:
        with recording_mrf_shapes(mrf_shapes), recording_wn_shapes(wn_shapes):
            # /api/tts GET and POST against text_to_speech, and /process
            server.wav("/api/tts", voice=VOICE, text=PANGRAM)  # warm: the server's threads
            mrf_block.mrf_section.launches = 0
            flow_wn_start()
            calls = engine.generator_calls
            torch.cuda.synchronize()
            start = time.perf_counter()
            got = server.wav("/api/tts", voice=VOICE, text=PANGRAM)
            out["ms"]["server /api/tts f32"] = 1e3 * (time.perf_counter() - start)
            n_launch, calls = mrf_block.mrf_section.launches, engine.generator_calls - calls
            flow_wn_read("server /api/tts, pangram")
            if calls < 1 or n_launch != per_call * calls:
                raise AssertionError(f"server /api/tts: {n_launch} MRF launches for {calls} "
                                     f"generator calls")
            out["launches"]["server /api/tts, pangram"] = n_launch
            start = time.perf_counter()
            want = library(PANGRAM)
            out["ms"]["library text_to_speech f32"] = 1e3 * (time.perf_counter() - start)
            posted = server.wav("/api/tts", data=PANGRAM.encode(), voice=VOICE)
            mary = server.wav("/process", INPUT_TEXT=PANGRAM, VOICE=f"{VOICE};high")
            mary_post = server.wav("/process", data=urllib_form(INPUT_TEXT=PANGRAM,
                                                                VOICE=f"{VOICE};high"))
            for label, audio in (("GET /api/tts", got), ("POST /api/tts", posted),
                                 ("GET /process", mary), ("POST /process", mary_post)):
                if audio.shape != want.shape or lsb(audio, want) != 0 or \
                        np.abs(want.astype(np.int32)).max() < 1000:
                    raise AssertionError(f"server {label}: {audio.shape} vs the library's "
                                         f"{want.shape}, {lsb(audio, want) if audio.shape == want.shape else '-'} LSB")
            log(f"server /api/tts (GET, POST) and /process (GET, POST), pangram at noise 0: "
                f"{want.shape[0]} samples, 0 LSB from text_to_speech; one request "
                f"{out['ms']['server /api/tts f32']:.3f} ms wall against the library call's "
                f"{out['ms']['library text_to_speech f32']:.3f} ms; MRF launches {n_launch} "
                f"({calls} generator call(s), {per_call} each)")

            # /api/stream (HiFi-GAN) against stream_text_to_speech: time to first body byte
            stream_args = dict(lib, vocoder_or_quality="high")
            list(larynx_tpu_torch.stream_text_to_speech(PANGRAM, **stream_args))
            start = time.perf_counter()
            it = larynx_tpu_torch.stream_text_to_speech(PANGRAM, **stream_args)
            chunks = [next(it)]
            lib_ttfa = time.perf_counter() - start
            chunks += list(it)
            want = np.concatenate(chunks)
            server.body("/api/stream", voice=VOICE, text=PANGRAM)  # warm
            mrf_block.mrf_section.launches = 0
            flow_wn_start()
            start = time.perf_counter()
            with server.open("/api/stream", voice=VOICE, text=PANGRAM) as resp:
                header = resp.read(44)
                first = resp.read(2)
                ttfb = time.perf_counter() - start
                body = first + resp.read()
            total = time.perf_counter() - start
            n_launch = mrf_block.mrf_section.launches
            flow_wn_read("server /api/stream, pangram")
            got = np.frombuffer(body, dtype=np.int16)
            if header[:4] != b"RIFF" or got.shape != want.shape or lsb(got, want) != 0:
                raise AssertionError(f"server /api/stream: {got.shape} vs {want.shape}")
            if n_launch != per_call * len(chunks):
                raise AssertionError(f"server /api/stream: {n_launch} MRF launches for "
                                     f"{len(chunks)} chunks")
            out["launches"]["server /api/stream, pangram"] = n_launch
            out["ms"]["server /api/stream first byte"] = 1e3 * ttfb
            out["ms"]["library stream first chunk"] = 1e3 * lib_ttfa
            log(f"server /api/stream, pangram: {len(chunks)} chunks, 0 LSB from "
                f"stream_text_to_speech; time to first body byte {1e3 * ttfb:.3f} ms (the "
                f"library's time to first audio {1e3 * lib_ttfa:.3f} ms), whole stream "
                f"{1e3 * total:.3f} ms, MRF launches {n_launch}")

            # /api/stream with WaveGlow: one chunk per sentence through the
            # fallback, against WaveGlowVocoder.mels_to_audio on the same mels.
            # Bit for bit needs cuDNN's deterministic algorithms: by default
            # two runs of this path on one card differ by an LSB, so the
            # run-to-run difference is printed beside it
            voc = "waveglow/wn_256_sigma0"
            text2 = f"{RAGGED[0]} {RAGGED[2]}"
            jobs = larynx_tpu_torch._build_jobs(text2, VOICE, voc, custom_voices_dir=root,
                                                no_download=True)

            def reference():
                parts = []
                for job in jobs:
                    mels = job["tts_model"].phonemes_to_mels(job["ids"], settings=quiet,
                                                             device="cuda")
                    s = job["audio_settings"]
                    mels = s.dynamic_range_compression(s.db_to_amp(s.denormalize(mels)))
                    parts.append(job["vocoder_model"].mels_to_audio(
                        mels, settings={"denoiser_strength": strength}, device="cuda"))
                return parts

            default_runs = [np.concatenate(reference()) for _ in range(2)]
            torch.backends.cudnn.deterministic = True
            try:
                server.body("/api/stream", voice=VOICE, text=text2, vocoder=voc)  # warm
                wn_layer.fused_wn_layer_state.launches = 0
                mrf_block.mrf_section.launches = 0
                flow_wn_start()
                start = time.perf_counter()
                got = np.frombuffer(server.body("/api/stream", voice=VOICE, text=text2,
                                                vocoder=voc)[44:], dtype=np.int16)
                wg_stream_ms = 1e3 * (time.perf_counter() - start)
                n_wn = wn_layer.fused_wn_layer_state.launches
                flow_wn_read("server /api/stream?vocoder=waveglow (fallback), 2 sentences")
                parts = reference()
            finally:
                torch.backends.cudnn.deterministic = False
            want = np.concatenate(parts)
            if len(jobs) != 2 or got.shape != want.shape or lsb(got, want) != 0:
                diff = lsb(got, want) if got.shape == want.shape else "-"
                raise AssertionError(f"server /api/stream waveglow: {got.shape} vs "
                                     f"{want.shape} over {len(jobs)} sentences, {diff} LSB; two "
                                     f"default runs {lsb(*default_runs)} LSB apart")
            if n_wn != 96 * len(jobs) or mrf_block.mrf_section.launches:
                raise AssertionError(f"server /api/stream waveglow: {n_wn} WN launches")
            out["launches"]["server /api/stream?vocoder=waveglow (fallback), 2 sentences"] = n_wn
            out["ms"]["server /api/stream waveglow"] = wg_stream_ms
            log(f"server /api/stream?vocoder={voc}, 2 sentences: one chunk per sentence "
                f"({[len(p) for p in parts]} samples), 0 LSB from WaveGlowVocoder.mels_to_audio "
                f"on the sentences' phonemes_to_mels (cuDNN deterministic; two runs of the "
                f"reference at cuDNN's defaults {lsb(*default_runs)} LSB apart, "
                f"{np.mean(default_runs[0] != default_runs[1]):.2e} of samples); "
                f"{wg_stream_ms:.3f} ms wall, WN launches {n_wn} (96 per sentence)")

            # /api/tts with WaveGlow through the engine
            server.wav("/api/tts", voice=VOICE, text=PANGRAM, vocoder="waveglow")  # warm
            wn_layer.fused_wn_layer_state.launches = 0
            flow_wn_start()
            calls = wg_engine.generator_calls
            audio = server.wav("/api/tts", voice=VOICE, text=PANGRAM, vocoder="waveglow")
            n_wn, calls = wn_layer.fused_wn_layer_state.launches, wg_engine.generator_calls - calls
            flow_wn_read("server /api/tts?vocoder=waveglow, pangram")
            if calls < 1 or n_wn != 96 * calls or np.abs(audio.astype(np.int32)).max() < 1000:
                raise AssertionError(f"server /api/tts waveglow: {n_wn} WN launches, {calls} calls")
            out["launches"]["server /api/tts?vocoder=waveglow, pangram"] = n_wn
            log(f"server /api/tts?vocoder=waveglow, pangram: {audio.shape[0]} samples, WN "
                f"launches {n_wn} ({calls} group call(s), 96 each)")

            # /api/tts with Griffin-Lim: spectral convergence against the target
            gl_audio = server.wav("/api/tts", voice=gl_voice, text=PANGRAM, vocoder="griffin_lim")
            gl_jobs = larynx_tpu_torch._build_jobs(PANGRAM, gl_voice, "griffin_lim",
                                                   custom_voices_dir=root, no_download=True)
            gl_engine = larynx_tpu_torch._get_engine(gl_jobs[0]["tts_model"],
                                                     gl_jobs[0]["vocoder_model"],
                                                     torch.device("cuda"))
            with torch.inference_mode():
                enc, _g = gl_engine.encode_launch([gl_jobs[0]["ids"]], LENGTH_SCALE)
                y = enc[4].cpu().numpy()
                mel, mask = gl_engine.decode_launch(enc, y, None, 1, noise_scale=0.0)
                frames = int(y[0])
                target = dspmel.linear_from_mel(postprocess(mel, mask, gl_engine.audio_settings),
                                                gl_engine._gl_basis, 1000.0)[:, :, : frames - 1]
            gen = torch.Generator().manual_seed(11)
            phase = (2 * np.pi * torch.rand(target.shape, generator=gen)).cuda()
            start_signal = dsp.inverse_magnitude_phase(target, phase)[0]
            sc = spectral_convergence(gl_audio.astype(np.float32), target[0])
            sc0 = spectral_convergence(start_signal, target[0])
            # random weights give magnitudes that no signal has exactly (on the
            # CPU test voice 60 iterations go from 0.70 to 0.52): the bar is
            # that Griffin-Lim got a good part of the way
            if gl_audio.shape != ((frames - 1) * 256 + 1024,) or not sc < GL_PROGRESS * sc0:
                raise AssertionError(f"server /api/tts griffin_lim: {gl_audio.shape}, spectral "
                                     f"convergence {sc} against {sc0} at its random start")
            out["griffin_lim spectral convergence"] = sc
            log(f"server /api/tts?vocoder=griffin_lim, pangram (spec_gain 20 voice): "
                f"{gl_audio.shape[0]} samples, spectral convergence {sc:.4f} against the target "
                f"magnitudes ({sc0:.4f} from a random phase; bar: under {GL_PROGRESS} of it)")

            # Griffin-Lim CUDA against CPU at one injected phase, 60 Fast-GL iterations
            gl = lambda mag, ph: dsp.griffin_lim(mag, None, 1024, 256, 60,  # noqa: E731
                                                 initial_phase=ph, momentum=0.99)
            with torch.inference_mode():
                gl_cuda, t_gl = timed(lambda: gl(target, phase))
                gl_cpu = gl(target.cpu(), phase.cpu())
            sc_cuda = spectral_convergence(gl_cuda[0], target[0])
            sc_cpu = spectral_convergence(gl_cpu[0], target[0])
            corr = correlation(gl_cuda.cpu(), gl_cpu)
            if not abs(sc_cuda - sc_cpu) <= 0.01 * sc_cpu or not corr > 0.99:
                raise AssertionError(f"griffin_lim CUDA vs CPU: spectral convergence {sc_cuda} "
                                     f"vs {sc_cpu}, correlation {corr}")
            gl_rtf = t_gl / 1e3 / (gl_cuda.shape[-1] / 22050)
            out["griffin_lim rtf"] = gl_rtf
            out["ms"]["griffin_lim 60 iterations"] = t_gl
            log(f"griffin_lim CUDA vs CPU, pangram magnitudes [513, {frames - 1}], injected "
                f"phase, momentum 0.99, 60 iterations: spectral convergence {sc_cuda:.6f} vs "
                f"{sc_cpu:.6f} (tol 1% relative), correlation {corr:.6f} (tol > 0.99); CUDA "
                f"{t_gl:.3f} ms, RTF {gl_rtf:.6f}")

            # the scheduler through the server: eight concurrent requests
            before = json.loads(server.body("/api/stats"))
            mrf_block.mrf_section.launches = 0
            flow_wn_start()
            calls = engine.generator_calls
            barrier = threading.Barrier(len(SHORT_SENTENCES))
            results = {}

            def request(i):
                barrier.wait()
                results[i] = server.wav("/api/tts", voice=VOICE, text=SHORT_SENTENCES[i])

            threads = [threading.Thread(target=request, args=(i,))
                       for i in range(len(SHORT_SENTENCES))]
            start = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - start
            stats = json.loads(server.body("/api/stats"))
            n_launch, calls = mrf_block.mrf_section.launches, engine.generator_calls - calls
            flow_wn_read("server, 8 concurrent /api/tts")
            batches = stats["batches_run"] - before["batches_run"]
            sentences = stats["sentences_run"] - before["sentences_run"]
            if len(results) != 8 or sentences != 8 or not batches < 8 or \
                    n_launch != per_call * calls:
                raise AssertionError(f"server, 8 concurrent requests: {len(results)} results, "
                                     f"{sentences} sentences in {batches} batches, {n_launch} "
                                     f"MRF launches for {calls} generator calls")
            out["launches"]["server, 8 concurrent /api/tts"] = n_launch
            out["ms"]["server 8 concurrent /api/tts"] = 1e3 * wall
            log(f"server, 8 concurrent /api/tts from threads: {sentences} sentences in "
                f"{batches} batches (/api/stats), {calls} generator calls, MRF launches "
                f"{n_launch}, wall {1e3 * wall:.3f} ms; engines {sorted(stats['engines'])}")

            for path, params in (("/api/voices", {}), ("/api/vocoders", {}),
                                 ("/api/phonemes", {"language": "en-us"}),
                                 ("/openapi/swagger.json", {})):
                json.loads(server.body(path, **params))
            log("server /api/voices, /api/vocoders, /api/phonemes, /openapi/swagger.json: 200")

            # the per-model surfaces against the engine, on the pangram's mel
            job = larynx_tpu_torch._build_jobs(PANGRAM, VOICE, "high", custom_voices_dir=root,
                                               no_download=True)[0]
            hifi = job["vocoder_model"]
            with torch.inference_mode():
                enc, _g = engine.encode_launch([job["ids"]], LENGTH_SCALE)
                y = enc[4].cpu().numpy()
                mel, mask = engine.decode_launch(enc, y, None, 1, noise_scale=0.0)
                frames = int(y[0])
                mel_np = postprocess(mel, mask, engine.audio_settings)[:, :, :frames].cpu().numpy()
            hifi.maybe_init_denoiser("cuda")  # its bias: one generator call, built once
            rows = {}
            for d in (0.0, strength):
                parts = engine.vocode_launch(mel, mask, 1, d, y_lengths=y)
                want = engine.crop_rows(engine.vocode_collect(parts, 1), y, 1, d)[0]
                mrf_block.mrf_section.launches = 0
                got = hifi.mels_to_audio(mel_np, settings={"denoiser_strength": d},
                                         device="cuda")
                n_launch = mrf_block.mrf_section.launches
                # with the denoiser the engine's STFT runs past the mel's end
                # and the model's stops there: samples from frames that both
                # computed, the first (n - 1) hops
                common = dsp.num_frames(frames * 256, 1024, 256) * 256 if d else want.shape[0]
                if got.shape != want.shape or lsb(got[:common], want[:common]) > \
                        AUDIO_TOLERANCE_LSB or n_launch != per_call:
                    raise AssertionError(f"HiFiGanVocoder.mels_to_audio (denoiser {d}): "
                                         f"{got.shape} vs {want.shape}, {n_launch} launches")
                rows[d] = lsb(got[:common], want[:common])
            out["launches"]["HiFiGanVocoder.mels_to_audio, one sentence"] = n_launch
            log(f"HiFiGanVocoder.mels_to_audio, {frames} frames: from the engine's audio "
                f"{rows[0.0]} LSB, with the denoiser {rows[strength]} LSB over the first "
                f"{common} samples (tol {AUDIO_TOLERANCE_LSB}), MRF launches {n_launch}")

            wg_jobs = larynx_tpu_torch._build_jobs(PANGRAM, VOICE, voc, custom_voices_dir=root,
                                                   no_download=True)
            waveglow = wg_jobs[0]["vocoder_model"]
            wg_sigma0 = larynx_tpu_torch._get_engine(wg_jobs[0]["tts_model"], waveglow,
                                                     torch.device("cuda"))
            parts = wg_sigma0.vocode_launch(mel, mask, 1, 0.0, y_lengths=y)
            want = wg_sigma0.crop_rows(wg_sigma0.vocode_collect(parts, 1), y, 1, 0.0)[0]
            wn_layer.fused_wn_layer_state.launches = 0
            got = waveglow.mels_to_audio(mel_np, settings={"denoiser_strength": 0.0},
                                         device="cuda")
            n_wn = wn_layer.fused_wn_layer_state.launches
            if got.shape != want.shape or lsb(got, want) > AUDIO_TOLERANCE_LSB or n_wn != 96:
                raise AssertionError(f"WaveGlowVocoder.mels_to_audio: {got.shape} vs "
                                     f"{want.shape}, {n_wn} WN launches")
            out["launches"]["WaveGlowVocoder.mels_to_audio, one sentence"] = n_wn
            bucketed = got
            area = engine_module.MAX_VOCODE_AREA
            engine_module.MAX_VOCODE_AREA = 1024  # a 256-frame cap, as the env var would set
            try:
                wn_layer.fused_wn_layer_state.launches = 0
                chunked = waveglow.mels_to_audio(mel_np, settings={"denoiser_strength": 0.0},
                                                 device="cuda")
                n_chunked = wn_layer.fused_wn_layer_state.launches
            finally:
                engine_module.MAX_VOCODE_AREA = area
            wg_halo = waveglow._halo_frames()
            n_chunks = -(-frames // 256)
            inner = slice(0, (frames - wg_halo) * 256)  # the utterance's end: other buckets
            if n_chunks < 2 or chunked.shape != bucketed.shape or \
                    lsb(chunked[inner], bucketed[inner]) > AUDIO_TOLERANCE_LSB or \
                    n_chunked != 96 * n_chunks:
                raise AssertionError(f"WaveGlowVocoder.mels_to_audio chunked: {n_chunks} chunks, "
                                     f"{chunked.shape}, {n_chunked} WN launches")
            out["launches"]["WaveGlowVocoder.mels_to_audio, chunked"] = n_chunked
            log(f"WaveGlowVocoder.mels_to_audio (sigma 0), {frames} frames: from the engine's "
                f"audio {lsb(got, want)} LSB (tol {AUDIO_TOLERANCE_LSB}), WN launches {n_wn}; "
                f"chunked at a 256-frame cap ({n_chunks} chunks, halo {wg_halo} frames) against "
                f"the bucketed call {lsb(chunked[inner], bucketed[inner])} LSB over its first "
                f"{inner.stop} samples, WN launches {n_chunked}")

        # the server at the CUDA default (bf16 vocoder) against the library
        pin_precision(None)
        try:
            server.wav("/api/tts", voice=VOICE, text=PANGRAM)
            library(PANGRAM)
            walls = {"server": [], "library": []}
            for _ in range(3):
                torch.cuda.synchronize()
                start = time.perf_counter()
                got = server.wav("/api/tts", voice=VOICE, text=PANGRAM)
                walls["server"].append(time.perf_counter() - start)
                start = time.perf_counter()
                want = library(PANGRAM)
                walls["library"].append(time.perf_counter() - start)
            if lsb(got, want) != 0:
                raise AssertionError(f"server /api/tts bf16: {lsb(got, want)} LSB from the library")
        finally:
            pin_precision("f32")
        out["ms"]["server /api/tts bf16"] = 1e3 * float(np.mean(walls["server"]))
        out["ms"]["library text_to_speech bf16"] = 1e3 * float(np.mean(walls["library"]))
        log(f"server /api/tts at the CUDA default (bf16 vocoder), pangram: "
            f"{out['ms']['server /api/tts bf16']:.3f} ms wall per request against the library "
            f"call's {out['ms']['library text_to_speech bf16']:.3f} ms (mean of 3), 0 LSB")
    finally:
        server.close()

    out["daemon"] = daemon_path(root, PANGRAM, quiet, strength, mary)
    log(f"server: mrf_section shapes (C, B, T) {sorted(mrf_shapes)}, wn_layer shapes (B, T) "
        f"{sorted(wn_shapes)}")
    return out


def urllib_form(**fields) -> bytes:
    import urllib.parse

    return urllib.parse.urlencode(fields).encode()


def daemon_path(root: Path, text, quiet, strength, served) -> str:
    """The CLI's --daemon from the checkout root as a subprocess: it starts
    the port's server on the card, returns a WAV equal to the in-process
    server's ``served`` audio, and --stop-daemon stops it."""
    import io

    from larynx_tpu_torch.io import wavfile

    here = Path(__file__).resolve().parent
    port = free_port()
    env = dict(os.environ, XDG_RUNTIME_DIR=str(root / "runtime"))
    pidfile = root / "runtime" / "larynx" / "torch_daemon.pidfile"
    argv = [sys.executable, "-m", "larynx_tpu_torch", text, "--daemon", "--daemon-port",
            str(port), "--voices-dir", str(root), "--device", "cuda", "--voice", VOICE,
            "--quality", "high", "--noise-scale", str(quiet["noise_scale"]), "--length-scale",
            str(quiet["length_scale"]), "--denoiser-strength", str(strength)]
    pid = None
    try:
        start = time.perf_counter()
        proc = subprocess.run(argv, cwd=here, env=env, capture_output=True, timeout=600)
        wall = time.perf_counter() - start
        if proc.returncode != 0:
            raise AssertionError(f"cli --daemon: exit {proc.returncode}\n"
                                 f"{proc.stderr.decode()[-3000:]}")
        pid = int(pidfile.read_text())
        rate, audio = wavfile.read(io.BytesIO(proc.stdout))
        if rate != 22050 or audio.shape != served.shape or lsb(audio, served) != 0:
            raise AssertionError(f"cli --daemon: {rate} Hz, {audio.shape} vs the in-process "
                                 f"server's {served.shape}")
        start = time.perf_counter()
        again = subprocess.run(argv, cwd=here, env=env, capture_output=True, timeout=600)
        reuse = time.perf_counter() - start
        if again.returncode != 0 or again.stdout != proc.stdout or int(pidfile.read_text()) != pid:
            raise AssertionError("cli --daemon: a second call did not reuse the daemon")
    finally:
        stop = subprocess.run([sys.executable, "-m", "larynx_tpu_torch", "--stop-daemon"],
                              cwd=here, env=env, capture_output=True, timeout=120)
    deadline = time.monotonic() + 30
    while pid is not None and pid_running(pid) and time.monotonic() < deadline:
        time.sleep(0.2)
    if stop.returncode != 0 or pidfile.exists() or (pid is not None and pid_running(pid)):
        raise AssertionError(f"cli --stop-daemon: exit {stop.returncode}, pidfile "
                             f"{pidfile.exists()}, daemon {pid} running")
    msg = (f"cli --daemon --device cuda (subprocess): the daemon (pid {pid}) answered with "
           f"{audio.shape[0]} samples, 0 LSB from the in-process server's /process audio; "
           f"first call {wall:.2f} s (server start, model load, synthesis), second call "
           f"{reuse:.2f} s on the same daemon; --stop-daemon stopped it, pidfile removed")
    log(msg)
    return msg


def tacotron2_state_dict(tree) -> dict:
    """The NVIDIA/tacotron2 state dict whose conversion
    (``convert/torch_import.py::tacotron2_params_from_state_dict``) is the
    native ``tree``: the converter's names and layouts, inverted.  Each LSTM
    keeps its fused bias as ``bias_ih`` beside a zero ``bias_hh``."""
    sd = {}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def linear(prefix, p):
        sd[f"{prefix}.weight"] = tensor(np.asarray(p["w"]).T)
        if "b" in p:
            sd[f"{prefix}.bias"] = tensor(p["b"])

    def lstm(prefix, p, suffix=""):
        sd[f"{prefix}.weight_ih{suffix}"] = tensor(np.asarray(p["w_ih"]).T)
        sd[f"{prefix}.weight_hh{suffix}"] = tensor(np.asarray(p["w_hh"]).T)
        sd[f"{prefix}.bias_ih{suffix}"] = tensor(p["b"])
        sd[f"{prefix}.bias_hh{suffix}"] = tensor(np.zeros_like(p["b"]))

    def conv_bn(prefix, p):
        sd[f"{prefix}.0.conv.weight"] = tensor(np.transpose(p["w"], (2, 1, 0)))
        sd[f"{prefix}.0.conv.bias"] = tensor(p["b"])
        for name, key in (("weight", "gamma"), ("bias", "beta"), ("running_mean", "mean"),
                          ("running_var", "var")):
            sd[f"{prefix}.1.{name}"] = tensor(p["bn"][key])

    sd["embedding.weight"] = tensor(tree["embedding"])
    for i, conv in enumerate(tree["encoder"]["convs"]):
        conv_bn(f"encoder.convolutions.{i}", conv)
    lstm("encoder.lstm", tree["encoder"]["lstm_fw"], "_l0")
    lstm("encoder.lstm", tree["encoder"]["lstm_bw"], "_l0_reverse")
    dec = tree["decoder"]
    for i, layer in enumerate(dec["prenet"]):
        linear(f"decoder.prenet.layers.{i}.linear_layer", layer)
    lstm("decoder.attention_rnn", dec["attention_rnn"])
    att, ap = dec["attention"], "decoder.attention_layer"
    for key, module in (("query", "query_layer"), ("memory", "memory_layer"), ("v", "v")):
        linear(f"{ap}.{module}.linear_layer", att[key])
    sd[f"{ap}.location_layer.location_conv.conv.weight"] = tensor(
        np.transpose(att["location_conv"], (2, 1, 0)))
    linear(f"{ap}.location_layer.location_dense.linear_layer", att["location_dense"])
    lstm("decoder.decoder_rnn", dec["decoder_rnn"])
    linear("decoder.linear_projection.linear_layer", dec["projection"])
    linear("decoder.gate_layer.linear_layer", dec["gate"])
    for i, conv in enumerate(tree["postnet"]["convs"]):
        conv_bn(f"postnet.convolutions.{i}", conv)
    return sd


def hifi_gan_state_dict(tree) -> dict:
    """The HiFi-GAN Generator state dict whose conversion
    (``convert/torch_import.py::hifi_gan_params_from_state_dict``) is the
    native ``tree``."""
    sd = {}

    def conv(prefix, p, perm=(2, 1, 0)):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(p["w"], perm)))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.ascontiguousarray(p["b"]))

    conv("conv_pre", tree["conv_pre"])
    for i, up in enumerate(tree["ups"]):  # ConvTranspose1d weights are [C_in, C_out, k]
        conv(f"ups.{i}", up, perm=(1, 2, 0))
    for i, block in enumerate(tree["resblocks"]):
        for name, convs in block.items():
            for j, p in enumerate(convs):
                conv(f"resblocks.{i}.{name}.{j}", p)
    conv("conv_post", tree["conv_post"])
    return sd


def stage_tacotron2_voices(root: Path):
    """Phase 13's voices beside stage_voices' ones: ``T2_VOICE`` (Tacotron2Config's
    defaults, random weights from ``T2_SEED``, gate bias ``T2_GATE_BIAS``) with
    a ``generator.npz``, and the same weights as NVIDIA-named ``generator.pth``
    files of that voice and of universal_large, in dirs of their own."""
    import dataclasses
    import shutil

    from larynx_tpu_torch.convert.native import load_params, save_params
    from larynx_tpu_torch.models.tacotron2 import Tacotron2Config
    from larynx_tpu_torch.weights import init_params

    cfg = Tacotron2Config()
    tree = init_params(torch.Generator().manual_seed(T2_SEED), cfg)
    tree["decoder"]["gate"]["b"][:] = T2_GATE_BIAS
    config = json.dumps({"audio": AUDIO, "model": dataclasses.asdict(cfg)})
    phonemes = "".join(f"{i} {p}\n" for i, p in enumerate(PHONEMES))
    for name, write in (("harvard-tacotron2", lambda d: save_params(d / "generator.npz", tree)),
                        ("harvard_pth-tacotron2", lambda d: torch.save(
                            {"state_dict": tacotron2_state_dict(tree), "iteration": 0},
                            d / "generator.pth"))):
        voice_dir = root / "en-us" / name
        voice_dir.mkdir(parents=True)
        (voice_dir / "config.json").write_text(config)
        (voice_dir / "phonemes.txt").write_text(phonemes)
        write(voice_dir)
    voc_dir = root / "hifi_gan" / "universal_large"
    pth_dir = root / "hifi_gan" / "universal_large_pth"
    pth_dir.mkdir(parents=True)
    shutil.copy(voc_dir / "config.json", pth_dir / "config.json")
    torch.save({"generator": hifi_gan_state_dict(load_params(voc_dir / "generator.npz"))},
               pth_dir / "generator.pth")


def tacotron2_path(root: Path, mrf_block, wn_layer, mrf_shapes: set, wn_shapes: set):
    """Phase 13, float32: a Tacotron2 voice at full width through
    ``text_to_speech`` (HiFi-GAN universal_large and WaveGlow) and
    ``/api/tts``, both through the engine's autoregressive batch path
    (``runtime/tacotron2_engine.py``: one vocoder group call a sentence), and
    the stream through the unfused fallback (one chunk, the same audio); the
    engine's blocked decode alone, its time and launches per step and the
    card's busy share over it; the CUDA path against the CPU path under the
    same prenet keep masks (dropout on, p = 0.5); the same weights from
    NVIDIA-named ``.pth`` files.  Adds the shapes that the CUDA runs give the
    kernels to ``mrf_shapes`` and ``wn_shapes``; returns launches and
    measurements."""
    import collections

    import re

    import larynx_tpu_torch
    from larynx_tpu_torch.models.tacotron2 import model as t2_model
    from larynx_tpu_torch.ops import tacotron2_step
    from larynx_tpu_torch.runtime import trace as port_trace
    from larynx_tpu_torch.server.app import ServerSettings
    from larynx_tpu_torch.tacotron2 import _DEFAULT_SEED, _MAX_FRAMES_PER_TOKEN, text_bucket

    cuda = torch.device("cuda")
    out = {"launches": {}, "ms": {}}
    kwargs = dict(voice_or_lang=T2_VOICE, custom_voices_dir=root, no_download=True)
    job = larynx_tpu_torch._build_jobs(PANGRAM, T2_VOICE, "high", custom_voices_dir=root,
                                       no_download=True)[0]
    model, vocoder, ids = job["tts_model"], job["vocoder_model"], job["ids"]
    cfg = model.model_config
    t_bucket = text_bucket(len(ids))
    steps = min(cfg.max_decoder_steps, _MAX_FRAMES_PER_TOKEN * t_bucket)
    n_samples = steps * 256
    per_call = mrf_launches_per_call(vocoder.model_config)

    def tts(text=PANGRAM, device="cuda", **extra):
        return [r.audio for r in larynx_tpu_torch.text_to_speech(text, device=device,
                                                                 **dict(kwargs, **extra))]

    def check_audio(audio, label):
        if audio.dtype != np.int16 or audio.shape != (n_samples,):
            raise AssertionError(f"tacotron2 {label}: audio {audio.dtype} {audio.shape}, "
                                 f"expected ({n_samples},): no gate fires")
        if np.abs(audio.astype(np.int32)).max() < 1000 or audio.astype(np.float64).std() < 10:
            raise AssertionError(f"tacotron2 {label}: silent audio")

    with recording_mrf_shapes(mrf_shapes), recording_wn_shapes(wn_shapes):
        tts()  # warm-up: cuDNN plans, the voice's params on the card
        mrf_block.mrf_section.launches = 0
        tacotron2_step.decode_steps.launches = 0
        counted = dict(port_trace.counters())
        (audio,), wall = timed_once(tts)
        n_mrf = mrf_block.mrf_section.launches
        n_step = tacotron2_step.decode_steps.launches
        moved = {k: port_trace.counters().get(k, 0) - counted.get(k, 0)
                 for k in ("engine.ar_steps", "engine.ar_kernel_steps", "engine.ar_stop_checks")}
        check_audio(audio, "text_to_speech")
        if n_mrf != per_call:
            raise AssertionError(f"tacotron2 text_to_speech: {n_mrf} MRF launches, "
                                 f"expected {per_call}")
        # the engine's decode: one step kernel launch a block (a stop read),
        # every step in the kernel
        if not (moved["engine.ar_steps"] == moved["engine.ar_kernel_steps"] == steps
                and n_step == moved["engine.ar_stop_checks"] > 0):
            raise AssertionError(f"tacotron2 text_to_speech: {n_step} step kernel launches and "
                                 f"counters {moved}, expected {steps} steps in the kernel and "
                                 "a launch a stop read")
        out["launches"]["tacotron2 text_to_speech, pangram"] = n_mrf
        out["launches"]["tacotron2 text_to_speech, pangram, step kernel"] = n_step
        out["engine_decode"] = {"steps": steps, "step_kernel_launches": n_step,
                                "blocks": moved["engine.ar_stop_checks"],
                                "kernel_steps": moved["engine.ar_kernel_steps"]}
        mels, t_acoustic = timed_once(lambda: model.phonemes_to_mels(ids, device="cuda"))
        if mels.shape != (1, cfg.mel_channels, steps) or not np.isfinite(mels).all():
            raise AssertionError(f"tacotron2 phonemes_to_mels: {mels.shape}")
        settings = job["audio_settings"]
        mels_pp = settings.dynamic_range_compression(settings.db_to_amp(settings.denormalize(mels)))
        _, t_vocode = timed_once(lambda: vocoder.mels_to_audio(mels_pp, device="cuda"))
        out["ms"].update({"tacotron2 text_to_speech": wall, "tacotron2 phonemes_to_mels":
                          t_acoustic, "tacotron2 HiFi-GAN mels_to_audio": t_vocode})
        log(f"tacotron2 text_to_speech, pangram ({len(ids)} ids, text bucket {t_bucket}, "
            f"{steps} decoder steps, {n_samples / 22050:.2f} s of audio), HiFi-GAN "
            f"universal_large, f32: wall {wall:.3f} ms, RTF {wall / 1e3 / (n_samples / 22050):.6f}; "
            f"phonemes_to_mels {t_acoustic:.3f} ms, mels_to_audio {t_vocode:.3f} ms; MRF launches "
            f"{n_mrf}; the engine's decode: {n_step} step kernel launches for "
            f"{moved['engine.ar_stop_checks']} blocks, {moved['engine.ar_kernel_steps']} of "
            f"{moved['engine.ar_steps']} steps in the kernel")

        # the engine's blocked decode alone (its stops read once a block), on
        # the voice's device params and the engine's masks for a row of a call
        # without seeds
        params = model._device_params.get(cuda, torch.float32)
        ids_t = torch.zeros((1, t_bucket), dtype=torch.long)
        ids_t[0, : len(ids)] = torch.from_numpy(ids)
        len_t = torch.tensor([len(ids)], dtype=torch.int32)
        keep = t2_model.draw_keep_masks(cfg, steps, 1, _DEFAULT_SEED)  # the model's masks

        def decode():
            return t2_model.decode_blocked(params, cfg, memory, mask, np.array([steps]),
                                           keep.cuda())

        with torch.inference_mode():
            (memory, mask), t_encode = timed_once(
                lambda: t2_model.encode(params, cfg, ids_t.cuda(), len_t.cuda()))
            decode()
            tacotron2_step.decode_steps.launches = 0
            (mel_gpu, lengths, _steps, blocks), t_decode = timed_once(decode)
            step_launches = tacotron2_step.decode_steps.launches
            _, t_postnet = timed_once(lambda: t2_model.postnet(params, cfg, mel_gpu))
            events, names = collections.Counter(), collections.Counter()
            _, traced, busy = device_busy_ms(decode, events, names)
        if lengths.tolist() != [steps]:
            raise AssertionError(f"tacotron2 decode: lengths {lengths.tolist()}, expected [{steps}]")
        # a block is one step kernel launch: in the trace, the step kernel once
        # a block, no cuBLAS kernel but the memory's projection (once a
        # decode), and the stop's few elementwise kernels a block, not a step
        traced_steps = sum(v for k, v in names.items() if "steps_kernel" in k)
        cublas = sum(v for k, v in names.items() if re.search("gemm|gemv|xmma", k))
        others = events["kernel"] - traced_steps
        if not (step_launches == blocks == traced_steps and cublas <= 1
                and others <= 20 * blocks):
            raise AssertionError(f"tacotron2 decode: {step_launches} step kernel launches, "
                                 f"{traced_steps} traced, {cublas} cuBLAS and {others} other "
                                 f"kernels for {blocks} blocks of {steps} steps")
        busy_share = None if busy is None else busy / traced
        out["ms"].update({"tacotron2 encode": t_encode, "tacotron2 decode": t_decode,
                          "tacotron2 decode per step": t_decode / steps,
                          "tacotron2 postnet": t_postnet})
        out["decode"] = {"steps": steps, "blocks": blocks, "ms": t_decode, "traced_ms": traced,
                         "busy_ms": busy, "kernels": events["kernel"],
                         "step_kernel_launches": step_launches,
                         "step_kernels_traced": traced_steps, "cublas_kernels": cublas,
                         "memcpy": events["gpu_memcpy"], "memset": events["gpu_memset"],
                         "host_syncs": events["host_sync"]}
        log(f"tacotron2 encode (B=1, T={t_bucket}, BiLSTM step by step) {t_encode:.3f} ms, "
            f"postnet {t_postnet:.3f} ms (host clock)")
        log(f"tacotron2 blocked decode, {steps} steps ({blocks} stop reads), B=1, "
            f"T={t_bucket}: {t_decode:.3f} ms "
            f"({t_decode / steps:.4f} ms per step, host clock); traced {traced:.3f} ms, the card "
            f"busy {busy if busy is None else round(busy, 3)} ms "
            f"({'not measured' if busy_share is None else f'{busy_share:.1%}'}); "
            f"{events['kernel']} kernel launches ({events['kernel'] / steps:.1f} per step): "
            f"the step kernel {traced_steps} ({step_launches} launches by the wrapper), cuBLAS "
            f"{cublas}, {others} others ({others / blocks:.1f} a block); "
            f"{events['gpu_memcpy']} copies, {events['gpu_memset']} memsets, "
            f"{events['host_sync']} host waits for the card (the trace's closing one included)")

        # WaveGlow through the engine: one group call of the 1000-frame mel
        tts(vocoder_or_quality="waveglow")
        wn_layer.fused_wn_layer_state.launches = 0
        (wg_audio,), t_wg = timed_once(lambda: tts(vocoder_or_quality="waveglow"))
        n_wn = wn_layer.fused_wn_layer_state.launches
        check_audio(wg_audio, "waveglow")
        wg_cfg = larynx_tpu_torch.get_vocoder_model("waveglow", custom_voices_dir=root,
                                                    no_download=True).model_config
        if n_wn != wg_cfg.flows * wg_cfg.wn_layers:  # one group call of the 1000-frame mel
            raise AssertionError(f"tacotron2 waveglow: {n_wn} WN launches, expected "
                                 f"{wg_cfg.flows * wg_cfg.wn_layers}")
        out["launches"]["tacotron2 text_to_speech, pangram, waveglow"] = n_wn
        out["ms"]["tacotron2 text_to_speech waveglow"] = t_wg
        log(f"tacotron2 text_to_speech, pangram, WaveGlow wn_256: wall {t_wg:.3f} ms, WN launches "
            f"{n_wn}")

        # the stream: one chunk per sentence through the fallback
        mrf_block.mrf_section.launches = 0
        chunks, t_stream = timed_once(lambda: list(larynx_tpu_torch.stream_text_to_speech(
            PANGRAM, device="cuda", **kwargs)))
        n_stream = mrf_block.mrf_section.launches
        if len(chunks) != 1 or lsb(chunks[0], audio) > AUDIO_TOLERANCE_LSB or n_stream != per_call:
            raise AssertionError(f"tacotron2 stream: {len(chunks)} chunks, {n_stream} MRF "
                                 "launches, or not the text_to_speech audio")
        out["launches"]["tacotron2 stream_text_to_speech, pangram"] = n_stream
        out["ms"]["tacotron2 stream"] = t_stream
        log(f"tacotron2 stream_text_to_speech: 1 chunk in {t_stream:.3f} ms, "
            f"{lsb(chunks[0], audio)} LSB from text_to_speech, MRF launches {n_stream}")

        # one /api/tts request
        server = ServedApp(ServerSettings(voices_dir=str(root), quality="high",
                                          denoiser_strength=0.0, device="cuda"))
        try:
            server.wav("/api/tts", voice=T2_VOICE, text=PANGRAM)
            mrf_block.mrf_section.launches = 0
            served, t_served = timed_once(lambda: server.wav("/api/tts", voice=T2_VOICE,
                                                             text=PANGRAM))
            n_served = mrf_block.mrf_section.launches
        finally:
            server.close()
        if served.shape != audio.shape or lsb(served, audio) > AUDIO_TOLERANCE_LSB or \
                n_served != per_call:
            raise AssertionError(f"tacotron2 /api/tts: {served.shape}, {n_served} MRF launches")
        out["launches"]["tacotron2 server /api/tts"] = n_served
        out["ms"]["tacotron2 server /api/tts"] = t_served
        log(f"tacotron2 server /api/tts: {t_served:.3f} ms, {lsb(served, audio)} LSB from "
            f"text_to_speech, MRF launches {n_served}")

        # the same weights from NVIDIA-named .pth files, backend "pytorch"
        pth = larynx_tpu_torch.get_tts_model("en-us_harvard_pth-tacotron2", backend="pytorch",
                                              custom_voices_dir=root, no_download=True)
        pth_voc = larynx_tpu_torch.get_vocoder_model("hifi_gan/universal_large_pth",
                                                     backend="pytorch", custom_voices_dir=root,
                                                     no_download=True)
        for label, a, b in (("tacotron2", pth.params, model.params),
                            ("universal_large", pth_voc.params, vocoder.params)):
            flat_a, flat_b = dict(flat_tree(a)), dict(flat_tree(b))
            if flat_a.keys() != flat_b.keys() or not all(
                    torch.equal(flat_a[k], flat_b[k]) for k in flat_a):
                raise AssertionError(f"{label} from generator.pth: another tree than the .npz's")
        prior = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            (pth_audio,) = tts(voice_or_lang="en-us_harvard_pth-tacotron2", backend="pytorch",
                               vocoder_or_quality="hifi_gan/universal_large_pth")
            (npz_audio,) = tts()
        finally:
            torch.backends.cudnn.deterministic = prior
        if pth_audio.shape != npz_audio.shape or lsb(pth_audio, npz_audio) != 0:
            raise AssertionError("tacotron2 .pth voice: not the .npz voice's audio")
        log(f"checkpoint import: Tacotron2 ({len(flat_tree(model.params))} tensors) and "
            f"universal_large ({len(flat_tree(vocoder.params))}) from NVIDIA/HiFi-GAN-named "
            f"generator.pth files equal the .npz trees; the .pth voice's audio is 0 LSB from the "
            f".npz voice's")

    # CUDA against the CPU path under the same keep masks: one step from
    # identical states, then the whole decode and the audio
    cpu_params = model.params
    memory_cpu, mask_cpu = memory.cpu(), mask.cpu()
    processed = torch.nn.functional.linear(memory_cpu,
                                           cpu_params["decoder"]["attention"]["memory"]["w"])
    gen = torch.Generator().manual_seed(T2_SEED + 1)
    state = {k: torch.randn(v.shape, generator=gen) * (0.1 if k.startswith("attn_w") else 0.5)
             for k, v in t2_model._decoder_state0(cfg, 1, t_bucket, memory_cpu).items()}
    pre = torch.relu(torch.randn((1, cfg.prenet_dim), generator=gen))
    with torch.inference_mode():
        step_gpu = t2_model._decoder_step(params, cfg, {k: v.cuda() for k, v in state.items()},
                                          pre.cuda(), memory, processed.cuda(), mask)
        step_cpu = t2_model._decoder_step(cpu_params, cfg, state, pre, memory_cpu, processed,
                                          mask_cpu)
    step_err = max(float((a.cpu() - b).abs().max()) for a, b in
                   zip([*step_gpu[0].values(), *step_gpu[1:]], [*step_cpu[0].values(), *step_cpu[1:]]))
    if not step_err <= T2_STEP_TOLERANCE:
        raise AssertionError(f"tacotron2 _decoder_step CUDA vs CPU: {step_err:.3g} "
                             f"(tol {T2_STEP_TOLERANCE})")
    start = time.perf_counter()
    with torch.inference_mode():
        mel_cpu, lengths_cpu, _steps, _blocks = t2_model.decode_blocked(
            cpu_params, cfg, *t2_model.encode(cpu_params, cfg, ids_t, len_t), np.array([steps]),
            keep)
        t_cpu_decode = 1e3 * (time.perf_counter() - start)
        post_cpu = (mel_cpu + t2_model.postnet(cpu_params, cfg, mel_cpu)).transpose(1, 2)
    err = (mel_gpu.cpu() - mel_cpu).abs()[0].amax(dim=-1)  # [steps]
    per_100 = [float(err[i : i + 100].max()) for i in range(0, steps, 100)]
    scale = float(mel_cpu.abs().max())
    if lengths_cpu.tolist() != [steps] or not max(per_100) <= T2_DECODE_TOLERANCE:
        raise AssertionError(f"tacotron2 decode CUDA vs CPU: largest error per 100 steps "
                             f"{per_100} (tol {T2_DECODE_TOLERANCE})")
    # the CPU mel through the fallback's chain and the vocoder on the CPU,
    # against the CUDA text_to_speech audio (the same masks: the model's seed)
    post_pp = settings.dynamic_range_compression(settings.db_to_amp(settings.denormalize(
        post_cpu.numpy())))
    cpu_audio, t_cpu = timed_once(lambda: vocoder.mels_to_audio(post_pp, device="cpu"))
    corr = correlation(audio, cpu_audio)
    if cpu_audio.shape != audio.shape or not corr > T2_AUDIO_CORRELATION:
        raise AssertionError(f"tacotron2 audio CUDA vs CPU: {cpu_audio.shape}, correlation {corr}")
    out["cuda_vs_cpu"] = {"step": step_err, "decode_per_100": per_100, "mel_scale": scale,
                          "audio_correlation": corr, "audio_lsb": lsb(audio, cpu_audio)}
    log(f"tacotron2 CUDA vs CPU (same keep masks, dropout p {cfg.p_prenet_dropout}): "
        f"_decoder_step {step_err:.3g} (tol {T2_STEP_TOLERANCE}); the {steps}-step decode's mel "
        f"(|mel| <= {scale:.4f}), largest error per 100 steps "
        f"{', '.join(f'{e:.3g}' for e in per_100)} (tol {T2_DECODE_TOLERANCE}; CPU decode "
        f"{t_cpu_decode / 1e3:.1f} s); audio correlation {corr:.6f} (bar {T2_AUDIO_CORRELATION}), "
        f"{lsb(audio, cpu_audio)} LSB (CPU vocode {t_cpu / 1e3:.1f} s)")
    return out


def t2_step_voice(seed: int = T2_SEED):
    """(cfg, packed params) of a Tacotron2 at NVIDIA's widths on the card,
    random weights from ``seed`` with the benchmark's projection
    (portbench/kinds/nvidia_tacotron2.py::calibrate) and a held-off gate."""
    from larynx_tpu_torch.models.tacotron2 import Tacotron2Config
    from larynx_tpu_torch.models.tacotron2 import model as t2_model
    from larynx_tpu_torch.weights import init_params, params_from_jax, tree_to

    cfg = Tacotron2Config()
    tree = init_params(torch.Generator().manual_seed(seed), cfg)
    tree["decoder"]["projection"]["w"] *= 30.0
    tree["decoder"]["projection"]["b"][:] = torch.linspace(-3.5, -7.5, cfg.mel_channels)
    tree["decoder"]["gate"]["b"][:] = T2_GATE_BIAS
    params = tree_to(params_from_jax(tree, "tacotron2"), torch.device("cuda"))
    return cfg, t2_model.pack_params(params, cfg)


def t2_step_batch(cfg, params, b: int, t: int, n: int, seed: int):
    """A decode's block on the card: the encoder's memory of b random rows at
    text bucket t (row 1 five ids short), the processed memory and mask, a
    random state and last frame, and the engine's per-row keep masks."""
    from larynx_tpu_torch.models.tacotron2 import model as t2_model

    gen = torch.Generator().manual_seed(seed)
    lengths = torch.full((b,), t, dtype=torch.int32)
    if b > 1:
        lengths[1] = t - 5
    ids = torch.randint(1, cfg.num_symbols, (b, t), generator=gen)
    memory, mask = t2_model.encode(params, cfg, ids.cuda(), lengths.cuda())
    processed = torch.nn.functional.linear(memory, params["decoder"]["attention"]["memory"]["w"])
    state = {k: (torch.randn(v.shape, generator=gen).abs() * 0.02 if k.startswith("attn_w")
                 else torch.randn(v.shape, generator=gen) * 0.5).cuda()
             for k, v in t2_model._decoder_state0(cfg, b, t, memory.cpu()).items()}
    prev = torch.randn((b, cfg.mel_channels), generator=gen).cuda() * 2.0 - 5.0
    keep = t2_model.row_keep_masks(cfg, n, [[seed, r] for r in range(b)]).cuda()
    return state, prev, memory, processed, mask, keep


def t2_step_rel_err(got, want) -> float:
    """The largest error of a block's outputs and state, each relative to
    the larger of 1 and its largest magnitude."""
    (sa, pa, ma, ga), (sb, pb, mb, gb) = got, want
    pairs = [(ma, mb), (ga, gb), (pa, pb)] + [(sa[k], sb[k]) for k in sb]
    return max(float((x - y).abs().max()) / max(1.0, float(y.abs().max())) for x, y in pairs)


def check_t2_step(shapes=T2_KERNEL_SHAPES, n: int = T2_KERNEL_STEPS):
    """The decoder step kernel at each (B, T): against its plain version
    (``T2_KERNEL_TOLERANCE``), bit for bit against itself and, in a batch,
    three of its rows decoded alone; a block's device time a step against
    the step's bound (portbench/counts/tacotron2.py), the plain version's,
    and the step's PyTorch ops replayed as a CUDA graph (cuBLAS: the decode
    before the kernel, ``library_ms``); the launches of a block (the
    wrapper's count; phase 13's traced decode names the kernels).  Times
    are per step; ``main_path`` marks t2wg_batch8's shapes."""
    import dataclasses

    from larynx_tpu_torch.models.tacotron2 import model as t2_model
    from larynx_tpu_torch.ops import tacotron2_step as ts
    from larynx_tpu_torch.runtime.glow_graphs import capture_cuda_graph
    from portbench.counts import tacotron2 as t2_counts

    cfg, params = t2_step_voice()
    packed = params["decoder"]["step_kernel"]
    counts_cfg = dataclasses.asdict(cfg)
    rows = []
    for b, t in shapes:
        with torch.inference_mode():
            state, prev, memory, processed, mask, keep = t2_step_batch(
                cfg, params, b, t, n, seed=1000 * b + t)
            geo = ts.geometry(packed, b, t)

            def kernel():
                return ts.decode_steps(packed, state, prev, memory, processed, mask, n, keep)

            def plain():
                return ts.decode_steps_plain(packed, state, prev, memory, processed, mask, n, keep)

            def library():
                st, pv = dict(state), prev
                for i in range(n):
                    pre = t2_model._prenet(params["decoder"]["prenet"], pv, keep[i],
                                           cfg.p_prenet_dropout)
                    st, pv, _gate = t2_model._decoder_step(params, cfg, st, pre, memory,
                                                          processed, mask)
                return (pv,)

            ts.decode_steps.launches = 0
            got = kernel()
            launched = ts.decode_steps.launches
            want = plain()
            err = t2_step_rel_err(got, want)
            if not err <= T2_KERNEL_TOLERANCE:
                raise AssertionError(f"tacotron2_step B={b} T={t}: {err:.3g} from the plain "
                                     f"version (tol {T2_KERNEL_TOLERANCE})")
            again = kernel()
            if not (all(torch.equal(x, y) for x, y in zip(got[1:], again[1:]))
                    and all(torch.equal(got[0][k], again[0][k]) for k in got[0])):
                raise AssertionError(f"tacotron2_step B={b} T={t}: two runs differ")
            for r in sorted({0, b // 2, b - 1}) if b > 1 else ():
                one = slice(r, r + 1)
                alone = ts.decode_steps(packed, {k: v[one].contiguous() for k, v in state.items()},
                                        prev[one].contiguous(), memory[one].contiguous(),
                                        processed[one].contiguous(), mask[one].contiguous(), n,
                                        keep[:, :, one].contiguous())
                if not (torch.equal(alone[2], got[2][one]) and torch.equal(alone[3], got[3][one])
                        and all(torch.equal(alone[0][k], got[0][k][one]) for k in got[0])):
                    raise AssertionError(f"tacotron2_step B={b} T={t}: row {r} alone differs "
                                         "from its batch row")
            graph, _out = capture_cuda_graph(library)
            ms = time_ms(kernel, iters=20) / n
            plain_ms = time_ms(plain, iters=3) / n
            library_ms = time_ms(graph.replay, iters=5) / n
        ops_ms = 1e3 * t2_counts.step_flops(counts_cfg, b, t) / t2_counts.F32_FLOPS
        bytes_ms = 1e3 * t2_counts.step_bytes(counts_cfg, b, t) / 3.35e12
        bound_ms = max(ops_ms, bytes_ms)
        rows.append({"name": f"decoder step, B={b}, T={t}", "B": b, "T": t, "steps": n,
                     "main_path": b == 8, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms, "ops_ms": ops_ms,
                     "bytes_ms": bytes_ms, "launches_per_block": launched, "geometry": geo})
        log(f"tacotron2_step B={b} T={t} ({geo['grid']} blocks x {geo['threads']}, "
            f"{geo['smem_bytes']} B shared, {geo['attn_parts']} context parts a row): "
            f"{1e3 * ms:.2f} us a step ({n}-step block), bound {1e3 * bound_ms:.2f} us "
            f"({bound_ms / ms:.1%}), plain {1e3 * plain_ms:.1f} us, cuBLAS graph "
            f"{1e3 * library_ms:.1f} us; error {err:.3g} (tol {T2_KERNEL_TOLERANCE}); "
            f"{launched} launch a block")
        if launched != -(-b // ts.MAX_ROWS):
            raise AssertionError(f"tacotron2_step: {launched} launches a block at B={b}")
    return rows


# Phase 14: training on the card.  The corpus: the chapter's 16 pangram rows
# through the port's own text_to_speech (harvard voice, universal_large) at
# six length scales, 96 wavs of up to ~900 frames (under the 1024-frame
# padding), all with the pangram's text
TRAIN_SCALES = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0)
TRAIN_VOICE = "en-us_trained-glow_tts"
TRAIN_VOCODER = "hifi_gan/trained"
# CUDA against the CPU path in float64 from the same params and batch, TF32
# off, cuDNN deterministic: float32 sums in other orders, ~1e-6 relative.
# Losses to 1e-5 relative; each GlowTTS gradient leaf to 1e-4 of its scale,
# the scale floored at 1e-4 of the net's largest gradient (a leaf whose true
# gradient is zero, as the attention's key bias, holds rounding noise only);
# a float64 run on the card to 1e-8
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# HiFi-GAN's float32 gradients: cuDNN's convolution algorithms (TF32 off)
# sit up to 2.0e-3 of a leaf's scale from float64 on the generator's
# resblock convs and 1e-3 on the discriminators (measured on an H100):
# sums of 8192 to 65536 terms that cancel; XLA's float32 CPU convs sit 1.3e-3
# from float64 on the same discriminators.  5e-3 bounds that; a layout or
# indexing fault moves a gradient by O(1) of its scale.  The float64 run on
# the card holds the port's code to float64 rounding
TRAIN_GAN_GRAD_RTOL = 5e-3
TRAIN_F64_RTOL = 1e-8
# the saved voice's reverse flow undoes its forward flow: float32 rounding
# through 12 blocks, with the recomputed weight_inv
FLOW_ROUND_TRIP = 1e-4


def stage_training_corpus(root: Path) -> Path:
    """96 wavs and an LJSpeech-style metadata.csv, written by the port's own
    text_to_speech on the card, and the harvard phoneme table."""
    import larynx_tpu_torch
    from larynx_tpu_torch.io import wavfile

    corpus = root / "train_corpus"
    (corpus / "wavs").mkdir(parents=True)
    rows = []
    for s_i, scale in enumerate(TRAIN_SCALES):
        results = larynx_tpu_torch.text_to_speech(
            BOOK, voice_or_lang=VOICE, vocoder_or_quality="high", custom_voices_dir=root,
            no_download=True, device="cuda", tts_settings={"length_scale": scale}, seed=s_i)
        for r_i, result in enumerate(results):
            name = f"pangram_{s_i}_{r_i:02d}"
            wavfile.write(corpus / "wavs" / f"{name}.wav", result.sample_rate, result.audio)
            rows.append(f"{name}|{result.text}")
    (corpus / "metadata.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    (corpus / "phonemes.txt").write_text("".join(f"{i} {p}\n" for i, p in enumerate(PHONEMES)))
    (corpus / "config.json").write_text(json.dumps({"audio": AUDIO, "model": {}}))
    return corpus


def grad_errors(got, want, floor_share=TRAIN_GRAD_RTOL):
    """{leaf path: max |got's .grad - want's .grad| as a share of the leaf's
    scale, max |want's .grad|, floored at ``floor_share`` of the net's
    largest gradient (a leaf whose true gradient is zero holds rounding
    noise only)}."""
    want_leaves = dict(flat_tree(want))
    floor = floor_share * max(g.grad.abs().max().item() for _, g in flat_tree(want)
                              if g.grad is not None)
    errors = {}
    for path, leaf in flat_tree(got):
        ref = want_leaves[path].grad
        if (leaf.grad is None) != (ref is None):
            raise AssertionError(f"{path}: a gradient on one side only")
        if ref is not None:
            ref = ref.double().cpu()
            scale = max(ref.abs().max().item(), floor)
            errors[path] = (leaf.grad.double().cpu() - ref).abs().max().item() / scale
    return errors


def against_float64(label, runs, f32_bound, floor_share=TRAIN_GRAD_RTOL):
    """Each run {name: (params with .grad, metrics)} against "CPU f64": the
    losses within TRAIN_LOSS_RTOL (float32) or TRAIN_F64_RTOL (CUDA f64),
    every gradient within ``f32_bound`` (CUDA f32) or TRAIN_F64_RTOL (CUDA
    f64) of its leaf's scale (``grad_errors`` with ``floor_share``); the
    CPU's float32 is reported.  Returns the largest gradient error of each
    run."""
    ref_params, ref_metrics = runs["CPU f64"]
    worst = {}
    for name, (params, metrics) in runs.items():
        if name == "CPU f64":
            continue
        errors = grad_errors(params, ref_params, floor_share)
        path = max(errors, key=errors.get)
        worst[name] = errors[path]
        log(f"{label}, {name} against the CPU in float64: losses "
            + ", ".join(f"{k} {float(v):.9g} / {float(ref_metrics[k]):.9g}"
                        for k, v in metrics.items())
            + "; worst gradient leaves: " + ", ".join(
                f"{p} {e:.3g}" for p, e in sorted(errors.items(), key=lambda kv: -kv[1])[:3]))
        if name == "CPU f32":
            continue
        bound = TRAIN_F64_RTOL if name == "CUDA f64" else f32_bound
        for k, v in metrics.items():
            err = abs(float(v) - float(ref_metrics[k])) / abs(float(ref_metrics[k]))
            if not err <= (TRAIN_F64_RTOL if name == "CUDA f64" else TRAIN_LOSS_RTOL):
                raise AssertionError(f"{label} {k}: {name} {float(v)} against the CPU's float64 "
                                     f"{float(ref_metrics[k])}")
        if worst[name] > bound:
            raise AssertionError(f"{label} {path}: {name} gradient {worst[name]:.3g} of its scale "
                                 f"from the CPU's float64 (bound {bound})")
    return worst


def training_path(root: Path, mrf_block, mrf_shapes: set):
    """Phase 14, float32: GlowTTS (python -m larynx_tpu_torch.train, harvard
    dims, batch 32 x 1024 frames, --ddi, 3 steps) and HiFi-GAN
    (train_vocoder --quality high, batch 16, 5 steps) at full width on the
    card; step times split into MAS, forward, backward and optimizer
    (GlowTTS) and into generator, D and G (HiFi-GAN); peak memory; one
    step's losses and gradients on CUDA against the CPU path (GlowTTS B=4,
    HiFi-GAN B=2); the written dirs through text_to_speech (27 MRF launches)
    and the saved voice's flow round trip.  Adds the MRF shapes of the
    trained vocoder's run to ``mrf_shapes``; returns launches and
    measurements."""
    import larynx_tpu_torch
    from larynx_tpu_torch import train, train_vocoder
    from larynx_tpu_torch.audio import AudioSettings
    from larynx_tpu_torch.convert.native import load_params
    from larynx_tpu_torch.device import to_device
    from larynx_tpu_torch.models.glow_tts import flows
    from larynx_tpu_torch.models.glow_tts import training as glow_training
    from larynx_tpu_torch.models.glow_tts.config import config_from_voice_json
    from larynx_tpu_torch.models.glow_tts.data import Dataset, mel_basis_tensor
    from larynx_tpu_torch.models.hifi_gan import model as hifi_model
    from larynx_tpu_torch.models.hifi_gan import training as gan_training
    from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
    from larynx_tpu_torch.parallel import train as ptrain
    from larynx_tpu_torch.text.ids import load_phoneme_ids
    from larynx_tpu_torch.weights import cast, params_from_jax, tree_to

    out = {"launches": {}, "ms": {}, "mb": {}, "loss": {}}
    t0 = time.perf_counter()
    corpus = stage_training_corpus(root)
    log(f"training corpus: {len(TRAIN_SCALES) * 16} wavs from text_to_speech on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    lang, name = TRAIN_VOICE.split("_", 1)
    voice_dir = root / lang / name
    argv = ["--metadata", str(corpus / "metadata.csv"), "--wav-dir", str(corpus / "wavs"),
            "--output-dir", str(voice_dir), "--config", str(corpus / "config.json"),
            "--phonemes", str(corpus / "phonemes.txt"), "--batch-size", "32", "--epochs", "1",
            "--ddi", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the earlier phases' cached engines
    (state, history), wall = timed_once(lambda: train.main(argv))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    losses = [{k: float(v) for k, v in m.items()} for m in history]
    if len(losses) != 3 or not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"train: {len(losses)} steps, losses {losses}")
    out["ms"]["train wall (3 steps, DDI, data)"] = wall
    out["mb"]["train peak"] = peak
    out["loss"]["train"] = losses
    log(f"train (GlowTTS harvard dims, batch 32, ids 192, mels 1024 x 80, --ddi, 3 steps): wall "
        f"{wall:.1f} ms with data and DDI, peak memory {peak:.0f} MiB above what was allocated "
        "before; losses "
        + "; ".join(f"step {i + 1} loss {m['loss']:.4f} (mle {m['mle_loss']:.4f} dur "
                    f"{m['duration_loss']:.4f})" for i, m in enumerate(losses)))

    # GlowTTS step times at batch 32: plain steps, then one split by phase
    cfg = config_from_voice_json(json.loads((corpus / "config.json").read_text()))
    with open(corpus / "phonemes.txt", encoding="utf-8") as f:
        table = load_phoneme_ids(f)
    dataset = Dataset(corpus / "metadata.csv", corpus / "wavs", table, AudioSettings(**AUDIO),
                      device="cuda")
    batches, t_data = timed_once(lambda: list(dataset.batches(32, shuffle_seed=0)))
    batch = batches[0]
    out["ms"]["train data, one epoch (96 wavs, 3 batches)"] = t_data
    optimizer = ptrain.make_optimizer(cfg)
    step = ptrain.make_train_step(cfg, optimizer)
    step(state, batch)
    _, t_step = timed(lambda: step(state, batch))
    mas_ms = []
    mas = glow_training.maximum_path

    def timed_mas(value, mask):
        path, ms = timed_once(lambda: mas(value, mask))
        mas_ms.append(ms)
        return path

    b = ptrain.batch_to(batch, "cuda")
    glow_training.maximum_path = timed_mas
    try:
        ptrain.zero_grads(state.opt_state)
        (loss, _), t_fwd = timed_once(lambda: glow_training.training_forward(
            state.params, cfg, b["ids"], b["id_lengths"], b["mels"], b["mel_lengths"]))
    finally:
        glow_training.maximum_path = mas
    _, t_bwd = timed_once(loss.backward)
    _, t_opt = timed_once(lambda: optimizer.update(state.opt_state))
    split = {"MAS": mas_ms[0], "forward without MAS": t_fwd - mas_ms[0], "backward": t_bwd,
             "optimizer": t_opt}
    out["ms"]["train step, batch 32"] = t_step
    out["ms"].update({f"train step, {k}": v for k, v in split.items()})
    log(f"train data: one epoch's {len(batches)} batches (wav read, frontend, mel targets on the "
        f"card, padding) {t_data:.1f} ms")
    log(f"train step, batch 32 x 1024 frames: {t_step:.3f} ms (host clock, 3 steps); one step "
        "split with a synchronisation between phases: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f"; MAS over {b['mels'].shape[1]} frames {mas_ms[0] / b['mels'].shape[1]:.4f} ms a frame")

    # one GlowTTS forward and backward on CUDA against the CPU path in
    # float64, B=4, all at the card's MAS path
    tree = load_params(voice_dir / "generator.npz")
    small = {k: v[:4] for k, v in batch.items()}
    searched = {}

    def grads_on(device, dtype=torch.float32, path=None):
        """Params with their gradients and the metrics of one training
        forward on ``device`` in ``dtype``; MAS's inputs and its own path are
        kept in ``searched``, and ``path`` (if given) is the one the forward
        uses."""
        params = ptrain.trainable(cast(params_from_jax(tree, "glow_tts", device), dtype))
        bb = ptrain.batch_to(small, device)
        bb["mels"] = bb["mels"].to(dtype)

        def recorded(value, mask):
            own = mas(value, mask)
            searched[device.type, dtype] = (value.cpu(), mask.cpu(), own.cpu())
            return own if path is None else path.to(device, value.dtype)

        glow_training.maximum_path = recorded
        try:
            loss, metrics = glow_training.training_forward(
                params, cfg, bb["ids"], bb["id_lengths"], bb["mels"], bb["mel_lengths"])
        finally:
            glow_training.maximum_path = mas
        loss.backward()
        return params, metrics

    torch.backends.cudnn.deterministic = True
    try:
        runs = {"CUDA f32": grads_on(torch.device("cuda"))}
        cuda_logp, cuda_mask, cuda_path = searched["cuda", torch.float32]
        # MAS on the card is exact: the CPU's, on the card's inputs, gives its path
        if not torch.equal(mas(cuda_logp, cuda_mask), cuda_path):
            raise AssertionError("maximum_path on the card differs from the CPU's on its inputs")
        for name, device, dtype in (("CUDA f64", "cuda", torch.float64),
                                    ("CPU f32", "cpu", torch.float32),
                                    ("CPU f64", "cpu", torch.float64)):
            runs[name] = grads_on(torch.device(device), dtype, path=cuda_path)
        differ = int((searched["cpu", torch.float32][2] != cuda_path).any(dim=1).sum())
    finally:
        torch.backends.cudnn.deterministic = False
    worst = against_float64("train", runs, TRAIN_GRAD_RTOL)
    out["loss"]["train CUDA vs CPU"] = {name: {k: float(v) for k, v in m.items()}
                                        for name, (_, m) in runs.items()}
    log(f"train, one step at B=4 (TF32 off, cuDNN deterministic): CUDA float32 gradients within "
        f"{worst['CUDA f32']:.3g} of their scale from the CPU in float64 (bound "
        f"{TRAIN_GRAD_RTOL}), CUDA float64 within {worst['CUDA f64']:.3g} (bound "
        f"{TRAIN_F64_RTOL}), the CPU's float32 within {worst['CPU f32']:.3g}; MAS on the card "
        f"equal to the CPU's on the card's inputs; the CPU's own float32 inputs give a path that "
        f"differs in {differ} of {4 * small['mels'].shape[1]} frames (near-ties of float32 sums; "
        "every run took the card's path)")

    # HiFi-GAN at --quality high, batch 16, 5 steps
    argv = ["--wav-dir", str(corpus / "wavs"), "--out-dir", str(root / TRAIN_VOCODER),
            "--quality", "high", "--batch-size", "16", "--steps", "5", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    (gan_state, history), wall = timed_once(lambda: train_vocoder.main(argv))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    losses = [{k: float(v) for k, v in m.items()} for m in history]
    if len(losses) != 5 or not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"train_vocoder: {len(losses)} steps, losses {losses}")
    out["ms"]["train_vocoder wall (5 steps)"] = wall
    out["mb"]["train_vocoder peak"] = peak
    out["loss"]["train_vocoder"] = losses
    log(f"train_vocoder (HiFi-GAN universal_large, batch 16 x 8192 samples, 5 steps): wall "
        f"{wall:.1f} ms, peak memory {peak:.0f} MiB above what was allocated before; losses "
        + "; ".join(f"step {i + 1} d {m['d_loss']:.4f} g {m['g_loss']:.4f} (mel_l1 "
                    f"{m['mel_l1']:.4f} fm {m['fm_loss']:.4f} adv {m['adv_loss']:.4f})"
                    for i, m in enumerate(losses)))

    voc_cfg = HiFiGanConfig(**train_vocoder.GEOMETRY["high"])
    settings = AudioSettings()
    corpus_audio = train_vocoder._load_corpus(corpus / "wavs", 32 * 256 + 256)
    rng = np.random.default_rng(0)
    make_mels = train_vocoder._make_mel_fn(settings, 32, "cuda")
    audio = to_device(train_vocoder._sample_batch(rng, corpus_audio, 16, 32 * 256, 256), "cuda")
    gan_batch = {"mels": make_mels(audio), "audio": audio}
    gen_opt = ptrain.Optimizer(lambda k: 2e-4, betas=(0.8, 0.99))
    gan_step = gan_training.make_gan_train_step(voc_cfg, settings, gen_opt, gen_opt)
    gan_step(gan_state, gan_batch)
    _, t_gan = timed(lambda: gan_step(gan_state, gan_batch))
    basis = mel_basis_tensor(settings, "cuda")
    fake, t_gen = timed_once(lambda: hifi_model.generator(gan_state.gen_params, voc_cfg,
                                                          gan_batch["mels"]))

    def d_phase():
        ptrain.zero_grads(gan_state.disc_opt)
        gan_training.discriminator_loss_fn(gan_state.disc_params, audio, fake.detach()).backward()
        gen_opt.update(gan_state.disc_opt)

    def g_phase():
        ptrain.zero_grads(gan_state.gen_opt)
        gan_training.generator_loss_fn(gan_state.disc_params, audio, fake, settings,
                                       basis)[0].backward()
        gen_opt.update(gan_state.gen_opt)

    _, t_d = timed_once(d_phase)
    _, t_g = timed_once(g_phase)
    out["ms"].update({"train_vocoder step, batch 16": t_gan, "train_vocoder step, generator":
                      t_gen, "train_vocoder step, D": t_d, "train_vocoder step, G": t_g})
    log(f"train_vocoder step, batch 16: {t_gan:.3f} ms (host clock, 3 steps); one step split: "
        f"generator forward {t_gen:.3f} ms, D (loss, backward, Adam) {t_d:.3f} ms, G (loss, "
        f"backward through the discriminators and the generator, Adam) {t_g:.3f} ms")

    # one GAN step's losses and gradients, CUDA against the CPU path, B=2,
    # both at the same (trained) params, before any update
    gen_tree = load_params(root / TRAIN_VOCODER / "generator.npz")
    pair = {k: v[:2].cpu() for k, v in gan_batch.items()}

    def gan_grads_on(device, dtype=torch.float32):
        """Both nets with one step's gradients (the discriminators' on the
        detached fake, the generator's against the same discriminators) and
        the losses, on ``device`` in ``dtype``."""
        device = torch.device(device)
        gen = ptrain.trainable(cast(params_from_jax(gen_tree, "hifi_gan", device), dtype))
        dis = ptrain.trainable(cast(tree_to(gan_state.disc_params, device), dtype))
        real, mels = pair["audio"].to(device, dtype), pair["mels"].to(device, dtype)
        fake = hifi_model.generator(gen, voc_cfg, mels)
        d_loss = gan_training.discriminator_loss_fn(dis, real, fake.detach())
        d_loss.backward()
        g_loss, parts = gan_training.generator_loss_fn(dis, real, fake, settings,
                                                       basis.to(device, dtype))
        d_grads = [p.grad for _, p in flat_tree(dis)]
        for _, p in flat_tree(dis):
            p.grad = None
        g_loss.backward()
        for (_, p), g in zip(flat_tree(dis), d_grads):
            p.grad = g
        return {"generator": gen, "discriminators": dis}, {
            k: v.detach() for k, v in dict(parts, d_loss=d_loss, g_loss=g_loss).items()}

    torch.backends.cudnn.deterministic = True
    try:
        runs = {name: gan_grads_on(device, dtype) for name, device, dtype in (
            ("CUDA f32", "cuda", torch.float32), ("CUDA f64", "cuda", torch.float64),
            ("CPU f32", "cpu", torch.float32), ("CPU f64", "cpu", torch.float64))}
    finally:
        torch.backends.cudnn.deterministic = False
    worst = against_float64("train_vocoder", runs, TRAIN_GAN_GRAD_RTOL)
    out["loss"]["train_vocoder CUDA vs CPU"] = {name: {k: float(v) for k, v in m.items()}
                                                for name, (_, m) in runs.items()}
    log(f"train_vocoder, one step at B=2 (TF32 off, cuDNN deterministic): CUDA float32 gradients "
        f"within {worst['CUDA f32']:.3g} of their scale from the CPU in float64 (bound "
        f"{TRAIN_GAN_GRAD_RTOL}), CUDA float64 within {worst['CUDA f64']:.3g} (bound "
        f"{TRAIN_F64_RTOL}), the CPU's float32 within {worst['CPU f32']:.3g}")

    # the written dirs through text_to_speech: the trained vocoder runs the
    # MRF kernel, 27 launches per generator call
    per_call = mrf_launches_per_call(voc_cfg)
    kwargs = dict(voice_or_lang=TRAIN_VOICE, vocoder_or_quality=TRAIN_VOCODER,
                  custom_voices_dir=root, no_download=True, device="cuda")
    with recording_mrf_shapes(mrf_shapes):
        list(larynx_tpu_torch.text_to_speech(PANGRAM, **kwargs))  # warm-up
        mrf_block.mrf_section.launches = 0
        flow_wn_start()
        results, t_tts = timed_once(lambda: list(larynx_tpu_torch.text_to_speech(PANGRAM,
                                                                                 **kwargs)))
        n_mrf = mrf_block.mrf_section.launches
        flow_wn_read("train: trained dirs, text_to_speech, pangram")
    if n_mrf != per_call:
        raise AssertionError(f"trained dirs: {n_mrf} MRF launches, expected {per_call}")
    audio_out = results[0].audio
    if audio_out.dtype != np.int16 or np.abs(audio_out.astype(np.int32)).max() < 1000:
        raise AssertionError(f"trained dirs: audio {audio_out.dtype}, silent or empty")
    out["launches"]["train: trained dirs, text_to_speech, pangram"] = n_mrf
    out["ms"]["trained dirs text_to_speech"] = t_tts

    # the saved voice's flow: reverse(forward(mel)) is the mel
    params = params_from_jax(tree, "glow_tts", "cuda")
    bb = ptrain.batch_to(small, "cuda")
    lengths = (bb["mel_lengths"] // cfg.n_sqz) * cfg.n_sqz
    y_mask = (torch.arange(bb["mels"].shape[1], device="cuda")[None] < lengths[:, None]).float()
    mels = bb["mels"] * y_mask[..., None]
    with torch.no_grad():
        z, _ = flows.decoder(params["decoder"], mels, y_mask, cfg, reverse=False)
        back, _ = flows.decoder(params["decoder"], z, y_mask, cfg, reverse=True)
    round_trip = (back - mels).abs().max().item()
    if not round_trip <= FLOW_ROUND_TRIP:
        raise AssertionError(f"saved voice: reverse(forward(mel)) off by {round_trip}")
    log(f"trained dirs through text_to_speech, pangram: {t_tts:.3f} ms, {len(audio_out)} samples, "
        f"MRF launches {n_mrf} (expected {per_call}); the saved voice's reverse(forward(mel)) "
        f"within {round_trip:.3g} of the mel (bound {FLOW_ROUND_TRIP}) over 12 blocks at "
        f"B=4 x 1024 frames")
    log("phase 14 times: " + ", ".join(f"{k} {v:.3f} ms" for k, v in out["ms"].items()))
    return out


# Phase 15: training, part 2, on phase 14's corpus: WaveGlow wn_256
# (train_vocoder --family waveglow) and Tacotron2 at NVIDIA's hparams
# (train --family tacotron2), widths not cut
TRAIN_WG_VOCODER = "waveglow/trained"
TRAIN_T2_VOICE = "en-us_trained-tacotron2"
# WaveGlow, one step at B=1 x 8 frames (256 blocks), float32 on the card
# against the CPU in float64: each gradient is a sum of at most 256 x 3
# products per weight, so float32 in another order sits ~1e-6 of a leaf's
# scale; 1e-4, GlowTTS's bound, catches a layout or indexing fault (O(1))
WG_GRAD_RTOL = 1e-4
# Tacotron2, one step at B=2, 32 ids, 64 frames: the gradients flow back
# through 64 recurrent steps of 1024-wide LSTMs, whose float32 rounding
# compounds; 1e-3 of each leaf's scale, the scale floored at 1e-2 of the
# net's largest gradient: a conv bias before a BatchNorm, which removes it,
# has a true gradient of 0 and holds rounding noise only
T2_GRAD_RTOL = 1e-3
T2_GRAD_FLOOR = 1e-2
T2_TRAIN_SEED = 1234  # train.py's --seed default: its masks are seeded by seed + 1


def training_path_2(root: Path, mrf_block, wn_layer, mrf_shapes: set, wn_shapes: set):
    """Phase 15, float32: WaveGlow (python -m larynx_tpu_torch.train_vocoder
    --family waveglow, wn_256, batch 16 x 8192 samples, 5 steps) and
    Tacotron2 (python -m larynx_tpu_torch.train --family tacotron2, NVIDIA's
    hparams, batch 32 x 1024 frames, 3 steps) at full width on the card, on
    phase 14's corpus; step times split (WaveGlow: forward, backward, Adam;
    Tacotron2: masks, encode, teacher decode, postnet + loss, backward,
    optimizer), Tacotron2's launches per decoder step and busy share, peak
    memory; one step's losses and gradients on CUDA against the CPU path in
    float64; the BatchNorm running statistics moved; the written dirs through
    text_to_speech (96 WN launches per group call, 27 MRF per sentence).
    Adds the kernels' shapes to ``mrf_shapes`` and ``wn_shapes``; returns
    launches and measurements."""
    import collections

    import larynx_tpu_torch
    from larynx_tpu_torch import train, train_vocoder
    from larynx_tpu_torch.audio import AudioSettings
    from larynx_tpu_torch.convert.native import load_params
    from larynx_tpu_torch.device import to_device
    from larynx_tpu_torch.models.glow_tts.data import Dataset
    from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
    from larynx_tpu_torch.models.tacotron2 import model as t2_model
    from larynx_tpu_torch.models.tacotron2 import training as t2_training
    from larynx_tpu_torch.models.tacotron2.config import tacotron2_config_from_voice_json
    from larynx_tpu_torch.models.waveglow import model as wg_model
    from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
    from larynx_tpu_torch.parallel import train as ptrain
    from larynx_tpu_torch.text.ids import load_phoneme_ids
    from larynx_tpu_torch.weights import cast, params_from_jax

    out = {"launches": {}, "ms": {}, "mb": {}, "loss": {}}
    corpus = root / "train_corpus"

    def run_cli(label, fn, n_steps):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        (state, history), wall = timed_once(fn)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        if len(history) != n_steps or not all(type(v) is float and np.isfinite(v)
                                              for m in history for v in m.values()):
            raise AssertionError(f"{label}: {len(history)} steps, history {history}")
        out["ms"][f"{label} wall ({n_steps} steps)"] = wall
        out["mb"][f"{label} peak"] = peak
        out["loss"][label] = history
        log(f"{label}: wall {wall:.1f} ms for {n_steps} steps with data, peak memory {peak:.0f} "
            f"MiB above what was allocated before; history (host floats): "
            + "; ".join(", ".join(f"{k} {v:.4f}" for k, v in m.items()) for m in history))
        return state

    # WaveGlow wn_256 at batch 16 x 32 frames, 5 steps
    wg_cfg = WaveGlowConfig()
    wg_state = run_cli("train_vocoder --family waveglow", lambda: train_vocoder.main([
        "--family", "waveglow", "--wav-dir", str(corpus / "wavs"),
        "--out-dir", str(root / TRAIN_WG_VOCODER), "--batch-size", "16", "--steps", "5",
        "--device", "cuda"]), 5)
    up = wg_cfg.upsample_stride
    settings = AudioSettings(mel_channels=wg_cfg.mel_channels, sample_rate=wg_cfg.sampling_rate,
                             hop_length=up)
    corpus_audio = train_vocoder._load_corpus(corpus / "wavs", 32 * up + up)
    audio = to_device(train_vocoder._sample_batch(np.random.default_rng(0), corpus_audio, 16,
                                                  32 * up, up), "cuda")
    mels = train_vocoder._make_mel_fn(settings, 32, "cuda")(audio)
    wg_opt = ptrain.Optimizer(ptrain.exponential_decay(2e-4, 1000, 0.999))

    def wg_step():
        ptrain.zero_grads(wg_state.opt_state)
        loss = wg_model.loss_fn(wg_state.params, wg_cfg, audio, mels, 1.0)
        loss.backward()
        wg_opt.update(wg_state.opt_state)

    wg_step()
    _, t_step = timed(wg_step)
    ptrain.zero_grads(wg_state.opt_state)
    loss, t_fwd = timed_once(lambda: wg_model.loss_fn(wg_state.params, wg_cfg, audio, mels, 1.0))
    _, t_bwd = timed_once(loss.backward)
    _, t_opt = timed_once(lambda: wg_opt.update(wg_state.opt_state))
    split = {"forward": t_fwd, "backward": t_bwd, "Adam": t_opt}
    out["ms"]["waveglow train step, batch 16"] = t_step
    out["ms"].update({f"waveglow train step, {k}": v for k, v in split.items()})
    log(f"waveglow train step, batch 16 x 8192 samples (wn_256, unfused WN stacks, f32): "
        f"{t_step:.3f} ms (host clock, 3 steps); one step split with a synchronisation between "
        "phases: " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))

    # one WaveGlow step, CUDA against the CPU path in float64, B=1 x 8
    # frames, the trained dir's weights with the end convs perturbed as the
    # inference phases perturb them
    tree = load_params(root / TRAIN_WG_VOCODER / "generator.npz")
    gen = torch.Generator().manual_seed(7)
    for flow in tree["flows"]:
        flow["wn"]["end_w"] = (torch.randn(flow["wn"]["end_w"].shape, generator=gen)
                               * WG_END_SCALE).numpy()
    pair = audio[:1, : 8 * up].cpu(), mels[:1, :8].cpu()

    def wg_grads_on(device, dtype):
        device = torch.device(device)
        params = ptrain.trainable(cast(params_from_jax(tree, "waveglow", device), dtype),
                                  frozen=("w_inv",))
        loss = wg_model.loss_fn(params, wg_cfg, pair[0].to(device, dtype),
                                pair[1].to(device, dtype), 1.0)
        loss.backward()
        return params, {"nll": loss.detach()}

    torch.backends.cudnn.deterministic = True
    try:
        runs = {name: wg_grads_on(device, dtype) for name, device, dtype in (
            ("CUDA f32", "cuda", torch.float32), ("CUDA f64", "cuda", torch.float64),
            ("CPU f32", "cpu", torch.float32), ("CPU f64", "cpu", torch.float64))}
    finally:
        torch.backends.cudnn.deterministic = False
    worst = against_float64("train_vocoder waveglow", runs, WG_GRAD_RTOL)
    out["loss"]["waveglow CUDA vs CPU"] = {name: {k: float(v) for k, v in m.items()}
                                           for name, (_, m) in runs.items()}
    log(f"waveglow, one step at B=1 x 8 frames (end convs at scale {WG_END_SCALE}; TF32 off, cuDNN "
        f"deterministic): CUDA float32 gradients within {worst['CUDA f32']:.3g} of their scale "
        f"from the CPU in float64 (bound {WG_GRAD_RTOL}), CUDA float64 within "
        f"{worst['CUDA f64']:.3g} (bound {TRAIN_F64_RTOL}), the CPU's float32 within "
        f"{worst['CPU f32']:.3g}")

    # the trained WaveGlow through text_to_speech: 96 WN launches per group call
    per_group = wg_cfg.flows * wg_cfg.wn_layers
    saved = load_params(root / TRAIN_WG_VOCODER / "generator.npz")
    inv_err = max(np.abs(f["convinv"]["w"].astype(np.float64) @ f["convinv"]["w_inv"]
                         - np.eye(f["convinv"]["w"].shape[0])).max() for f in saved["flows"])
    if not inv_err <= 1e-5:
        raise AssertionError(f"trained waveglow: w @ w_inv off the identity by {inv_err}")
    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality=TRAIN_WG_VOCODER,
                  custom_voices_dir=root, no_download=True, device="cuda")
    with recording_wn_shapes(wn_shapes):
        list(larynx_tpu_torch.text_to_speech(PANGRAM, **kwargs))  # warm-up
        wn_layer.fused_wn_layer_state.launches = 0
        flow_wn_start()
        results, t_tts = timed_once(lambda: list(larynx_tpu_torch.text_to_speech(PANGRAM,
                                                                                 **kwargs)))
        n_wn = wn_layer.fused_wn_layer_state.launches
        flow_wn_read("train: trained waveglow, text_to_speech, pangram")
    wg_audio = results[0].audio
    if n_wn != per_group:
        raise AssertionError(f"trained waveglow: {n_wn} WN launches, expected {per_group}")
    if wg_audio.dtype != np.int16 or np.abs(wg_audio.astype(np.int32)).max() < 1000:
        raise AssertionError(f"trained waveglow: audio {wg_audio.dtype}, silent or empty")
    out["launches"]["train: trained waveglow, text_to_speech, pangram"] = n_wn
    out["ms"]["trained waveglow text_to_speech"] = t_tts
    log(f"trained waveglow through text_to_speech, pangram: {t_tts:.3f} ms, {len(wg_audio)} "
        f"samples, WN launches {n_wn} (expected {per_group}, one group call); the saved w @ w_inv "
        f"within {inv_err:.3g} of the identity")

    # Tacotron2 at NVIDIA's hparams, batch 32, ids 192, mels 1024 x 80, 3 steps
    lang, name = TRAIN_T2_VOICE.split("_", 1)
    voice_dir = root / lang / name
    t2_state = run_cli("train --family tacotron2", lambda: train.main([
        "--family", "tacotron2", "--metadata", str(corpus / "metadata.csv"),
        "--wav-dir", str(corpus / "wavs"), "--output-dir", str(voice_dir),
        "--config", str(corpus / "config.json"), "--phonemes", str(corpus / "phonemes.txt"),
        "--batch-size", "32", "--epochs", "1", "--device", "cuda"]), 3)
    t2_cfg = tacotron2_config_from_voice_json(json.loads((voice_dir / "config.json").read_text()))
    with open(corpus / "phonemes.txt", encoding="utf-8") as f:
        table = load_phoneme_ids(f)
    batch = next(Dataset(corpus / "metadata.csv", corpus / "wavs", table, AudioSettings(**AUDIO),
                         device="cuda").batches(32, shuffle_seed=0))
    bsz, t_ids = batch["ids"].shape
    frames = batch["mels"].shape[1]
    t2_opt = ptrain.Optimizer(ptrain.linear_schedule(0.0, 1e-3, 4000), grad_clip=5.0,
                              clip="global_norm", weight_decay=1e-6)
    t2_step = t2_training.make_train_step(t2_cfg, t2_opt)

    def masks_for(k):
        return t2_training.draw_train_masks(t2_cfg, bsz, t_ids, frames, T2_TRAIN_SEED + 1, k,
                                            "cuda")

    def step():
        return t2_step(t2_state, batch, masks_for(t2_state.step))

    step()
    _, t_step = timed(step)
    b = ptrain.batch_to(batch, "cuda")
    masks, t_masks = timed_once(lambda: masks_for(t2_state.step))
    parts = {}

    def timing(label, fn):
        def wrapped(*args, **kwargs):
            result, parts[label] = timed_once(lambda: fn(*args, **kwargs))
            return result
        return wrapped

    encode, decode = t2_model.encode, t2_model.decode_teacher
    t2_model.encode, t2_model.decode_teacher = timing("encode", encode), timing("teacher decode",
                                                                                decode)
    try:
        ptrain.zero_grads(t2_state.opt_state)
        stats = []
        (loss, _), t_fwd = timed_once(lambda: t2_training.loss_fn(t2_state.params, t2_cfg, b,
                                                                  *masks, stats))
    finally:
        t2_model.encode, t2_model.decode_teacher = encode, decode
    _, t_bwd = timed_once(loss.backward)
    _, t_opt = timed_once(lambda: (t2_opt.update(t2_state.opt_state),
                                   t2_training.update_bn_running(stats)))
    split = {"masks (host draw, one copy)": t_masks, "encode": parts["encode"],
             "teacher decode": parts["teacher decode"],
             "postnet + loss": t_fwd - parts["encode"] - parts["teacher decode"],
             "backward": t_bwd, "optimizer + BN EMA": t_opt}
    out["ms"]["tacotron2 train step, batch 32"] = t_step
    out["ms"].update({f"tacotron2 train step, {k}": v for k, v in split.items()})
    # the card's busy share: the teacher decode's forward alone (phase 13's
    # measure), then a whole step
    decode_events, step_events = collections.Counter(), collections.Counter()
    memory, mask = t2_model.encode(t2_state.params, t2_cfg, b["ids"], b["id_lengths"], train=True,
                                   keep=masks[0])
    _, dec_traced, dec_busy = device_busy_ms(lambda: t2_model.decode_teacher(
        t2_state.params, t2_cfg, memory, mask, b["mels"], keep=masks[1]), decode_events)
    del memory, mask
    _, step_traced, step_busy = device_busy_ms(step, step_events)
    out["decode"] = {"frames": frames, "traced_ms": dec_traced, "busy_ms": dec_busy,
                     "kernels": decode_events["kernel"], "step_traced_ms": step_traced,
                     "step_busy_ms": step_busy, "step_kernels": step_events["kernel"],
                     "step_memcpy": step_events["gpu_memcpy"],
                     "step_host_syncs": step_events["host_sync"]}

    def share(busy, traced):
        return "not measured" if busy is None else f"{busy:.3f} ms, {busy / traced:.1%}"

    log(f"tacotron2 train step, batch 32 x {t_ids} ids x {frames} frames (f32): {t_step:.3f} ms "
        "(host clock, 3 steps); one step split with a synchronisation between phases: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f"; teacher decode {parts['teacher decode'] / frames:.4f} ms a frame")
    log(f"tacotron2 teacher decode forward, traced: {dec_traced:.3f} ms, the card busy "
        f"{share(dec_busy, dec_traced)}; {decode_events['kernel']} kernel launches "
        f"({decode_events['kernel'] / frames:.1f} per decoder step); a whole step traced: "
        f"{step_traced:.3f} ms, the card busy {share(step_busy, step_traced)}; "
        f"{step_events['kernel']} kernel launches ({step_events['kernel'] / frames:.1f} per "
        f"frame), {step_events['gpu_memcpy']} copies, {step_events['host_sync']} host waits")

    # one Tacotron2 step, CUDA against the CPU path in float64, B=2, 32 ids,
    # 64 frames, ragged, with injected masks
    tree = load_params(voice_dir / "generator.npz")
    bns = [c["bn"] for c in tree["encoder"]["convs"] + tree["postnet"]["convs"]]
    if not all(np.abs(bn["mean"]).max() > 0 and np.abs(bn["var"] - 1).max() > 0 for bn in bns):
        raise AssertionError("trained tacotron2: BatchNorm running statistics at the init's")
    small = {"ids": batch["ids"][:2, :32], "id_lengths": np.array([32, 25], np.int32),
             "mels": batch["mels"][:2, :64], "mel_lengths": np.array([64, 50], np.int32)}
    keep = t2_training.draw_train_masks(t2_cfg, 2, 32, 64, T2_TRAIN_SEED + 1, 0, "cpu")

    def t2_grads_on(device, dtype):
        device = torch.device(device)
        params = ptrain.trainable(cast(params_from_jax(tree, "tacotron2", device), dtype),
                                  frozen=t2_training.BN_RUNNING)
        bb = ptrain.batch_to(small, device)
        bb["mels"] = bb["mels"].to(dtype)
        loss, parts = t2_training.loss_fn(params, t2_cfg, bb, keep[0].to(device),
                                          keep[1].to(device))
        loss.backward()
        return params, {k: v.detach() for k, v in dict(parts, loss=loss).items()}

    torch.backends.cudnn.deterministic = True
    try:
        runs = {name: t2_grads_on(device, dtype) for name, device, dtype in (
            ("CUDA f32", "cuda", torch.float32), ("CUDA f64", "cuda", torch.float64),
            ("CPU f32", "cpu", torch.float32), ("CPU f64", "cpu", torch.float64))}
    finally:
        torch.backends.cudnn.deterministic = False
    worst = against_float64("train tacotron2", runs, T2_GRAD_RTOL, T2_GRAD_FLOOR)
    out["loss"]["tacotron2 CUDA vs CPU"] = {name: {k: float(v) for k, v in m.items()}
                                            for name, (_, m) in runs.items()}
    log(f"tacotron2, one step at B=2, 32 ids, 64 frames (injected masks; TF32 off, cuDNN "
        f"deterministic): CUDA float32 gradients within {worst['CUDA f32']:.3g} of their scale "
        f"from the CPU in float64 (bound {T2_GRAD_RTOL}, scale floored at {T2_GRAD_FLOOR} of the "
        f"largest), CUDA float64 within {worst['CUDA f64']:.3g} (bound {TRAIN_F64_RTOL}), the "
        f"CPU's float32 within {worst['CPU f32']:.3g}; the saved BatchNorm running statistics "
        f"moved from the init's 0 and 1 in all {len(bns)} layers (largest |mean| "
        f"{max(np.abs(bn['mean']).max() for bn in bns):.4g})")

    # the trained voice through text_to_speech with universal_large: 27 MRF launches
    per_call = mrf_launches_per_call(HiFiGanConfig())
    kwargs = dict(voice_or_lang=TRAIN_T2_VOICE, vocoder_or_quality="high", custom_voices_dir=root,
                  no_download=True, device="cuda")
    with recording_mrf_shapes(mrf_shapes):
        list(larynx_tpu_torch.text_to_speech(PANGRAM, **kwargs))  # warm-up
        mrf_block.mrf_section.launches = 0
        results, t_tts = timed_once(lambda: list(larynx_tpu_torch.text_to_speech(PANGRAM,
                                                                                 **kwargs)))
        n_mrf = mrf_block.mrf_section.launches
    t2_audio = results[0].audio
    if n_mrf != per_call:
        raise AssertionError(f"trained tacotron2: {n_mrf} MRF launches, expected {per_call}")
    if t2_audio.dtype != np.int16 or not len(t2_audio):
        raise AssertionError(f"trained tacotron2: audio {t2_audio.dtype} {t2_audio.shape}")
    out["launches"]["train: trained tacotron2, text_to_speech, pangram"] = n_mrf
    out["ms"]["trained tacotron2 text_to_speech"] = t_tts
    log(f"trained tacotron2 through text_to_speech with universal_large, pangram: {t_tts:.3f} ms, "
        f"{len(t2_audio)} samples, MRF launches {n_mrf} (expected {per_call})")
    log("phase 15 times: " + ", ".join(f"{k} {v:.3f} ms" for k, v in out["ms"].items()))
    return out


# Phase 16: the multi-device layer.  Serving: a ServingMesh of MESH_POSITIONS
# positions on cuda:0 (the measuring machine has one card; serving_mesh()
# builds none there), against the single-device engine.  Bounds: the JAX
# engine's (tests/test_mesh_serving.py, tests/test_time_shard.py) in float32;
# in bf16 the row shard's positions run the single engine's per-row
# arithmetic on fewer rows, held to the same LSB bound where the bytes agree,
# else to the bf16 bar of phase 9.
MESH_POSITIONS = 4
MESH_LSB, MESH_SHARE = 2, 0.02  # row shard, denoised time shard
WINDOW_LSB, WINDOW_SHARE = 1, 1e-3  # plain time shard and grid
# Training on the card, world 2 over gloo on cuda:0 against world 1 on the
# batch of phases 14-15, TF32 off, cuDNN deterministic: the bounds that
# phases 14-15 hold the float32 steps to against float64 (a data-parallel
# step sums the same terms in another order)
MESH_GRAD_RTOL = {"glow_tts": 5.1e-5, "hifi_gan": TRAIN_GAN_GRAD_RTOL, "tacotron2": 3.8e-5}
MESH_STAT_ATOL = 1e-6  # the running statistics of O(1) activations


def lsb_share(a, b):
    """(max |a - b| in int16 steps, share of samples that differ)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes {a.shape} vs {b.shape}")
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(diff.max()) if diff.size else 0, float(np.mean(diff != 0)) if diff.size else 0.0


def hold_rows(label, got, want, lsb_bound, share_bound, bf16=False):
    """Each row within (lsb_bound, share_bound); in bf16, rows that miss it
    are held to phase 9's bar.  Returns the worst (lsb, share)."""
    worst = (0, 0.0)
    for i, (a, b) in enumerate(zip(got, want)):
        lsb_i, share_i = lsb_share(a, b)
        worst = (max(worst[0], lsb_i), max(worst[1], share_i))
        if lsb_i <= lsb_bound and share_i < share_bound:
            continue
        if not bf16:
            raise AssertionError(f"{label}, row {i}: {lsb_i} LSB on {share_i:.3%} of samples "
                                 f"(bound {lsb_bound} LSB on < {share_bound:.1%})")
        audibly_identical(a, b, f"{label}, row {i}")
    log(f"{label}: {len(got)} rows, worst {worst[0]} LSB on {worst[1]:.4%} of samples "
        f"(bound {lsb_bound} LSB on < {share_bound:.1%}" + (", else phase 9's bf16 bar)" if bf16
                                                             else ")"))
    return worst


def mesh_engines(root: Path, mesh, vocoder: str):
    """(single-device engine, mesh engine, jobs) for the staged harvard voice
    and ``vocoder`` at the current precision pin."""
    import larynx_tpu_torch
    from larynx_tpu_torch.runtime.engine import SynthesisEngine, default_vocoder_half

    jobs = larynx_tpu_torch._build_jobs(" ".join([PANGRAM] * 8), VOICE, vocoder,
                                        custom_voices_dir=root, no_download=True)
    tts, voc = jobs[0]["tts_model"], jobs[0]["vocoder_model"]
    kind = "waveglow" if vocoder == "waveglow" else "hifi_gan"
    extra = {"waveglow_sigma": voc.sigma} if kind == "waveglow" else {}
    engines = [SynthesisEngine(tts.params, tts.model_config, tts.audio_settings,
                               vocoder_kind=kind, vocoder_params=voc.params,
                               vocoder_cfg=voc.model_config, device="cuda",
                               vocoder_half=default_vocoder_half("cuda"), mesh=m, **extra)
               for m in (None, mesh)]
    return engines[0], engines[1], jobs


def mesh_serving(root: Path, mrf_block, wn_layer, mesh, label, mrf_shapes, wn_shapes):
    """Phase 16, serving, on ``mesh``: the row shard (pangram x8), the time
    shard (one pangram, 1024-frame bucket) and the grid (three pangrams), each
    plain and denoised, and the stream, HiFi-GAN in bf16 (the CUDA default)
    and float32; WaveGlow's grid; make_sharded_synthesis.  Returns launches
    and times."""
    from larynx_tpu_torch.parallel.serve import make_sharded_synthesis
    from larynx_tpu_torch.runtime.engine import postprocess, stream_halo_frames

    out = {"launches": {}, "ms": {}, "lsb": {}}
    n = len(mesh)
    ids = None
    for precision in ("bf16", "f32"):
        pin_precision(precision)  # bf16 is the CUDA default; pinned, as phase 9 reads it
        single, meshed, jobs = mesh_engines(root, mesh, "high")
        bf16 = meshed.voc_dtype == torch.bfloat16
        if bf16 != (precision == "bf16"):
            raise AssertionError(f"mesh engine vocoder dtype {meshed.voc_dtype} under {precision}")
        ids = [j["ids"] for j in jobs]
        per_call = mrf_launches_per_call(meshed.vocoder_cfg, meshed.voc_dtype)
        kw = dict(seed=STREAM_SEED, length_scale=LENGTH_SCALE)
        routes = (("row shard, pangram x8", ids, 0.0, MESH_LSB, MESH_SHARE),
                  ("time shard, pangram", ids[:1], 0.0, WINDOW_LSB, WINDOW_SHARE),
                  ("time shard denoised, pangram", ids[:1], 0.005, MESH_LSB, MESH_SHARE),
                  ("grid, pangram x3", ids[:3], 0.0, WINDOW_LSB, WINDOW_SHARE),
                  ("grid denoised, pangram x3", ids[:3], 0.005, MESH_LSB, MESH_SHARE))
        with recording_mrf_shapes(mrf_shapes):
            for route, rows, strength, lsb_bound, share_bound in routes:
                want = single.synthesize_batch(rows, denoiser_strength=strength, **kw)
                meshed.synthesize_batch(rows, denoiser_strength=strength, **kw)  # warm-up
                hits = (meshed._time_shard_hits, meshed._grid_shard_hits)
                mrf_block.mrf_section.launches = 0
                flow_wn_start()
                got, t_mesh = timed_once(lambda: meshed.synthesize_batch(
                    rows, denoiser_strength=strength, **kw))
                launches = mrf_block.mrf_section.launches
                flow_wn_read(f"mesh {label}, {precision} {route}")
                _, t_single = timed_once(lambda: single.synthesize_batch(
                    rows, denoiser_strength=strength, **kw))
                dt = (meshed._time_shard_hits - hits[0], meshed._grid_shard_hits - hits[1])
                expect = {"row": (0, 0), "time": (1, 0), "grid": (0, 1)}[route.split()[0].rstrip(",")]
                if dt != expect:
                    raise AssertionError(f"{label} {precision} {route}: time/grid hits {dt}, "
                                         f"expected {expect}")
                # one generator call per position: its rows or its window
                if launches != per_call * n:
                    raise AssertionError(f"{label} {precision} {route}: {launches} MRF launches, "
                                         f"expected {per_call} in each of {n} positions")
                key = f"{precision} {route}"
                out["lsb"][key] = hold_rows(f"{label} {key}", got, want, lsb_bound, share_bound,
                                            bf16=bf16)
                out["launches"][f"mesh {label}, {key}"] = launches
                out["ms"][f"{key}: single device"] = t_single
                out["ms"][f"{key}: mesh"] = t_mesh
                log(f"{label} {key}: {launches} MRF launches ({n} generator calls of "
                    f"{per_call}), single device {t_single:.3f} ms, mesh {t_mesh:.3f} ms")
            # the stream runs on the first position: the single-device bytes
            mrf_block.mrf_section.launches = 0
            flow_wn_start()
            got = list(meshed.synthesize_stream(ids[0], seed=STREAM_SEED,
                                                length_scale=LENGTH_SCALE))
            stream_launches = mrf_block.mrf_section.launches
            flow_wn_read(f"mesh {label}, {precision} stream")
            want = list(single.synthesize_stream(ids[0], seed=STREAM_SEED,
                                                 length_scale=LENGTH_SCALE))
        if len(got) != len(want) or any(not np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label} {precision} stream: chunks differ from the single "
                                 "device's")
        out["launches"][f"mesh {label}, {precision} stream"] = stream_launches
        log(f"{label} {precision} stream: {len(got)} chunks equal to the single device's, "
            f"{stream_launches} MRF launches")

    # float32 from here: make_sharded_synthesis at noise 0 against the
    # engine's batch path (its mel and generator on the single device)
    single, _, jobs = mesh_engines(root, mesh, "high")
    tts, voc = jobs[0]["tts_model"], jobs[0]["vocoder_model"]
    id_arr, lengths, _ = single._pad_id_arrays(ids, n)
    # length scale 1: make_sharded_synthesis has none (JAX's has none)
    enc1, g1 = single.encode_launch(ids, 1.0)
    y1 = enc1.lengths.numpy()
    m1 = single.policy.mel_bucket(int(y1.max()))
    mel1, mask1 = single.decode_launch(enc1, y1, g1, len(ids), noise_scale=0.0)
    want = single._generate(postprocess(mel1, mask1, single.audio_settings).transpose(1, 2))
    fn = make_sharded_synthesis(tts.model_config, voc.model_config, mesh, m1, tts.audio_settings)
    with recording_mrf_shapes(mrf_shapes):
        mrf_block.mrf_section.launches = 0
        (got, got_y), t_sharded = timed_once(lambda: fn(tts.params, voc.params, id_arr, lengths,
                                                        seed=0, noise_scale=0.0))
        sharded_launches = mrf_block.mrf_section.launches
    if not np.array_equal(got_y.cpu().numpy(), y1):
        raise AssertionError(f"make_sharded_synthesis y_lengths {got_y.tolist()} vs {y1.tolist()}")
    err = (got.float() - want.float()).abs().max().item() / want.abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"make_sharded_synthesis: {err:.3g} of the audio's scale from the "
                             "engine's batch path")
    out["launches"][f"mesh {label}, make_sharded_synthesis"] = sharded_launches
    out["ms"]["make_sharded_synthesis, pangram x8"] = t_sharded
    log(f"{label} make_sharded_synthesis, pangram x8 at length scale 1, noise 0: float audio "
        f"within {err:.3g} of its scale from the engine's batch path (bound 1e-4), "
        f"{sharded_launches} MRF launches, {t_sharded:.3f} ms")

    # WaveGlow wn_256: one pangram at the 1024-frame bucket takes the grid
    wg_single, wg_mesh, _ = mesh_engines(root, mesh, "waveglow")
    with recording_wn_shapes(wn_shapes):
        want = wg_single.synthesize_batch(ids[:1], **kw)
        wn_layer.fused_wn_layer_state.launches = 0
        flow_wn_start()
        hits = wg_mesh._grid_shard_hits
        got, t_wg = timed_once(lambda: wg_mesh.synthesize_batch(ids[:1], **kw))
        wg_launches = wn_layer.fused_wn_layer_state.launches
        flow_wn_read(f"mesh {label}, waveglow grid")
    if wg_mesh._grid_shard_hits != hits + 1:
        raise AssertionError(f"{label} waveglow: the grid did not run (plan "
                             f"{wg_mesh._grid_vocode_plan(1, 1024, wg_mesh._wg_halo_frames)})")
    cfg = wg_mesh.vocoder_cfg
    per_group = cfg.flows * cfg.wn_layers
    if wg_launches != per_group * n:
        raise AssertionError(f"{label} waveglow grid: {wg_launches} WN launches, expected "
                             f"{per_group} in each of {n} windows")
    out["lsb"]["waveglow grid, pangram"] = hold_rows(f"{label} f32 waveglow grid, pangram", got,
                                                     want, WINDOW_LSB, WINDOW_SHARE)
    out["launches"][f"mesh {label}, waveglow grid"] = wg_launches
    out["ms"]["waveglow grid, pangram: mesh"] = t_wg
    m = single.policy.mel_bucket(int(single.encode_batch(ids[:1], LENGTH_SCALE)[1][0]))
    halo = stream_halo_frames(single.vocoder_cfg)
    for cards in (2, 4, 8):
        log(f"latency model (a prediction, parallel/time_shard.py): a {m}-frame utterance on "
            f"{cards} cards, M / (M/N + 2 halo) = {m / (m / cards + 2 * halo):.2f}x (HiFi-GAN "
            f"halo {halo}); WaveGlow halo {wg_mesh._wg_halo_frames}: "
            f"{m / (m / cards + 2 * wg_mesh._wg_halo_frames):.2f}x")
    pin_precision("f32")
    return out


def mesh_train_problem(corpus: Path):
    """Phase 16's training problem, as numpy: the corpus's first batch of 32
    (ids 192, mels 1024 x 80) for GlowTTS and Tacotron2, and 16 crops of
    8192 samples with their mels for HiFi-GAN."""
    from larynx_tpu_torch import train_vocoder
    from larynx_tpu_torch.audio import AudioSettings
    from larynx_tpu_torch.device import to_device
    from larynx_tpu_torch.models.glow_tts.data import Dataset
    from larynx_tpu_torch.text.ids import load_phoneme_ids

    with open(corpus / "phonemes.txt", encoding="utf-8") as f:
        table = load_phoneme_ids(f)
    batch = next(Dataset(corpus / "metadata.csv", corpus / "wavs", table, AudioSettings(**AUDIO),
                         device="cuda").batches(32, shuffle_seed=0))
    up = 256
    wavs = train_vocoder._load_corpus(corpus / "wavs", 32 * up + up)
    audio = train_vocoder._sample_batch(np.random.default_rng(0), wavs, 16, 32 * up, up)
    mels = train_vocoder._make_mel_fn(AudioSettings(), 32, "cuda")(to_device(audio, "cuda"))
    return {"batch": batch, "audio": audio, "mels": mels.cpu().numpy(),
            "num_symbols": max(table.values()) + 1}


def _mesh_grad_tree(params):
    if isinstance(params, dict):
        return {k: _mesh_grad_tree(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_mesh_grad_tree(v) for v in params]
    return (torch.zeros_like(params) if params.grad is None else params.grad).detach().clone()


# Tacotron2's conv biases before a BatchNorm: the norm removes them, so their
# true gradient is 0 and both sides hold float32 noise of sums over B x T
# positions; they are held by magnitude (under this share of the net's
# largest gradient on both sides), not against each other
T2_ZERO_GRAD = ("/encoder/convs/", "/postnet/convs/")
T2_ZERO_GRAD_SHARE = 1e-3


def _zero_grad_leaf(path: str) -> bool:
    return path.startswith(T2_ZERO_GRAD) and path.endswith("/b")


def _mesh_rel_errors(got, want, floor_share, skip=lambda path: False):
    """The largest |got - want| as a share of each leaf's scale (floored at
    ``floor_share`` of the largest), and the three worst leaves; leaves for
    which ``skip`` holds are left out."""
    want_l, got_l = dict(flat_tree(want)), dict(flat_tree(got))
    floor = floor_share * max(v.abs().max().item() for v in want_l.values())
    errs = {p: (got_l[p].double() - w.double()).abs().max().item()
            / max(w.abs().max().item(), floor, 1e-30) for p, w in want_l.items() if not skip(p)}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    return worst[0][1], ", ".join(f"{p} {e:.3g}" for p, e in worst)


def mesh_train_rank(rank: int, port: int, out_file: str, problem: dict):
    """One of phase 16's two training ranks on cuda:0 over gloo.  Each case
    runs its world-2 step twice (the second timed); rank 0 then runs the
    world-1 step on the whole batch and holds the first world-2 step
    against it.  Rank 0 writes the errors and times to ``out_file``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                      RANK=str(rank), LOCAL_RANK="0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from larynx_tpu_torch.audio import AudioSettings
    from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
    from larynx_tpu_torch.models.hifi_gan import training as gan_training
    from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
    from larynx_tpu_torch.models.tacotron2 import training as t2_training
    from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config
    from larynx_tpu_torch.parallel import mesh as pmesh
    from larynx_tpu_torch.parallel import train as ptrain
    from larynx_tpu_torch.weights import init_params, params_from_jax

    dp = pmesh.make_mesh(1, device="cuda:0", backend="gloo")
    tp = pmesh.make_mesh(2, device="cuda:0", backend="gloo")
    report = {"errors": {}, "ms": {}, "stats": {}}
    batch = problem["batch"]

    def twice(step):
        """The first call's result, and the second call's host-clocked ms."""
        first = step()
        _, ms = timed_once(step)
        return first, ms

    # GlowTTS, harvard dims: data parallel 2, then model parallel 2
    cfg = GlowTTSConfig()
    full = params_from_jax(init_params(torch.Generator().manual_seed(0), cfg), "glow_tts", "cuda")

    def glow(mesh):
        opt = ptrain.make_optimizer(cfg, grad_clip=1e9)  # the value clip never binds
        state = ptrain.init_train_state(full if mesh is None else pmesh.shard_params(full, mesh),
                                        opt)
        step = ptrain.make_train_step(cfg, opt, mesh)
        history = ptrain.MetricHistory(None if mesh is None else mesh.data_group)

        def once():
            _, metrics = step(state, batch)
            history.append(metrics)
            return _mesh_grad_tree(state.params)

        grads, ms = twice(once)
        history.flush()
        if mesh is not None and mesh.model_parallel > 1:
            grads = pmesh.gather_params(grads, mesh)
        return grads, history.steps[0], ms

    for name, mesh in (("glow_tts data parallel 2", dp), ("glow_tts model parallel 2", tp)):
        grads, metrics, ms = glow(mesh)
        report["ms"][name] = ms
        if rank == 0:
            want, want_metrics, ms1 = glow(None)
            report["ms"]["glow_tts world 1"] = ms1
            err, path = _mesh_rel_errors(tree_to_cpu(grads), tree_to_cpu(want), TRAIN_GRAD_RTOL)
            loss_err = max(abs(metrics[k] - want_metrics[k]) / abs(want_metrics[k])
                           for k in want_metrics)
            report["errors"][name] = (err, path, loss_err, MESH_GRAD_RTOL["glow_tts"])

    # HiFi-GAN universal_large, batch 16: both updates (learning rate 0, so
    # the generator's objective sees the same discriminators on both sides)
    hcfg = HiFiGanConfig()
    gen_np = init_params(torch.Generator().manual_seed(1), hcfg)
    dis_np = init_params(torch.Generator().manual_seed(2), "discriminators")
    audio = torch.from_numpy(problem["audio"]).cuda()
    mels = torch.from_numpy(problem["mels"]).cuda()

    def hifi(mesh):
        opt = ptrain.Optimizer(lambda k: 0.0, betas=(0.8, 0.99))
        gen = ptrain.trainable(params_from_jax(gen_np, "hifi_gan", "cuda"))
        dis = ptrain.trainable(params_from_jax(dis_np, "discriminators", "cuda"))
        state = gan_training.GanTrainState(gen, dis, opt.init(gen), opt.init(dis))
        step = gan_training.make_gan_train_step(hcfg, AudioSettings(), opt, opt, mesh=mesh)
        d_grads = {}
        update = opt.update

        def capture(opt_state):
            if opt_state is state.disc_opt:
                d_grads["d"] = _mesh_grad_tree(state.disc_params)
            update(opt_state)

        opt.update = capture

        def once():
            step(state, {"audio": audio, "mels": mels})
            return {"d": d_grads["d"], "g": _mesh_grad_tree(state.gen_params)}

        return twice(once)

    grads, ms = hifi(dp)
    report["ms"]["hifi_gan data parallel 2"] = ms
    if rank == 0:
        want, report["ms"]["hifi_gan world 1"] = hifi(None)
        for part in ("d", "g"):
            err, path = _mesh_rel_errors(tree_to_cpu(grads[part]), tree_to_cpu(want[part]),
                                         TRAIN_GRAD_RTOL)
            report["errors"][f"hifi_gan {part} data parallel 2"] = (
                err, path, 0.0, MESH_GRAD_RTOL["hifi_gan"])
    del grads

    # Tacotron2, NVIDIA's hparams, batch 32: gradients and running statistics
    tcfg = Tacotron2Config(num_symbols=problem["num_symbols"])
    t2_np = init_params(torch.Generator().manual_seed(3), tcfg)
    bsz, t_ids = batch["ids"].shape
    masks = t2_training.draw_train_masks(tcfg, bsz, t_ids, batch["mels"].shape[1],
                                         T2_TRAIN_SEED + 1, 0, "cuda")

    def t2(mesh):
        opt = ptrain.Optimizer(lambda k: 0.0)
        state = t2_training.init_train_state(params_from_jax(t2_np, "tacotron2", "cuda"), opt)
        step = t2_training.make_train_step(tcfg, opt, mesh)
        history = ptrain.MetricHistory(None if mesh is None else mesh.data_group)
        _, metrics = step(state, batch, masks)
        history.append(metrics)
        history.flush()
        grads = _mesh_grad_tree(state.params)
        stats = {p: v.detach().clone() for p, v in flat_tree(state.params)
                 if p.endswith(("/mean", "/var"))}
        _, ms = timed_once(lambda: step(state, batch, masks))
        return grads, stats, history.steps[0], ms

    grads, stats, metrics, ms = t2(dp)
    report["ms"]["tacotron2 data parallel 2"] = ms
    if rank == 0:
        want, want_stats, want_metrics, report["ms"]["tacotron2 world 1"] = t2(None)
        got_cpu, want_cpu = tree_to_cpu(grads), tree_to_cpu(want)
        err, path = _mesh_rel_errors(got_cpu, want_cpu, 1e-2, skip=_zero_grad_leaf)
        loss_err = max(abs(metrics[k] - want_metrics[k]) / abs(want_metrics[k])
                       for k in want_metrics)
        largest = max(v.abs().max().item() for _p, v in flat_tree(want_cpu))
        report["stats"]["tacotron2 zero-gradient biases, share of the largest gradient"] = max(
            v.abs().max().item() / largest for tree in (got_cpu, want_cpu)
            for p, v in flat_tree(tree) if _zero_grad_leaf(p))
        report["errors"]["tacotron2 data parallel 2"] = (err, path, loss_err,
                                                         MESH_GRAD_RTOL["tacotron2"])
        report["stats"]["tacotron2 running statistics"] = max(
            (stats[p] - want_stats[p]).abs().max().item() for p in want_stats)
        report["stats"]["tacotron2 running statistics moved"] = max(
            (want_stats[p] - (0.0 if p.endswith("mean") else 1.0)).abs().max().item()
            for p in want_stats)
        Path(out_file).write_text(json.dumps(report))
    dp.close()


def tree_to_cpu(tree):
    if isinstance(tree, dict):
        return {k: tree_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_cpu(v) for v in tree]
    return tree.detach().cpu()


def mesh_training(root: Path, corpus: Path):
    """Phase 16, training: (a) one GlowTTS CLI step under torchrun with one
    process (an NCCL group of one) against the same run with no torchrun;
    (b) two ranks on cuda:0 over gloo against world 1 (``mesh_train_rank``)."""
    import torch.multiprocessing as tmp

    from larynx_tpu_torch import train
    from larynx_tpu_torch.convert.native import load_params

    out = {"ms": {}}
    # (a) the first batch of 32 rows: one step, with DDI
    sub = root / "mesh_corpus"
    sub.mkdir()
    rows = (corpus / "metadata.csv").read_text(encoding="utf-8").splitlines()[:32]
    (sub / "metadata.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")

    def argv(out_dir):
        return ["--metadata", str(sub / "metadata.csv"), "--wav-dir", str(corpus / "wavs"),
                "--output-dir", str(out_dir), "--config", str(corpus / "config.json"),
                "--phonemes", str(corpus / "phonemes.txt"), "--batch-size", "32", "--epochs", "1",
                "--ddi", "--device", "cuda"]

    runs = {}
    for name in ("no group, run 1", "no group, run 2"):
        _, ms = timed_once(lambda: train.main(argv(root / "mesh_voices" / name.replace(" ", "_")
                                                    .replace(",", ""))))
        runs[name] = ms
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node", "1",
         "--master-addr", "127.0.0.1", "--master-port", str(free_port()), "-m",
         "larynx_tpu_torch.train", *argv(root / "mesh_voices" / "torchrun")],
        capture_output=True, text=True, cwd=Path(__file__).resolve().parent, env=env, timeout=600)
    runs["torchrun, one process"] = 1e3 * (time.perf_counter() - start)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train: exit {proc.returncode}: {proc.stderr[-3000:]}")
    if "mesh: data 1, model 1" not in proc.stderr + proc.stdout:
        raise AssertionError("torchrun train: no mesh line in its log")
    trees = {name: dict(flat_tree(load_params(root / "mesh_voices" / d / "generator.npz")))
             for name, d in (("a", "no_group_run_1"), ("b", "no_group_run_2"),
                             ("t", "torchrun"))}
    spread = max(np.abs(trees["a"][p] - trees["b"][p]).max() for p in trees["a"])
    diff = max(np.abs(trees["a"][p] - trees["t"][p]).max() for p in trees["a"])
    if spread == 0.0:
        if diff != 0.0:
            raise AssertionError(f"torchrun train: generator.npz {diff:.3g} from the run without "
                                 "a group, where two runs without one are bit for bit equal")
        verdict = "bit for bit equal (two runs without a group are too)"
    else:
        if not diff <= 2 * spread:
            raise AssertionError(f"torchrun train: {diff:.3g} from the run without a group, "
                                 f"beyond twice the runs' own spread {spread:.3g}")
        verdict = (f"within {diff:.3g} (two runs without a group differ by {spread:.3g}: cuDNN's "
                   "algorithms are not deterministic; bound twice that)")
    log(f"phase 16 (a): train, GlowTTS harvard, one step of 32 rows with DDI: torchrun "
        f"--nproc-per-node 1 (NCCL, a group of one) against no torchrun: {verdict}; walls "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in runs.items()))
    out["ms"].update({f"train CLI, {k}": v for k, v in runs.items()})

    # (b) two ranks on the one card over gloo
    problem = mesh_train_problem(corpus)
    report_file = root / "mesh_train_report.json"
    start = time.perf_counter()
    tmp.spawn(mesh_train_rank, args=(free_port(), str(report_file), problem), nprocs=2,
              join=True)
    wall = time.perf_counter() - start
    report = json.loads(report_file.read_text())
    for name, (err, path, loss_err, bound) in report["errors"].items():
        log(f"phase 16 (b): {name} on cuda:0 over gloo against world 1 on the card: gradients "
            f"within {err:.3g} of their scale (worst leaves {path}; bound {bound}), losses within "
            f"{loss_err:.3g} relative")
        if not err <= bound or not loss_err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"phase 16 (b) {name}: gradient {err:.3g} at {path} (bound "
                                 f"{bound}), losses {loss_err:.3g}")
    stat_err = report["stats"]["tacotron2 running statistics"]
    moved = report["stats"]["tacotron2 running statistics moved"]
    if not stat_err <= MESH_STAT_ATOL or not moved > 1e-4:
        raise AssertionError(f"phase 16 (b) tacotron2: running statistics {stat_err:.3g} from "
                             f"world 1 (bound {MESH_STAT_ATOL}), moved {moved:.3g}")
    zero = report["stats"]["tacotron2 zero-gradient biases, share of the largest gradient"]
    if not zero <= T2_ZERO_GRAD_SHARE:
        raise AssertionError(f"phase 16 (b) tacotron2: a conv bias before a BatchNorm has a "
                             f"gradient {zero:.3g} of the largest (bound {T2_ZERO_GRAD_SHARE})")
    log(f"phase 16 (b): tacotron2 conv biases before a BatchNorm (true gradient 0): at most "
        f"{zero:.3g} of the net's largest gradient on either side (bound {T2_ZERO_GRAD_SHARE})")
    log(f"phase 16 (b): tacotron2 running statistics within {stat_err:.3g} of world 1's (bound "
        f"{MESH_STAT_ATOL}), moved up to {moved:.3g} from the init; the two ranks' wall "
        f"{wall:.1f} s; step times (host clock, rank 0, the second step; two processes share "
        "the card): " + ", ".join(f"{k} {v:.3f} ms" for k, v in report["ms"].items()))
    out["ms"].update(report["ms"])
    return out


def mesh_path(root: Path, mrf_block, wn_layer, mrf_shapes: set, wn_shapes: set):
    """Phase 16: the multi-device layer (see the module docstring)."""
    from larynx_tpu_torch.parallel.mesh import ServingMesh, serving_mesh

    count = torch.cuda.device_count()
    mesh = serving_mesh()
    log(f"phase 16: torch.cuda.device_count() {count}; serving_mesh() {mesh}")
    if count == 1 and mesh is not None:
        raise AssertionError("serving_mesh() built a mesh on one card")
    out = {"launches": {}, "ms": {}, "lsb": {}}
    meshes = [(f"{MESH_POSITIONS} positions on cuda:0", ServingMesh(["cuda:0"] * MESH_POSITIONS))]
    if mesh is not None:
        meshes.append((f"{len(mesh)} cards", mesh))
    for label, m in meshes:
        got = mesh_serving(root, mrf_block, wn_layer, m, label, mrf_shapes, wn_shapes)
        for k in out:
            out[k].update({f"{label}: {kk}": v for kk, v in got[k].items()})
    trained = mesh_training(root, root / "train_corpus")
    out["ms"].update(trained["ms"])
    return out


def flat_tree(tree, prefix=""):
    """[(path, leaf)] of a parameter tree."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat_tree(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in flat_tree(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def kernel_entry(name, source, replaces, launches, by_path, rows, main_rows, scale=1):
    """One entry of the kernels line: times summed over the main path's rows
    (times ``scale``), the bound from their summed operations and bytes."""
    ops = scale * sum(r["ops_ms"] for r in main_rows)
    byt = scale * sum(r["bytes_ms"] for r in main_rows)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": scale * sum(r["ms"] for r in main_rows),
        "plain_ms": scale * sum(r["plain_ms"] for r in main_rows),
        "bound_ms": max(ops, byt), "bound_by": "operations" if ops > byt else "bytes",
        "library_ms": scale * sum(r["library_ms"] for r in main_rows),
        "cases": rows,
    }


def t2_step_entry(t2, t2_step_rows):
    """The decoder step kernel's entry of the kernels line: a step's time
    averaged over t2wg_batch8's text buckets at B=8, and its launches as
    phase 13's main path counted them (``tacotron2_path``)."""
    t2_main = [r for r in t2_step_rows if r["main_path"]]
    t2_dec, t2_engine = t2["decode"], t2["engine_decode"]
    return kernel_entry(
        "tacotron2_step", "larynx_tpu_torch/csrc/tacotron2_step.cu",
        "none: the JAX package leaves Tacotron2's decoder step to XLA",
        t2_engine["step_kernel_launches"],
        {f"tacotron2 text_to_speech, pangram, {t2_engine['steps']} steps "
         f"({t2_engine['blocks']} blocks)": t2_engine["step_kernel_launches"],
         f"tacotron2 blocked decode, B=1, {t2_dec['steps']} steps ({t2_dec['blocks']} blocks)":
             t2_dec["step_kernel_launches"],
         "the same decode traced, step kernels": t2_dec["step_kernels_traced"],
         "the same decode traced, cuBLAS kernels": t2_dec["cublas_kernels"],
         "launches a block, blocked decode": t2_dec["step_kernel_launches"] / t2_dec["blocks"],
         f"launches a {T2_KERNEL_STEPS}-step block at B=8":
             max(r["launches_per_block"] for r in t2_main)},
        t2_step_rows, t2_main, scale=1 / len(t2_main))


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
    build.build(["mrf_section", "wn_layer", "mrf_bf16", "wn_bf16", "tacotron2_step", "flow_wn"])
    for name in ("mrf_section", "wn_layer", "mrf_bf16", "wn_bf16", "tacotron2_step", "flow_wn"):
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
    check_wn_bf16_plan(wn_layer)
    # the bf16 kernel's own geometry against ops/mrf_block.py's mirror: the
    # unit plan's widest units at C=128, the section plan at C <= 64
    for c, (ks, dils, cpu) in ((128, ((11,), ((5,),), 2)), (128, ((7,), ((12,),), 1)), (64, R1),
                               (32, R1), (8, R1), (64, R2)):
        got = mrf_block.bf16_geometry(mrf_block.MRFStage(None, None, None, ks, dils, cpu), c)
        r, s, p = mrf_block.bf16_tile(c, ks, dils, cpu)
        want = [r, s, p, mrf_block.bf16_ring_stages(c, r, p), mrf_block.bf16_smem_bytes(c, r, p),
                int(mrf_block.bf16_fits(c, r, p))]
        if got != want:
            raise AssertionError(f"mrf_bf16 (C={c}, k={ks}, d={dils}): kernel geometry {got}, "
                                 f"ops/mrf_block.py mirrors {want}")
        log(f"mrf_bf16 {mrf_block.bf16_plan(c)} plan, C={c}, k={ks}, d={dils}: {r} output rows "
            f"a block, halo {s}, {p} buffer rows, {got[3]}-stage weight ring, dynamic shared "
            f"memory {got[4]} bytes per block")

    # plain references and the main path run in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with tempfile.TemporaryDirectory() as tmp:
        stage_voices(Path(tmp))
        pin_precision("f32")  # phases 2-8: the float32 paths (the CUDA default is bf16)
        jobs, engine, y_lengths, main_cases = plan_main_path(Path(tmp))
        wg_jobs, wg_engine, wg_y, wg_plan, wg_shapes = plan_waveglow_path(Path(tmp))
        stream = stream_cases(engine)
        mrf_cases, mrf_units = phase2_mrf_cases(main_cases, stream)
        rows = check_mrf(mrf_block, mrf_cases, mrf_units)
        wn_rows, wn_stacks = check_wn(wn_layer, wg_shapes)
        count_flow_decodes()
        flow_rows = check_flow_wn(engine, [j["ids"] for j in jobs], y_lengths)
        bf16_cases = list(main_cases) + list(stream) + [
            ("vctk_medium stage 4 (C=8, inputs padded to 16), 512-frame mel", 8, R1, 8, 131072,
             False),
            ("vctk_small stage 1, 512-frame mel", 128, R2, 8, 4096, False),
            ("ResBlock2 section (vctk_small's dilations)", 64, R2, 8, 32768, False),
            ("ragged T", 128, R1, 2, 1000, False),
            ("ragged T, 13 tiles", 64, R1, 3, 256 * 13 - 50, False),
            ("ragged T, 13 tiles", 32, R1, 3, 256 * 13 - 50, False),
            ("T under one tile", 32, R1, 2, 100, False),
            ("T under one tile, ResBlock2", 64, R2, 2, 100, False),
        ]
        bf16_rows = check_mrf(mrf_block, bf16_cases, dtype=torch.bfloat16)
        bf16_wn_rows, bf16_wn_stacks = check_wn(wn_layer, wg_shapes, dtype=torch.bfloat16)
        bf16_wn_stacks += wn_stack_rows(
            wn_layer, [(1, t) for t in WN_B1_T if (1, t) not in wg_shapes],
            torch.Generator().manual_seed(9), torch.bfloat16,
            "B=1 (server, fallback stream, trained voice, mesh grid), 8-layer WN stack")
        launches = main_path(Path(tmp), mrf_block, jobs, engine, y_lengths)
        wn_launches = waveglow_path(Path(tmp), wn_layer, mrf_block, wg_jobs, wg_engine, wg_y,
                                    wg_plan)
        stream_launches = stream_path(Path(tmp), mrf_block, engine, int(y_lengths[0]))
        path_shapes = {"scheduler batch": set(), "cli": set()}
        scheduler_launches = scheduler_path(Path(tmp), mrf_block, engine,
                                            path_shapes["scheduler batch"])
        cli_launches = cli_path(Path(tmp), mrf_block, engine, int(y_lengths[0]),
                                path_shapes["cli"])
        # phase 8: the kernel at the shapes phases 6 and 7 gave it
        phase8_cases = path_mrf_cases(mrf_cases, path_shapes)
        rows += check_mrf(mrf_block, phase8_cases)
        # phase 9: the bf16 paths; phase 10: the bf16 kernel at their shapes
        pin_precision(None)
        bf16_shapes = set()
        bf16 = bf16_path(Path(tmp), mrf_block, wn_layer, y_lengths, wg_plan, bf16_shapes)
        bf16_rows += check_mrf(mrf_block, path_mrf_cases(bf16_cases, {"bf16 stream/cli":
                                                                      bf16_shapes}),
                               dtype=torch.bfloat16)
        # phase 11: the server on the card in float32, then both kernels at
        # the shapes it gave them
        pin_precision("f32")
        server_mrf, server_wn = set(), set()
        served = server_path(Path(tmp), mrf_block, wn_layer, engine, wg_engine, server_mrf,
                             server_wn)
        server_cases = path_mrf_cases(mrf_cases + phase8_cases, {"server": server_mrf})
        rows += check_mrf(mrf_block, server_cases)
        for shape in sorted(server_wn & set(wg_shapes)):
            log(f"wn_layer server, B={shape[0]} T={shape[1]}: checked as a main path stack")
        wn_stacks += wn_stack_rows(wn_layer, sorted(server_wn - set(wg_shapes), reverse=True),
                                   torch.Generator().manual_seed(4), torch.float32,
                                   "server paths, 8-layer WN stack")
        # phase 12: the pipelined batch path and multi-speaker GlowTTS in
        # float32, then both kernels at the shapes it gave them
        start12 = time.perf_counter()
        run_mrf, run_wn = set(), set()
        run = run_jobs_path(Path(tmp), mrf_block, wn_layer, run_mrf, run_wn)
        t_path = time.perf_counter() - start12
        run_cases = path_mrf_cases(mrf_cases + phase8_cases + server_cases, {"run_jobs": run_mrf})
        rows += check_mrf(mrf_block, run_cases)
        checked_wn = set(wg_shapes) | server_wn
        for shape in sorted(run_wn & checked_wn):
            log(f"wn_layer run_jobs, B={shape[0]} T={shape[1]}: checked by an earlier stack")
        wn_stacks += wn_stack_rows(wn_layer, sorted(run_wn - checked_wn, reverse=True),
                                   torch.Generator().manual_seed(5), torch.float32,
                                   "run_jobs paths, 8-layer WN stack")
        log(f"phase 12 times: paths {t_path:.1f} s, kernels at its shapes "
            f"{time.perf_counter() - start12 - t_path:.1f} s")
        # phase 13: Tacotron2 and checkpoint import in float32, then both
        # kernels at the shapes it gave them
        start13 = time.perf_counter()
        stage_tacotron2_voices(Path(tmp))
        t2_mrf, t2_wn = set(), set()
        t2 = tacotron2_path(Path(tmp), mrf_block, wn_layer, t2_mrf, t2_wn)
        t2_step_rows = check_t2_step()
        t_path = time.perf_counter() - start13
        rows += check_mrf(mrf_block, path_mrf_cases(
            mrf_cases + phase8_cases + server_cases + run_cases, {"tacotron2": t2_mrf}))
        checked_wn |= run_wn
        for shape in sorted(t2_wn & checked_wn):
            log(f"wn_layer tacotron2, B={shape[0]} T={shape[1]}: checked by an earlier stack")
        wn_stacks += wn_stack_rows(wn_layer, sorted(t2_wn - checked_wn, reverse=True),
                                   torch.Generator().manual_seed(6), torch.float32,
                                   "tacotron2 paths, 8-layer WN stack")
        log(f"phase 13 times: paths {t_path:.1f} s, kernels at its shapes "
            f"{time.perf_counter() - start13 - t_path:.1f} s")
        # phase 14: training in float32, then the MRF kernel at the shapes
        # that the trained vocoder gave it
        start14 = time.perf_counter()
        train_mrf = set()
        trained = training_path(Path(tmp), mrf_block, train_mrf)
        t_path = time.perf_counter() - start14
        train_cases = path_mrf_cases(mrf_cases + phase8_cases + server_cases + run_cases,
                                     {"trained vocoder": train_mrf})
        rows += check_mrf(mrf_block, train_cases)
        log(f"phase 14 times: paths {t_path:.1f} s, kernel at its shapes "
            f"{time.perf_counter() - start14 - t_path:.1f} s")
        # phase 15: WaveGlow and Tacotron2 training in float32, then both
        # kernels at the shapes that the trained dirs gave them
        start15 = time.perf_counter()
        train2_mrf, train2_wn = set(), set()
        trained2 = training_path_2(Path(tmp), mrf_block, wn_layer, train2_mrf, train2_wn)
        t_path = time.perf_counter() - start15
        rows += check_mrf(mrf_block, path_mrf_cases(
            mrf_cases + phase8_cases + server_cases + run_cases + train_cases,
            {"trained tacotron2": train2_mrf}))
        checked_wn |= t2_wn
        for shape in sorted(train2_wn & checked_wn):
            log(f"wn_layer trained waveglow, B={shape[0]} T={shape[1]}: checked by an earlier "
                "stack")
        wn_stacks += wn_stack_rows(wn_layer, sorted(train2_wn - checked_wn, reverse=True),
                                   torch.Generator().manual_seed(7), torch.float32,
                                   "trained waveglow, 8-layer WN stack")
        log(f"phase 15 times: paths {t_path:.1f} s, kernels at its shapes "
            f"{time.perf_counter() - start15 - t_path:.1f} s")
        # phase 16: the serving mesh and the training mesh, then both kernels
        # at the shapes that the mesh's positions and windows gave them
        start16 = time.perf_counter()
        mesh_mrf, mesh_wn = set(), set()
        meshed = mesh_path(Path(tmp), mrf_block, wn_layer, mesh_mrf, mesh_wn)
        t_path = time.perf_counter() - start16
        rows += check_mrf(mrf_block, path_mrf_cases(
            mrf_cases + phase8_cases + server_cases + run_cases + train_cases,
            {"mesh positions and windows": {s for s in mesh_mrf}}))
        bf16_rows += check_mrf(mrf_block, path_mrf_cases(
            bf16_cases, {"bf16 mesh positions and windows": {s for s in mesh_mrf}}),
            dtype=torch.bfloat16)
        checked_wn |= train2_wn
        for shape in sorted(mesh_wn & checked_wn):
            log(f"wn_layer mesh window, B={shape[0]} T={shape[1]}: checked by an earlier stack")
        wn_stacks += wn_stack_rows(wn_layer, sorted(mesh_wn - checked_wn, reverse=True),
                                   torch.Generator().manual_seed(8), torch.float32,
                                   "mesh windows, 8-layer WN stack")
        log(f"phase 16 times: paths {t_path:.1f} s, kernels at its shapes "
            f"{time.perf_counter() - start16 - t_path:.1f} s")
        log("training step times, this run (host clock, mean of 3, f32, TF32 off): GlowTTS "
            f"{trained['ms']['train step, batch 32']:.3f} ms, HiFi-GAN "
            f"{trained['ms']['train_vocoder step, batch 16']:.3f} ms (earlier runs on an H100 at "
            "700 W: 220-339 and 209-210 ms), WaveGlow "
            f"{trained2['ms']['waveglow train step, batch 16']:.3f} ms, Tacotron2 "
            f"{trained2['ms']['tacotron2 train step, batch 32']:.3f} ms")
        pin_precision(None)

    main_rows = [r for r in rows if r["main_path"]]
    kernels = [{
        "name": "mrf_section",
        "route": "cuda",
        "source": "larynx_tpu_torch/csrc/mrf_section.cu",
        "replaces": "larynx_tpu/ops/mrf_block.py:272; larynx_tpu/ops/mrf_block.py:382",
        "launches": launches,
        # each path's launches, counted from 0 around its own run
        "launches_by_path": {"text_to_speech, pangram x8": launches,
                             "stream_text_to_speech, pangram": stream_launches,
                             f"scheduler, {SCHEDULER_REQUESTS} requests": scheduler_launches,
                             "cli, pangram WAV": cli_launches["WAV on stdout"],
                             "cli --stream, pangram": cli_launches["--stream"],
                             **{k: v for k, v in served["launches"].items()
                                if "Glow" not in k and "waveglow" not in k},
                             **{k: v for k, v in run["launches"].items() if "waveglow" not in k},
                             **{k: v for k, v in t2["launches"].items() if "waveglow" not in k},
                             **trained["launches"],
                             **{k: v for k, v in trained2["launches"].items()
                                if "waveglow" not in k},
                             **{k: v for k, v in meshed["launches"].items()
                                if "waveglow" not in k and "bf16" not in k}},
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
        "launches_by_path": {"text_to_speech, pangram x8, waveglow": wn_launches,
                             **{k: v for k, v in served["launches"].items()
                                if "Glow" in k or "waveglow" in k},
                             **{k: v for k, v in run["launches"].items() if "waveglow" in k},
                             **{k: v for k, v in t2["launches"].items() if "waveglow" in k},
                             **{k: v for k, v in trained2["launches"].items()
                                if "waveglow" in k},
                             **{k: v for k, v in meshed["launches"].items() if "waveglow" in k}},
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

    # the bf16 kernels, each its own source (csrc/mrf_bf16.cu,
    # csrc/wn_bf16.cu); bound_by from the main rows' summed
    # operations and bytes (small rows may be bound by bytes at the bf16 peak)
    bf16_main = [r for r in bf16_rows if r["main_path"]]
    kernels.append(kernel_entry(
        "mrf_section (bf16)", "larynx_tpu_torch/csrc/mrf_bf16.cu",
        "larynx_tpu/ops/mrf_block.py:272; larynx_tpu/ops/mrf_block.py:382",
        bf16["launches"]["high"],
        {"text_to_speech, pangram x8, CUDA default": bf16["launches"]["high"],
         "text_to_speech, pangram x8, half=True": bf16["launches"]["half"],
         "stream_text_to_speech, pangram, CUDA default": bf16["launches"]["stream"],
         "stream_text_to_speech, pangram, half=True": bf16["launches"]["stream half"],
         "cli --half, pangram WAV": bf16["launches"]["cli --half"],
         **{k: v for k, v in meshed["launches"].items() if "bf16" in k}},
        bf16_rows, bf16_main))
    # the bf16 WN kernel at every path's WaveGlow shapes (the paths ran in
    # float32; the CUDA default runs them in bf16): the launches of one
    # group call (flows x one 8-layer stack) at each (B, T) a path gave
    path_wn = {"server": server_wn, "run_jobs": run_wn, "tacotron2": t2_wn,
               "trained waveglow": train2_wn, "mesh windows": mesh_wn}
    missing = sorted(set().union(*path_wn.values()) - {(r["B"], r["T"]) for r in bf16_wn_stacks})
    bf16_wn_stacks += wn_stack_rows(wn_layer, missing, torch.Generator().manual_seed(10),
                                    torch.bfloat16, "path shapes, 8-layer WN stack")
    bf16_stack_of = {(r["B"], r["T"]): r for r in bf16_wn_stacks}
    bf16_wn = kernel_entry(
        "wn_layer (bf16)", "larynx_tpu_torch/csrc/wn_bf16.cu",
        "larynx_tpu/ops/wn_layer.py:258; larynx_tpu/ops/wn_layer.py:332",
        bf16["launches"]["waveglow"],
        {"text_to_speech, pangram x8, waveglow, CUDA default": bf16["launches"]["waveglow"]},
        bf16_wn_rows + bf16_wn_stacks,
        [bf16_stack_of[(rows_g, frames * cfg.upsample_stride // cfg.groups)]
         for _s, rows_g, frames in wg_plan], scale=cfg.flows)
    bf16_wn["ms_by_path"] = {
        "text_to_speech, pangram x8, waveglow, CUDA default": bf16_wn["ms"],
        **{f"{path}, one group call at B={b} T={t}": cfg.flows * bf16_stack_of[(b, t)]["ms"]
           for path, shapes in path_wn.items() for b, t in sorted(shapes)}}
    kernels.append(bf16_wn)
    kernels.append(t2_step_entry(t2, t2_step_rows))
    # the main path's flow decode: its batch's 4-layer stack, once a coupling
    flow_main = [r for r in flow_rows if r["main_path"]]
    blocks = engine.glow_cfg.n_blocks_dec
    kernels.append({
        "name": "flow_wn", "route": "cuda", "source": "larynx_tpu_torch/csrc/flow_wn.cu",
        "replaces": "none (larynx_tpu/models/glow_tts/flows.py::wavenet is left to XLA)",
        "launches": FLOW_WN_LAUNCHES["text_to_speech, pangram x8"],
        "launches_by_path": dict(FLOW_WN_LAUNCHES),
        "max_rel_err": max(r["max_rel_err"] for r in flow_rows),
        **{k: blocks * sum(r[k] for r in flow_main)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "operations", "cases": flow_rows,
    })
    for path, ms in bf16_wn["ms_by_path"].items():
        log(f"wn_layer (bf16) by path: {path}: {ms:.3f} ms")
    for k in kernels[2:]:
        log(f"{k['name']}, main path: kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, "
            f"library {k['library_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms ({k['bound_by']}, "
            f"{k['bound_ms'] / k['ms']:.1%}), launches {k['launches']}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
