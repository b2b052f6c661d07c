#!/usr/bin/env python3
"""Profile the port's MRF kernel (larynx_tpu_torch/csrc/mrf_section.cu) on one GPU.

    python3 scripts/profile_torch_mrf.py [--repo DIR] [--label NAME]
    python3 scripts/profile_torch_mrf.py --hifigan [--bf16] [--repo DIR] [--label NAME]
    python3 scripts/profile_torch_mrf.py --bf16 [--repo DIR] [--label NAME]

The default mode runs ``mrf_section`` at the HiFi-GAN main path's three
shapes (universal_large stages 2-4 of 8 rows x 1024 mel frames: C=128,
T=65536; C=64, T=131072; C=32, T=262144) and prints one JSON line with,
per shape: the CUDA-event time of one section (mean of 10 after a
warm-up), the TF32 rate (3 TF32 operations per f32 FLOP), the bound and
the share of it (as chip_smoke.py counts them), and the time of each unit
kind alone at C=128; then ptxas's registers, spills and performance
warnings, and a census of each kernel instantiation's machine code
(cuobjdump: HGMMA, WARPGROUP.DEPBAR waits, local loads and stores).
``--hifigan`` instead profiles one universal_large generator call of the
main path (``models/hifi_gan/model.py::generator`` on 8 rows x 1024 mel
frames, random weights), 3 calls after a warm-up: CUDA events around each
phase (conv_pre, each stage's transposed conv, stage 1's resblocks in
cuDNN, each MRF section, conv_post; the rest, elementwise lrelu and tanh,
is the window less the phases), then ``torch.profiler``: the device's busy
share over the window and the device time of every kernel by name; with
``--bf16``, the call in bf16 as the CUDA default runs it (params and mel
cast to bf16).
``--bf16`` checks and times the bf16 kernel (csrc/mrf_bf16.cu): its
geometry against ops/mrf_block.py's mirror, then every case of
``BF16_CASES`` (the main path's three sections, the stream's one-row
windows, ragged and short T, ResBlock2, C = 8 and 16) against the plain
bf16 version (at most 2 bf16 ULPs of the output's scale), the main and
stream cases timed (mean of 10 after a warm-up) with their bound; each
case runs in a child process with a time limit, so a fault ends the case
and not the run.
``--repo`` profiles the package of another checkout (an older commit
unpacked with git archive), so two versions can be compared in one call.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys

import torch

TF32_PEAK_FLOPS = 495e12
TF32_PER_F32 = 3
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
R1 = ((3, 7, 11), ((1, 3, 5),) * 3, 2)  # universal_large: ResBlock1
R2 = ((3, 5, 7), ((1, 2), (2, 6), (3, 12)), 1)  # vctk_small: ResBlock2
BF16_CASES = (  # (label, C, geometry, B, T, timed)
    ("main path, stage 2", 128, R1, 8, 65536, True),
    ("main path, stage 3", 64, R1, 8, 131072, True),
    ("main path, stage 4", 32, R1, 8, 262144, True),
    ("stream chunk, stage 2", 128, R1, 1, 5888, True),
    ("stream chunk, stage 3", 64, R1, 1, 11776, True),
    ("stream chunk, stage 4", 32, R1, 1, 23552, True),
    ("ragged T, 13 tiles", 64, R1, 3, 256 * 13 - 50, False),
    ("ragged T, 13 tiles", 32, R1, 3, 256 * 13 - 50, False),
    ("ragged T, 13 blocks", 128, R1, 3, 246 * 13 - 50, False),
    ("T under one tile", 32, R1, 2, 100, False),
    ("T under one tile, ResBlock2", 64, R2, 2, 100, False),
    ("T under one block, ResBlock2", 128, R2, 2, 100, False),
    ("ResBlock2", 64, R2, 4, 32768, False),
    ("C=16", 16, R1, 2, 5000, False),
    ("C=8 (inputs padded to 16)", 8, R1, 8, 131072, False),
)
SHAPES = ((128, 65536), (64, 131072), (32, 262144))  # (C, T) of stages 2-4, B = 8
B = 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=".")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--hifigan", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--case", type=int, help=argparse.SUPPRESS)  # one BF16_CASES row, in a child
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mrf: no CUDA device", flush=True)
        return 1
    sys.path.insert(0, args.repo)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.hifigan:
        return profile_generator(args.label, torch.bfloat16 if args.bf16 else torch.float32)
    if args.case is not None:
        return bf16_case(args.case)
    if args.bf16:
        return profile_bf16(args)
    from larynx_tpu_torch.ops import build, mrf_block

    build.build(["mrf_section"])
    ptxas = sorted({line.split(":", 1)[-1].strip()
                    for line in build.BUILD_LOGS.get("mrf_section", "").splitlines()
                    if "registers" in line or "spill" in line or "Performance Loss" in line})
    gen = torch.Generator().manual_seed(0)
    rows = []
    for c, t in SHAPES:
        x = torch.randn((B, t, c), generator=gen).cuda()
        stage = random_stage(mrf_block, gen, c, *R1)
        ms = event_ms(lambda: mrf_block.mrf_section(x, stage))
        flops = 2.0 * B * t * c * c * R1[2] * sum(k * len(d) for k, d in zip(*R1[:2]))
        bound_ms = 1e3 * TF32_PER_F32 * flops / TF32_PEAK_FLOPS
        row = {"C": c, "B": B, "T": t, "ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
               "tf32_tflops": TF32_PER_F32 * flops / (ms * 1e-3) / 1e12}
        if c == 128:
            row["units_ms"] = {}
            for k, d in ((3, 1), (3, 3), (3, 5), (7, 1), (7, 3), (7, 5), (11, 1), (11, 3), (11, 5)):
                unit = random_stage(mrf_block, gen, c, (k,), ((d,),), 2)
                row["units_ms"][f"{k},{d}"] = event_ms(lambda: mrf_block.mrf_section(x, unit))
        rows.append(row)
    print(json.dumps({
        "label": args.label, "card": smi("name,power.limit"), "sections": rows,
        "ptxas": ptxas, "sass": sass_census(build.library_path("mrf_section")),
    }), flush=True)
    return 0


def random_stage(mrf_block, gen, c, kernel_sizes, dilations, convs_per_unit,
                 dtype=torch.float32):
    """A stage packed on the card, with the init's scale."""
    def conv(k):
        bound = 1.0 / (c * k) ** 0.5
        return {"w": ((torch.rand((c, c, k), generator=gen) * 2 - 1) * bound).cuda().to(dtype),
                "b": ((torch.rand(c, generator=gen) * 2 - 1) * bound).cuda().to(dtype)}

    if convs_per_unit == 2:
        blocks = [{"convs1": [conv(k) for _ in d], "convs2": [conv(k) for _ in d]}
                  for k, d in zip(kernel_sizes, dilations)]
    else:
        blocks = [{"convs": [conv(k) for _ in d]} for k, d in zip(kernel_sizes, dilations)]
    return mrf_block.pack_mrf_stage(blocks, kernel_sizes, dilations, convs_per_unit)


def profile_bf16(args) -> int:
    from larynx_tpu_torch.ops import build, mrf_block

    build.build(["mrf_bf16"])
    log = build.BUILD_LOGS.get("mrf_bf16", "")
    ptxas = sorted({line.split(":", 1)[-1].strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line or "Performance Loss" in line})
    print(json.dumps({"label": args.label, "card": smi("name,power.limit"), "ptxas": ptxas}),
          flush=True)
    geometry = []
    for c, (ks, dils, cpu) in ((128, R1), (64, R1), (32, R1), (16, R1), (8, R1), (128, R2),
                               (64, R2)):
        stage = random_stage(mrf_block, torch.Generator().manual_seed(0), c, ks, dils, cpu,
                             torch.bfloat16)
        got = mrf_block.bf16_geometry(stage, c)
        if mrf_block.bf16_plan(c) == "units":  # the kernel reports the first unit's launch
            ks, dils = ks[:1], ((dils[0][0],),)
        r, s, p = mrf_block.bf16_tile(c, ks, dils, cpu)
        want = [r, s, p, mrf_block.bf16_ring_stages(c, r, p), mrf_block.bf16_smem_bytes(c, r, p),
                int(mrf_block.bf16_fits(c, r, p))]
        geometry.append({"C": c, "convs_per_unit": cpu, "kernel": got, "mirror": want})
        if got != want:
            print(json.dumps({"geometry mismatch": geometry[-1]}), flush=True)
            return 1
    print(json.dumps({"geometry": geometry}), flush=True)
    failed = 0
    for i, case in enumerate(BF16_CASES):
        try:
            proc = subprocess.run([sys.executable, __file__, "--repo", args.repo, "--case",
                                   str(i)], capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired:
            print(json.dumps({"case": case[0], "C": case[1], "timed out": 300}), flush=True)
            failed += 1
            continue
        print(proc.stdout.strip() or json.dumps({"case": case[0], "C": case[1],
                                                 "stderr": proc.stderr[-2000:]}), flush=True)
        failed += proc.returncode != 0
    print(json.dumps({"sass": sass_census(build.library_path("mrf_bf16"))}), flush=True)
    return 1 if failed else 0


def ulps_of_scale(out, ref) -> float:
    """max |out - ref| in bf16 ULPs of ref's scale, 2^(floor(log2 max|ref|) - 7)."""
    ref = ref.float()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    return (out.float() - ref).abs().max().item() / ulp


def bf16_case(i) -> int:
    from larynx_tpu_torch.ops import mrf_block

    label, c, (ks, dils, cpu), b, t, timed = BF16_CASES[i]
    gen = torch.Generator().manual_seed(i)
    stage = random_stage(mrf_block, gen, c, ks, dils, cpu, torch.bfloat16)
    x = torch.randn((b, t, c), generator=gen).cuda().to(torch.bfloat16)
    mrf_block.mrf_section.launches = 0
    out = mrf_block.mrf_section(x, stage)
    torch.cuda.synchronize()
    launches = mrf_block.mrf_section.launches
    ref = mrf_block.mrf_section_plain(x, stage.w_flat, stage.b_flat, ks, dils, cpu)
    ulps = ulps_of_scale(out, ref)
    row = {"case": label, "C": c, "B": b, "T": t, "convs_per_unit": cpu, "launches": launches,
           "bf16_ulps_of_scale": ulps, "finite": bool(torch.isfinite(out.float()).all())}
    if timed:
        taps = cpu * sum(k * len(d) for k, d in zip(ks, dils))
        ops_ms = 1e3 * 2.0 * b * t * c * c * taps / BF16_PEAK_FLOPS
        bytes_ms = 1e3 * 2 * (2 * b * t * c + stage.wpack.numel()) / HBM_BYTES_PER_S
        row["ms"] = event_ms(lambda: mrf_block.mrf_section(x, stage))
        row["bound_ms"] = max(ops_ms, bytes_ms)
        row["bound_share"] = row["bound_ms"] / row["ms"]
    print(json.dumps(row), flush=True)
    return 0 if ulps <= 2 and row["finite"] else 1


def event_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def profile_generator(label, dtype=torch.float32) -> int:
    from larynx_tpu_torch.models.hifi_gan import model as hifi
    from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
    from larynx_tpu_torch.weights import cast, init_params, params_from_jax, tree_to

    cfg = HiFiGanConfig()
    gen = torch.Generator().manual_seed(1)
    params = hifi.pack_params(
        cast(tree_to(params_from_jax(init_params(gen, cfg), "hifi_gan"), "cuda"), dtype), cfg)
    mel = (torch.randn((8, 1024, 80), generator=gen) - 4.0).cuda().to(dtype)

    # CUDA events around each phase: every call of the wrapped names made
    # outside another wrapped call
    phases = []
    depth = [0]
    ups = [0]

    def timed(name_of, fn):
        def inner(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            depth[0] -= 1
            phases.append((name_of(*a), start, end))
            return out
        return inner

    def upsample_name(*a):
        ups[0] += 1
        return f"stage {(ups[0] - 1) % len(cfg.upsample_rates) + 1} transposed conv"

    originals = {n: getattr(hifi, n) for n in ("conv1d", "conv_transpose1d", "mrf_section",
                                               "_resblock1", "_resblock2")}
    hifi.conv1d = timed(lambda x, w, *r: "conv_post" if w.shape[0] == 1 else "conv_pre",
                        originals["conv1d"])
    hifi.conv_transpose1d = timed(upsample_name, originals["conv_transpose1d"])
    hifi.mrf_section = timed(lambda x, s: f"MRF section C={x.shape[-1]} (kernel)",
                             originals["mrf_section"])
    for n in ("_resblock1", "_resblock2"):
        setattr(hifi, n, timed(lambda p, x, d: f"resblocks C={x.shape[-1]} (cuDNN)", originals[n]))
    try:
        with torch.inference_mode():
            hifi.generator(params, cfg, mel)
            torch.cuda.synchronize()
            phases.clear()
            w0, w1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            w0.record()
            for _ in range(3):
                hifi.generator(params, cfg, mel)
            w1.record()
            torch.cuda.synchronize()
    finally:
        for n, f in originals.items():
            setattr(hifi, n, f)
    window_ms = w0.elapsed_time(w1) / 3
    split = {}
    for name, start, end in phases:
        split[name] = split.get(name, 0.0) + start.elapsed_time(end) / 3
    split["rest (elementwise lrelu, tanh, launch gaps)"] = window_ms - sum(split.values())

    with torch.inference_mode():
        acts = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            p0, p1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            p0.record()
            for _ in range(3):
                hifi.generator(params, cfg, mel)
            p1.record()
            torch.cuda.synchronize()
    prof_window = p0.elapsed_time(p1)

    def dev_us(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    kernels = sorted((e for e in prof.key_averages()
                      if dev_us(e) > 0 and e.device_type.name == "CUDA"), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(json.dumps({
        "label": label, "card": smi("name,power.limit"), "dtype": str(dtype), "rows": 8,
        "frames": 1024,
        "generator_ms": window_ms, "phases_ms": split,
        "profiler_window_ms": prof_window / 3, "busy_share": busy_ms / prof_window,
        "kernels_ms_per_call": [[e.key[:90], dev_us(e) / 1e3 / 3, e.count // 3]
                                for e in kernels[:14]],
    }), flush=True)
    return 0


def sass_census(lib_path):
    """Per kernel instantiation: HGMMA (wgmma) and WARPGROUP.DEPBAR (waits
    on them) instructions, local-memory loads and stores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True).stdout
    census = {}
    for func in out.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        m = re.search(r"mrf_\w*kernel\w*?ILi(\d+)ELi(\d+)E", name)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", func)
        key = f"C={m.group(1)},convs={m.group(2)}" if m else name[:60]
        census[key] = {n: ops.count(n) for n in ("HGMMA", "STL", "LDL")} | {
            "DEPBAR": func.count("WARPGROUP.DEPBAR")}
    return census


if __name__ == "__main__":
    sys.exit(main())
