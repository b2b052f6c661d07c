#!/usr/bin/env python3
"""Profile the port's WN-layer kernels on one GPU.

    python3 scripts/profile_torch_wn_layer.py [--bf16] [--repo DIR] [--label NAME]
    python3 scripts/profile_torch_wn_layer.py --waveglow [--repo DIR] [--label NAME]

Runs K3 at the WaveGlow main path's middle-layer shape (B=4, T=32768,
ch 256, cc 640, d=8), in float32 (csrc/wn_layer.cu) or with ``--bf16`` in
bfloat16 (csrc/wn_bf16.cu; in a checkout without it, the bf16
instantiation of csrc/wn_layer.cu), and prints one JSON line with:
  * ms: CUDA-event time per launch (mean of 20 after a warm-up);
  * profiler_ms, busy_share: the kernel's device time per launch and the
    device's busy share over a window of 20 back-to-back launches, from
    torch.profiler with CUDA activities;
  * tflops: the layer's FLOPs over ms (tf32_tflops: 3 TF32 operations per
    f32 FLOP);
  * l2_weight_gb, l2_weight_tb_s: the weight bytes that the kernel's blocks
    read from L2 per launch and that rate: every packed weight byte once
    per group of tiles that one multicast load feeds (float32: 2 tiles of
    a batch row, 1 for the mma.sync kernel before it, whose layer holds no
    ``wpack``; bf16: the kernel's plan, ``ops/wn_layer.py::
    bf16_launch_plan``, where the checkout has it, else 2 tiles);
  * bound_ms and bound_share: the layer's bound at the card's dense TF32
    peak (bf16: the dense bf16 peak), as chip_smoke.py counts it;
  * ptxas: registers, spills and ptxas's performance warnings of the build;
  * sass: a census of the middle-layer kernel's machine code (cuobjdump):
    HGMMA (wgmma) and WARPGROUP.DEPBAR (waits on them) instructions, and
    local-memory loads and stores; a wait after every HGMMA means that
    ptxas serialized the wgmma pipeline;
  * ncu: whether Nsight Compute is on the machine.
``--waveglow`` instead profiles one WaveGlow wn_256 vocoder group call of
the main path (``models/waveglow/model.py::infer`` on 4 rows of a
1024-frame mel, random weights) over 3 calls after a warm-up: the device
time of every kernel by name, the device's busy share over the window, and
the SM clock and power draw read by nvidia-smi before and after.
``--repo`` profiles the package of another checkout (an older commit
unpacked with git archive), so two versions can be compared in one call.
"""

import argparse
import dataclasses
import json
import re
import shutil
import subprocess
import sys

import torch

TF32_PEAK_FLOPS = 495e12
TF32_PER_F32 = 3
BF16_PEAK_FLOPS = 989e12
B, T, CH, CC, DIL = 4, 32768, 256, 640, 8
TILE = 64


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=".")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--waveglow", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_wn_layer: no CUDA device", flush=True)
        return 1
    sys.path.insert(0, args.repo)
    if args.waveglow:
        return profile_waveglow(args.label)
    from larynx_tpu_torch.ops import build, wn_layer

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    own_bf16 = args.bf16 and hasattr(wn_layer, "bf16_launch_plan")
    lib = "wn_bf16" if own_bf16 else "wn_layer"
    build.build([lib])
    ptxas = sorted({line.split(":", 1)[-1].strip()
                    for line in build.BUILD_LOGS.get(lib, "").splitlines()
                    if "registers" in line or "spill" in line or "Performance Loss" in line})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator().manual_seed(0)

    def n(*shape, scale=0.05):
        return (torch.randn(shape, generator=gen) * scale).cuda().to(dtype)

    layer = wn_layer.pack_wn_layer(n(2 * CH, CH, 3), n(2 * CH, scale=0.01), n(2 * CH, CC),
                                   n(2 * CH, scale=0.01), n(2 * CH, CH), n(2 * CH, scale=0.01))
    h, cond, skip = n(B, T, CH, scale=1.0), n(B, T, CC, scale=1.0), n(B, T, CH, scale=1.0)

    def run():
        return wn_layer.fused_wn_layer_state(h, cond, skip, layer, DIL)

    h_new, s_new = run()
    ref_h, ref_s = wn_layer.wn_layer_state_plain(h, cond, skip, layer.w_in, layer.w_cond,
                                                 layer.bias_a, layer.w_rs, layer.b_rs, DIL)
    err = max((h_new.float() - ref_h.float()).abs().max().item(),
              (s_new.float() - ref_s.float()).abs().max().item())

    iters = 20
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters

    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = torch.cuda.Event(enable_timing=True)
        w1 = torch.cuda.Event(enable_timing=True)
        w0.record()
        for _ in range(iters):
            run()
        w1.record()
        torch.cuda.synchronize()
    window_ms = w0.elapsed_time(w1)
    kernels = [e for e in prof.key_averages() if "wn_layer" in e.key or "wn_bf16" in e.key]
    dev_us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                 for e in kernels)
    profiler_ms = dev_us / 1e3 / iters if dev_us else None
    busy = dev_us / 1e3 / window_ms if dev_us else None

    e = torch.finfo(dtype).bits // 8
    flops = 2.0 * B * T * (2 * CH * (3 * CH + CC) + CH * 2 * CH)
    ops_s = flops / BF16_PEAK_FLOPS if args.bf16 else TF32_PER_F32 * flops / TF32_PEAK_FLOPS
    io = B * T * (CH + CC + CH + CH + CH)
    weights = sum(getattr(layer, name).numel() for name in ("bias_a", "b_rs"))
    weight_bytes = e * sum(t.numel() for t in wn_layer_weight_tensors(layer))
    bytes_s = e * (io + weights + 2 * CH * (3 * CH + CC) + CH * 2 * CH) / 3.35e12
    bound_ms = 1e3 * max(ops_s, bytes_s)
    tiles = B * -(-T // TILE)
    if own_bf16:
        plan = wn_layer.bf16_launch_plan(B, T, CC, 2 * CH, wn_layer.bf16_active_clusters())
        cluster, l2_gb = plan["cluster"], plan["l2_weight_bytes"] / 1e9
    else:
        plan = None
        cluster = 2 if hasattr(layer, "wpack") else 1
        l2_gb = weight_bytes * tiles / cluster / 1e9
    sass = sass_census(build.library_path(lib), "wn_bf16_kernelILi1ELi512E" if own_bf16 else
                       "wn_layer_kernelI13__nv_bfloat16Li1ELi512E" if args.bf16 else
                       "wn_layer_kernelILi1ELi512E")
    tflops = flops / (ms * 1e-3) / 1e12
    print(json.dumps({
        "label": args.label, "card": smi("name,power.limit"), "dtype": str(dtype),
        "kernel": f"csrc/{lib}.cu", "shape": {"B": B, "T": T, "dilation": DIL},
        "max_abs_err": err, "ms": ms, "profiler_ms": profiler_ms, "busy_share": busy,
        "tflops": tflops, "tf32_tflops": None if args.bf16 else TF32_PER_F32 * tflops,
        "peak_tflops": (BF16_PEAK_FLOPS if args.bf16 else TF32_PEAK_FLOPS) / 1e12,
        "bound_ms": bound_ms, "bound_share": bound_ms / ms,
        "weight_bytes_per_tile": weight_bytes, "cluster": cluster, "plan": plan,
        "l2_weight_gb": l2_gb, "l2_weight_tb_s": l2_gb / ms,
        "ptxas": ptxas, "sass": sass, "ncu": shutil.which("ncu"),
        "profiler_kernels": [e.key for e in kernels],
    }), flush=True)
    return 0


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def profile_waveglow(label) -> int:
    from larynx_tpu_torch.models.waveglow import model as wg
    from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
    from larynx_tpu_torch.weights import init_params, params_from_jax, tree_to

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = WaveGlowConfig()
    gen = torch.Generator().manual_seed(2)
    params = wg.pack_params(
        tree_to(params_from_jax(init_params(gen, cfg), "waveglow"), "cuda"), cfg)
    rows, frames = 4, 1024
    mel = (torch.randn((rows, frames, cfg.mel_channels), generator=gen) - 4.0).cuda()
    blocks = frames * cfg.upsample_stride // cfg.groups
    z = torch.randn((rows, blocks, cfg.groups), generator=gen).cuda()
    with torch.inference_mode():
        wg.infer(params, cfg, mel, z=z)
        torch.cuda.synchronize()
        before = smi("clocks.sm,power.draw")
        acts = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            w0, w1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            w0.record()
            for _ in range(3):
                wg.infer(params, cfg, mel, z=z)
            w1.record()
            torch.cuda.synchronize()
        after = smi("clocks.sm,power.draw")
    window_ms = w0.elapsed_time(w1)

    def dev_us(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    kernels = sorted((e for e in prof.key_averages()
                      if dev_us(e) > 0 and e.device_type.name == "CUDA"), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(json.dumps({
        "label": label, "card": smi("name,power.limit"), "rows": rows, "frames": frames,
        "infer_ms": window_ms / 3, "busy_share": busy_ms / window_ms,
        "clocks_sm_power_before": before, "clocks_sm_power_after": after,
        "kernels_ms_per_call": [[e.key[:90], dev_us(e) / 1e3 / 3, e.count // 3]
                                for e in kernels[:12]],
    }), flush=True)
    return 0


def sass_census(lib_path, kernel):
    """Instruction counts of the middle-layer kernel (mode 1, rs 512), whose
    mangled name holds ``kernel``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True).stdout
    for func in out.split("Function : ")[1:]:
        if kernel not in func.split("\n", 1)[0]:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", func)
        return {name: ops.count(name) for name in ("HGMMA", "WARPGROUP", "STL", "LDL")} | {
            "DEPBAR": func.count("WARPGROUP.DEPBAR")}
    return None


def wn_layer_weight_tensors(layer):
    """The packed weight tensors the kernel reads per tile (whatever the
    checkout's WNLayer calls them)."""
    plain = ("w_in", "w_cond", "bias_a", "w_rs", "b_rs")
    return [getattr(layer, f.name) for f in dataclasses.fields(layer)
            if f.name not in plain and isinstance(getattr(layer, f.name), torch.Tensor)]


if __name__ == "__main__":
    sys.exit(main())
