#!/usr/bin/env python3
"""Ablate the bf16 WN-layer kernel on one GPU.

    python3 scripts/ablate_torch_wn_bf16.py [--repo DIR]

Builds the bf16 WN kernel of a checkout (``--repo``, default this one) as
it is and copies of it, each with one part taken out, and times the
WaveGlow main path's first (d=1), middle (d=8) and last (d=128) layer
shapes (B=4, T=32768, ch 256, cc 640; random weights, CUDA events, mean of
10 after a warm-up) with each.  The kernel is ``csrc/wn_bf16.cu`` where the
checkout has it, else the bf16 instantiation of ``csrc/wn_layer.cu`` (the
design before it); each has its own list of variants:

  no_products     every wgmma skipped (the weight ring, the gate, the
                  loads and stores stay)
  no_ring_waits   (csrc/wn_layer.cu) the consumers do not wait for weight
                  stages and the producer loads none (the products read
                  whatever the ring holds)
  no_weight_data  (csrc/wn_bf16.cu) the ring's barriers run as built but no
                  weight byte moves: the producer arrives on each stage
                  instead of copying it (the products read whatever the
                  ring holds; the consumers still wait, so no barrier
                  phase is skipped)
  no_products_or_weights  (csrc/wn_bf16.cu) both: what the activations,
                  the gate, the epilogue and the barriers take alone
  no_gate         the gate's tanh and sigmoid replaced by a sum
  no_epi_loads    the epilogue adds zeros instead of loading h and skip
  p2_two_groups   (csrc/wn_layer.cu) the second product with two wgmma
                  groups in flight, not one
  p2_one_group    (csrc/wn_bf16.cu) the second product waiting for each
                  wgmma group, as the design before it did
  cluster_4       (csrc/wn_bf16.cu) clusters of 4 sharing each weight
                  stage, not 2
  cluster_1       (csrc/wn_bf16.cu) no cluster: every block loads every
                  weight stage from L2 itself
  ring_4          (csrc/wn_bf16.cu) a weight ring of 4 stages, not 8
  stages_32k      (csrc/wn_bf16.cu) 4 stages of two k-steps (32 KB), not 8
                  of one
  serial_release  (csrc/wn_bf16.cu) one thread of each consumer releases a
                  weight stage in every block of the cluster in turn, not
                  one thread per block at once

The copies compute wrong outputs by design (except p2_two_groups,
p2_one_group, cluster_4, cluster_1, ring_4, stages_32k and
serial_release, which stay exact); only their times mean anything.  What
a part costs is the time it takes out, where the others do not hide it.
With ``no_products`` the time is what the weight ring and the rest take
alone, so its L2 rate is the rate that this card gives the ring's access
pattern.  A variant with no result within 120 s is reported and skipped.
Each row also prints the L2 weight bytes of one launch (every weight stage
read once from L2 per cluster of tiles) and their rate.

The copies are built under larynx_tpu_torch/_build/ablate/ (gitignored),
one nvcc each, all at once.  Prints one JSON line per variant, then the
card's name and power limit.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
B, T, CC = 4, 32768, 640
LAYERS = (("first", 1, True, False), ("middle", 8, False, False), ("last", 128, False, True))

# csrc/wn_layer.cu's bf16 instantiation of the float32 template (the design before
# csrc/wn_bf16.cu)
TEMPLATE_VARIANTS = {
    "no_products": [(
        "    wgmma_bf16<N>(d, desc_a_sw128(a_hi), desc_kmajor(b_hi));",
        "    if (a_lo == 1u) wgmma_bf16<N>(d, desc_a_sw128(a_hi), desc_kmajor(b_hi));")],
    "no_ring_waits": [
        ("        mbar_wait(full_b(b_stage), b_phase);\n", ""),
        ("        if (j == 0) mbar_wait(full_b(b_stage), b_phase);\n", ""),
        ("      for (int s = 0; s < n_stages; ++s) {", "      for (int s = 0; s < 0; ++s) {")],
    "no_gate": [(
        "        gv[4 * i + e] = tanhf(acc[4 * i + e]) * sigmoid(acc[4 * (i + 16) + e]);",
        "        gv[4 * i + e] = acc[4 * i + e] + acc[4 * (i + 16) + e];")],
    "no_epi_loads": [
        ("          const float2 hv = load2(h + step * kCh + col);",
         "          const float2 hv = make_float2(0.f, 0.f);"),
        ("            const float2 old = load2(skip + step * kCh + ch);",
         "            const float2 old = make_float2(0.f, 0.f);")],
    "p2_two_groups": [
        ("        wgmma_commit();\n        wgmma_wait<0>();\n        if (j == kKps2 - 1) {\n"
         "          release_b(b_stage);",
         "        wgmma_commit();\n        wgmma_wait<1>();\n        if (j == kKps2 - 1) {\n"
         "          if (ks >= kKps2) release_b(prev(b_stage, kBStages));"),
        ("    fence_acc(acc2);\n\n    // ---- epilogue",
         "    wgmma_wait<0>();\n    release_b(prev(b_stage, kBStages));\n    fence_acc(acc2);\n\n"
         "    // ---- epilogue")],
}

# csrc/wn_bf16.cu, the Hopper design
NO_PRODUCTS = [(
    "  wgmma_bf16<N>(acc, desc_a_sw128(a), desc_kmajor(b));",
    "  if (a == 1u) wgmma_bf16<N>(acc, desc_a_sw128(a), desc_kmajor(b));")]
NO_WEIGHT_DATA = [(
    "          mbar_expect_tx(full_b(ring.slot), kBStageBytes);\n"
    "          bulk_load_multicast(b_ring + ring.slot * kBStageBytes + rank * kPart,\n"
    "                              src + static_cast<size_t>(s) * kBStageBytes, kPart,\n"
    "                              full_b(ring.slot));\n",
    "          mbar_arrive(full_b(ring.slot));\n")]
BF16_VARIANTS = {
    "no_products": NO_PRODUCTS,
    "no_weight_data": NO_WEIGHT_DATA,
    "no_products_or_weights": NO_PRODUCTS + NO_WEIGHT_DATA,
    "no_gate": [(
        "            gv[e] = gate(acc[4 * i + 2 * hr + e], acc[4 * (i + 16) + 2 * hr + e]);",
        "            gv[e] = acc[4 * i + 2 * hr + e] + acc[4 * (i + 16) + 2 * hr + e];")],
    "no_epi_loads": [(
        "              old[i - i0] = load2(reinterpret_cast<const E*>(res_buf + swizzled(ch, row)"
        "));",
        "              old[i - i0] = make_float2(0.f, 0.f);")],
    "p2_one_group": [("constexpr int kP2InFlight = 1;", "constexpr int kP2InFlight = 0;")],
    "cluster_4": [("constexpr int kCluster = 2;", "constexpr int kCluster = 4;")],
    "cluster_1": [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")],
    "ring_4": [("constexpr int kBStages = 8;", "constexpr int kBStages = 4;")],
    "serial_release": [(
        "      if (r < kCluster) mbar_arrive_cluster(empty_b(slot), r);",
        "      if (r == 0)\n"
        "        for (int q = 0; q < kCluster; ++q) mbar_arrive_cluster(empty_b(slot), q);")],
    "stages_32k": [("constexpr int kStageSteps = 1;", "constexpr int kStageSteps = 2;"),
                   ("constexpr int kBStages = 8;", "constexpr int kBStages = 4;")],
}


def kernel_of(root: Path):
    """(library name, variants) of a checkout's bf16 WN kernel."""
    if (root / "larynx_tpu_torch" / "csrc" / "wn_bf16.cu").is_file():
        return "wn_bf16", BF16_VARIANTS
    return "wn_layer", TEMPLATE_VARIANTS


def make_variant(repo: Path, name: str, edits) -> Path:
    lib, _ = kernel_of(repo)
    root = REPO / "larynx_tpu_torch" / "_build" / "ablate" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(repo / "larynx_tpu_torch", root / "larynx_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / "larynx_tpu_torch" / "csrc" / f"{lib}.cu"
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ablation {name}: {src.name} no longer has {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def l2_weight_bytes(wn_layer, layer, b, t) -> float:
    """The weight bytes one launch reads from L2: the packed weights once
    per cluster of tiles (the cluster size the checkout's kernel reports;
    the template design: clusters of 2 neighbouring tiles of one batch
    row)."""
    tiles = -(-t // 64)
    if hasattr(wn_layer, "bf16_geometry"):
        cluster = wn_layer.bf16_geometry(b, t, CC, layer.b_rs.numel())[1]
        items = -(-b * tiles // cluster)
    else:
        items = b * -(-tiles // 2)
    return layer.wpack.numel() * 2 * items


def time_layers(label: str) -> dict:
    """In a child whose sys.path starts with the variant's root."""
    from larynx_tpu_torch.ops import build, wn_layer

    build.build([kernel_of(Path.cwd())[0]])
    gen = torch.Generator().manual_seed(0)

    def n(*shape, scale=0.05):
        return (torch.randn(shape, generator=gen) * scale).cuda().bfloat16()

    out = {"variant": label}
    h, cond, skip = n(B, T, 256, scale=1.0), n(B, T, CC, scale=1.0), n(B, T, 256, scale=1.0)
    for name, d, first, last in LAYERS:
        rs_out = 256 if last else 512
        layer = wn_layer.pack_wn_layer(n(512, 256, 3), n(512, scale=0.01), n(512, CC),
                                       n(512, scale=0.01), n(rs_out, 256), n(rs_out, scale=0.01))

        def run():
            wn_layer.fused_wn_layer_state(h, cond, None if first else skip, layer, d, first, last)

        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        l2 = l2_weight_bytes(wn_layer, layer, B, T)
        out[f"{name} ms"] = ms
        out[f"{name} L2 weight GB"] = l2 / 1e9
        out[f"{name} L2 weight TB/s"] = l2 / (ms * 1e-3) / 1e12
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(time_layers(sys.argv[2])), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(REPO), help="checkout whose kernel is ablated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_torch_wn_bf16: no CUDA device", flush=True)
        return 1
    repo = Path(args.repo).resolve()
    lib, variants = kernel_of(repo)
    roots = {"as built": repo}
    roots.update({name: make_variant(repo, name, edits) for name, edits in variants.items()})
    builds = [subprocess.Popen([sys.executable, "-c", "from larynx_tpu_torch.ops import build; "
                                f"build.build([{lib!r}])"], cwd=root,
                               env={**os.environ, "PYTHONPATH": str(root)})
              for root in roots.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    failed = 0
    for label, root in list(roots.items()) + [("as built, again", repo)]:
        try:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                                   f"{lib}: {label}"], cwd=root, capture_output=True, text=True,
                                  timeout=120, env={**os.environ, "PYTHONPATH": str(root)})
        except subprocess.TimeoutExpired:
            print(json.dumps({"variant": label, "error": "no result within 120 s"}), flush=True)
            failed += 1
            continue
        print(proc.stdout.strip() or json.dumps({"variant": label, "stderr": proc.stderr[-1500:]}),
              flush=True)
        failed += proc.returncode != 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
