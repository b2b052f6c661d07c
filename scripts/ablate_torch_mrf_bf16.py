#!/usr/bin/env python3
"""Ablate the bf16 MRF kernel (larynx_tpu_torch/csrc/mrf_bf16.cu) on one GPU.

    python3 scripts/ablate_torch_mrf_bf16.py

Builds the kernel as it is and four copies of it, each with one part taken
out, and times universal_large's three main-path sections (B = 8 rows of a
1024-frame mel: C=128, T=65536; C=64, T=131072; C=32, T=262144; random
weights, CUDA events, mean of 10 after a warm-up) with each:

  no_products     every wgmma skipped (the weight ring, the epilogues, the
                  loads and stores stay)
  no_ring_waits   the consumers do not wait for weight stages and the
                  producer loads none (the products read whatever the ring
                  holds)
  no_epilogues    each conv's epilogue skipped (the products stay)
  no_reloads      the section plan loads its input once, not once a chain

The copies compute wrong outputs by design; only their times mean
anything.  What a part costs is the time it takes out, where the others
do not hide it.  The copies are built under larynx_tpu_torch/_build/ablate/
(gitignored), one nvcc each, all at once.  Prints one JSON line per
variant, then the card's name and power limit.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "larynx_tpu_torch"
ABLATE_DIR = PACKAGE / "_build" / "ablate"
SOURCE = "csrc/mrf_bf16.cu"
R1 = ((3, 7, 11), ((1, 3, 5),) * 3, 2)  # universal_large: ResBlock1
SHAPES = ((128, 65536), (64, 131072), (32, 262144))  # (C, T) of stages 2-4, B = 8

VARIANTS = {  # name -> [(text in the source, its replacement)]
    "no_products": [(
        "        wgmma_bf16<C>(acc[m], desc_rows(rows[m] + shift + 2 * kk * plane, plane),",
        "        if (steps < 0) wgmma_bf16<C>(acc[m], desc_rows(rows[m] + shift + 2 * kk * plane,"
        " plane),")],
    "no_ring_waits": [
        ("    mbar_wait(bars + 8 * (2 + ring.slot), ring.parity);\n", ""),
        ("      for (int s = 0; s < n_stages; ++s) {", "      for (int s = 0; s < 0; ++s) {")],
    "no_epilogues": [(
        "        if (!residual) {  // the first conv's output -> the second conv's operand",
        "        if (T < 0) {\n        } else if (!residual) {")],
    "no_reloads": [
        ("      for (int r = 0; r < g.n; ++r) {\n        if (r > 0) mbar_wait(h_free",
         "      for (int r = 0; r < 1; ++r) {\n        if (r > 0) mbar_wait(h_free"),
        ("    mbar_wait(x_full, r & 1);", "    if (r == 0) mbar_wait(x_full, 0);")],
}


def make_variant(name, edits) -> Path:
    root = ABLATE_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / "larynx_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / "larynx_tpu_torch" / SOURCE
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ablation {name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def time_sections(label: str) -> dict:
    """In a child whose sys.path starts with the variant's root."""
    from larynx_tpu_torch.ops import build, mrf_block

    build.build(["mrf_bf16"])
    gen = torch.Generator().manual_seed(0)
    out = {"variant": label}
    for c, t in SHAPES:
        def conv(k):
            bound = 1.0 / (c * k) ** 0.5
            return {"w": ((torch.rand((c, c, k), generator=gen) * 2 - 1) * bound).cuda()
                    .bfloat16(),
                    "b": ((torch.rand(c, generator=gen) * 2 - 1) * bound).cuda().bfloat16()}

        stage = mrf_block.pack_mrf_stage(
            [{"convs1": [conv(k) for _ in d], "convs2": [conv(k) for _ in d]}
             for k, d in zip(*R1[:2])], *R1)
        x = torch.randn((8, t, c), generator=gen).cuda().bfloat16()
        mrf_block.mrf_section(x, stage)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            mrf_block.mrf_section(x, stage)
        end.record()
        torch.cuda.synchronize()
        out[f"C={c} ms"] = start.elapsed_time(end) / 10
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(time_sections(sys.argv[2])), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("ablate_torch_mrf_bf16: no CUDA device", flush=True)
        return 1
    roots = {"as built": REPO}
    roots.update({name: make_variant(name, edits) for name, edits in VARIANTS.items()})
    builds = [subprocess.Popen([sys.executable, "-c", "from larynx_tpu_torch.ops import build; "
                                "build.build(['mrf_bf16'])"], cwd=root)
              for root in roots.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    failed = 0
    for label, root in list(roots.items()) + [("as built, again", REPO)]:
        proc = subprocess.run([sys.executable, __file__, "--child", label], cwd=root,
                              capture_output=True, text=True, timeout=300,
                              env={**os.environ, "PYTHONPATH": str(root)})
        print(proc.stdout.strip() or json.dumps({"variant": label, "stderr": proc.stderr[-1500:]}),
              flush=True)
        failed += proc.returncode != 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
