#!/usr/bin/env python3
"""Build, check and time Tacotron2's decoder step kernel
(``larynx_tpu_torch/csrc/tacotron2_step.cu``) on one NVIDIA GPU.

    python3 scripts/profile_torch_tacotron2_step.py [--tests] [--repo DIR]

Prints the card, ptxas's registers and spills, then, each in a child
process with a time limit: one short call (B=1, T=32, 2 steps) against the
plain version, then ``chip_smoke.check_t2_step`` (the kernel against its
plain version at t2wg_batch8's shapes and at B=1, bit for bit against
itself and a batch row alone, and its time a step against the step's
bound, the plain version and the cuBLAS step replayed as a CUDA graph).
``--stages`` first times each of a step's stages (a build that records the
SM clock at every grid barrier); ``--tests`` also runs the card tests of
``tests/test_torch_tacotron2_step.py``; ``--repo`` times another checkout's
kernel (its ``chip_smoke.check_t2_step``).
"""

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

QUICK = """
import torch
from larynx_tpu_torch.ops import tacotron2_step as ts
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
cfg, params = chip_smoke.t2_step_voice()
packed = params["decoder"]["step_kernel"]
with torch.inference_mode():
    batch = chip_smoke.t2_step_batch(cfg, params, 1, 32, 2, seed=5)
    got = ts.decode_steps(packed, *batch[:5], 2, batch[5])
    torch.cuda.synchronize()
    want = ts.decode_steps_plain(packed, *batch[:5], 2, batch[5])
print("quick call: geometry", ts.geometry(packed, 1, 32), "error",
      chip_smoke.t2_step_rel_err(got, want), flush=True)
for b, n, masks in ((1, 1, True), (1, 1, False), (8, 1, True), (8, 2, True)):
    with torch.inference_mode():
        batch = chip_smoke.t2_step_batch(cfg, params, b, 32, n, seed=5)
        keep = batch[5] if masks else None
        got = ts.decode_steps(packed, *batch[:5], n, keep)
        want = ts.decode_steps_plain(packed, *batch[:5], n, keep)
    errs = {k: float((got[0][k] - want[0][k]).abs().max()) for k in want[0]}
    errs["mels"] = float((got[2] - want[2]).abs().max())
    errs["gates"] = float((got[3] - want[3]).abs().max())
    print(f"B={b} n={n} masks {masks}: " + ", ".join(f"{k} {v:.2g}" for k, v in errs.items()),
          flush=True)
"""

STAGES = """
import ctypes, subprocess, tempfile
import numpy as np
import torch
from larynx_tpu_torch.ops import build, tacotron2_step as ts
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
lib_path = tempfile.mkdtemp() + "/libtacotron2_step_times.so"
subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DTACOTRON2_STEP_TIMES", "-o", lib_path,
                str(build.CSRC_DIR / "tacotron2_step.cu")], check=True, stdout=subprocess.DEVNULL)
lib = ctypes.CDLL(lib_path)
p, i = ctypes.c_void_p, ctypes.c_int
lib.tacotron2_steps.restype = i
lib.tacotron2_steps.argtypes = [p, p, ctypes.c_float, p]
lib.tacotron2_step_scratch_floats.restype = ctypes.c_longlong
lib.tacotron2_step_scratch_floats.argtypes = [p]
lib.tacotron2_step_geometry.restype = i
lib.tacotron2_step_geometry.argtypes = [p, p]
lib.tacotron2_step_error_string.restype = ctypes.c_char_p
lib.tacotron2_step_error_string.argtypes = [i]
lib.tacotron2_step_times.restype = i
lib.tacotron2_step_times.argtypes = [p]
ts._library = lambda: lib
cfg, params = chip_smoke.t2_step_voice()
packed = params["decoder"]["step_kernel"]
names = ["stage 6 -> barrier 1", "stage 1", "stage 2", "stage 3", "stage 4", "stage 5"]
for b, t in ((8, 96), (1, 96)):
    n = 32
    with torch.inference_mode():
        batch = chip_smoke.t2_step_batch(cfg, params, b, t, n, seed=7)
        for _ in range(3):
            ts.decode_steps(packed, *batch[:5], n, batch[5])
        torch.cuda.synchronize()
    out = np.zeros(160 * 64 * 6 * 2 + 4, dtype=np.int64)
    assert lib.tacotron2_step_times(out.ctypes.data) == 0
    clk = out[:-4].reshape(160, 64, 6, 2)[:132, :n].astype(np.float64)
    cal = out[-4:]
    cyc_per_ns = (cal[3] - cal[1]) / (cal[2] - cal[0])
    arrive, leave = clk[..., 0], clk[..., 1]
    prev_leave = np.roll(leave, 1, axis=2)  # stage k starts at barrier k-1's exit
    prev_leave[:, 0, 0] = np.nan
    prev_leave[:, 1:, 0] = leave[:, :-1, 5]
    work = (arrive - prev_leave) / cyc_per_ns / 1e3
    wait = (leave - arrive) / cyc_per_ns / 1e3
    step_us = (leave[:, 1:, 5] - leave[:, :-1, 5]).mean() / cyc_per_ns / 1e3
    print(f"B={b} T={t}: {cyc_per_ns:.3f} cycles a ns, {step_us:.2f} us a step; kernel "
          f"{(cal[2] - cal[0]) / 1e3:.1f} us for {n} steps", flush=True)
    for k in range(6):
        w = work[:, 1:, k]
        per_block = np.nanmean(w, axis=1)
        top = np.argsort(per_block)[::-1][:4]
        print(f"  {names[k]:22s} work mean {np.nanmean(w):6.2f} us, slowest block "
              f"{np.nanmean(np.nanmax(w, axis=0)):6.2f} us; barrier {k + 1} wait mean "
              f"{np.nanmean(wait[:, 1:, k]):6.2f} us; slowest blocks "
              + ", ".join(f"{i}: {per_block[i]:.2f}" for i in top), flush=True)
"""

CHECK = """
import torch
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.check_t2_step()
"""


def child(code: str, repo: Path, timeout: int) -> int:
    env = dict(os.environ, PYTHONPATH=f"{repo}:{os.environ.get('PYTHONPATH', '')}")
    start = time.perf_counter()
    try:
        rc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                            timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        print(f"child timed out after {timeout} s", flush=True)
        return 124
    print(f"child exit {rc} in {time.perf_counter() - start:.1f} s", flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tests", action="store_true", help="also run the card tests")
    ap.add_argument("--stages", action="store_true",
                    help="time each stage in a build that records clocks at the barriers")
    ap.add_argument("--repo", type=Path, default=ROOT, help="the checkout to time")
    args = ap.parse_args()
    repo = args.repo.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; checkout {repo}", flush=True)
    sys.path.insert(0, str(repo))
    from larynx_tpu_torch.ops import build

    start = time.perf_counter()
    build.build(["tacotron2_step"])
    lines = build.BUILD_LOGS.get("tacotron2_step", "").splitlines()
    print(f"built in {time.perf_counter() - start:.1f} s", flush=True)
    for line in lines:
        if "registers" in line or "spill" in line or "error" in line or "warning" in line:
            print("  " + line.strip(), flush=True)
    rc = child(QUICK, repo, 120)
    if rc != 0:
        return rc
    if args.stages:
        rc = child(STAGES, repo, 300)
        if rc != 0:
            return rc
    rc = child(CHECK, repo, 600)
    if rc == 0 and args.tests:
        env = dict(os.environ, PYTHONPATH=f"{repo}:{os.environ.get('PYTHONPATH', '')}")
        rc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "card", "--noconftest",
                             "-p", "no:cacheprovider", "tests/test_torch_tacotron2_step.py"],
                            cwd=repo, env=env, timeout=900).returncode
        print(f"card tests exit {rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
