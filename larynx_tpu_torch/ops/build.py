"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` at first use; the
hash is of the source and the local headers it includes (``csrc/sm90.cuh``),
so an edited kernel or header is rebuilt.  Nothing is built or
loaded when a module is imported.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import typing
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: typing.Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: typing.Dict[str, str] = {}  # nvcc output (ptxas -v) per library


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def sources(name: str) -> typing.List[Path]:
    """``csrc/<name>.cu`` and the local headers it includes (``#include "x"``)."""
    main = CSRC_DIR / f"{name}.cu"
    headers = re.findall(r'^\s*#include\s+"([^"]+)"', main.read_text(), flags=re.MULTILINE)
    return [main] + [CSRC_DIR / h for h in headers]


def library_path(name: str) -> Path:
    """The library's path, keyed by a hash of its source and its local
    headers, so an edit to either is rebuilt."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources(name))).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: typing.Sequence[str]) -> typing.Dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc processes
    at once; returns name -> library path.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.is_file():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
