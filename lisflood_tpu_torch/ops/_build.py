"""Build and load the port's CUDA kernels.

Each source under lisflood_tpu_torch/csrc/ is compiled by nvcc for sm_90a
into a shared library with a plain C interface, at first use, into
lisflood_tpu_torch/_build/ (listed in .gitignore), and loaded with ctypes.
The library's name carries a hash of the source, the shared headers
(csrc/*.cuh) and the flags, so an edited source or header builds anew.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = {"kinwave_substep": CSRC / "kinwave_substep.cu",
           "kinwave_sweep": CSRC / "kinwave_sweep.cu",
           "kinwave_sharded": CSRC / "kinwave_sharded.cu",
           "segment_sum": CSRC / "segment_sum.cu",
           "soil_tail": CSRC / "soil_tail.cu"}
BUILD_DIR = _PKG / "_build"
# -fmad=false: every operation rounds on its own, as the plain PyTorch
# versions' separate elementwise operations do
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC)]

_libs = {}
build_log = {}


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def library_path(name):
    src = SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None):
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per source, all started together. Returns the seconds
    taken; each compiler's output lands in `build_log`."""
    import time
    t0 = time.perf_counter()
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name):
    """The kernel library `name`, built first if needed."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]
