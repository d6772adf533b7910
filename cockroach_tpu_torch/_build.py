"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, no ninja). Libraries land in ``_build/`` beside this
file, named by a hash of their source, so an edited source is rebuilt and
an unchanged one is reused. ``build_all`` starts one ``nvcc`` per source
at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
OUT = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("scan_filter", "merge_path")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return OUT / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library of `names`, all nvcc processes in
    parallel. Returns the seconds spent; raises with nvcc's output if any
    build fails. The compiler's report (ptxas registers, shared memory,
    spills) is kept in ``_build/<name>.log``."""
    t0 = time.perf_counter()
    OUT.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    procs = []
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, p in procs:
        try:
            out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate(timeout=30)
            failed.append(f"{n}: nvcc timed out after {NVCC_TIMEOUT_S}s")
            continue
        (OUT / f"{n}.log").write_bytes(out)
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n"
                          + out.decode(errors="replace"))
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
