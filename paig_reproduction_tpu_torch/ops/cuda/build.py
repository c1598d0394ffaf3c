"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a library
with a plain C interface, loaded with ``ctypes``. Libraries go into
``paig_reproduction_tpu_torch/_build/``, named by a hash of the source and
the flags, so an edited source is rebuilt at its next use. Nothing is
compiled when a module is imported: the first launch builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found; set CUDA_HOME to the CUDA "
                           "toolkit")
    return path


def sources() -> list:
    """Names of every CUDA source in ``csrc/`` (without ``.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the named sources (default: all), one ``nvcc`` each, all
    started together. Returns {name: (seconds, compiler log)}; the log
    holds ``ptxas``'s registers and shared memory for each kernel. Raises
    if any compile fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc_path = nvcc()
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        out = library_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    results, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled first if no
    build of the current source exists."""
    if name not in _loaded:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
