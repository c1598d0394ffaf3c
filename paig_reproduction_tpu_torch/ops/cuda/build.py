"""Builds the port's native sources into shared libraries.

Each CUDA source (``csrc/*.cu``) is compiled by ``nvcc`` for Hopper
(``sm_90a``), each host C++ source (``csrc/*.cpp``, the native data loader)
by ``g++ -O3 -fPIC -shared -std=c++17 -pthread``, into a library with a
plain C interface, loaded with ``ctypes``. Libraries go into
``paig_reproduction_tpu_torch/_build/``, named by a hash of the source and
the flags, so an edited source is rebuilt at its next use. Nothing is
compiled when a module is imported: the first use builds what it needs.
This hashed directory is also what the JAX package's persistent compile
cache (``utils/cache.py``) is to it: the port compiles nothing else.
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

GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

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


def library_path(name: str, ext: str = ".cu") -> str:
    flags = NVCC_FLAGS if ext == ".cu" else GXX_FLAGS
    with open(os.path.join(CSRC_DIR, name + ext), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
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


def load_host(name: str) -> ctypes.CDLL:
    """The library built from the host C++ source ``csrc/<name>.cpp``,
    compiled with ``g++`` (``$CXX`` overrides) first if no build of the
    current source exists. Raises if the compiler is missing or fails."""
    key = name + ".cpp"
    if key not in _loaded:
        path = library_path(name, ".cpp")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            cxx = os.environ.get("CXX", "g++")
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run(
                    [cxx, *GXX_FLAGS, os.path.join(CSRC_DIR, key), "-o", tmp],
                    capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"{cxx} not found for {key}: {e}") from e
            if proc.returncode:
                raise RuntimeError(f"{cxx} failed for {key}:\n{proc.stderr}")
            os.replace(tmp, path)
        _loaded[key] = ctypes.CDLL(path)
    return _loaded[key]
