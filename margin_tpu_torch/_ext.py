"""Build step of the port: compiles and loads the CUDA kernels and the host
C++ engines, and resolves the device an entry point runs on.

Everything goes into `margin_tpu_torch/_build/` (git-ignored); nothing is
written into `native/`, whose shared libraries are tracked by the JAX
package.

  * CUDA kernels: each `csrc/*.cu` is compiled at first use with
    `nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
    -Xcompiler -fPIC` into its own shared library with a plain C ABI and
    loaded with `ctypes`. `--fmad=false` keeps `a*b+c` unfused, as the JAX
    kernels and `native/` do, so the LUT logAdd flavour agrees bit for bit.
  * Host engines (`native/marginio.cc`, `marginfb.cc`, `marginrp.cc`,
    `marginpoa.cc`) are
    compiled from their sources with the flags of `native/Makefile`. When
    one fails to build, `native_lib` returns None and the caller takes the
    same pure-Python path the JAX package takes (host code, not a device
    fallback).
  * marginio includes <libdeflate.h>. Where the system's libdeflate does
    not compile and link (a one-line trial, `deflate_variant`), it builds
    against `csrc/compat/libdeflate.h`, the same calls over zlib, and
    links -lz alone. `deflate_variant()` says which: "libdeflate" or
    "zlib stand-in".

Builds are serialised across processes with a lock file and land by
atomic rename, so concurrent test workers never load a half-written
library. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import time
from typing import Dict, List, Optional

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
NATIVE_SRC = os.path.join(os.path.dirname(_PKG), "native")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_CXX = ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall"]
# native/Makefile:7-29, per engine
_NATIVE_FLAGS = {
    "marginio": _CXX + ["-pthread"],
    "marginfb": _CXX + ["-march=native", "-funroll-loops",
                        "-ffp-contract=off"],
    "marginrp": _CXX + ["-march=native", "-ffp-contract=off", "-pthread"],
    "marginpoa": _CXX + ["-ffp-contract=off"],
}
_NATIVE_LIBS = {
    "marginio": ["-shared", "-lz", "-ldeflate"],
    "marginfb": ["-shared", "-lm"],
    "marginrp": ["-shared", "-lm"],
    "marginpoa": ["-shared", "-lm"],
}

COMPAT = os.path.join(CSRC, "compat")
DEFLATE_SYSTEM = "libdeflate"
DEFLATE_STAND_IN = "zlib stand-in"

KERNEL_SOURCES = ("pairhmm_forward", "banded_fb", "banded_seg",
                  "banded_wide", "rphmm_fb")
# the shared memory a Hopper block may use (set per kernel with
# cudaFuncSetAttribute); the kernel wrappers size their layouts by it
MAX_SMEM = 232_448
NATIVE_ENGINES = tuple(_NATIVE_FLAGS)

_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
BUILD_SECONDS: Dict[str, float] = {}
LOAD_ERRORS: Dict[str, str] = {}
_deflate: List[str] = []


def nvcc_path() -> str:
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.path.exists(cand) else "nvcc"


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _source(name: str) -> str:
    if name in _NATIVE_FLAGS:
        return os.path.join(NATIVE_SRC, f"{name}.cc")
    return os.path.join(CSRC, f"{name}.cu")


def deflate_variant() -> str:
    """DEFLATE_SYSTEM when a program that includes <libdeflate.h> and links
    -ldeflate builds here, else DEFLATE_STAND_IN (decided once)."""
    if not _deflate:
        trial = ("#include <libdeflate.h>\n"
                 "int main() { libdeflate_free_compressor(0); }\n")
        try:
            ok = subprocess.run(
                ["g++", "-x", "c++", "-", "-o", os.devnull, "-ldeflate"],
                input=trial.encode(), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL).returncode == 0
        except OSError:
            ok = False
        _deflate.append(DEFLATE_SYSTEM if ok else DEFLATE_STAND_IN)
    return _deflate[0]


def marginio_command(out: str, deflate: str) -> List[str]:
    """The g++ command that builds marginio into `out` against the system's
    libdeflate (DEFLATE_SYSTEM) or the zlib stand-in (DEFLATE_STAND_IN)."""
    if deflate == DEFLATE_SYSTEM:
        return (_NATIVE_FLAGS["marginio"] + ["-o", out, _source("marginio")]
                + _NATIVE_LIBS["marginio"])
    libs = [f for f in _NATIVE_LIBS["marginio"] if f != "-ldeflate"]
    return (_NATIVE_FLAGS["marginio"] + ["-I", COMPAT, "-o", out,
                                         _source("marginio")] + libs)


def _command(name: str, out: str) -> List[str]:
    src = _source(name)
    if name == "marginio":
        return marginio_command(out, deflate_variant())
    if name in _NATIVE_FLAGS:
        return _NATIVE_FLAGS[name] + ["-o", out, src] + _NATIVE_LIBS[name]
    return [nvcc_path()] + NVCC_FLAGS + ["-o", out, src]


def _inputs(name: str) -> List[str]:
    """The source and, for a kernel, the shared headers it includes."""
    if name == "marginio":
        return [_source(name), os.path.join(COMPAT, "libdeflate.h")]
    if name in _NATIVE_FLAGS:
        return [_source(name)]
    return [_source(name)] + sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh"))


def _fresh(name: str) -> bool:
    so = _so_path(name)
    return (os.path.exists(so)
            and all(os.path.getmtime(so) >= os.path.getmtime(src)
                    for src in _inputs(name)))


class _BuildLock:
    def __enter__(self):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self._fh = open(os.path.join(BUILD_DIR, ".lock"), "w")
        fcntl.flock(self._fh, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._fh, fcntl.LOCK_UN)
        self._fh.close()


def build(names, log=None) -> Dict[str, Optional[str]]:
    """Compile every stale library in `names` concurrently (one compiler
    process per source, all started together). Returns name -> None on
    success or the compiler's error text."""
    errors: Dict[str, Optional[str]] = {}
    with _BuildLock():
        procs = []
        for name in names:
            if _fresh(name):
                errors[name] = None
                continue
            tmp = f"{_so_path(name)}.{os.getpid()}.tmp"
            try:
                p = subprocess.Popen(_command(name, tmp),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
            except OSError as e:  # compiler missing
                errors[name] = str(e)
                continue
            procs.append((name, tmp, p, time.perf_counter()))
        for name, tmp, p, t0 in procs:
            out, _ = p.communicate()
            BUILD_SECONDS[name] = time.perf_counter() - t0
            if p.returncode == 0 and os.path.exists(tmp):
                os.replace(tmp, _so_path(name))
                errors[name] = None
            else:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                errors[name] = out.decode(errors="replace")
            if log is not None:
                log(f"built lib{name}.so in {BUILD_SECONDS[name]:.1f}s"
                    + ("" if errors[name] is None else " (FAILED)"))
    return errors


def native_lib(name: str) -> Optional[ctypes.CDLL]:
    """The host engine `name` (one of NATIVE_ENGINES), built on first use
    together with its siblings; None when it cannot be built."""
    if name not in _loaded:
        if not _fresh(name):
            build(list(NATIVE_ENGINES))
        lib = None
        if _fresh(name):
            try:
                lib = ctypes.CDLL(_so_path(name))
            except OSError as e:
                LOAD_ERRORS[name] = str(e)
        _loaded[name] = lib
    return _loaded[name]


def kernel_lib(name: str) -> ctypes.CDLL:
    """The CUDA kernel library built from `csrc/<name>.cu`. Raises when it
    does not build: a CUDA tensor never falls back to a plain version."""
    lib = _loaded.get(name)
    if lib is None:
        if not _fresh(name):
            err = build([name])[name]
            if err is not None:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{err}")
        lib = ctypes.CDLL(_so_path(name))
        _loaded[name] = lib
    return lib


def launch(dev: torch.device, entry, *args) -> int:
    """Call the C entry `entry(*args, stream)` with `dev` the calling
    thread's current CUDA device and `dev`'s current stream last; returns
    the entry's error code. The entries' cudaFuncSetAttribute and
    <<<>>> act on the current device, which need not be the tensors'
    (a mesh shard on cuda:1)."""
    with torch.cuda.device(dev):
        return entry(*args, torch.cuda.current_stream(dev).cuda_stream)


def check_launch(rc: int, what: str) -> None:
    """The C entries return cudaGetLastError() after their launches."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def resolve_device(device) -> torch.device:
    """Entry points run on `cuda` unless the caller asks for the CPU; CUDA
    asked for and absent raises (nothing carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
