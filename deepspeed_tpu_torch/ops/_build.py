"""Builds the port's CUDA kernels and loads them with ctypes.

Counterpart of ``deepspeed_tpu/ops/op_builder/builder.py``. Each source
``deepspeed_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on its own by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/deepspeed_tpu_torch/`` at the root of the checkout. The library's
file name carries a hash of the source, the shared headers and the flags, so a
changed source is built again at its next use and an unchanged one is loaded
as it is. Nothing is built when a module is imported: a kernel's wrapper calls
:func:`load` when it first launches, and :func:`build_all` builds every source
at once, one ``nvcc`` process each, all started together.

The host C++ of ZeRO-Offload (``csrc/host/*.cpp``: the SIMD Adam and the
asynchronous I/O pool) builds the same way with the host compiler
(:func:`load_host`), under the JAX package's flags probed as it probes them
(``-O3 -shared -fPIC -std=c++17``, plus ``-mavx2 -mfma`` where the CPU lists
both and the compiler takes them, and ``-fopenmp`` where it takes it). These
run on the host, so they build and load on a machine without a card too.

A build or load failure raises :class:`KernelBuildError` with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HOST_CSRC = CSRC / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepspeed_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ptxas's register / shared-memory / spill report of the last build of each
# source, for the chip smoke run to print
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    h = hashlib.sha256()
    for part in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    """Start nvcc on one source; it writes a temporary file, renamed on success."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, Path(tmp), out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    build_logs[name] = log
    os.replace(tmp, out)


def build_all() -> None:
    """Build every source whose library is missing, all nvcc processes at once."""
    started = []
    try:
        for name in sources():
            if not _target(name).exists():
                started.append((name, *_start(name)))
        errors = []
        for name, proc, tmp, out in started:
            try:
                _finish(name, proc, tmp, out)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
    finally:
        for _, proc, tmp, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    out = _target(name)
    if not out.exists():
        _finish(name, *_start(name))
    try:
        return ctypes.CDLL(str(out))
    except OSError as e:
        raise KernelBuildError(f"cannot load {out}: {e}") from e


# ----------------------------------------------------------------- host C++
HOST_BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# extra link flags of a host source
HOST_LDFLAGS = {"aio": ("-lpthread",)}


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("clang++")
    if not found:
        raise KernelBuildError("no host C++ compiler found: set CXX or put g++ on PATH")
    return found


def _cpu_supports(feature: str) -> bool:
    """Whether /proc/cpuinfo lists ``feature`` (True where it cannot be read,
    so that the compile probe decides)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return feature in line.split()
    except OSError:
        return True
    return False


def _try_compile(cxx: str, flags: List[str]) -> bool:
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "probe.cpp"
        src.write_text("int main(){return 0;}")
        try:
            r = subprocess.run([cxx, *flags, str(src), "-o", str(Path(td) / "a.out")],
                               capture_output=True, timeout=60)
        except (OSError, subprocess.SubprocessError):
            return False
        return r.returncode == 0


@functools.lru_cache(maxsize=None)
def host_flags() -> Tuple[str, ...]:
    """The host build's flags: the base ones, AVX2 + FMA when the CPU lists
    both and the compiler takes them (a flag the compiler takes says nothing
    of the CPU, whose binary would die of SIGILL), OpenMP when it takes it."""
    cxx = _cxx()
    flags = list(HOST_BASE_FLAGS)
    if _cpu_supports("avx2") and _cpu_supports("fma") and _try_compile(cxx, ["-mavx2", "-mfma"]):
        flags += ["-mavx2", "-mfma"]
    if _try_compile(cxx, ["-fopenmp"]):
        flags += ["-fopenmp"]
    return tuple(flags)


def _host_target(name: str) -> Path:
    src = HOST_CSRC / f"{name}.cpp"
    if not src.exists():
        raise KernelBuildError(f"no host source {src}")
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join((_cxx(), *host_flags(), *HOST_LDFLAGS.get(name, ()))).encode())
    return BUILD_DIR / f"host_{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/host/<name>.cpp``, built first if needed."""
    out = _host_target(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_cxx(), *host_flags(), str(HOST_CSRC / f"{name}.cpp"), "-o", tmp,
               *HOST_LDFLAGS.get(name, ())]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise KernelBuildError(f"{' '.join(cmd)} failed (exit {r.returncode}):\n"
                                       f"{r.stdout}{r.stderr}")
            os.replace(tmp, out)
        finally:
            Path(tmp).unlink(missing_ok=True)
    try:
        return ctypes.CDLL(str(out))
    except OSError as e:
        raise KernelBuildError(f"cannot load {out}: {e}") from e


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error code."""
    if status != 0:
        lib.ds_error_string.restype = ctypes.c_char_p
        lib.ds_error_string.argtypes = [ctypes.c_int]
        msg = lib.ds_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
