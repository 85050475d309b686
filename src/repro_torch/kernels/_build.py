"""Build and load the hand-written CUDA kernels under ``kernels/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, which is loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The kernels build only
from a checkout of the repository (run in place, or installed with
``pip install -e``): the sources are not packaged, and the libraries go to
``build/torch_ext/`` at the root of that checkout, named by a hash of the
sources so an edited kernel is rebuilt, each beside its ``nvcc -Xptxas -v``
log (``ptxas_log``). Nothing is built at import time: ``load`` builds on
first use, and ``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
CHECKOUT = Path(__file__).resolve().parents[3]   # <root>/src/repro_torch/kernels
BUILD_DIR = CHECKOUT / "build" / "torch_ext"
SOURCES = ("batch_similarity", "pairwise_adjacency", "greedy_diversify",
           "fused_round", "int8_dot", "pq_lut_sum", "topk_merge")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                               "on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    if not (CHECKOUT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        raise KernelBuildError(
            f"repro_torch is not running from a checkout ({CHECKOUT}): the "
            "CUDA kernels build only from the repository's sources")
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per built source and
    raises ``KernelBuildError`` with the compiler output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (time.perf_counter(), tmp, out, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    seconds, errors = {}, []
    for name, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return seconds


def ptxas_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` output (registers, spills, shared memory of
    each kernel) of the current build of source ``name``, built first if
    needed."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        build_all((name,))
    return log.read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


METRIC_CODES = {"ip": 0, "cos": 1, "l2": 2}


def metric_code(metric: str) -> int:
    try:
        return METRIC_CODES[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}") from None


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``ndim``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, "
                         f"got one on {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


def stream() -> int:
    """PyTorch's current CUDA stream, which every kernel launches on."""
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch "
                           f"(cudaError {rc})")
