"""Build and load the port's CUDA kernels (csrc/*.cu).

Each kernel source is CUDA C++ for sm_90a with a plain C entry point.  It
is compiled with ``nvcc`` at first use into ``build/torch_kernels/``,
keyed by a hash of the source, the shared headers (csrc/*.cuh) and the
flags, and loaded with ``ctypes``.  Nothing is built or loaded when this
module is imported.

The flags keep the kernels on the plain PyTorch versions' roundings:
``-fmad=false`` (no multiply-add contraction) and no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: the kernel sources, by name
KERNELS = ("chain_kernel", "cycle_kernel", "envelope_kernel",
           "first_order_kernel")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc is neither on PATH nor at /usr/local/cuda/bin/"
                       "nvcc; the CUDA toolkit is needed to build the "
                       "kernels in dsp_stuff_tpu_torch/csrc")


def lib_path(name: str, defines: tuple = ()) -> pathlib.Path:
    """Where the library of kernel ``name`` (built with the preprocessor
    ``defines``, names such as "CK_PHASES") lives once built."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}")
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(*names: str,
          defines: tuple = ()) -> dict[str, tuple[pathlib.Path, str]]:
    """Compile the named kernels (all of them by default) whose sources
    changed since their last build, one ``nvcc`` each, all started
    together, with ``-D`` for each of ``defines``.  Returns {name:
    (library path, nvcc's output, empty when cached)}; raises if any
    build fails."""
    out: dict[str, tuple[pathlib.Path, str]] = {}
    running = []
    for name in names or KERNELS:
        lib = lib_path(name, defines)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I",
             str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The library of kernel ``name`` built with ``defines``, built if
    needed."""
    return ctypes.CDLL(str(build(name, defines=defines)[name][0]))
