"""Build and load the port's CUDA kernels (csrc/*.cu).

Each kernel source is CUDA C++ for sm_90a with a plain C entry point.  It
is compiled with ``nvcc`` at first use into ``build/torch_kernels/``,
keyed by a hash of the source, the shared headers (csrc/*.cuh) and the
flags, and loaded with ``ctypes``.  Nothing is built or loaded when this
module is imported.

The cycle kernel and its reverse are built once per block program: their
wrappers (ops/cycle_kernel.py, ops/cycle_reverse_kernel.py) generate a
header with the program's straight-line block code (its adjoint for the
reverse), which the source includes (``header``: written next to the
library and passed as ``-DKERNEL_PROGRAM_H``), as the JAX package's
Pallas cycle kernel is traced once per program.  The pointwise kernel is
built the same way once per group program (ops/pointwise_kernel.py), its
reverse once per adjoint program (ops/pointwise_reverse_kernel.py).

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
KERNELS = ("chain_kernel", "chain_reverse_kernel", "cycle_kernel",
           "cycle_reverse_kernel", "envelope_kernel", "first_order_kernel",
           "oscillator_kernel", "oscillator_reverse_kernel",
           "pointwise_divide_check", "pointwise_kernel",
           "pointwise_reverse_kernel", "sequential_kernel")
#: the kernels built without a generated header
STATIC_KERNELS = ("chain_kernel", "chain_reverse_kernel", "envelope_kernel",
                  "first_order_kernel", "oscillator_kernel",
                  "oscillator_reverse_kernel", "sequential_kernel")


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


def lib_path(name: str, defines: tuple = (),
             header: str = "") -> pathlib.Path:
    """Where the library of kernel ``name`` (built with the preprocessor
    ``defines``, names such as "CK_PHASES", and the generated ``header``
    text) lives once built."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}")
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    h.update(header.encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_jobs(jobs) -> list[tuple[pathlib.Path, str]]:
    """Compile each (name, defines, header) of ``jobs`` whose library is
    not built yet, one ``nvcc`` each, all started together (a job listed
    twice builds once).  Returns (library path, nvcc's output, empty when
    cached) per job; raises if any build fails."""
    out: list = [None] * len(jobs)
    running = []
    first: dict = {}                    # library -> the job that builds it
    for i, (name, defines, header) in enumerate(jobs):
        lib = lib_path(name, defines, header)
        if lib.exists() or lib in first:
            out[i] = (lib, "")
            continue
        first[lib] = i
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        args = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines)]
        if header:
            hpath = lib.with_suffix(".h")
            hpath.write_text(header)
            args.append(f'-DKERNEL_PROGRAM_H="{hpath}"')
        proc = subprocess.Popen(
            [*args, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((i, name, lib, tmp, proc))
    failed = []
    for i, name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[i] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(*names: str,
          defines: tuple = ()) -> dict[str, tuple[pathlib.Path, str]]:
    """Compile the named kernels (by default every kernel built without a
    generated header) whose sources changed since their last build, all
    started together, with ``-D`` for each of ``defines``.  Returns
    {name: (library path, nvcc's output, empty when cached)}."""
    names = names or STATIC_KERNELS
    return dict(zip(names, build_jobs([(n, tuple(defines), "")
                                       for n in names])))


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = (), header: str = "") -> ctypes.CDLL:
    """The library of kernel ``name`` built with ``defines`` and the
    generated ``header``, built if needed."""
    return ctypes.CDLL(str(build_jobs([(name, tuple(defines),
                                        header)])[0][0]))
