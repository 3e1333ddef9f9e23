"""What the tools that time another checkout's kernel in turns against
this one share (tools/measure_torch_chain.py --reverse --root,
tools/measure_torch_cycle.py --root): a module's attribute swapped for a
block, a module imported from another checkout, and nvcc started on
another checkout's kernel source with this checkout's flags.

Imported by those tools, which run as scripts from tools/; imports
nothing of JAX.
"""

import contextlib
import hashlib
import importlib.util
import os
import subprocess


@contextlib.contextmanager
def swapped(obj, name, value):
    """``obj.name`` set to ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def load_module(root: str, relpath: str, name: str):
    """The module at ``relpath`` in the checkout ``root``, imported as
    ``name`` (not entered in sys.modules)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_build(root: str, kernel: str, header: str = ""):
    """Start nvcc on ``root``'s csrc/``kernel``.cu with this checkout's
    flags (and ``header`` as its KERNEL_PROGRAM_H, where given) into
    build/torch_kernels/: returns (library path, the nvcc process, or None
    when that library is built already).  The library's name hashes the
    flags, the header and root's kernel source with its headers."""
    from dsp_stuff_tpu_torch.ops import cuda_build
    csrc = os.path.join(root, "dsp_stuff_tpu_torch", "csrc")
    h = hashlib.sha256((" ".join(cuda_build.NVCC_FLAGS) + header).encode())
    for name in sorted(os.listdir(csrc)):
        if name == f"{kernel}.cu" or name.endswith(".cuh"):
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(f.read())
    lib = cuda_build.BUILD_DIR / f"{kernel}_other_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, None
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = []
    if header:
        hpath = lib.with_suffix(".h")
        hpath.write_text(header)
        flags.append(f'-DKERNEL_PROGRAM_H="{hpath}"')
    proc = subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-I", csrc,
         "-o", str(lib), os.path.join(csrc, f"{kernel}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc
