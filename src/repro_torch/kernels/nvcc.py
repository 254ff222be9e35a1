"""Build, load and launch the port's hand-written CUDA kernels.

Every kernel source under ``kernels/<name>/csrc/`` has a plain C entry point
that takes device pointers, ints and floats, launches on the stream it is
given and returns ``cudaGetLastError()``. At first use in a process,
``nvcc`` compiles one source alone into a shared library under ``build/``
at the repository root, named by a hash of the source, the headers it
includes and the flags (an edited source or flag is always rebuilt), and
``ctypes`` loads its entry point. Nothing is compiled or loaded when a
kernel module is imported, so the CPU tests import them without ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch import spans

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

# argument kinds of an entry point's signature string
P, I, F = "p", "i", "f"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in csrc/")


def build(source: Path, headers=(), flags=FLAGS, verbose: bool = False):
    """Compile ``source`` with ``flags`` into ``build/`` unless that exact
    source, headers and flags are already built; ``verbose=True`` always
    compiles, with ``-Xptxas -v``, to report registers and spills. Returns
    (library path, seconds, nvcc output); raises on a failed build. A call
    is a ``build`` span (``repro_torch.spans``) that counts ``built`` or
    ``cached``."""
    with spans.span("build"):
        digest = hashlib.sha1(b"".join(
            Path(p).read_bytes() for p in (source, *headers))
            + " ".join(flags).encode()).hexdigest()[:12]
        lib = BUILD_DIR / f"{Path(source).stem}-{digest}.so"
        if lib.exists() and not verbose:
            spans.count("cached")
            return lib, 0.0, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {Path(source).name} ({proc.returncode}):"
                f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        spans.count("built")
        return lib, secs, proc.stdout + proc.stderr


def load(path: Path, entry: str, sig: str):
    """The C function ``entry`` of library ``path``; ``sig`` spells its
    arguments (``P`` pointer, ``I`` int, ``F`` float), the stream last."""
    import ctypes
    kinds = {P: ctypes.c_void_p, I: ctypes.c_int, F: ctypes.c_float}
    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.argtypes = [kinds[k] for k in sig] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lead_strides(name: str, x: torch.Tensor, dims: int):
    """Element strides over the first three dims of ``x``, which the kernel
    reads through them: ``x`` has ``dims`` dims and, with four, unit stride
    over the last. Raises on what a 32-bit stride argument cannot hold."""
    if x.dim() != dims:
        raise ValueError(f"{name}: {dims} dims expected, got "
                         f"{tuple(x.shape)}")
    if dims == 4 and x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"{name}: unit stride over the last dim expected")
    st = x.stride()[:3]
    if max(abs(v) for v in st) >= 2 ** 31 or min(st) < 0:
        raise ValueError(f"{name}: strides {st} out of range")
    return st


def launch(fn, device: torch.device, args, what: str, codes=None) -> None:
    """Call entry point ``fn`` on the current stream of ``device``; tensors
    pass as device pointers, None as a null pointer. Raises if the launch
    reports an error: a CUDA error, or one of the entry point's own
    ``codes`` (code: meaning)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        why = (codes or {}).get(err, f"CUDA error {err}")
        raise RuntimeError(f"{what} kernel launch failed: {why}")
