"""Hopper kernel for the fused VCC PGD epoch: build, bind and launch.

The kernel is hand-written CUDA C++ in ``csrc/pgd_epoch.cu`` and replaces
the TPU kernel ``src/repro/kernels/vcc_pgd/kernel.py:122``
(``pgd_epoch_pallas``). At first use in a process, ``nvcc`` compiles that
source alone into a shared library under ``build/`` at the repository root
(named by a hash of the source, so an edited source is always rebuilt) and
``ctypes`` loads its plain C entry point. Nothing is compiled or loaded when
this module is imported, so the CPU tests import it without ``nvcc``.

``pgd_epoch_cuda`` launches on ``torch.cuda.current_stream()`` and adds one
to ``pgd_epoch_cuda.launches`` per launch.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "pgd_epoch.cu"
REPO_ROOT = Path(__file__).resolve().parents[4]
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_H = 32

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build(verbose: bool = False):
    """Compile ``csrc/pgd_epoch.cu`` into ``build/`` unless that exact
    source is already built; ``verbose=True`` always compiles, with
    ``-Xptxas -v``, to report registers and spills. Returns (library
    path, seconds, nvcc output); raises on a failed build."""
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"pgd_epoch-{digest}.so"
    if lib.exists() and not verbose:
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, secs, proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        import ctypes
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.pgd_epoch_f32
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, x, shape):
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: float32 expected, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor expected")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")


def pgd_epoch_cuda(delta, eta, pi, pow_nom, tau24, price, lo, ub, lr, temp,
                   lambda_e, *, iters: int, proj_iters: int = 50
                   ) -> torch.Tensor:
    """Launch the fused epoch. delta/eta/pi/pow_nom/lo/ub: (rows, H) with
    H <= 32; tau24/price/lr/temp/lambda_e: (rows, 1). All float32,
    contiguous, on one CUDA device. Returns the new delta (rows, H)."""
    if delta.dim() != 2:
        raise ValueError("delta: (rows, H) expected, got "
                         f"{tuple(delta.shape)}")
    rows, H = delta.shape
    if not 1 <= H <= MAX_H:
        raise ValueError(f"the kernel holds one row per warp: H <= {MAX_H}, "
                         f"got {H}")
    wide = dict(delta=delta, eta=eta, pi=pi, pow_nom=pow_nom, lo=lo, ub=ub)
    slim = dict(tau24=tau24, price=price, lr=lr, temp=temp,
                lambda_e=lambda_e)
    for name, x in wide.items():
        _check(name, x, (rows, H))
    for name, x in slim.items():
        _check(name, x, (rows, 1))
    if len({x.device for x in (*wide.values(), *slim.values())}) != 1:
        raise ValueError("all operands must be on one CUDA device")
    out = torch.empty_like(delta)
    lib = _load()
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pgd_epoch_f32(
            delta.data_ptr(), eta.data_ptr(), pi.data_ptr(),
            pow_nom.data_ptr(), tau24.data_ptr(), price.data_ptr(),
            lo.data_ptr(), ub.data_ptr(), lr.data_ptr(), temp.data_ptr(),
            lambda_e.data_ptr(), out.data_ptr(), rows, H, int(iters),
            int(proj_iters), stream)
    if err != 0:
        raise RuntimeError(f"pgd_epoch kernel launch failed: CUDA error {err}")
    pgd_epoch_cuda.launches += 1
    return out


pgd_epoch_cuda.launches = 0


def epoch_flops(rows: int, H: int, iters: int, proj_iters: int = 50) -> int:
    """FP32 operations of one epoch as ``csrc/pgd_epoch.cu`` performs them
    (each add, multiply, divide, min, max, exp and compare counts one; a
    reduction over H hours counts H - 1):

    per hour and step: pow 3, /temp 1, -max 1, exp 1, /sum 1, grad 5,
    z 2, final clip 3, and 3 per bisection step;
    per row and step: softmax max and sum and the z bracket min and max,
    2 (H - 1) each pair, one (H - 1) sum per bisection step, 3 scalar ops
    per bisection step and 4 for the bracket and nu;
    per row once: the max ub / min lo bracket terms, 2 (H - 1)."""
    per_hour = 17 + 3 * proj_iters
    per_row_step = (4 + proj_iters) * (H - 1) + 3 * proj_iters + 4
    return rows * (iters * (per_hour * H + per_row_step) + 2 * (H - 1))


def epoch_shuffles(rows: int, iters: int, proj_iters: int = 50) -> int:
    """Warp-shuffle instructions of one epoch in ``csrc/pgd_epoch.cu``
    (one warp per row, five butterfly stages per reduction): per step the
    softmax max and sum, the bracket min and max and one sum per
    bisection step; once per epoch the max ub / min lo terms."""
    return rows * (5 * iters * (4 + proj_iters) + 10)


def epoch_bytes(rows: int, H: int) -> int:
    """Bytes the epoch must move: 6 wide and 5 slim float32 inputs read
    once, one wide float32 output written once."""
    return 4 * rows * (7 * H + 5)
