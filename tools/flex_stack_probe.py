#!/usr/bin/env python3
"""The card's memory held outside PyTorch's allocator by kernel #4's library
yardstick under a softcap, on one card.

    python3 tools/flex_stack_probe.py [--without-restore]

``chip_smoke.py`` times ``flex_attention`` (compiled) beside kernel #4 at
every softcap case of ``flash_cases``. This script runs those cases through
``chip_smoke.flash_case`` and prints, after each, the device memory in use
(``torch.cuda.mem_get_info``), PyTorch's reserved and allocated bytes and
the rest: memory the CUDA context holds outside the allocator, such as the
local memory it reserves for the stack of the largest kernel launched so
far. ``flash_case`` sets the stack limit back after each timing
(``chip_smoke.stack_limit_kept``); ``--without-restore`` leaves it as the
kernels grew it. Then the context's stack limit (``cuCtxGetLimit``), and
the memory after setting that limit to the same value and to 1,024 bytes,
which makes the driver size its local memory again. Prints each case's
seconds (the compiles included) and the card's name and power limit.
"""
import contextlib
import ctypes
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def mem(tag):
    free, total = torch.cuda.mem_get_info()
    used = (total - free) / 2**30
    res = torch.cuda.memory_reserved() / 2**30
    print(f"[probe] {tag}: used {used:.3f} GiB, reserved {res:.3f}, "
          f"allocated {torch.cuda.memory_allocated() / 2**30:.3f}, outside "
          f"the allocator {used - res:.3f}", flush=True)


def main():
    if "--without-restore" in sys.argv[1:]:
        cs.stack_limit_kept = contextlib.nullcontext
    _, sms, clk = cs.phase_device()
    card = cs.Card(sms, clk)
    cs.phase_build()
    torch.cuda.synchronize()
    mem("after the build")
    for case in cs.flash_cases():
        if case[-1].get("softcap") is None:
            continue
        t = time.perf_counter()
        cs.flash_case(card, *case)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem(f"after {case[0]} ({time.perf_counter() - t:.1f} s)")
    cuda = ctypes.CDLL("libcuda.so.1")
    stack = ctypes.c_size_t()                  # CU_LIMIT_STACK_SIZE = 0
    print(f"[probe] cuCtxGetLimit(stack) -> "
          f"{cuda.cuCtxGetLimit(ctypes.byref(stack), 0)}, {stack.value} "
          f"bytes a thread", flush=True)
    for size in (stack.value, 1024):
        rc = cuda.cuCtxSetLimit(0, ctypes.c_size_t(size))
        mem(f"after cuCtxSetLimit(stack, {size}) -> {rc}")
    print(cs.smi("name,power.limit"), flush=True)


if __name__ == "__main__":
    main()
