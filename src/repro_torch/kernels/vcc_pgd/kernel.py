"""Hopper kernels for the VCC projected-gradient solvers: build, bind, launch.

Three hand-written CUDA C++ kernels, one source each under ``csrc/``, share
their reductions, softmax and projection through ``csrc/pgd_common.cuh``:

* ``pgd_epoch.cu`` replaces ``src/repro/kernels/vcc_pgd/kernel.py:122``
  (``pgd_epoch_pallas``): the fused PGD epoch;
* ``pgd_epoch_ens.cu`` replaces ``kernel.py:251`` (``pgd_epoch_ens_pallas``):
  the CVaR ensemble epoch;
* ``joint_step.cu`` replaces ``kernel.py:207`` (``joint_step_pallas``): one
  joint spatio-temporal step, in two routes. The split route
  (``joint_step_cuda``, then ``s_project_cuda``) writes (d', g_s) and then
  the fleet-coupled shift s' in a second launch; the fused route
  (``joint_step_s_cuda``) writes (d', s') in one launch, a thread-block
  cluster of C blocks per rollout. ``joint_plan`` picks the route by the
  rollout's n clusters.

All three take the row-group layout: a row of H <= 32 hours goes to
``LANES`` lanes, each holding ceil(H / LANES) hours in registers, so a warp
holds 32 / LANES rows and a reduction takes log2(LANES) shuffle stages after
the lane's own hours; the bisection leaves its loop once no bracket of a warp
moves (the same bits as the fixed count). ``tools/pgd_probe.py`` times the
epochs' variants and ``tools/joint_probe.py`` the joint step's
(``build(name, defines=...)``, ``variant``).

They are built, loaded and launched through ``kernels/nvcc.py`` (at first
use in a process, one library per source under ``build/``, keyed by a hash
of the source, the shared header and the flags). Nothing is compiled
or loaded when this module is imported, so the CPU tests import it without
``nvcc``.

Each ``*_cuda`` wrapper launches on ``torch.cuda.current_stream()`` and adds
one to its ``launches`` attribute per launch (kernel #3's two routes count
on ``joint_step_cuda.launches``, and by route on ``joint_step_cuda.routes``;
the split route's shift update on ``s_project_cuda.launches``); while
``repro_torch.spans`` records, each launch also counts
``launch.<kernel>`` with its sizes on the innermost open span (the route
only on ``.routes``). Beside each wrapper,
``*_flops`` and ``*_bytes`` count the function's work (the bound in
``chip_smoke.py`` and PERF.md comes from them) and ``*_shuffles`` the warp
shuffles its source issues (the shuffle-issue floor).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels import nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"pgd_epoch": CSRC / "pgd_epoch.cu",
           "pgd_epoch_ens": CSRC / "pgd_epoch_ens.cu",
           "joint_step": CSRC / "joint_step.cu"}
HEADERS = (CSRC / "pgd_common.cuh",)
# nvcc's default FMA contraction stays on (-fmad=false costs kernel #1 4%
# on the H100, PERF.md); the expressions kernels #1 and #2 share are spelled
# with explicit FMAs in csrc/pgd_common.cuh instead
NVCC_FLAGS = nvcc.FLAGS
MAX_H = 32
MAX_MEMBERS = 32
# the epochs' lanes a row, as csrc/pgd_common.cuh sets them (PGD_LANES),
# and the shuffle stages of one reduction over a row
LANES = 4
STAGES = LANES.bit_length() - 1

_P, _I, _F = nvcc.P, nvcc.I, nvcc.F
# each entry point: its source, C name and argument kinds (pointer, int,
# float), the stream after them
_ENTRY = {"pgd_epoch": ("pgd_epoch", "pgd_epoch_f32", _P * 12 + _I * 4),
          "pgd_epoch_ens": ("pgd_epoch_ens", "pgd_epoch_ens_f32",
                            _P * 13 + _I * 6),
          "joint_step": ("joint_step", "joint_step_f32",
                         _P * 17 + _I * 2 + _F * 2 + _I),
          "joint_step_s": ("joint_step", "joint_step_s_f32",
                           _P * 21 + _I * 5 + _F * 2 + _I),
          "s_project": ("joint_step", "s_project_f32", _P * 7 + _I * 3)}
# what the entry points' own error codes mean
_CODES = {10001: "no thread-block cluster of this shape fits the card "
                 "(cudaOccupancyMaxActiveClusters is 0)"}
_libs = {}


def build(name: str = "pgd_epoch", verbose: bool = False, defines=()):
    """Compile ``SOURCES[name]`` with ``NVCC_FLAGS`` and a ``-D`` flag for
    each of ``defines`` (``nvcc.build``); returns (library path, seconds,
    nvcc output)."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    return nvcc.build(SOURCES[name], HEADERS, flags, verbose=verbose)


def variant(entry: str, defines):
    """Entry point ``entry`` (a key of ``_ENTRY``) of its source built with
    ``defines`` (such as ``("PGD_LANES=8", "PGD_EARLY_EXIT=0")``). Put it
    in ``_libs[entry]`` and the wrapper launches it; the shipped build is
    the one without."""
    src, cname, sig = _ENTRY[entry]
    return nvcc.load(build(src, defines=defines)[0], cname, sig)


def _load(entry: str):
    """Entry point ``entry``, built and loaded at first use."""
    if entry not in _libs:
        _libs[entry] = variant(entry, ())
    return _libs[entry]


def _check(name, x, shape):
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: float32 expected, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor expected")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")


def _rows_h(delta):
    if delta.dim() != 2:
        raise ValueError("delta: (rows, H) expected, got "
                         f"{tuple(delta.shape)}")
    rows, H = delta.shape
    if not 1 <= H <= MAX_H:
        raise ValueError(f"the kernels take rows of H <= {MAX_H} hours, "
                         f"got {H}")
    return rows, H


def _check_all(wide, slim, rows, H, extra=()):
    for name, x in wide.items():
        _check(name, x, (rows, H))
    for name, x in slim.items():
        _check(name, x, (rows, 1))
    tensors = (*wide.values(), *slim.values(), *extra)
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all operands must be on one CUDA device")


def _launch(entry, delta, *args):
    """Call entry point ``entry`` on the current stream of ``delta``'s
    device."""
    nvcc.launch(_load(entry), delta.device, args, entry, _CODES)


# ------------------------------------------------------------- kernel #1

def pgd_epoch_cuda(delta, eta, pi, pow_nom, tau24, price, lo, ub, lr, temp,
                   lambda_e, *, iters: int, proj_iters: int = 50
                   ) -> torch.Tensor:
    """Launch the fused epoch. delta/eta/pi/pow_nom/lo/ub: (rows, H) with
    H <= 32; tau24/price/lr/temp/lambda_e: (rows, 1). All float32,
    contiguous, on one CUDA device. Returns the new delta (rows, H)."""
    rows, H = _rows_h(delta)
    _check_all(dict(delta=delta, eta=eta, pi=pi, pow_nom=pow_nom, lo=lo,
                    ub=ub),
               dict(tau24=tau24, price=price, lr=lr, temp=temp,
                    lambda_e=lambda_e), rows, H)
    out = torch.empty_like(delta)
    _launch("pgd_epoch", delta, delta, eta, pi, pow_nom, tau24, price, lo, ub,
            lr, temp, lambda_e, out, rows, H, int(iters), int(proj_iters))
    pgd_epoch_cuda.launches += 1
    spans.count("launch.pgd_epoch", rows=rows, H=H, iters=int(iters))
    return out


pgd_epoch_cuda.launches = 0


def epoch_flops(rows: int, H: int, iters: int, proj_iters: int = 50) -> int:
    """FP32 operations of the epoch's function, the bound's yardstick (each
    add, multiply, divide, min, max, exp and compare counts one; a
    reduction over H hours counts H - 1, however the kernel's lanes split
    it; all ``proj_iters`` bisection steps count, as the reference runs
    them):

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
    """Warp-shuffle instructions of one epoch in ``csrc/pgd_epoch.cu``: a
    warp holds 32 / ``LANES`` rows and each reduction takes ``STAGES``
    stages; per step the softmax max and sum, the bracket min and max and
    one sum per bisection step (all ``proj_iters`` of them: the early exit
    issues fewer); once per epoch the max ub / min lo terms."""
    warps = -(-rows * LANES // 32)
    return warps * STAGES * (iters * (4 + proj_iters) + 2)


def epoch_bytes(rows: int, H: int) -> int:
    """Bytes the epoch must move: 6 wide and 5 slim float32 inputs read
    once, one wide float32 output written once."""
    return 4 * rows * (7 * H + 5)


# ------------------------------------------------------------- kernel #2

def _members(x, rows, H):
    """(K, n) of a member stack (B, K, n, H) with B * n = rows."""
    if x.dim() == 4 and x.shape[0] * x.shape[2] == rows and x.shape[3] == H:
        return x.shape[1], x.shape[2]
    raise ValueError(f"member stack: (B, K, n, {H}) with B * n = {rows} "
                     f"expected, got {tuple(x.shape)}")


def pgd_epoch_ens_cuda(delta, eta_e, pi, pow_e, tau24, price, lo, ub, lr,
                       temp, lambda_e, risk_s, *, iters: int,
                       proj_iters: int = 50) -> torch.Tensor:
    """Launch the CVaR ensemble epoch. delta/pi/lo/ub: (rows, H), H <= 32;
    eta_e/pow_e: member stacks (B, K, n, H) with B * n = rows, K <= 32,
    read in place; tau24/price/lr/temp/lambda_e/risk_s:
    (rows, 1). All float32, contiguous, on one CUDA device. Returns the new
    delta (rows, H)."""
    rows, H = _rows_h(delta)
    _check_all(dict(delta=delta, pi=pi, lo=lo, ub=ub),
               dict(tau24=tau24, price=price, lr=lr, temp=temp,
                    lambda_e=lambda_e, risk_s=risk_s), rows, H,
               extra=(eta_e, pow_e))
    K, n = _members(eta_e, rows, H)
    if not 1 <= K <= MAX_MEMBERS:
        raise ValueError(f"the kernel takes K <= {MAX_MEMBERS} members, got "
                         f"{K}")
    for name, x in (("eta_e", eta_e), ("pow_e", pow_e)):
        _check(name, x, tuple(eta_e.shape))
    out = torch.empty_like(delta)
    _launch("pgd_epoch_ens", delta, delta, eta_e, pi, pow_e, tau24, price, lo,
            ub, lr, temp, lambda_e, risk_s, out, rows, H, n, K, int(iters),
            int(proj_iters))
    pgd_epoch_ens_cuda.launches += 1
    spans.count("launch.pgd_epoch_ens", rows=rows, H=H, K=K,
                iters=int(iters))
    return out


pgd_epoch_ens_cuda.launches = 0


def ens_epoch_flops(rows: int, H: int, K: int, iters: int,
                    proj_iters: int = 50) -> int:
    """FP32 operations of the ensemble epoch's function (counted as
    ``epoch_flops``; the member weights, which every lane of a row repeats
    alike, count once a row):

    per member, hour and step: pow 1, softmax 4, the two cost products 2,
    the two anchored accumulations 6;
    per hour and step: pi d tau24 2, eta_w and w_w 2, grad 5, z 2, final
    clip 3, and 3 per bisection step;
    per member, row and step: the four reductions 4 (H - 1), the cost 3,
    and the member weights 12 (mean 1, deviation 3, logit 3, max 1,
    exponential 2, sum 1, weight 1);
    per row and step: the mean and scale 3, and the projection's scalar
    work as in ``epoch_flops``; per row once: 2 (H - 1)."""
    P = proj_iters
    per_hour = 13 * K + 14 + 3 * P
    per_row_step = K * (4 * (H - 1) + 15) + 3 \
        + (2 + P) * (H - 1) + 3 * P + 4
    return rows * (iters * (per_hour * H + per_row_step) + 2 * (H - 1))


def ens_epoch_shuffles(rows: int, K: int, iters: int,
                       proj_iters: int = 50) -> int:
    """Warp-shuffle instructions of one ensemble epoch, in the layout of
    ``epoch_shuffles``: per step four reductions a member (softmax max and
    sum, the two cost sums), the bracket min and max and one sum per
    bisection step (all ``proj_iters``); once per epoch the box terms."""
    warps = -(-rows * LANES // 32)
    return warps * STAGES * (iters * (4 * K + 2 + proj_iters) + 2)


def ens_epoch_bytes(rows: int, H: int, K: int) -> int:
    """Bytes the ensemble epoch must move: 4 wide, 2 K-member wide and 6
    slim float32 inputs read once, one wide output written once."""
    return 4 * rows * ((5 + 2 * K) * H + 6)


# ------------------------------------------------------------- kernel #3

# the fused route: blocks a cluster (the portable cluster size) and rows a
# block at most (csrc/joint_step.cu), and the rows a block it aims at
# (tools/joint_probe.py chose it: the header of csrc/joint_step.cu)
MAX_CLUSTER = 8
MAX_BLOCK_ROWS = 256
BLOCK_ROWS = 128
# the split route's shift update keeps a rollout in shared memory
MAX_PROJECT_N = 16384


def joint_plan(n: int, block_rows: int = BLOCK_ROWS):
    """The route of a joint step over rollouts of ``n`` clusters, as
    (route, C, R): ``("fused", C, R)``, a cluster of C = ceil(n /
    block_rows) blocks (at most ``MAX_CLUSTER``) of R = ceil(n / C) rows;
    ``("split", 0, 0)`` where R would pass ``MAX_BLOCK_ROWS``."""
    if n < 1:
        raise ValueError(f"a rollout has n >= 1 clusters, got {n}")
    C = min(-(-n // max(int(block_rows), 1)), MAX_CLUSTER)
    R = -(-n // C)
    if R > MAX_BLOCK_ROWS:
        return "split", 0, 0
    return "fused", C, R


def _joint_operands(d, s, eta, pi, pow_nom, tau, u_if, u_if_q, ratio,
                    u_pow_cap, capacity, price, lr_d, temp, lambda_e,
                    extra=()):
    rows, H = _rows_h(d)
    _check_all(dict(d=d, eta=eta, pi=pi, pow_nom=pow_nom, u_if=u_if,
                    u_if_q=u_if_q, ratio=ratio),
               dict(s=s, tau=tau, u_pow_cap=u_pow_cap, capacity=capacity,
                    price=price, lr_d=lr_d, temp=temp, lambda_e=lambda_e),
               rows, H, extra)
    return rows, H


def _drop_args(drop_limit):
    """drop_limit as float32 and the float32 value of -drop_limit + 1e-9,
    which the reference compares float32 ub with."""
    return (float(np.float32(drop_limit)),
            float(np.float32(-float(drop_limit) + 1e-9)))


def _rollouts(rows, n, lr_s, extra):
    """B = rows / n rollouts; lr_s (B, 1) and ``extra`` (rows, 1)."""
    if n < 1 or rows % n:
        raise ValueError(f"{rows} rows are not rollouts of n = {n}")
    B = rows // n
    _check("lr_s", lr_s, (B, 1))
    for name, x in extra.items():
        _check(name, x, (rows, 1))
    return B


def _nu_out(nu_out, blocks, device):
    if nu_out is not None:
        _check("nu_out", nu_out, (blocks, 2))
        if nu_out.device != device:
            raise ValueError("nu_out: on the operands' device expected")
    return nu_out


def joint_step_cuda(d, s, eta, pi, pow_nom, tau, u_if, u_if_q, ratio,
                    u_pow_cap, capacity, price, lr_d, temp, lambda_e, *,
                    drop_limit: float, proj_iters: int = 50):
    """Launch one joint step on the split route. d/eta/pi/pow_nom/u_if/
    u_if_q/ratio: (rows, H) with H <= 32; s/tau/u_pow_cap/capacity/price/
    lr_d/temp/lambda_e: (rows, 1). All float32, contiguous, on one CUDA
    device. Returns (d' (rows, H), g_s (rows, 1))."""
    rows, H = _joint_operands(d, s, eta, pi, pow_nom, tau, u_if, u_if_q,
                              ratio, u_pow_cap, capacity, price, lr_d, temp,
                              lambda_e)
    d_out = torch.empty_like(d)
    gs_out = torch.empty_like(s)
    _launch("joint_step", d, d, s, eta, pi, pow_nom, tau, u_if, u_if_q, ratio,
            u_pow_cap, capacity, price, lr_d, temp, lambda_e, d_out, gs_out,
            rows, H, *_drop_args(drop_limit), int(proj_iters))
    joint_step_cuda.launches += 1
    joint_step_cuda.routes["split"] += 1
    spans.count("launch.joint_step", rows=rows, H=H)
    return d_out, gs_out


joint_step_cuda.launches = 0
joint_step_cuda.routes = {"fused": 0, "split": 0}   # launches by route


def s_project_cuda(s, g_s, lr_s, lo_s, ub_s, *, n: int, proj_iters: int = 50,
                   nu_out=None):
    """Launch the split route's shift update: per rollout of ``n``
    clusters, s' = clip(z - nu, lo_s, ub_s) with z = s - lr_s g_s and nu
    by bisection (``ref.project_row``). s/g_s/lo_s/ub_s: (rows, 1) with
    rows = B n, n <= ``MAX_PROJECT_N``; lr_s: (B, 1). ``nu_out`` (B, 2)
    takes each rollout's (nu, final bracket width) where given. Returns
    s' (rows, 1)."""
    B = _rollouts(s.shape[0], n, lr_s,
                  dict(s=s, g_s=g_s, lo_s=lo_s, ub_s=ub_s))
    if n > MAX_PROJECT_N:
        raise ValueError(f"s_project takes n <= {MAX_PROJECT_N} clusters a "
                         f"rollout, got {n}")
    if len({x.device for x in (s, g_s, lr_s, lo_s, ub_s)}) != 1:
        raise ValueError("all operands must be on one CUDA device")
    out = torch.empty_like(s)
    _launch("s_project", s, s, g_s, lr_s, lo_s, ub_s, out,
            _nu_out(nu_out, B, s.device), B, int(n), int(proj_iters))
    s_project_cuda.launches += 1
    spans.count("launch.s_project", B=B, n=int(n))
    return out


s_project_cuda.launches = 0


def joint_step_s_cuda(d, s, eta, pi, pow_nom, tau, u_if, u_if_q, ratio,
                      u_pow_cap, capacity, price, lr_d, temp, lambda_e, lo_s,
                      ub_s, lr_s, *, n: int, drop_limit: float,
                      proj_iters: int = 50, block_rows: int = BLOCK_ROWS,
                      nu_out=None):
    """One joint step with the shift update: the operands of
    ``joint_step_cuda`` for rows = B n, the rows of B rollouts of ``n``
    clusters one after another, with lo_s/ub_s (rows, 1) and lr_s (B, 1).
    Returns (d' (rows, H), s' (rows, 1)).

    ``joint_plan(n, block_rows)`` picks the route: the fused route, one
    launch of B clusters of C blocks; or, for n beyond one cluster's rows,
    the split route, ``joint_step_cuda`` then ``s_project_cuda``. A failed
    launch raises on either; neither falls back to the other. ``nu_out``
    takes each block's (nu, final bracket width), (B C, 2) on the fused
    route and (B, 2) on the split one."""
    rows, H = _joint_operands(d, s, eta, pi, pow_nom, tau, u_if, u_if_q,
                              ratio, u_pow_cap, capacity, price, lr_d, temp,
                              lambda_e, extra=(lo_s, ub_s, lr_s))
    B = _rollouts(rows, n, lr_s, dict(lo_s=lo_s, ub_s=ub_s))
    route, C, R = joint_plan(n, block_rows)
    if route == "split":
        d_out, g_s = joint_step_cuda(
            d, s, eta, pi, pow_nom, tau, u_if, u_if_q, ratio, u_pow_cap,
            capacity, price, lr_d, temp, lambda_e, drop_limit=drop_limit,
            proj_iters=proj_iters)
        return d_out, s_project_cuda(s, g_s, lr_s, lo_s, ub_s, n=n,
                                     proj_iters=proj_iters, nu_out=nu_out)
    d_out = torch.empty_like(d)
    s_out = torch.empty_like(s)
    _launch("joint_step_s", d, d, s, eta, pi, pow_nom, tau, u_if, u_if_q,
            ratio, u_pow_cap, capacity, price, lr_d, temp, lambda_e, lo_s,
            ub_s, lr_s, d_out, s_out, _nu_out(nu_out, B * C, d.device), B,
            int(n), C, R, H, *_drop_args(drop_limit), int(proj_iters))
    joint_step_cuda.launches += 1
    joint_step_cuda.routes["fused"] += 1
    spans.count("launch.joint_step", rows=rows, H=H, n=int(n))
    return d_out, s_out


def joint_step_flops(rows: int, H: int, proj_iters: int = 50) -> int:
    """FP32 operations of one joint step's function (counted as
    ``epoch_flops``: the reference's work, all ``proj_iters`` bisection
    steps):

    per hour: the box 10 and its feasibility compare 1, pow 5, softmax 4,
    gcoef 4, g_d 1, the g_s term 2, z 2, final clip 3, and 3 per bisection
    step;
    per row: tau + s, t24 and tau_s / 24 4, the feasibility compares 2,
    g_s / 24 1, the reductions (sum ub, softmax max and sum, g_s, box max
    and min, bracket min and max, one sum per bisection step)
    (8 + P) (H - 1), and the projection's 3 P + 4 scalar ops."""
    P = proj_iters
    return rows * ((32 + 3 * P) * H + (8 + P) * (H - 1) + 3 * P + 11)


def shift_flops(B: int, n: int, proj_iters: int = 50) -> int:
    """FP32 operations of the shift update of B rollouts of n clusters
    (counted as ``epoch_flops``, all ``proj_iters`` steps): per cluster z
    2, final clip 3, and 3 per bisection step; per rollout the bracket's
    four reductions 4 (n - 1) and its two differences, one (n - 1) sum and
    3 scalar ops per bisection step, and nu 2."""
    P = proj_iters
    return B * ((5 + 3 * P) * n + (4 + P) * (n - 1) + 3 * P + 4)


def joint_step_s_flops(B: int, n: int, H: int, proj_iters: int = 50) -> int:
    """FP32 operations of the fused route: the joint step of B n rows and
    the shift update of B rollouts of n clusters."""
    return joint_step_flops(B * n, H, proj_iters) \
        + shift_flops(B, n, proj_iters)


def joint_step_shuffles(rows: int, proj_iters: int = 50) -> int:
    """Warp-shuffle instructions of one joint step on the split route, in
    the layout of ``epoch_shuffles``: eight reductions a row (sum ub,
    softmax max and sum, g_s, box max and min, bracket min and max) and one
    per bisection step (all ``proj_iters``: the early exit issues fewer);
    the feasibility ballot is not a shuffle."""
    warps = -(-rows * LANES // 32)
    return warps * STAGES * (8 + proj_iters)


def shift_shuffles(warps: int, proj_iters: int = 50) -> int:
    """Warp-shuffle instructions of ``warps`` warps each bisecting one
    rollout's shift: the bracket's four and one sum per bisection step,
    five stages each."""
    return warps * 5 * (4 + proj_iters)


def joint_step_s_shuffles(B: int, n: int, proj_iters: int = 50,
                          block_rows: int = BLOCK_ROWS) -> int:
    """Warp-shuffle instructions of one joint step with the shift update on
    the route ``joint_plan`` picks: the fused route's B C blocks each run
    their rows' groups (whole warps of ``LANES``-lane groups, dead groups
    included) and one warp's bisection of the shift; the split route adds
    one bisecting warp per rollout to ``joint_step_shuffles``."""
    route, C, R = joint_plan(n, block_rows)
    if route == "split":
        return joint_step_shuffles(B * n, proj_iters) \
            + shift_shuffles(B, proj_iters)
    groups = min(R, 512 // LANES)
    warps = -(-groups * LANES // 32) * -(-R // groups)
    return B * C * (warps * STAGES * (8 + proj_iters)
                    + 5 * (4 + proj_iters))


def joint_step_bytes(rows: int, H: int) -> int:
    """Bytes one joint step must move: 7 wide and 8 slim float32 inputs
    read once, one wide and one slim output written once."""
    return 4 * rows * (8 * H + 9)


def shift_bytes(B: int, n: int) -> int:
    """Bytes the split route's shift update must move: s, g_s, lo_s and
    ub_s read once, s' written once, and lr_s, per rollout."""
    return 4 * (5 * B * n + B)


def joint_step_s_bytes(B: int, n: int, H: int) -> int:
    """Bytes the fused route must move: those of ``joint_step_bytes`` for
    rows = B n with g_s not written, plus lo_s and ub_s read and s' written
    a row, and lr_s a rollout."""
    return joint_step_bytes(B * n, H) + 4 * (2 * B * n + B)
