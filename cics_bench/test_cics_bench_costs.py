"""The kernels' operation and byte counts against hand counts, the roofline
share they give, and the reference's projection and halvings tally against
the program's plain bisection."""
import pytest
import torch

from cics_bench.costs import joint_step, peaks, pgd_epoch, pgd_epoch_ens
from cics_bench.costs import roofline
from cics_bench.reference import solve


def test_pgd_epoch_counts_by_hand():
    # 2 rows, 3 hours, 1 step, 2 halvings: per hour 17 + 3 * 2 = 23 (69 a
    # row), per row (4 + 2) * 2 + 3 * 2 + 4 = 22, once 2 * 2 = 4
    assert pgd_epoch.flops(rows=2, H=3, iters=1, halvings=2) == 2 * 95
    # 6 wide + 1 wide out, 5 slim: 4 bytes * 2 rows * (7 * 3 + 5)
    assert pgd_epoch.nbytes(rows=2, H=3, iters=1) == 208


def test_pgd_epoch_ens_counts_by_hand():
    # 1 row, 2 hours, 2 members, 1 step, 1 halving: per hour 13 * 2 + 14 +
    # 3 = 43 (86), per row 2 * (4 + 15) + 3 + 3 * 1 + 3 + 4 = 51, once 2
    assert pgd_epoch_ens.flops(rows=1, H=2, K=2, iters=1, halvings=1) == 139
    assert pgd_epoch_ens.nbytes(rows=1, H=2, K=2, iters=1) == 4 * 24


def test_joint_step_counts_by_hand():
    # 2 rollouts of 2 clusters, 2 hours, one halving each: a row (32 + 3)
    # * 2 + 9 * 1 + 3 + 11 = 93; a rollout's shift (5 + 3) * 2 + 5 * 1 +
    # 3 + 4 = 28
    assert joint_step.flops(rows=4, H=2, n=2, halvings=1,
                            shift_halvings=1) == 4 * 93 + 2 * 28
    assert joint_step.nbytes(rows=4, H=2, n=2) == 4 * 4 * 27 + 4 * 2


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, names):
        return self.seconds


class _Run:
    def __init__(self, launches, seconds, halvings):
        self.launches = launches
        self.trace = _Trace(seconds)
        self.tally = solve.Tally()
        for k, v in halvings.items():
            self.tally.sums[k], self.tally.rows[k] = v, 1


def test_roofline_share_is_the_bound_over_the_device_time():
    shape = {"rows": 90112, "H": 24, "iters": 80}
    bound = peaks.bound_s(pgd_epoch.flops(**shape, halvings=26.0),
                          pgd_epoch.nbytes(**shape))
    run = _Run({"pgd_epoch": [shape, shape]}, 4 * bound,
               {"pgd_epoch": 26.0})
    assert roofline.share(run, pgd_epoch) == pytest.approx(50.0)
    # operations bound this kernel, not bytes
    assert bound == pgd_epoch.flops(**shape, halvings=26.0) / 67e12


def test_roofline_share_reads_nothing_without_launches_or_time():
    shape = {"rows": 8, "H": 24, "iters": 80}
    assert roofline.share(_Run({}, 1.0, {"pgd_epoch": 26.0}),
                          pgd_epoch) is None
    assert roofline.share(_Run({"pgd_epoch": [shape]}, 0.0,
                               {"pgd_epoch": 26.0}), pgd_epoch) is None
    assert roofline.share(_Run({"pgd_epoch": [shape]}, 1.0, {}),
                          pgd_epoch) is None


def _rows(seed, n=64, H=24):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(n, H, generator=g) * 3
    lo = torch.full((n, H), -0.8)
    ub = torch.rand(n, H, generator=g) * 4 - 0.2
    return z, lo, ub


def test_exact_projection_agrees_with_the_programs_bisection():
    from repro_torch.kernels.vcc_pgd import ref
    z, lo, ub = _rows(0)
    exact = solve.project(z, lo, ub)
    bisect = ref.project_row(z, lo, ub, 50)
    assert torch.allclose(exact, bisect, atol=2e-6, rtol=0)
    assert exact.sum(-1).abs().max() < 1e-4
    assert ((exact >= lo) & (exact <= ub)).all()


def test_halvings_are_where_the_programs_bisection_stops_moving():
    from repro_torch.kernels.vcc_pgd import ref
    z, lo, ub = _rows(1)
    h = solve.bisect_halvings(z, lo, ub)
    assert ((h >= 2) & (h <= 50)).all() and h.float().mean() < 45
    full = ref.project_row(z, lo, ub, 50)
    for k in torch.unique(h).tolist():
        rows = h == k
        cut = ref.project_row(z[rows], lo[rows], ub[rows], int(k) - 1)
        assert torch.equal(cut, full[rows])


def test_trace_reads_busy_time_kernels_and_gaps():
    from cics_bench import trace
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 110.0,
         "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 111.0, "dur": 1.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "ts": 150.0, "dur": 1.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "void add_kernel<float>(int)",
         "ts": 120.0, "dur": 20.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "ts": 130.0, "dur": 20.0,
         "name": "void (anonymous namespace)::pgd_epoch_kernel<6>(Args)",
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "ts": 160.0, "dur": 10.0,
         "name": "void (anonymous namespace)::pgd_epoch_ens_kernel<6, 8>(A)",
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 175.0, "dur": 24.0},
    ]
    t = trace.Trace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)         # [120, 150] + [160, 170]
    assert t.kernel_seconds(("pgd_epoch_kernel",)) == pytest.approx(20e-6)
    assert t.kernel_seconds(("pgd_epoch_ens_kernel",)) == pytest.approx(1e-5)
    assert t.gaps["aten::add"] == pytest.approx(20e-6)
    assert t.gaps["cudaLaunchKernelExC"] == pytest.approx(10e-6)
    assert t.gaps["window end"] == pytest.approx(30e-6)
    assert len(t.kernels) == 3
    assert t.runtime_s == pytest.approx(2e-6)     # the closing sync left out
