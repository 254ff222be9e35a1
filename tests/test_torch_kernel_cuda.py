"""The hand-written CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so these tests carry the ``cuda`` marker and
skip without a card. They import neither JAX nor the JAX package, so they
also run on a machine that has only PyTorch:

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances: atol 1e-4 on delta after 80 steps of either epoch (the kernels
sum the hours, and the CVaR epoch the members, in another order than the
plain versions), and after 8 steps at the MPC loop's suffix boxes, whose
pinned entries (lo == ub) come back bit for bit; one joint step 1e-5 on d' and 1e-5 x max|g_s| on g_s, and
with its shift update (#3's fused and split routes) 1e-5 on d' and on s'
1e-5 x max|z| plus the final bisection bracket's width (the sums over the
clusters run in another order, so nu may move by about a bracket). The
CVaR epoch over K identical members is kernel #1 to 1e-6 (they share their
device code, so bitwise is expected); the epochs with the bisection's early
exit are their fixed-count builds bit for bit. The epochs' row-group layout
is held at row counts and widths that leave groups and hours masked.
Flash attention (#4): 2e-5 in float32
and 2e-2 in bf16 against ``ref.attention_reference``, as
``tests/test_kernels_flash.py`` holds the TPU kernel; the decode route's
float32 split partials 2e-5 of max(1, max|plain|) against
``ref.attention_partials``. The GLA scan (#5):
1e-4 of max|o| on the output and of max|state| on the final state against
``ref.gla_chunked`` (the kernel walks a chunk in tiles of up to 64 rows and
sums in another order); its bf16 tensor-core routes (``csrc/gla_ssd.cu``,
scalar decay, and ``csrc/gla_vec.cu``, per-channel decay) and the bf16
calls of its split-TF32 route (``csrc/gla_scan.cu``) to ``chip_smoke.py``'s
limit, 1e-4 of max|o| plus one bf16 unit in the last place of the plain
value (both sides round a float32 sum to bf16); the split-TF32 route's own
cases (16 tiles of state, decays of -30 a step, odd widths, one token,
element loads) in float32 to 1e-4 of max|o| and of max|state|.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import vcc
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.linear_scan import kernel as gla_kernel
from repro_torch.kernels.linear_scan import ops as gla_ops
from repro_torch.kernels.linear_scan import ref as gla_ref
from repro_torch.kernels.vcc_pgd import kernel, ref

H = 24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rows(n, seed, device, H=H):
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)

    pi, eta = 150 + 250 * u(n, H), 0.1 + 0.6 * u(n, H)
    tau24, price, lam = 0.05 + 0.3 * u(n, 1), 0.05 + 0.5 * u(n, 1), \
        0.02 + 2.0 * u(n, 1)
    dead = (torch.arange(n) % 5 == 0)[:, None]
    lo = torch.where(dead, 0.0, torch.full((n, H), -0.8))
    ub = torch.where(dead, 0.0, 0.1 + 2.9 * u(n, H))
    pow_nom = 300 + 400 * u(n, H)
    lr = 0.5 / (pi.amax(1, keepdim=True) * tau24
                * (lam * eta.amax(1, keepdim=True) + price))
    temp = 0.02 * pow_nom.mean(1, keepdim=True)
    args = [torch.zeros(n, H), eta, pi, pow_nom, tau24, price, lo, ub, lr]
    return [x.to(device) for x in args], temp.to(device), lam.to(device)


def _check_epoch(got, want, lo, ub):
    """Within 1e-4 of the plain epoch, conserving and inside the box."""
    assert (got - want).abs().max().item() <= 1e-4
    assert got.sum(1).abs().max().item() <= 1e-4 * ub.abs().max().item()
    assert bool(((got >= lo - 1e-6) & (got <= ub + 1e-6)).all())


# row counts that no warp's rows divide (kernel.LANES = 4: 8 rows a warp),
# so the last warp runs groups past the last row
@pytest.mark.cuda
@pytest.mark.parametrize("rows", (1, 7, 45, 1000, 1001))
def test_kernel_matches_plain_on_card(cuda_device, rows):
    args, temp, lam = _rows(rows, rows, cuda_device)
    got = kernel.pgd_epoch_cuda(*args, temp, lam, iters=80)
    want = ref.pgd_epoch_ref(*args, temp=temp, lambda_e=lam, iters=80)
    torch.cuda.synchronize()
    _check_epoch(got, want, args[6], args[7])


# widths that leave a lane's last hours masked (H % 4 != 0), one hour, and
# the widest row
@pytest.mark.cuda
@pytest.mark.parametrize("width", (1, 7, 23, 24, 32))
def test_epochs_match_plain_at_every_width(cuda_device, width):
    rows, K, B = 1001, 3, 7
    args, eta_e, pow_e, temp, lam, rs = _members(rows, K, width, cuda_device,
                                                 B, H=width)
    got = kernel.pgd_epoch_cuda(*args, temp, lam, iters=80)
    want = ref.pgd_epoch_ref(*args, temp=temp, lambda_e=lam, iters=80)
    torch.cuda.synchronize()
    _check_epoch(got, want, args[6], args[7])
    got, want = _ens_pair(args, eta_e, pow_e, temp, lam, rs, B)
    _check_epoch(got, want, args[6], args[7])


@pytest.mark.cuda
def test_early_exit_gives_the_fixed_count_bits(cuda_device):
    """The shipped epochs leave the bisection once no bracket of a warp
    moves; the same sources built with the fixed count give the same bits
    (rows past a warp's last row, masked hours, both member layouts)."""
    fixed = {name: kernel.variant(name, ("PGD_EARLY_EXIT=0",))
             for name in ("pgd_epoch", "pgd_epoch_ens")}
    for rows, width, K, B in ((1001, 24, 8, 7), (45, 23, 3, 5),
                              (7, 32, 32, 1)):
        args, eta_e, pow_e, temp, lam, rs = _members(rows, K, rows,
                                                     cuda_device, B, H=width)
        runs = {}
        for build in ("shipped", "fixed"):
            saved = dict(kernel._libs)
            if build == "fixed":
                kernel._libs.update(fixed)
            try:
                runs[build] = (kernel.pgd_epoch_cuda(*args, temp, lam,
                                                     iters=80),
                               _ens_pair(args, eta_e, pow_e, temp, lam, rs,
                                         B, plain=False)[0])
            finally:
                kernel._libs.clear()
                kernel._libs.update(saved)
        torch.cuda.synchronize()
        for got, want in zip(runs["shipped"], runs["fixed"]):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    args, temp, lam = _rows(16, 3, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        kernel.pgd_epoch_cuda(args[0].double(), *args[1:], temp, lam,
                              iters=1)
    wide = [torch.zeros(16, 33, device=cuda_device)] * 4
    with pytest.raises(ValueError, match="H <= 32"):
        kernel.pgd_epoch_cuda(*wide, *args[4:6], wide[0], wide[0], args[8],
                              temp, lam, iters=1)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.pgd_epoch_cuda(args[0].t().contiguous().t(), *args[1:], temp,
                              lam, iters=1)


@pytest.mark.cuda
def test_solve_on_card_goes_through_the_kernel(cuda_device):
    p = vcc.synthetic_problem(device="cpu")
    before = kernel.pgd_epoch_cuda.launches
    on_card = vcc.solve_vcc(p, device=cuda_device)
    assert kernel.pgd_epoch_cuda.launches == before + 20
    on_cpu = vcc.solve_vcc(p, device="cpu")
    np.testing.assert_allclose(on_card.delta.cpu().numpy(),
                               on_cpu.delta.numpy(), rtol=0, atol=1e-4)


# the suffix boxes of the MPC recourse loop: elapsed hours and whole rows
# pinned at lo == ub, where the kernel's clamp returns lo bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("hour", (1, 12, 23, 24))
def test_pinned_entries_come_back_exactly_on_card(cuda_device, hour):
    args, temp, lam = _rows(1001, hour, cuda_device)
    lo, ub = args[6], args[7]
    g = torch.Generator().manual_seed(hour)
    start = lo + (ub - lo) * torch.rand(lo.shape, generator=g).to(lo.device)
    pinned = (torch.arange(H, device=lo.device) < hour)[None, :] \
        | (torch.arange(1001, device=lo.device) % 3 == 0)[:, None]
    args[0] = start.contiguous()
    args[6] = torch.where(pinned, start, lo).contiguous()
    args[7] = torch.where(pinned, start, ub).contiguous()
    got = kernel.pgd_epoch_cuda(*args, temp, lam, iters=8)
    want = ref.pgd_epoch_ref(*args, temp=temp, lambda_e=lam, iters=8)
    torch.cuda.synchronize()
    for out in (got, want):
        assert torch.equal(out[pinned], start[pinned])
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_suffix_solve_on_card_goes_through_the_kernel(cuda_device):
    p = vcc.synthetic_problem(8, seed=3, device="cpu")
    plan = vcc.solve_vcc(p, device="cpu")
    before = kernel.pgd_epoch_cuda.launches
    on_card = vcc.solve_vcc_suffix(p, plan.delta, plan.mu, 12,
                                   device=cuda_device)
    assert kernel.pgd_epoch_cuda.launches == before + 2
    on_cpu = vcc.solve_vcc_suffix(p, plan.delta, plan.mu, 12, device="cpu")
    got = on_card.delta.cpu()
    assert torch.equal(got[:, :12], plan.delta[:, :12])
    np.testing.assert_allclose(got.numpy(), on_cpu.delta.numpy(), rtol=0,
                               atol=1e-4)


def _members(rows, K, seed, device, B=1, H=H):
    """A CVaR epoch problem: kernel #1's rows plus K members of intensity
    and nominal power (member 0 the point forecast), stacked (B, K, n, H)
    with B * n = rows."""
    args, temp, lam = _rows(rows, seed, device, H)
    g = torch.Generator().manual_seed(seed + 1)
    delta, eta, pi, pow_nom = (x.cpu() for x in args[:4])
    prof = 1 + 0.4 * (torch.rand(K, 1, H, generator=g) - 0.5)
    prof[0] = 1.0
    noise = 30 * (torch.rand(K, rows, H, generator=g) - 0.5)
    noise[0] = 0.0
    n = rows // B

    def stack(x):
        return x.reshape(K, B, n, H).transpose(0, 1).contiguous().to(device)

    eta_e, pow_e = stack(eta[None] * prof), stack(pow_nom[None] + noise)
    risk_s = torch.full((rows, 1), 4.0 * (1 - 0.5) / 0.5, device=device)
    return args, eta_e, pow_e, temp, lam, risk_s


def _ens_pair(args, eta_e, pow_e, temp, lam, rs, B, plain=True):
    """(kernel #2, its plain version) on one problem, B rollouts; the plain
    side is None with ``plain=False``."""
    d, _, pi, _, tau24, price, lo, ub, lr = args
    rows, width = d.shape
    got = kernel.pgd_epoch_ens_cuda(d, eta_e, pi, pow_e, tau24, price, lo,
                                    ub, lr, temp, lam, rs, iters=80)
    if not plain:
        return got, None

    def b3(x):
        return x.reshape(B, rows // B, x.shape[-1])

    want = ref.pgd_epoch_ens_ref(
        b3(d), eta_e, b3(pi), pow_e, b3(tau24), b3(price), b3(lo), b3(ub),
        b3(lr), temp=b3(temp), lambda_e=b3(lam), risk_s=b3(rs),
        iters=80).reshape(rows, width)
    torch.cuda.synchronize()
    return got, want


# K in {1, 3, 8, 32}, each over B > 1 member stacks: the register (K <= 8)
# and the shared-memory (K > 8) layouts of the members
@pytest.mark.cuda
@pytest.mark.parametrize("K,rows,B", ((8, 45, 1), (3, 1000, 4), (32, 1000, 2),
                                      (1, 1001, 7), (8, 1001, 11),
                                      (32, 7, 7)))
def test_ens_kernel_matches_plain_on_card(cuda_device, K, rows, B):
    args, eta_e, pow_e, temp, lam, rs = _members(rows, K, rows + K,
                                                 cuda_device, B)
    before = kernel.pgd_epoch_ens_cuda.launches
    got, want = _ens_pair(args, eta_e, pow_e, temp, lam, rs, B)
    assert kernel.pgd_epoch_ens_cuda.launches == before + 1
    _check_epoch(got, want, args[6], args[7])


@pytest.mark.cuda
@pytest.mark.parametrize("K", (1, 8, 32))
def test_identical_members_ens_kernel_is_kernel_1(cuda_device, K):
    args, temp, lam = _rows(1000, 7, cuda_device)
    d, eta, pi, pow_nom, tau24, price, lo, ub, lr = args
    rs = torch.full((1000, 1), 4.0, device=cuda_device)
    ens = kernel.pgd_epoch_ens_cuda(
        d, eta.expand(1, K, 1000, H).contiguous(), pi,
        pow_nom.expand(1, K, 1000, H).contiguous(), tau24, price, lo, ub, lr,
        temp, lam, rs, iters=80)
    plain = kernel.pgd_epoch_cuda(*args, temp, lam, iters=80)
    torch.cuda.synchronize()
    assert (ens - plain).abs().max().item() <= 1e-6


def _joint(rows, seed, device, H=H):
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)

    tau = 1.0 + 4.0 * u(rows, 1)
    s = tau * (u(rows, 1) - 0.5)
    s[::4] = -tau[::4]
    u_if, pi, eta = 0.3 + 0.3 * u(rows, H), 150 + 250 * u(rows, H), \
        0.1 + 0.6 * u(rows, H)
    price, lam = 0.05 + 0.5 * u(rows, 1), 0.02 + 2.0 * u(rows, 1)
    lr = 0.5 / (pi.amax(1, keepdim=True) * tau / 24
                * (lam * eta.amax(1, keepdim=True) + price))
    pow_nom = 300 + 400 * u(rows, H)
    args = [0.3 * (u(rows, H) - 0.5), s, eta, pi, pow_nom, tau, u_if,
            u_if * 1.1, 1.1 + 0.4 * u(rows, H), 0.75 + 0.25 * u(rows, 1),
            1.0 + 0.6 * u(rows, 1), price, lr,
            0.02 * pow_nom.mean(1, keepdim=True), lam]
    return [x.to(device).contiguous() for x in args]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", (45, 1000))
def test_joint_kernel_matches_plain_on_card(cuda_device, rows):
    args = _joint(rows, rows, cuda_device)
    before = kernel.joint_step_cuda.launches
    d, g = kernel.joint_step_cuda(*args, drop_limit=0.8)
    assert kernel.joint_step_cuda.launches == before + 1
    wd, wg = ref.joint_step_arrays(*args, drop_limit=0.8)
    torch.cuda.synchronize()
    assert (d - wd).abs().max().item() <= 1e-5
    assert (g - wg).abs().max().item() <= 1e-5 * wg.abs().max().item()
    assert bool((d[::4] == 0).all())          # emptied budgets: box {0}


def _joint_s(B, n, seed, device, H=H):
    """B rollouts of n clusters: ``_joint``'s rows (every fourth budget
    emptied by its shift), the shift bounds at a mobility per rollout
    (rollout 1 at 0: lo_s = ub_s = 0) and lr_s per rollout. Returns the
    kernel's operands and the plain version's, (B, n, .)."""
    g = torch.Generator().manual_seed(seed + 1)
    args = _joint(B * n, seed, "cpu", H)
    tau = args[5]
    mob = 0.1 + 0.5 * torch.rand(B, 1, generator=g)
    if B > 1:
        mob[1] = 0.0
    mob = mob.repeat_interleave(n, 0)
    lo_s, ub_s = -mob * tau, mob * tau
    lr_s = 0.002 + 0.004 * torch.rand(B, 1, generator=g)
    kern = [x.to(device).contiguous() for x in (*args, lo_s, ub_s, lr_s)]
    plain = [x.reshape(B, n, x.shape[-1]) for x in kern[:-1]] + [kern[-1]]
    return kern, plain


def _check_joint_s(B, n, d, s2, nu, plain):
    """d' and s' against ``ref.joint_step_s_arrays``; s' in its box and
    conserving as closely as the plain version: both residuals are the
    rounding of sums over n clusters, so the kernel's may exceed twice the
    plain version's by n ulp of max|z|. Returns the bracket width."""
    wd, ws = ref.joint_step_s_arrays(*plain, drop_limit=0.8)
    _, g_s = ref.joint_step_arrays(*plain[:15], drop_limit=0.8)
    z = plain[1][..., 0] - plain[-1] * g_s[..., 0]
    width = nu[:, 1].max().item()
    torch.cuda.synchronize()
    assert (d.reshape(wd.shape) - wd).abs().max().item() <= 1e-5
    s2 = s2.reshape(B, n)
    assert (s2 - ws[..., 0]).abs().max().item() <= \
        1e-5 * z.abs().max().item() + width
    lo_s, ub_s = plain[15][..., 0], plain[16][..., 0]
    assert bool(((s2 >= lo_s) & (s2 <= ub_s)).all())
    assert s2.sum(-1).abs().max().item() <= \
        2 * ws.sum(-2).abs().max().item() + n * 2 ** -24 * z.abs().max().item()
    if B > 1:
        assert not s2[1].any()            # mobility 0: s' exactly 0
    return width


@pytest.mark.cuda
@pytest.mark.parametrize("Hh", (1, 7, 24, 32))
@pytest.mark.parametrize("B,n", ((1, 1), (3, 31), (2, 129), (28, 512),
                                 (1, 2048)))
def test_fused_joint_route_matches_plain_on_card(cuda_device, B, n, Hh):
    kern, plain = _joint_s(B, n, 100 * B + n, cuda_device, Hh)
    route, C, R = kernel.joint_plan(n)
    assert route == "fused"
    nu = torch.full((B * C, 2), float("nan"), device=cuda_device)
    before = (kernel.joint_step_cuda.launches,
              dict(kernel.joint_step_cuda.routes),
              kernel.s_project_cuda.launches)
    d, s2 = kernel.joint_step_s_cuda(*kern, n=n, drop_limit=0.8, nu_out=nu)
    assert kernel.joint_step_cuda.launches == before[0] + 1
    assert kernel.joint_step_cuda.routes == {
        "fused": before[1]["fused"] + 1, "split": before[1]["split"]}
    assert kernel.s_project_cuda.launches == before[2]
    _check_joint_s(B, n, d, s2, nu, plain)
    # every block of a rollout's cluster found the same nu, bit for bit
    bits = nu[:, 0].view(torch.int32).reshape(B, C)
    assert torch.equal(bits, bits[:, :1].expand(B, C))


@pytest.mark.cuda
def test_split_joint_route_matches_plain_on_card(cuda_device):
    """Past one cluster's rows (n = 3,000) the wrapper takes the split
    route: the step's kernel, then ``s_project``; at n = 512 the two called
    directly."""
    B, n = 2, 3000
    kern, plain = _joint_s(B, n, 7, cuda_device)
    assert kernel.joint_plan(n) == ("split", 0, 0)
    nu = torch.empty(B, 2, device=cuda_device)
    before = (dict(kernel.joint_step_cuda.routes),
              kernel.s_project_cuda.launches)
    d, s2 = kernel.joint_step_s_cuda(*kern, n=n, drop_limit=0.8, nu_out=nu)
    assert kernel.joint_step_cuda.routes == {
        "fused": before[0]["fused"], "split": before[0]["split"] + 1}
    assert kernel.s_project_cuda.launches == before[1] + 1
    _check_joint_s(B, n, d, s2, nu, plain)

    B, n = 3, 512
    kern, plain = _joint_s(B, n, 8, cuda_device)
    nu = torch.empty(B, 2, device=cuda_device)
    d, g_s = kernel.joint_step_cuda(*kern[:15], drop_limit=0.8)
    s2 = kernel.s_project_cuda(kern[1], g_s, kern[17], kern[15], kern[16],
                               n=n, nu_out=nu)
    _check_joint_s(B, n, d, s2, nu, plain)


@pytest.mark.cuda
def test_fused_and_split_joint_routes_agree(cuda_device):
    """At the slice path's 28 x 512 the two routes give the same d' bit for
    bit (one device function) and s' within the final bracket's width."""
    B, n = 28, 512
    kern, _ = _joint_s(B, n, 11, cuda_device)
    nu_f = torch.empty(B * 4, 2, device=cuda_device)
    nu_s = torch.empty(B, 2, device=cuda_device)
    d_f, s_f = kernel.joint_step_s_cuda(*kern, n=n, drop_limit=0.8,
                                        nu_out=nu_f)
    d_s, g_s = kernel.joint_step_cuda(*kern[:15], drop_limit=0.8)
    s_s = kernel.s_project_cuda(kern[1], g_s, kern[17], kern[15], kern[16],
                                n=n, nu_out=nu_s)
    torch.cuda.synchronize()
    assert torch.equal(d_f.view(torch.int32), d_s.view(torch.int32))
    width = max(nu_f[:, 1].max().item(), nu_s[:, 1].max().item())
    assert (s_f - s_s).abs().max().item() <= width


@pytest.mark.cuda
def test_joint_routes_early_exit_is_the_fixed_count(cuda_device):
    """Both routes built with the bisections' early exit (shipped) and
    without (``PGD_EARLY_EXIT=0``) give the same bits."""
    B, n = 5, 300
    kern, _ = _joint_s(B, n, 13, cuda_device)
    out = {}
    entries = ("joint_step_s", "joint_step", "s_project")
    try:
        for name, defs in (("shipped", ()),
                           ("fixed", ("PGD_EARLY_EXIT=0",))):
            for entry in entries:
                kernel._libs[entry] = kernel.variant(entry, defs)
            d_f, s_f = kernel.joint_step_s_cuda(*kern, n=n, drop_limit=0.8)
            d_s, g_s = kernel.joint_step_cuda(*kern[:15], drop_limit=0.8)
            s_s = kernel.s_project_cuda(kern[1], g_s, kern[17], kern[15],
                                        kern[16], n=n)
            torch.cuda.synchronize()
            out[name] = [x.view(torch.int32)
                         for x in (d_f, s_f, d_s, g_s, s_s)]
    finally:
        for entry in entries:
            kernel._libs.pop(entry, None)
    assert all(torch.equal(a, b) for a, b in zip(out["shipped"],
                                                  out["fixed"]))


@pytest.mark.cuda
def test_fused_joint_route_all_infeasible_rollout(cuda_device):
    """A rollout whose every budget is emptied by its shift: each row's box
    is {0}, so d' is 0 there; s' still conserves in its box."""
    B, n = 3, 200
    kern, plain = _joint_s(B, n, 17, cuda_device)
    rows = slice(2 * n, 3 * n)
    kern[1][rows] = -kern[5][rows]        # plain[1] is a view of kern[1]
    nu = torch.empty(B * 2, 2, device=cuda_device)
    d, s2 = kernel.joint_step_s_cuda(*kern, n=n, drop_limit=0.8, nu_out=nu)
    _check_joint_s(B, n, d, s2, nu, plain)
    assert not d[rows].any()


@pytest.mark.cuda
def test_joint_solve_with_members_goes_through_the_kernels(cuda_device):
    """solve_joint and the CVaR solve after it, on the card: 20 launches
    of kernel #1 (the warm start), 8 x 25 of the joint step (all on its
    fused route) and 20 of the CVaR epoch, and the cpu run of the same
    problem agrees."""
    from repro_torch.core import risk, spatial
    p = vcc.synthetic_problem(n=16, seed=3, device="cpu")
    p = dataclasses.replace(p, eta=p.eta * torch.where(
        torch.arange(16) % 2 == 0, 2.2, 0.5)[:, None],
        capacity=p.capacity * 0.85)
    members = torch.stack([p.eta * (1 + 0.2 * k) for k in range(4)])
    counts = (kernel.pgd_epoch_cuda, kernel.joint_step_cuda,
              kernel.pgd_epoch_ens_cuda)
    before = [c.launches for c in counts]
    routes = dict(kernel.joint_step_cuda.routes)
    out = {}
    for dev in (cuda_device, "cpu"):
        sol, tau_j, s, _ = spatial.solve_joint(p, 0.3, device=dev)
        pe = risk.attach_ensemble(dataclasses.replace(p.to(dev), tau=tau_j),
                                  members.to(dev), p.u_if.expand(4, 16, H)
                                  .to(dev), 0.5)
        out[str(dev)] = (s, vcc.solve_vcc(pe, device=dev).delta)
    assert [c.launches - b for c, b in zip(counts, before)] == [20, 200, 20]
    assert kernel.joint_step_cuda.routes == {"fused": routes["fused"] + 200,
                                             "split": routes["split"]}
    (s_gpu, d_gpu), (s_cpu, d_cpu) = out["cuda"], out["cpu"]
    assert (s_gpu.cpu() - s_cpu).abs().max().item() <= 1e-3 * \
        p.tau.abs().max().item()
    assert (d_gpu.cpu() - d_cpu).abs().max().item() <= 1e-3


# ------------------------------------------------------ kernel #4: attention

FLASH_CASES = [
    # B, Sq, Sk, N, K, H, causal, window, softcap, q_offset, length, dtype
    (2, 256, 256, 4, 2, 64, True, None, None, 0, None, torch.float32),
    (1, 200, 200, 8, 8, 32, True, None, 50.0, 0, None, torch.float32),
    (2, 128, 128, 4, 1, 64, True, 64, None, 0, None, torch.float32),
    (1, 256, 256, 2, 2, 128, False, None, None, 0, None, torch.float32),
    (1, 320, 320, 4, 4, 96, True, 128, 30.0, 0, None, torch.float32),
    (2, 130, 130, 4, 4, 112, True, None, None, 0, None, torch.bfloat16),
    (2, 128, 128, 16, 8, 128, True, None, None, 0, None, torch.bfloat16),
    (1, 70, 70, 4, 2, 256, True, 16, 50.0, 0, None, torch.float32),
    (2, 1, 80, 4, 2, 32, True, None, None, 45, 46, torch.float32),
    (3, 1, 90, 4, 4, 112, True, None, None, 60, 61, torch.bfloat16),
    (2, 1, 50, 16, 8, 128, True, 16, 50.0, 30, 31, torch.bfloat16),
    # the tensor-core prefill route (bf16, Sq > 16) at each padded width
    (2, 200, 200, 4, 2, 64, True, None, None, 0, None, torch.bfloat16),
    (1, 333, 333, 4, 4, 112, True, None, None, 0, None, torch.bfloat16),
    (1, 256, 256, 8, 4, 128, False, None, None, 0, None, torch.bfloat16),
    (1, 300, 300, 4, 2, 256, True, 100, 50.0, 0, None, torch.bfloat16),
    (1, 1000, 1000, 8, 8, 112, True, None, None, 0, None, torch.bfloat16),
    (1, 90, 120, 4, 2, 36, True, None, None, 30, 100, torch.bfloat16),
    # the split-KV decode route: length 1, a split boundary (64 keys) and
    # one either side, the whole cache, a window across splits, Qwen3's
    # G = 2, several query rows, an unaligned head dim
    (2, 1, 300, 8, 4, 128, True, None, None, 0, 1, torch.float32),
    (2, 1, 300, 4, 4, 112, True, None, None, 126, 127, torch.float32),
    (2, 1, 300, 4, 4, 112, True, None, None, 127, 128, torch.float32),
    (2, 1, 300, 4, 4, 112, True, None, None, 128, 129, torch.float32),
    (2, 1, 300, 8, 4, 64, True, None, None, 299, 300, torch.float32),
    (2, 1, 600, 8, 4, 64, True, 200, None, 500, 501, torch.float32),
    (4, 1, 1064, 16, 8, 128, True, None, None, 1040, 1041, torch.bfloat16),
    (4, 1, 1064, 16, 8, 128, True, None, None, 1040, 1041, torch.float32),
    (1, 5, 200, 8, 2, 64, True, None, None, 150, 155, torch.float32),
    (2, 1, 100, 4, 2, 256, True, None, 30.0, 80, 81, torch.bfloat16),
    (2, 1, 70, 4, 2, 33, True, None, None, 60, 61, torch.bfloat16),
    # non-causal with Sq != Sk on each route (an encoder-decoder's
    # cross-attention: Whisper-base's 8 heads of 64 over 1,500 frames), a
    # decode with no length, and a non-causal decode with length < Sk
    (2, 128, 1500, 8, 8, 64, False, None, None, 0, None, torch.bfloat16),
    (2, 40, 300, 4, 4, 64, False, None, None, 0, None, torch.float32),
    (2, 1, 1500, 8, 8, 64, False, None, None, 0, None, torch.bfloat16),
    (2, 1, 1500, 8, 8, 64, False, None, None, 0, None, torch.float32),
    (2, 1, 300, 8, 4, 64, False, None, None, 0, 170, torch.float32),
    # head dim 192 (DeepSeek-V2's MLA prefill: 128 nope + 64 rope, 128
    # heads) on the bf16 prefill route's 256-wide tiles and the float32
    # route
    (4, 1024, 1024, 128, 128, 192, True, None, None, 0, None, torch.bfloat16),
    (1, 300, 300, 16, 16, 192, True, None, None, 0, None, torch.float32),
    # the float32 prefill route's tiles: B * N = 65,536 (a one-dimensional
    # grid), H = 256 with window and softcap over many key tiles, a ragged
    # Sq, a chunked prefill (q_offset and length), GQA, H = 33 (element
    # loads, k-steps past H zero)
    (1024, 24, 24, 64, 64, 16, True, None, None, 0, None, torch.float32),
    (1, 300, 300, 4, 2, 256, True, 100, 50.0, 0, None, torch.float32),
    (1, 333, 333, 4, 4, 112, True, None, None, 0, None, torch.float32),
    (2, 90, 300, 4, 2, 64, True, None, None, 150, 240, torch.float32),
    (1, 256, 256, 16, 8, 128, True, None, None, 0, None, torch.float32),
    (2, 70, 70, 4, 2, 33, True, None, None, 0, None, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda_device, case):
    B, Sq, Sk, N, K, Hd, causal, window, softcap, off, length, dt = case
    g = torch.Generator().manual_seed(Sq + Sk + Hd)
    q, k, v = (torch.randn(*shape, generator=g).to(cuda_device, dt)
               for shape in ((B, Sq, N, Hd), (B, Sk, K, Hd), (B, Sk, K, Hd)))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off,
              length=length)
    before = fa_kernel.flash_attention_cuda.launches
    got = fa_ops.attention(q, k, v, **kw)
    assert fa_kernel.flash_attention_cuda.launches == before + 1
    want = fa_ref.attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 2e-5 if dt == torch.float32 else 2e-2
    assert got.dtype == dt and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.cuda
def test_flash_kernel_reads_strided_cache_views(cuda_device):
    """A layer's view of a stacked (L, B, S, K, H) cache and a q sliced
    from a wider projection go in without a copy."""
    g = torch.Generator().manual_seed(5)
    cache = torch.randn(3, 2, 64, 2, 32, generator=g).to(cuda_device)
    wide = torch.randn(2, 1, 4, 48, generator=g).to(cuda_device)
    q, kc, vc = wide[..., :32], cache[1], cache[2]
    got = fa_kernel.flash_attention_cuda(q, kc, vc, q_offset=20, length=21)
    want = fa_ref.attention_reference(q, kc, vc, q_offset=20, length=21)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("splits", (1, 3, 7))
def test_flash_decode_partials_match_plain_on_card(cuda_device, splits):
    """The decode route's float32 split partials (m, l, acc), a split
    with no key among them at 7 splits, against ``ref.attention_partials``;
    their merge against ``ref.attention_reference``."""
    g = torch.Generator().manual_seed(splits)
    q, k, v = (torch.randn(*shape, generator=g).to(cuda_device)
               for shape in ((2, 2, 8, 64), (2, 120, 4, 64), (2, 120, 4, 64)))
    kw = dict(causal=True, window=10, q_offset=100, length=101)
    got = fa_kernel.flash_decode_partials_cuda(q, k, v, splits=splits, **kw)
    want = fa_ref.attention_partials(q, k, v, splits, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert ((x - y).abs().max() / y.abs().max().clamp_min(1.0)
                ).item() < 2e-5
    merged = fa_ref.combine_partials(*got)
    assert torch.isfinite(merged).all()
    assert (merged - fa_ref.attention_reference(q, k, v, **kw)
            ).abs().max().item() < 2e-5


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(1, 4, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="length"):
        fa_kernel.flash_attention_cuda(q, q, q, length=5)
    with pytest.raises(ValueError, match="H <= 256"):
        big = torch.zeros(1, 4, 2, 264, device=cuda_device)
        fa_kernel.flash_attention_cuda(big, big, big)


# ------------------------------------------------------ kernel #5: GLA scan

GLA_CASES = [
    # B, S, H, K, V, mode, chunk, initial state, dtype
    (2, 64, 2, 16, 8, "scalar", 16, False, torch.float32),
    (1, 96, 3, 8, 16, "vector", 32, False, torch.float32),
    (2, 64, 2, 8, 8, "rwkv", 16, True, torch.float32),
    (1, 37, 1, 4, 4, "rwkv", 8, False, torch.float32),
    (2, 300, 4, 64, 64, "scalar", 256, True, torch.float32),
    (2, 300, 4, 64, 64, "scalar", 256, False, torch.bfloat16),
    (1, 130, 4, 64, 64, "rwkv", 64, True, torch.float32),
]


def _gla_inputs(case, device):
    B, S, H, K, V, mode, chunk, init, dt = case
    g = torch.Generator().manual_seed(S * H + K)

    def n(*shape):
        return torch.randn(*shape, generator=g)

    q, k, v = n(B, S, H, K), n(B, S, H, K), n(B, S, H, V)
    if mode == "scalar":
        # Mamba2: q and k shared by the heads (stride 0), scalar decay
        q, k = (x[:, :, :1].expand(B, S, H, K) for x in (q, k))
        ld, u = -0.7 * n(B, S, H).abs(), None
    else:
        ld = -3.0 * n(B, S, H, K).abs()
        u = n(H, K) if mode == "rwkv" else None
    h0 = n(B, H, K, V) if init else None
    to = dict(device=device)
    return (q.to(**to, dtype=dt), k.to(**to, dtype=dt), v.to(**to, dtype=dt),
            ld.to(**to), None if u is None else u.to(**to),
            None if h0 is None else h0.to(**to), mode == "rwkv", chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GLA_CASES)
def test_gla_kernel_matches_plain_on_card(cuda_device, case):
    q, k, v, ld, u, h0, strict, chunk = _gla_inputs(case, cuda_device)
    kw = dict(bonus=u, strict=strict, chunk=chunk, initial_state=h0)
    before = gla_kernel.gla_cuda.launches
    o, hT = gla_ops.gla(q, k, v, ld, **kw)
    assert gla_kernel.gla_cuda.launches == before + 1
    wo, whT = gla_ref.gla_chunked(q, k, v, ld, **kw)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and hT.dtype == torch.float32
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    assert (o.float() - wo.float()).abs().max().item() <= \
        tol * wo.float().abs().max().item()
    assert (hT - whT).abs().max().item() <= 1e-4 * whT.abs().max().item()


# the split-TF32 route, csrc/gla_scan.cu: float32, a scalar decay with the
# bonus or the strict mode, other widths
GLA_SCAN_CASES = [
    # B, S, H, K, V, decay, bonus, strict, initial state, decay scale,
    # dtype, misaligned
    (1, 1024, 4, 64, 64, "scalar", False, False, True, 0.7,
     torch.float32, False),                  # 16 tiles of state, Mamba2
    (2, 1024, 4, 64, 64, "vector", True, True, True, 3.0,
     torch.float32, False),                  # 16 tiles of state, RWKV6
    (2, 200, 3, 64, 64, "vector", True, True, True, 30.0,
     torch.float32, False),                  # log_decay <= -30 a step
    (2, 200, 3, 64, 64, "scalar", False, True, True, 30.0,
     torch.float32, False),
    (1, 1000, 2, 24, 40, "vector", True, True, True, 3.0,
     torch.float32, False),                  # odd widths, ragged
    (1, 1000, 2, 24, 40, "scalar", False, False, True, 0.7,
     torch.float32, False),
    (2, 1, 3, 64, 64, "vector", True, True, True, 3.0,
     torch.float32, False),                  # one token from a state
    (2, 1, 3, 64, 64, "scalar", False, False, True, 0.7,
     torch.float32, False),
    (1, 130, 3, 64, 32, "vector", True, False, True, 3.0,
     torch.float32, True),                   # element loads
    (1, 77, 2, 5, 3, "scalar", True, False, False, 0.7,
     torch.float32, False),
    (2, 300, 3, 64, 64, "scalar", True, True, True, 0.7,
     torch.bfloat16, False),                 # bf16, scalar, bonus + strict
    (2, 300, 3, 64, 64, "scalar", False, True, False, 0.7,
     torch.bfloat16, False),
    (2, 100, 3, 20, 36, "vector", True, True, True, 3.0,
     torch.bfloat16, False),                 # bf16 at other widths
]


def _scan_inputs(case, device):
    B, S, H, K, V, decay, bonus, strict, init, scale, dt, odd = case
    g = torch.Generator().manual_seed(S * H + 3 * K + V)

    def n(*shape):
        return torch.randn(*shape, generator=g)

    to = dict(device=device, dtype=dt)
    if decay == "scalar":   # Mamba2's B and C: stride 0 over the heads
        q, k = (n(B, S, 1, K).to(**to).expand(B, S, H, K) for _ in range(2))
        shape = (B, S, H)
    elif odd:               # q and k one element past a 16-byte boundary
        q, k = (n(B, S, H, K + 1).to(**to)[..., 1:] for _ in range(2))
        shape = (B, S, H, K)
    else:
        q, k = n(B, S, H, K).to(**to), n(B, S, H, K).to(**to)
        shape = (B, S, H, K)
    v = n(B, S, H, V).to(**to)
    ld = -scale * n(*shape).abs() if scale < 10 else \
        -(scale + n(*shape).abs())
    u = n(H, K).to(device) if bonus else None
    h0 = n(B, H, K, V).to(device) if init else None
    return q, k, v, ld.to(device), u, h0, strict


@pytest.mark.cuda
@pytest.mark.parametrize("case", GLA_SCAN_CASES)
def test_gla_scan_route_matches_plain_on_card(cuda_device, case):
    """Within 1e-4 of max|o| (plus one bf16 unit in the last place of a
    bf16 output) and 1e-4 of max|state| of the plain version."""
    q, k, v, ld, u, h0, strict = _scan_inputs(case, cuda_device)
    K, V = q.shape[-1], v.shape[-1]
    assert gla_kernel.route(q.dtype, K, V, vec=ld.dim() == 4,
                            bonus=u is not None, strict=strict) == "gla_scan"
    kw = dict(bonus=u, strict=strict, chunk=64, initial_state=h0)
    before = dict(gla_kernel.gla_cuda.routes)
    o, hT = gla_ops.gla(q, k, v, ld, **kw)
    assert {r: gla_kernel.gla_cuda.routes[r] - before[r] for r in before} \
        == {"gla_ssd": 0, "gla_vec": 0, "gla_scan": 1}
    wo, whT = gla_ref.gla_chunked(q, k, v, ld, **kw)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and hT.dtype == torch.float32
    assert torch.isfinite(o.float()).all() and torch.isfinite(hT).all()
    ulp = 2.0 ** -7 if q.dtype == torch.bfloat16 else 0.0
    err = (o.float() - wo.float()).abs()
    limit = 1e-4 * wo.float().abs().max() + ulp * wo.float().abs()
    assert (err <= limit).all(), err.max().item()
    assert (hT - whT).abs().max().item() <= 1e-4 * whT.abs().max().item()


@pytest.mark.cuda
def test_gla_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 2, 72, device=cuda_device)
    ld = torch.zeros(1, 8, 2, device=cuda_device)
    with pytest.raises(ValueError, match="K, V <= 64"):
        gla_kernel.gla_cuda(x, x, x, ld)
    y = torch.zeros(1, 8, 2, 16, device=cuda_device)
    with pytest.raises(ValueError, match="log_decay"):
        gla_kernel.gla_cuda(y, y, y, ld.double())


# the tensor-core route, csrc/gla_ssd.cu: bf16, scalar decay
GLA_SSD_CASES = [
    # B, S, H, K, V, q and k broadcast over H, initial state, decay scale
    (2, 1, 3, 64, 64, True, True, 0.7),
    (2, 15, 3, 64, 64, True, False, 0.7),
    (2, 17, 3, 64, 64, False, True, 0.7),
    (1, 64, 4, 64, 64, True, True, 0.7),
    (2, 65, 3, 32, 32, False, False, 0.7),
    (2, 1000, 3, 64, 64, True, True, 0.7),
    (1, 300, 2, 16, 16, True, True, 0.7),
    (1, 300, 2, 16, 64, False, True, 0.7),
    (1, 300, 2, 64, 16, True, False, 0.7),
    (1, 130, 5, 32, 64, True, True, 0.7),
    (1, 130, 5, 48, 48, False, True, 0.7),
    (2, 200, 3, 64, 64, True, True, 30.0),    # log_decay <= -30 a step
]


def _ssd_inputs(case, device):
    B, S, H, K, V, bcast, init, scale = case
    g = torch.Generator().manual_seed(S * H + K + V)

    def n(*shape):
        return torch.randn(*shape, generator=g)

    if bcast:   # Mamba2's B and C: stride 0 over the heads
        q, k = (n(B, S, 1, K).expand(B, S, H, K) for _ in range(2))
    else:
        q, k = n(B, S, H, K), n(B, S, H, K)
    v = n(B, S, H, V)
    ld = -scale * n(B, S, H).abs() if scale < 1 else \
        -(scale + n(B, S, H).abs())
    h0 = n(B, H, K, V) if init else None
    bf = dict(device=device, dtype=torch.bfloat16)
    return (q.to(**bf), k.to(**bf), v.to(**bf), ld.to(device),
            None if h0 is None else h0.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", GLA_SSD_CASES)
def test_gla_tensor_core_route_matches_plain_on_card(cuda_device, case):
    q, k, v, ld, h0 = _ssd_inputs(case, cuda_device)
    K, V = q.shape[-1], v.shape[-1]
    assert gla_kernel.route(q.dtype, K, V) == "gla_ssd"
    before = dict(gla_kernel.gla_cuda.routes)
    o, hT = gla_ops.gla(q, k, v, ld, chunk=256, initial_state=h0)
    assert {r: gla_kernel.gla_cuda.routes[r] - before[r] for r in before} \
        == {"gla_ssd": 1, "gla_vec": 0, "gla_scan": 0}
    wo, whT = gla_ref.gla_chunked(q, k, v, ld, chunk=256, initial_state=h0)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(hT).all()
    err = (o.float() - wo.float()).abs()
    limit = 1e-4 * wo.float().abs().max() + 2.0 ** -7 * wo.float().abs()
    assert (err <= limit).all(), err.max().item()
    assert (hT - whT).abs().max().item() <= 1e-4 * whT.abs().max().item()


# the per-channel-decay tensor-core route, csrc/gla_vec.cu: bf16, RWKV6
GLA_VEC_CASES = [
    # B, S, H, K, V, bonus, strict, initial state, decay scale, misaligned
    (2, 1, 3, 64, 64, True, True, True, 3.0, False),
    (2, 15, 3, 64, 64, True, True, False, 3.0, False),
    (2, 17, 3, 64, 64, False, False, True, 3.0, False),
    (1, 65, 4, 64, 64, True, False, True, 3.0, False),
    (2, 65, 3, 32, 32, False, True, False, 3.0, False),
    (2, 1000, 3, 64, 64, True, True, True, 3.0, False),
    (1, 1000, 2, 48, 32, False, False, True, 3.0, False),
    (1, 300, 2, 16, 16, True, True, True, 3.0, False),
    (1, 300, 2, 16, 64, False, False, True, 3.0, False),
    (1, 300, 2, 64, 16, True, True, False, 3.0, False),
    (1, 130, 5, 32, 64, True, False, True, 3.0, False),
    (1, 130, 5, 48, 48, True, True, True, 3.0, False),
    (2, 200, 3, 64, 64, True, True, True, 30.0, False),   # <= -30 a step
    (2, 200, 3, 64, 64, False, False, False, 30.0, False),
    (2, 90, 3, 64, 32, True, True, True, 3.0, True),      # element loads
]


def _vec_inputs(case, device):
    B, S, H, K, V, bonus, strict, init, scale, odd = case
    g = torch.Generator().manual_seed(S * H + K + 2 * V)

    def n(*shape):
        return torch.randn(*shape, generator=g)

    bf = dict(device=device, dtype=torch.bfloat16)
    if odd:     # q and k one element past a 16-byte boundary
        q, k = (n(B, S, H, K + 1).to(**bf)[..., 1:] for _ in range(2))
    else:
        q, k = n(B, S, H, K).to(**bf), n(B, S, H, K).to(**bf)
    v = n(B, S, H, V).to(**bf)
    ld = -scale * n(B, S, H, K).abs() if scale < 10 else \
        -(scale + n(B, S, H, K).abs())
    u = n(H, K).to(device) if bonus else None
    h0 = n(B, H, K, V).to(device) if init else None
    return q, k, v, ld.to(device), u, h0, strict


@pytest.mark.cuda
@pytest.mark.parametrize("case", GLA_VEC_CASES)
def test_gla_vec_route_matches_plain_on_card(cuda_device, case):
    q, k, v, ld, u, h0, strict = _vec_inputs(case, cuda_device)
    K, V = q.shape[-1], v.shape[-1]
    assert gla_kernel.route(q.dtype, K, V, vec=True, bonus=u is not None,
                            strict=strict) == "gla_vec"
    kw = dict(bonus=u, strict=strict, chunk=64, initial_state=h0)
    before = dict(gla_kernel.gla_cuda.routes)
    o, hT = gla_ops.gla(q, k, v, ld, **kw)
    assert {r: gla_kernel.gla_cuda.routes[r] - before[r] for r in before} \
        == {"gla_ssd": 0, "gla_vec": 1, "gla_scan": 0}
    wo, whT = gla_ref.gla_chunked(q, k, v, ld, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(hT).all()
    err = (o.float() - wo.float()).abs()
    limit = 1e-4 * wo.float().abs().max() + 2.0 ** -7 * wo.float().abs()
    assert (err <= limit).all(), err.max().item()
    assert (hT - whT).abs().max().item() <= 1e-4 * whT.abs().max().item()


@pytest.mark.cuda
def test_gla_cuda_tensors_never_take_the_plain_scan(cuda_device,
                                                    monkeypatch):
    """All three routes launch a kernel for CUDA tensors; the plain scan is
    not a fallback."""
    def plain(*args, **kw):
        raise AssertionError("a CUDA tensor reached ref.gla_chunked")

    monkeypatch.setattr(gla_ops._ref, "gla_chunked", plain)
    q, k, v, ld, h0 = _ssd_inputs((1, 70, 2, 64, 64, True, True, 0.7),
                                  cuda_device)
    before = dict(gla_kernel.gla_cuda.routes)
    gla_ops.gla(q, k, v, ld, chunk=256, initial_state=h0)
    gla_ops.gla(q.float(), k.float(), v.float(), ld, chunk=256,
                initial_state=h0)
    q, k, v, ld, u, h0, strict = _vec_inputs(
        (1, 70, 2, 64, 64, True, True, True, 3.0, False), cuda_device)
    gla_ops.gla(q, k, v, ld, bonus=u, strict=strict, initial_state=h0)
    torch.cuda.synchronize()
    assert {r: gla_kernel.gla_cuda.routes[r] - before[r]
            for r in before} == {"gla_ssd": 1, "gla_vec": 1, "gla_scan": 1}


# ------------------------------ gradients through kernels #4 and #5 (train)

def _grad_leaves(shapes, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(
        dtype).requires_grad_() for s in shapes]


def _grad_gaps(got, want):
    return [((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp(min=1e-30)).item()
            for a, b in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_attention_gradients_through_the_kernel_on_card(cuda_device, dtype):
    """``ops.attention`` on CUDA tensors that take gradients goes through
    ``FlashAttention``: one launch of the kernel, the kernel's output, and
    the gradients of the plain version (GQA, causal, softcap) within the
    kernel's tolerance of their largest |value|; under inference mode the
    kernel alone, with no graph."""
    q, k, v = _grad_leaves(((2, 80, 4, 64), (2, 80, 2, 64), (2, 80, 2, 64)),
                           dtype, 0)
    kw = dict(causal=True, softcap=30.0)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    before = fa_kernel.flash_attention_cuda.launches
    o = fa_ops.attention(q, k, v, **kw)
    assert fa_kernel.flash_attention_cuda.launches == before + 1
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(o.detach(), fa_kernel.flash_attention_cuda(
        q.detach(), k.detach(), v.detach(), **kw))
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(fa_ref.attention_chunked(q, k, v, **kw),
                               (q, k, v), do)
    assert max(_grad_gaps(got, want)) <= tol
    with torch.inference_mode():
        assert fa_ops.attention(q, k, v, **kw).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_gla_gradients_through_the_kernel_on_card(cuda_device, dtype):
    """``ops.gla`` on CUDA tensors that take gradients goes through
    ``GLAScan`` (Mamba2's mode: q and k broadcast over the heads, a scalar
    decay, an initial state): one launch, the kernel's outputs, and the
    plain version's gradients to every input within 1e-4 (float32) or 2e-2
    (bf16) of their largest |value|."""
    B, S, H_, K, V = 2, 70, 4, 16, 16
    c, b, v = _grad_leaves(((B, S, 1, K), (B, S, 1, K), (B, S, H_, V)),
                           dtype, 1)
    raw, h0 = _grad_leaves(((B, S, H_), (B, H_, K, V)), torch.float32, 2)

    def inputs():
        return (c.expand(B, S, H_, K), b.expand(B, S, H_, K), v,
                -0.5 * raw.abs())

    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = gla_kernel.gla_cuda.launches
    o, hT = gla_ops.gla(*inputs(), chunk=32, initial_state=h0)
    assert gla_kernel.gla_cuda.launches == before + 1
    assert type(o.grad_fn).__name__ == "GLAScanBackward"
    w = torch.randn(o.shape, device="cuda")
    leaves = (c, b, v, raw, h0)
    got = torch.autograd.grad((o.float() * w).sum() + hT.square().sum(),
                              leaves)
    o2, h2 = gla_ref.gla_chunked(*inputs(), chunk=32, initial_state=h0)
    want = torch.autograd.grad((o2.float() * w).sum() + h2.square().sum(),
                               leaves)
    assert max(_grad_gaps(got, want)) <= tol


@pytest.mark.cuda
def test_gla_rwkv6_gradients_through_the_kernel_on_card(cuda_device):
    """RWKV6's mode (per-channel decay, bonus, strict, an initial state) in
    bf16 through ``GLAScan``: one launch on ``gla_vec``, outputs within the
    route's limits of the plain version, and, from the output's gradient,
    the plain version's gradients to every input bit for bit (the backward
    recomputes the plain version on the same inputs)."""
    B, S, H_, K = 2, 70, 4, 32
    r, k, v = _grad_leaves(((B, S, H_, K),) * 3, torch.bfloat16, 3)
    raw, u, h0 = _grad_leaves(((B, S, H_, K), (H_, K), (B, H_, K, K)),
                              torch.float32, 4)

    def inputs():
        return r, k, v, -torch.exp(0.5 * raw)

    kw = dict(bonus=u, strict=True, chunk=64, initial_state=h0)
    before = dict(gla_kernel.gla_cuda.routes)
    o, hT = gla_ops.gla(*inputs(), **kw)
    assert {n: gla_kernel.gla_cuda.routes[n] - before[n] for n in before} \
        == {"gla_ssd": 0, "gla_vec": 1, "gla_scan": 0}
    assert type(o.grad_fn).__name__ == "GLAScanBackward"
    o2, h2 = gla_ref.gla_chunked(*inputs(), **kw)
    limit = 1e-4 * o2.float().abs().max() + 2.0 ** -7 * o2.float().abs()
    assert ((o.float() - o2.float()).abs() <= limit).all()
    assert (hT - h2).abs().max() <= 1e-4 * h2.abs().max()
    w = torch.randn(o.shape, device="cuda")
    leaves = (r, k, v, raw, u, h0)
    got = torch.autograd.grad((o.float() * w).sum(), leaves)
    want = torch.autograd.grad((o2.float() * w).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
