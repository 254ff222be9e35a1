"""A numeric model, in plain torch, of the arithmetic of kernel #5's split-TF32
route (``kernels/linear_scan/csrc/gla_scan.cu``), held against the JAX
package's ``repro.kernels.linear_scan.ref.gla_chunked``.

The model does what the kernel does, a tile of 64 rows at a time:

* the decay's cumulative sum in log2 units as the kernel sums it: per
  channel, rows 0-31 and 32-63 each by a chain of FMAs, the second half
  then adding the first's total (a per-channel decay); a warp's scan over
  pairs of rows (a scalar decay);
* every operand x of a product is split as hi = x rounded to TF32 (10
  mantissa bits, to nearest with ties away from zero) and lo = x - hi, which
  the tensor core reads truncated to TF32; each 8-deep step is three
  tensor-core products (``mma``), lo.hi, hi.lo, hi.hi;
* an ``mma``'s float32 sum truncates: the model forms its 8 products and
  its accumulator exactly (in float64) and rounds the sum toward zero to
  float32;
* the scores: a scalar decay's S = Q K^T in three accumulators (one per
  product kind) summed (lo.hi + hi.lo) + hi.hi, then A = S 2^{cum_q - cum}
  and the bonus on the diagonal; a per-channel decay's 16-row sub-blocks,
  the pairs i > j factored through the last row of sub-block j, each
  diagonal sub-block's quadrant rows 8-15 x columns 0-7 through its row 7,
  and its two 8-row triangles exactly and pairwise (summed in float64 and
  rounded once: the kernel's sum over lanes rounds more often);
* a tile's output (q o e^{cum_q}) H + A V summed from zero in one
  accumulator, the products in turn; the tile's state contribution V^T (k
  o e^{cl - cum}) summed from zero, then H = H e^{cl} + it by one rounded
  FMA.

Exponentials are ``torch.exp2`` in float32 (the kernel's ``ex2.approx``
differs by a few units in the last place). The kernel itself runs on the
card (``tests/test_torch_kernel_cuda.py``); here the point is the
arithmetic: the split keeps the route's limits (1e-4 of max|o| and 1e-4 of
max|state|), one TF32 product does not, and a state carried in the
accumulators (``state_sums="carried"``: H e^{cl} rounded, then every
product of the tile truncated into it) drifts further from the exact state
than the per-tile sums. Inputs come from numpy with a seed.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.linear_scan import ref as jref
from repro_torch.kernels.linear_scan import kernel

torch.set_num_threads(1)

TOL = 1e-4                       # of max|o| and of max|state|
T = 64                           # rows of a tile
SB = 16                          # rows of a sub-block
LOG2E = float(torch.tensor(1.4426950408889634, dtype=torch.float32))


def tf32_rna(x):
    """x rounded to TF32 (low 13 bits cleared), to nearest, ties away from
    zero: half a unit added to the magnitude's bits, then truncated."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """x as the tensor core reads a float32 operand: its low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def trunc_f32(x):
    """float64 x rounded toward zero to float32."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma(c, a, b):
    """One tensor-core product a (..., M, 8) b (..., 8, N) + c: exact
    products and sum, truncated to float32; c None adds nothing."""
    d = a.double() @ b.double()
    return trunc_f32(d if c is None else d + c.double())


def products(a, b, three=True):
    """The operand pairs of one 8-deep step in the kernel's order: lo.hi,
    hi.lo, hi.hi; with ``three`` False hi.hi alone (one TF32 product)."""
    ah = tf32_rna(a)
    bh = tf32_rna(b)
    if not three:
        return [(ah, bh)]
    return [(tf32_trunc(a - ah), bh), (ah, tf32_trunc(b - bh)), (ah, bh)]


def summed(a, b, depth, three, c=None):
    """a (..., M, depth) b (..., depth, N) in 8-deep steps, every product
    into one accumulator in turn (from c, or from zero)."""
    for s in range(0, depth, 8):
        for x, y in products(a[..., s:s + 8], b[..., s:s + 8, :], three):
            c = mma(c, x, y)
    return c


def apart(a, b, depth, three):
    """The same with each product kind in an accumulator of its own,
    summed (lo.hi + hi.lo) + hi.hi."""
    acc = [None] * (3 if three else 1)
    for s in range(0, depth, 8):
        acc = [mma(c, x, y) for c, (x, y) in zip(
            acc, products(a[..., s:s + 8], b[..., s:s + 8, :], three))]
    return acc[0] if len(acc) == 1 else (acc[0] + acc[1]) + acc[2]


def cum_vec(d):
    """(..., T, Kp) decays -> the kernel's cumulative sum in log2 units."""
    halves = []
    for h0 in (0, T // 2):
        run, rows = torch.zeros_like(d[..., 0, :]).double(), []
        for r in range(T // 2):
            run = (d[..., h0 + r, :].double() * LOG2E + run).float().double()
            rows.append(run)
        halves.append(torch.stack(rows, -2).float())
    return torch.cat([halves[0], halves[1] + halves[0][..., -1:, :]], -2)


def cum_scalar(d):
    """(..., T) decays -> the kernel's warp scan in log2 units: two rows a
    lane, a Hillis-Steele scan over the lanes' pair sums."""
    d = d * LOG2E
    d0, d1 = d[..., 0::2], d[..., 1::2]
    inc = d0 + d1
    for off in (1, 2, 4, 8, 16):
        inc = inc + F.pad(inc, (off, 0))[..., :T // 2]
    ce = F.pad(inc, (1, 0))[..., :T // 2] + d0
    return torch.stack([ce, ce + d1], -1).reshape(d.shape)


def scores_vec(q, k, cq, cum, dk, three):
    """A of one tile with a per-channel decay: q, k, cq, cum (B, H, T, Kp)
    float32, dk (H, Kp) the diagonal's weight (1 inclusive, 0 strict, plus
    the bonus)."""
    Kp = q.shape[-1]
    A = torch.zeros(q.shape[:-1] + (T,))
    # the diagonal sub-blocks' two 8-row triangles, exact and pairwise
    t, s = torch.arange(T)[:, None], torch.arange(T)[None, :]
    tri = (t // 8 == s // 8) & (s <= t)
    e = torch.exp2(cq[..., :, None, :] - cum[..., None, :, :])
    w = torch.where((s == t)[..., None], dk[None, :, None, None, :], e)
    pair = ((q[..., :, None, :] * k[..., None, :, :]) * w).double().sum(-1)
    A = torch.where(tri, pair.float(), A)
    for i in range(T // SB):
        # rows 8-15 x columns 0-7 through the sub-block's row 7
        r0 = SB * i
        b = cum[..., r0 + 7:r0 + 8, :]
        qf = q[..., r0 + 8:r0 + SB, :] * torch.exp2(cq[..., r0 + 8:r0 + SB,
                                                       :] - b)
        kf = k[..., r0:r0 + 8, :] * torch.exp2(b - cum[..., r0:r0 + 8, :])
        A[..., r0 + 8:r0 + SB, r0:r0 + 8] = apart(qf, kf.transpose(-1, -2),
                                                  Kp, three)
        for j in range(i):
            # the pair (i, j) through the last row of key sub-block j
            b = cum[..., SB * j + SB - 1:SB * j + SB, :]
            qf = q[..., r0:r0 + SB, :] * torch.exp2(cq[..., r0:r0 + SB, :] - b)
            kf = k[..., SB * j:SB * j + SB, :] * torch.exp2(
                b - cum[..., SB * j:SB * j + SB, :])
            A[..., r0:r0 + SB, SB * j:SB * j + SB] = apart(
                qf, kf.transpose(-1, -2), Kp, three)
    return A


def kernel_model(q, k, v, ld, *, bonus=None, strict=False,
                 initial_state=None, three=True, state_sums="tile"):
    """The route's (o, final state) for float32 q, k (B, S, H, K), v (B,
    S, H, V), log decay (B, S, H) or (B, S, H, K). ``state_sums="carried"``
    carries the state in the accumulators instead of a tile's sum from
    zero."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    vec = ld.dim() == 4
    Kp, nt = -(-K // 8) * 8, -(-S // T)
    pad = nt * T - S

    def lay(x, cols):   # (B, S, H, C) -> (B, H, S + pad, cols), zeros
        x = x.float().permute(0, 2, 1, 3)
        return F.pad(x, (0, cols - x.shape[-1], 0, pad))

    Q, Kt, Vt = lay(q, Kp), lay(k, Kp), lay(v, V)
    L = lay(ld, Kp) if vec else F.pad(ld.float().permute(0, 2, 1), (0, pad))
    U = torch.zeros(H, Kp)
    if bonus is not None:
        U[:, :K] = bonus.float()
    Hs = torch.zeros(B, H, Kp, V)
    if initial_state is not None:
        Hs[:, :, :K] = initial_state.float()
    outs = []
    for j in range(nt):
        rows = slice(j * T, (j + 1) * T)
        q_, k_, v_ = Q[:, :, rows], Kt[:, :, rows], Vt[:, :, rows]
        cum = cum_vec(L[:, :, rows]) if vec else cum_scalar(L[:, :, rows])
        cq = F.pad(cum, (0, 0, 1, 0) if vec else (1, 0))[
            :, :, :T] if strict else cum
        cl = cum[:, :, -1:]
        if vec:
            QE, KW = q_ * torch.exp2(cq), k_ * torch.exp2(cl - cum)
            ecl = torch.exp2(cl[:, :, 0])
            dk = (0.0 if strict else 1.0) + U
            A = scores_vec(q_, k_, cq, cum, dk, three)
        else:
            QE = q_ * torch.exp2(cq)[..., None]
            KW = k_ * torch.exp2(cl - cum)[..., None]
            ecl = torch.exp2(cl).expand(B, H, Kp)
            Sm = apart(q_, k_.transpose(-1, -2), Kp, three)
            t, s = torch.arange(T)[:, None], torch.arange(T)[None, :]
            dec = torch.exp2(cq[..., :, None] - cum[..., None, :])
            cf = ((q_ * U[None, :, None, :]).double()
                  * k_.double()).sum(-1).float()
            diag = (torch.zeros_like(Sm) if strict else Sm) + cf[..., None]
            A = torch.where(s < t, Sm * dec,
                            torch.where(s == t, diag, torch.zeros_like(Sm)))
        o = summed(QE, Hs, Kp, three)
        o = summed(A, v_, T, three, o)
        outs.append(o)
        if state_sums == "tile":
            dh = summed(v_.transpose(-1, -2), KW, T, three)
            Hs = (Hs.double() * ecl[..., None].double()
                  + dh.transpose(-1, -2).double()).float()
        else:
            hT = (Hs * ecl[..., None]).transpose(-1, -2)
            Hs = summed(v_.transpose(-1, -2), KW, T, three,
                        hT).transpose(-1, -2)
    o = torch.cat(outs, 2)[:, :, :S].permute(0, 2, 1, 3)
    return o, Hs[:, :, :K]


def _inputs(B, S, H, K, V, decay, bonus, init, seed, scale=None):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    shape = (B, S, H) if decay == "scalar" else (B, S, H, K)
    if scale is None:
        scale = 0.7 if decay == "scalar" else 3.0
    ld = -scale * np.abs(n(*shape)) if scale < 10 else \
        -(scale + np.abs(n(*shape)))
    return (n(B, S, H, K), n(B, S, H, K), n(B, S, H, V), ld,
            n(H, K) if bonus else None, n(B, H, K, V) if init else None)


def _gaps(arrs, strict, three=True):
    """max|model - JAX| over max|JAX| for the output and the state."""
    t = [None if a is None else torch.tensor(a) for a in arrs]
    q, k, v, ld, u, h0 = t
    o, hT = kernel_model(q, k, v, ld, bonus=u, strict=strict,
                         initial_state=h0, three=three)
    jo, jh = (np.asarray(x) for x in jref.gla_chunked(
        *(None if a is None else jnp.asarray(a) for a in arrs[:4]),
        bonus=None if arrs[4] is None else jnp.asarray(arrs[4]),
        strict=strict, chunk=T,
        initial_state=None if arrs[5] is None else jnp.asarray(arrs[5])))
    assert o.shape == jo.shape and hT.shape == jh.shape
    assert torch.isfinite(o).all() and torch.isfinite(hT).all()
    return (float(np.abs(o.numpy() - jo).max() / np.abs(jo).max()),
            float(np.abs(hT.numpy() - jh).max() / np.abs(jh).max()))


def test_model_tile_follows_the_source():
    """The model's tile and sub-block are the source's."""
    src = kernel.SOURCES["gla_scan"].read_text()
    assert int(re.search(r"constexpr int T = (\d+);", src).group(1)) == T
    assert int(re.search(r"constexpr int SB = (\d+);", src).group(1)) == SB
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src


CASES = {
    # B, S, H, K, V, decay, bonus, strict, initial state[, decay scale]
    "scalar, from a state": (1, 200, 2, 16, 16, "scalar", False, False,
                             True),
    "scalar, bonus + strict": (1, 130, 2, 16, 16, "scalar", True, True,
                               True),
    "per-channel": (1, 150, 2, 16, 8, "vector", False, False, False),
    "per-channel, bonus + strict, from a state": (
        2, 100, 1, 16, 16, "vector", True, True, True),
    "strong decay (-30 a step and below)": (
        1, 130, 2, 16, 16, "vector", True, True, True, 30.0),
    "odd widths (K = 5, V = 3)": (1, 77, 2, 5, 3, "vector", True, True,
                                  True),
    "16 tiles of state (S = 1,024)": (1, 1024, 1, 16, 8, "scalar", False,
                                      False, True),
    "1,000 ragged tokens": (1, 1000, 1, 8, 8, "vector", True, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_tf32_model_matches_jax_reference(case):
    B, S, H, K, V, decay, bonus, strict, init, *scale = CASES[case]
    arrs = _inputs(B, S, H, K, V, decay, bonus, init, len(case),
                   *(scale or [None]))
    gap_o, gap_s = _gaps(arrs, strict)
    print(f"split TF32 model vs JAX, {case}: o {gap_o:.3e}, state "
          f"{gap_s:.3e} of their max")
    assert gap_o < TOL and gap_s < TOL


def test_one_tf32_product_misses_the_limit():
    """Why the split is there: hi.hi alone is ~4e-4 of max|o| off."""
    arrs = _inputs(1, 130, 2, 16, 16, "vector", True, True, 7)
    one, three = _gaps(arrs, True, three=False), _gaps(arrs, True)
    print(f"one TF32 product: o {one[0]:.3e}, state {one[1]:.3e}; split: "
          f"o {three[0]:.3e}, state {three[1]:.3e}")
    assert max(one) > TOL and max(three) < TOL


def test_per_tile_state_sums_bound_the_truncation():
    """Why a tile's state contribution is summed from zero and merged by an
    FMA: carried in the accumulators over 16 tiles of a slow decay, every
    product's truncation pulls the state toward zero, further from the
    exact (float64) state than the per-tile sums (~12x, with ~10x the
    signed bias toward zero)."""
    q, k, v, ld, h0 = (torch.tensor(a) for a in _inputs(
        1, 1024, 2, 16, 16, "scalar", False, True, 3, 0.002)
        if a is not None)
    hd = h0.double()
    for t in range(q.shape[1]):   # the exact recurrence
        hd = torch.exp(ld[:, t].double())[..., None, None] * hd + \
            k[:, t].double()[..., :, None] * v[:, t].double()[..., None, :]
    gap, bias = {}, {}
    for mode in ("tile", "carried"):
        _, hT = kernel_model(q, k, v, ld, initial_state=h0,
                             state_sums=mode)
        d = hT.double() - hd
        gap[mode] = (d.abs().max() / hd.abs().max()).item()
        bias[mode] = ((d * hd.sign()).mean() / hd.abs().mean()).item()
    print(f"state per tile {gap['tile']:.3e} (bias {bias['tile']:.3e}), "
          f"carried {gap['carried']:.3e} (bias {bias['carried']:.3e})")
    assert gap["carried"] > 5 * gap["tile"] and gap["tile"] < TOL
    assert bias["carried"] < 5 * bias["tile"] < 0
