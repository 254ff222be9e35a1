"""The GLA scan (kernel #5's plain version and dispatcher) against the JAX
package: ``gla_chunked``, ``gla_naive`` and ``gla_step``, and its Pallas
kernel in interpret mode, over the cases of ``tests/test_kernels_gla.py``
(scalar, per-channel and RWKV6 bonus + strict decay, a ragged length,
several chunk sizes), output and final state, plus an initial state. The
CUDA kernels themselves are held against the plain version on the card by
``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py``; here, which of
them ``kernel.route`` picks for ``chip_smoke.py``'s cases, the work counts
behind the bound, and the sub-block factorisation that ``csrc/gla_vec.cu``
computes, emulated in float32.

Tolerance: 1e-5 of the largest value (output, or state), in float32:
both sides run the same float32 arithmetic, summed in another order.
Inputs come from numpy with a seed.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.linear_scan import kernel as jkernel
from repro.kernels.linear_scan import ref as jref
from repro_torch.kernels.linear_scan import kernel, ops, ref

RTOL = 1e-5
CASES = [
    # B, S, H, K, V, mode, chunk
    (2, 64, 2, 16, 8, "scalar", 16),
    (1, 96, 3, 8, 16, "vector", 32),
    (2, 64, 2, 8, 8, "rwkv", 16),
    (1, 37, 1, 4, 4, "rwkv", 8),        # ragged length
    (2, 128, 2, 32, 16, "scalar", 64),
]


def _inputs(case, seed, initial=False):
    """(jax arrays, torch tensors, strict) of a case:
    q, k, v, log_decay, bonus, initial state."""
    B, S, H, K, V, mode, _ = case
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = n(B, S, H, K), n(B, S, H, K), n(B, S, H, V)
    if mode == "scalar":
        ld, u = -np.abs(n(B, S, H)) * 0.7, None
    else:
        ld = -np.abs(n(B, S, H, K)) * 3.0
        u = n(H, K) if mode == "rwkv" else None
    h0 = n(B, H, K, V) if initial else None
    arrs = (q, k, v, ld, u, h0)
    return ([None if a is None else jnp.asarray(a) for a in arrs],
            [None if a is None else torch.tensor(a) for a in arrs],
            mode == "rwkv")


def _close(j, t, what):
    j = np.asarray(j)
    gap = np.abs(j - t.numpy()).max()
    assert gap <= RTOL * np.abs(j).max(), (what, gap, np.abs(j).max())


@pytest.mark.parametrize("initial", (False, True))
@pytest.mark.parametrize("case", CASES)
def test_chunked_matches_reference(case, initial):
    (jq, jk, jv, jld, ju, jh), (q, k, v, ld, u, h0), strict = _inputs(
        case, 0, initial)
    kw = dict(strict=strict, chunk=case[-1])
    o, hT = ref.gla_chunked(q, k, v, ld, bonus=u, initial_state=h0, **kw)
    jo, jhT = jref.gla_chunked(jq, jk, jv, jld, bonus=ju, initial_state=jh,
                               **kw)
    _close(jo, o, "o")
    _close(jhT, hT, "state")


@pytest.mark.parametrize("case", CASES)
def test_naive_matches_reference_and_interpret_kernel(case):
    """The sequential oracle, and the chunked version against the Pallas
    kernel (interpret mode, which takes no initial state)."""
    (jq, jk, jv, jld, ju, _), (q, k, v, ld, u, _), strict = _inputs(case, 1)
    o, hT = ref.gla_naive(q, k, v, ld, bonus=u, strict=strict)
    jo, jhT = jref.gla_naive(jq, jk, jv, jld, bonus=ju, strict=strict)
    _close(jo, o, "naive o")
    _close(jhT, hT, "naive state")
    po, phT = jkernel.gla_pallas(jq, jk, jv, jld, bonus=ju, strict=strict,
                                 chunk=case[-1], interpret=True)
    co, chT = ref.gla_chunked(q, k, v, ld, bonus=u, strict=strict,
                              chunk=case[-1])
    _close(po, co, "pallas o")
    _close(phT, chT, "pallas state")


@pytest.mark.parametrize("mode", ("scalar", "rwkv"))
def test_initial_state_carries_a_split_sequence(mode):
    """Scanning the second half from the first half's final state is the
    scan of the whole: what prefill followed by a later prefill needs."""
    case = (2, 80, 2, 8, 8, mode, 16)
    _, (q, k, v, ld, u, _), strict = _inputs(case, 2)
    kw = dict(bonus=u, strict=strict, chunk=16)
    o, hT = ref.gla_chunked(q, k, v, ld, **kw)
    o1, h1 = ref.gla_chunked(q[:, :30], k[:, :30], v[:, :30], ld[:, :30],
                             **kw)
    o2, h2 = ref.gla_chunked(q[:, 30:], k[:, 30:], v[:, 30:], ld[:, 30:],
                             initial_state=h1, **kw)
    assert (torch.cat([o1, o2], 1) - o).abs().max() <= RTOL * o.abs().max()
    assert (h2 - hT).abs().max() <= RTOL * hT.abs().max()


def test_chunk_size_invariance():
    case = (2, 96, 2, 8, 8, "rwkv", 8)
    _, (q, k, v, ld, u, _), strict = _inputs(case, 3)
    outs = [ref.gla_chunked(q, k, v, ld, bonus=u, strict=strict, chunk=c)[0]
            for c in (8, 16, 32, 96)]
    for o in outs[1:]:
        assert (o - outs[0]).abs().max() <= 2e-4


@pytest.mark.parametrize("mode", ("scalar", "rwkv"))
def test_step_matches_reference_step_and_sequence(mode):
    """``gla_step`` over a sequence, from an initial state, against the
    JAX package's step and the port's own sequential scan."""
    case = (1, 16, 2, 8, 8, mode, 8)
    (jq, jk, jv, jld, ju, jh), (q, k, v, ld, u, h), strict = _inputs(
        case, 4, initial=True)
    want, _ = ref.gla_naive(q, k, v, ld, bonus=u, strict=strict,
                            initial_state=h)
    jst = jh
    for t in range(q.shape[1]):
        o, h = ops.gla_step(q[:, t], k[:, t], v[:, t], ld[:, t], h, bonus=u,
                            strict=strict)
        jo, jst = jref.gla_step(jq[:, t], jk[:, t], jv[:, t], jld[:, t], jst,
                                bonus=ju, strict=strict)
        _close(jo, o, f"step {t}")
        _close(jst, h, f"state {t}")
        assert (o - want[:, t]).abs().max() <= 1e-5 * want.abs().max()


def test_cpu_tensors_take_the_plain_route():
    """A CPU tensor never reaches the kernel (the launch counter stays
    where it was, 0 without a card); broadcast q and k (Mamba2's B and C,
    stride 0 over the heads) go in as they are."""
    case = (2, 40, 3, 8, 4, "scalar", 16)
    _, (q, k, v, ld, _, h0), _ = _inputs(case, 5, initial=True)
    q, k = (x[:, :, :1].expand(2, 40, 3, 8) for x in (q, k))
    before = kernel.gla_cuda.launches
    o, hT = ops.gla(q, k, v, ld, chunk=16, initial_state=h0)
    assert kernel.gla_cuda.launches == before
    wo, whT = ref.gla_chunked(q.contiguous(), k.contiguous(), v, ld,
                              chunk=16, initial_state=h0)
    assert torch.equal(o, wo) and torch.equal(hT, whT)
    with pytest.raises(ValueError, match="no gla route"):
        ops.gla(q.to("meta"), k.to("meta"), v.to("meta"), ld.to("meta"))


def test_work_counts():
    """The scan's byte count reads a broadcast operand once; its pair
    count follows the tiles (strict drops the diagonal)."""
    case = (2, 100, 4, 16, 8, "scalar", 256)
    _, (q, k, v, ld, _, _), _ = _inputs(case, 6)
    qb = q[:, :, :1].expand(2, 100, 4, 16)
    full = kernel.gla_bytes(q, k, v, ld)
    bcast = kernel.gla_bytes(qb, qb, v, ld)
    assert full - bcast == 2 * 4 * (2 * 100 * 4 * 16 - 2 * 100 * 16)
    assert kernel.tile_rows(256) == 64 and kernel.tile_rows(16) == 16
    B, S, H, K, V = 2, 100, 4, 16, 8
    incl = kernel.gla_flops(B, S, H, K, V, chunk=256)
    strict = kernel.gla_flops(B, S, H, K, V, chunk=256, strict=True)
    # tiles of 64 and 36 rows: the diagonal is 100 pairs of 2 K + 2 V
    assert incl - strict == B * H * 100 * (2 * K + 2 * V)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_route_of_each_chip_smoke_case():
    """Mamba2's bf16 scans take the scalar-decay tensor-core source, RWKV6's
    bf16 scans (per-channel decay, with or without the bonus and the strict
    mode) the per-channel one; float32, a bf16 scalar decay with the bonus
    or the strict mode, and K or V outside ``SSD_DIMS`` the split-TF32 one
    (its own cases among them)."""
    want = {"zamba2 mamba2 prefill": "gla_ssd", "zamba2 ragged": "gla_ssd",
            "zamba2 from a state": "gla_ssd",
            "zamba2 one token from a state": "gla_ssd",
            "zamba2 float32": "gla_scan", "rwkv6 vector decay": "gla_vec",
            "rwkv6 bonus + strict": "gla_vec",
            "rwkv6 strong decay": "gla_vec", "rwkv6 ragged": "gla_vec",
            "rwkv6-7b serving prefill": "gla_vec",
            "rwkv6 float32": "gla_scan",
            "rwkv6 float32 strong decay": "gla_scan",
            "float32 odd widths": "gla_scan",
            "zamba2 bf16 bonus + strict": "gla_scan",
            "zamba2 float32 one token": "gla_scan"}
    cs = _chip_smoke()
    got = {}
    for label, B, S, H, K, V, dt, mode, chunk, init in cs.gla_cases():
        vec, bonus, strict = cs.gla_mode(mode)
        got[label] = kernel.route(dt, K, V, vec=vec, bonus=bonus,
                                  strict=strict)
    assert got == want
    assert kernel.route(torch.bfloat16, 64, 64) == "gla_ssd"
    for K, V in ((8, 64), (64, 40), (72, 64)):
        assert kernel.route(torch.bfloat16, K, V) == "gla_scan"
        assert kernel.route(torch.bfloat16, K, V, vec=True, bonus=True,
                            strict=True) == "gla_scan"
    assert kernel.route(torch.float32, 64, 64, vec=True) == "gla_scan"
    assert kernel.route(torch.bfloat16, 64, 64, strict=True) == "gla_scan"
    assert set(kernel.gla_cuda.routes) == set(kernel.SOURCES)


def _subblock_scan(q, k, v, ld, u, strict, h0):
    """``csrc/gla_vec.cu``'s arithmetic in float32: 64-row tiles in 16-row
    sub-blocks; the pairs of sub-blocks (i, j < i) as products of q_i o
    exp(cum_q - b_j) and k_j o exp(b_j - cum), b_j the cumulative decay at
    the last row of sub-block j (both factors <= 1); the diagonal
    sub-blocks pairwise, with the bonus (or, inclusive, 1 + bonus) on A's
    diagonal; the state passed at tile boundaries."""
    T, SB = 64, 16
    B, S, H, K = q.shape
    pad = (-S) % T

    def padded(x):
        return F.pad(x, [0, 0] * (x.dim() - 2) + [0, pad])

    q, k, v, ld = (padded(x) for x in (q, k, v, ld))
    h = h0.clone() if h0 is not None else torch.zeros(B, H, K, v.shape[-1])
    eye = torch.eye(SB, dtype=torch.bool)
    lower = torch.tril(torch.ones(SB, SB, dtype=torch.bool), -1)
    dk = (0.0 if strict else 1.0) + (u if u is not None else 0.0)
    outs = []
    for t0 in range(0, S + pad, T):
        qc, kc, vc = (x[:, t0:t0 + T] for x in (q, k, v))
        cum = torch.cumsum(ld[:, t0:t0 + T], 1)               # (B, T, H, K)
        cq = F.pad(cum, [0, 0, 0, 0, 1, 0])[:, :-1] if strict else cum
        assert (cq <= 0).all()
        A = torch.zeros(B, H, T, T)
        for i in range(T // SB):
            ti = slice(SB * i, SB * i + SB)
            for j in range(i):
                sj = slice(SB * j, SB * j + SB)
                bj = cum[:, SB * j + SB - 1][:, None]
                fq, fk = torch.exp(cq[:, ti] - bj), torch.exp(bj - cum[:, sj])
                assert fq.max() <= 1 and fk.max() <= 1
                A[:, :, ti, sj] = torch.einsum("bthk,bshk->bhts",
                                               qc[:, ti] * fq, kc[:, sj] * fk)
            d = cq[:, ti, None] - cum[:, None, ti]            # (B, t, s, H, K)
            e = torch.exp(torch.where(lower[None, :, :, None, None], d,
                                      -torch.inf))
            diag = torch.einsum("bthk,bthk,hk->bht", qc[:, ti], kc[:, ti],
                                dk * torch.ones(H, K))
            A[:, :, ti, ti] = torch.einsum("bthk,bshk,btshk->bhts", qc[:, ti],
                                           kc[:, ti], e) \
                + torch.where(eye, diag[..., None], 0.0)
        o = torch.einsum("bthk,bhkv->bthv", qc * torch.exp(cq), h) \
            + torch.einsum("bhts,bshv->bthv", A, vc)
        cl = cum[:, -1]
        h = torch.exp(cl)[..., None] * h + torch.einsum(
            "bthk,bthv->bhkv", kc * torch.exp(cl[:, None] - cum), vc)
        outs.append(o)
    return torch.cat(outs, 1)[:, :S], h


@pytest.mark.parametrize("scale", (3.0, 30.0))
@pytest.mark.parametrize("strict", (True, False))
def test_subblock_factorisation_matches_reference(strict, scale):
    """The emulation against the JAX package, strict with the bonus and
    inclusive without, from a state, over a ragged 150 rows, within 1e-5
    of max|o| and of max|state|, finite where factoring through the tile
    start (exp(-cum)) overflows. At ``chip_smoke.py``'s log decays,
    -3|N(0, 1)| a step, against ``gla_chunked`` (chunk 64); at decays
    down to -30 a step against the sequential ``gla_naive``: there a
    tile's cumulative decay reaches ~1e3 nats, whose float32 rounding
    puts the chunked forms themselves up to ~1e-5 of max|o| from a
    float64 scan (JAX's 9e-6, this emulation's and the port's 4e-6)."""
    B, S, H, K, V = 2, 150, 2, 16, 8
    rng = np.random.default_rng(int(scale) + 7 * strict)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v, h0 = n(B, S, H, K), n(B, S, H, K), n(B, S, H, V), n(B, H, K, V)
    ld = (-3.0 * np.abs(n(B, S, H, K)) if scale < 10 else
          -30.0 * rng.random((B, S, H, K)).astype(np.float32))
    u = n(H, K) if strict else None
    t = [torch.tensor(x) for x in (q, k, v, ld)]
    tu = None if u is None else torch.tensor(u)
    assert torch.isinf(torch.exp(-torch.cumsum(t[3][:, :64], 1))).any()
    o, hT = _subblock_scan(*t, tu, strict, torch.tensor(h0))
    assert torch.isfinite(o).all() and torch.isfinite(hT).all()
    args = [jnp.asarray(x) for x in (q, k, v, ld)]
    kw = dict(bonus=None if u is None else jnp.asarray(u), strict=strict,
              initial_state=jnp.asarray(h0))
    jo, jhT = (jref.gla_chunked(*args, chunk=64, **kw) if scale < 10
               else jref.gla_naive(*args, **kw))
    _close(jo, o, "o")
    _close(jhT, hT, "state")


def test_work_counts_at_zamba2_prefill_unchanged():
    """The bound measures the reference's work, whichever source runs:
    Zamba2-7B's Mamba2 prefill (4 x 1,024 tokens, 112 heads of 64, state
    64, chunk 256, B and C broadcast over the heads) needs 11,333,009,408
    operations and 127,664,128 bytes, 0.0381 ms at 3.35 TB/s."""
    B, S, H, K, V = 4, 1024, 112, 64, 64
    assert kernel.gla_flops(B, S, H, K, V, chunk=256) == 11_333_009_408

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    q = meta(B, S, 1, K).expand(B, S, H, K)
    nbytes = kernel.gla_bytes(q, q, meta(B, S, H, V),
                              meta(B, S, H, dtype=torch.float32))
    assert nbytes == 127_664_128
    assert round(1e3 * nbytes / 3.35e12, 4) == 0.0381
