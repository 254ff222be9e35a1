"""MLA (DeepSeek-V2's multi-head latent attention) against the JAX package
at ``deepseek-v2-236b-smoke`` in float32 on the CPU: the ``MLA`` module's
expanded forward with its latent (ckv, k_rope), the call it makes to the
attention op, its gradients through the ``FlashAttention`` Function, one
absorbed decode step with both cache leaves; ``DecoderLM``'s prefill and
four decode steps with every ``ckv`` / ``krope`` leaf; the absorbed decode
against the port's own expanded forward; the loss, aux loss and every
gradient leaf; one AdamW train step; a bf16 prefill; and the model cut to
its dense first layer (a stack of no MoE layers).

The weights are the JAX model's own init, carried across by
``convert.model_params_from_numpy``; inputs come from numpy with a seed.

Tolerances (those of ``test_torch_moe.py``): outputs, logits, cache
entries and gradients within 1e-4 of the largest |value|; the loss, its
metrics and the aux loss within 1e-5 relative; in bfloat16 the prefill's
logits within 2e-2 of the largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jA
from repro.models import build_model as jbuild_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import global_norm as jglobal_norm
from repro.optim import schedule as jschedule
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.training import init_train_state, make_train_step

RTOL = 1e-4
LOSS_RTOL = 1e-5
ARCH = "deepseek-v2-236b"
B, T, STEPS = 2, 17, 4
SMAX = T + 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(j, t, what, rtol=RTOL):
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.detach().float().numpy()
    assert j.shape == t.shape, (what, j.shape, t.shape)
    if not j.size:
        return
    gap = np.abs(j - t).max()
    assert gap <= rtol * max(np.abs(j).max(), 1e-6), (what, gap,
                                                       np.abs(j).max())


@pytest.fixture(scope="module")
def ref():
    """The float32 smoke config on both sides, the JAX model's init (as a
    JAX tree and as numpy), a token batch and the compiled reference
    calls."""
    jcfg = jget_arch(ARCH).smoke.replace(dtype="float32", remat="none")
    cfg = get_arch(ARCH).smoke.replace(dtype="float32", remat="none")
    jm = jbuild_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T + STEPS))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, params=params,
                np_params=jax.tree.map(np.asarray, params), toks=toks,
                prefill=jax.jit(jm.prefill, static_argnums=2),
                decode=jax.jit(jm.decode_step))


def _model(ref, cfg=None, np_params=None):
    cfg = ref["cfg"] if cfg is None else cfg
    model = build_model(cfg, "cpu")
    assert isinstance(model, DecoderLM)
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, ref["np_params"] if np_params is None else np_params, "cpu"),
        strict=True)
    return model


@pytest.fixture(scope="module")
def mixer(ref):
    """The first MoE layer's MLA mixer, as the JAX subtree and as the
    port's module, and a (2, 17, D) input."""
    jp = jax.tree.map(lambda a: a[0], ref["params"]["stack"]["mixer"])
    mla = _model(ref).stack[0].mixer
    assert isinstance(mla, A.MLA)
    x = np.random.default_rng(2).standard_normal(
        (B, T, ref["cfg"].d_model)).astype(np.float32)
    return jp, mla, x


# ------------------------------------------------------------ the mixer

def test_mla_forward_and_latent_match_reference(ref, mixer):
    jp, mla, x = mixer
    pos = np.arange(T)
    jout, (jckv, jkr) = jax.jit(lambda p, x: jA.apply_mla(
        p, ref["jcfg"], x, jnp.asarray(pos), return_kv=True))(jp,
                                                              jnp.asarray(x))
    with torch.inference_mode():
        out, (ckv, kr) = mla(torch.tensor(x), torch.tensor(pos),
                             return_kv=True)
    m = ref["cfg"].mla
    assert ckv.shape == (B, T, m.kv_lora_rank)
    assert kr.shape == (B, T, m.rope_head_dim)
    _close(jout, out, "mla output")
    _close(jckv, ckv, "ckv")
    _close(jkr, kr, "k_rope")


def test_mla_calls_the_attention_op_at_one_head_dim(ref, mixer,
                                                    monkeypatch):
    """What the expanded path hands kernel #4: q, k and v of one head dim
    (nope + rope), k contiguous (its rope part written out for every
    head, not a stride-0 view), v zero past its own head dim, causal, and
    the scale (nope + rope)^-0.5; the output's padded columns are exact
    zeros, so the slice back drops nothing."""
    _, mla, x = mixer
    m, N = ref["cfg"].mla, ref["cfg"].attn.num_heads
    qh = m.nope_head_dim + m.rope_head_dim
    seen = []

    def spy(q, k, v, **kw):
        o = fa_ref.attention_chunked(q, k, v, **kw)
        seen.append((q, k, v, kw, o))
        return o

    monkeypatch.setattr(A.attn_ops, "attention", spy)
    with torch.inference_mode():
        mla(torch.tensor(x), torch.arange(T))
    (q, k, v, kw, o), = seen
    assert q.shape == k.shape == v.shape == (B, T, N, qh)
    assert k.is_contiguous() and v.is_contiguous()
    assert torch.equal(k[..., m.nope_head_dim:],
                       k[:, :, :1, m.nope_head_dim:].expand(B, T, N,
                                                            m.rope_head_dim))
    assert not v[..., m.v_head_dim:].any()
    assert not o[..., m.v_head_dim:].any()
    assert kw["causal"] and kw["scale"] == qh ** -0.5


def test_mla_gradients_through_the_flash_function_match_reference(
        ref, mixer, monkeypatch):
    """Training's route: the attention call through ``FlashAttention``
    (built here with the plain forward, as the card's is with the
    kernel), its backward the plain version's under the saved options
    (the scale among them). The mixer's input and weight gradients against
    the JAX package's."""
    jp, mla, x = mixer
    pos = np.arange(T)
    dy = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jA.apply_mla(p, ref["jcfg"], x, jnp.asarray(pos))
                       * dy)

    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(1, 0)))(jp, jnp.asarray(x))
    fns = []

    def through_function(q, k, v, **kw):
        o = fa_ops.FlashAttention.apply(q, k, v, fa_ref.attention_chunked,
                                        kw)
        fns.append(type(o.grad_fn).__name__)
        return o

    monkeypatch.setattr(A.attn_ops, "attention", through_function)
    xt = torch.tensor(x, requires_grad=True)
    out = mla(xt, torch.tensor(pos))
    params = dict(mla.named_parameters())
    got = torch.autograd.grad((out * torch.tensor(dy)).sum(),
                              [xt, *params.values()])
    assert fns == ["FlashAttentionBackward"]
    _close(jgx, got[0], "d x")
    assert set(params) == set(jgp)
    for (name, _), g in zip(params.items(), got[1:]):
        _close(jgp[name], g, f"d {name}")


def test_mla_decode_step_matches_reference(ref, mixer):
    """One absorbed decode step at position 9 of a 16-slot cache filled
    with numpy values (slots past 9 included, which the mask must hide):
    the output, and both cache leaves after the step's write."""
    jp, mla, x = mixer
    m = ref["cfg"].mla
    rng = np.random.default_rng(4)
    ckv = rng.standard_normal((B, 16, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, 16, m.rope_head_dim)).astype(np.float32)
    pos = 9
    jout, jckv, jkr = jax.jit(lambda p, x, c, r, s: jA.apply_mla_decode(
        p, ref["jcfg"], x, c, r, s))(jp, jnp.asarray(x[:, :1]),
                                     jnp.asarray(ckv), jnp.asarray(kr),
                                     jnp.asarray(pos, jnp.int32))
    tc, tr = torch.tensor(ckv), torch.tensor(kr)
    with torch.inference_mode():
        out, c2, r2 = mla.decode(torch.tensor(x[:, :1]), tc, tr, pos)
    assert c2 is tc and r2 is tr                 # written in place
    _close(jout, out, "decode output")
    _close(jckv, tc, "ckv cache")
    _close(jkr, tr, "krope cache")
    assert torch.equal(tc[:, pos + 1:], torch.tensor(ckv[:, pos + 1:]))


# ------------------------------------------------------------ the model

def test_prefill_and_four_decode_steps_match_reference(ref):
    model = _model(ref)
    toks, params = ref["toks"], ref["params"]
    jl, jc = ref["prefill"](params, {"tokens": jnp.asarray(toks[:, :T])},
                            SMAX)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks[:, :T])}, SMAX)
        empty = model.init_cache(B, SMAX)
    assert set(tc) == set(jc) == set(empty) == {"prefix_0", "stack"}
    _close(jl, tl, "prefill logits")
    for i in range(STEPS + 1):
        for k in jc:
            assert set(tc[k]) == set(jc[k]) == {"ckv", "krope"}
            for leaf in ("ckv", "krope"):
                assert empty[k][leaf].shape == tc[k][leaf].shape
                _close(jc[k][leaf], tc[k][leaf], f"cache {k}.{leaf} after "
                       f"{i} steps")
        if i == STEPS:
            break
        tok = toks[:, T + i]
        jl, jc = ref["decode"](params, jc, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(T + i, jnp.int32))
        with torch.inference_mode():
            tl, tc = model.decode_step(tc, torch.tensor(tok), T + i)
        _close(jl, tl, f"decode {i} logits")


def test_absorbed_decode_matches_expanded_forward(ref):
    """The port against itself, as tests/test_decode_consistency.py holds
    the reference: at capacity factor 8.0 (no prefill drops), each of four
    absorbed decode steps after a (T - 1)-token prefill against the
    expanded prefill of the same tokens."""
    cfg = ref["cfg"].replace(moe=dataclasses.replace(ref["cfg"].moe,
                                                     capacity_factor=8.0))
    model = _model(ref, cfg)
    toks = torch.tensor(ref["toks"])
    with torch.inference_mode():
        _, cache = model.prefill({"tokens": toks[:, :T - 1]}, SMAX)
        for i in range(STEPS):
            dec, cache = model.decode_step(cache, toks[:, T - 1 + i],
                                           T - 1 + i)
            full, _ = model.prefill({"tokens": toks[:, :T + i]}, SMAX)
            _close(full.numpy(), dec, f"decode step {i} vs prefill")


@pytest.fixture(scope="module")
def one_layer(ref):
    """The smoke config cut to its dense first layer (an empty MoE stack,
    the depth the card trains DeepSeek-V2 at): both configs, the JAX
    model and its float32 init."""
    jcfg = ref["jcfg"].replace(num_layers=1)
    jm = jbuild_model(jcfg)
    return dict(jcfg=jcfg, cfg=ref["cfg"].replace(num_layers=1), jm=jm,
                params=jax.jit(jm.init)(jax.random.PRNGKey(0)))


def _bf16(ref, jcfg, cfg, p32):
    """The float32 JAX init ``p32`` of ``jcfg`` rounded to bf16 (the
    routers stay float32, as in the reference's init) on both sides:
    (the bf16 JAX model, its params, the port's bf16 model)."""
    jm = jbuild_model(jcfg.replace(dtype="bfloat16"))
    params = jax.tree.map(lambda s, a: a.astype(s.dtype),
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          p32)
    model = _model(ref, cfg.replace(dtype="bfloat16"),
                   jax.tree.map(np.asarray, params))
    assert model.prefix_0.mixer.wkv_a.dtype == torch.bfloat16
    return jm, params, model


def test_bfloat16_mla_matches_reference(ref, mixer):
    """MLA's own bf16 arithmetic on shared bf16 inputs: the expanded
    forward, and an absorbed decode step (q_eff in bf16, the float32
    scores and context cast back to bf16 before ``wv_b``) with its
    latent entries, within 2e-2 of the largest."""
    jp, mla, x = mixer
    m = ref["cfg"].mla
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    mla16 = A.MLA(ref["cfg"], torch.bfloat16, generator=torch.Generator(),
                  device="cpu")
    mla16.load_state_dict({k: v.to(torch.bfloat16)
                           for k, v in mla.state_dict().items()})
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.tensor(np.asarray(x16.astype(jnp.float32))).bfloat16()
    jout = jax.jit(lambda p, x: jA.apply_mla(p, ref["jcfg"], x,
                                             jnp.arange(T)))(jp16, x16)
    rng = np.random.default_rng(5)
    ckv = rng.standard_normal((B, 16, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, 16, m.rope_head_dim)).astype(np.float32)
    jdec, jckv, jkr = jax.jit(lambda p, x, c, r: jA.apply_mla_decode(
        p, ref["jcfg"], x, c, r, jnp.asarray(9, jnp.int32)))(
        jp16, x16[:, :1], jnp.asarray(ckv).astype(jnp.bfloat16),
        jnp.asarray(kr).astype(jnp.bfloat16))
    tc, tr = (torch.tensor(a).bfloat16() for a in (ckv, kr))
    with torch.inference_mode():
        out = mla16(xt, torch.arange(T))
        dec, _, _ = mla16.decode(xt[:, :1], tc, tr, 9)
    assert out.dtype == dec.dtype == tc.dtype == torch.bfloat16
    for what, j, t in (("forward", jout, out), ("decode", jdec, dec),
                       ("ckv", jckv, tc), ("krope", jkr, tr)):
        _close(j, t, f"bf16 {what}", 2e-2)


def test_bfloat16_prefill_matches_reference(ref, one_layer):
    """The whole smoke model's prefill in bf16: its logits within 2e-2 of
    the largest against the JAX package's float32 logits of the same
    weights (what bf16 serving approximates), and the dense first layer
    alone (no routing) within 2e-2 against the JAX package's bf16 logits.
    Against the JAX package's bf16 the whole model's gap sits at that
    limit: each package rounds the MLPs' silu in bf16 its own way (one
    bf16 unit here and there; the MLA mixer's bf16 output agrees), the
    two roundings add over three layers, and a top-2 route may flip; the
    gaps are printed (``-s``)."""
    toks = jnp.asarray(ref["toks"][:, :T])
    for jcfg, cfg, p32 in ((ref["jcfg"], ref["cfg"], ref["params"]),
                           (one_layer["jcfg"], one_layer["cfg"],
                            one_layer["params"])):
        jm, params, model = _bf16(ref, jcfg, cfg, p32)
        jl, _ = jax.jit(jm.prefill, static_argnums=2)(
            params, {"tokens": toks}, SMAX)
        with torch.inference_mode():
            tl, tc = model.prefill({"tokens": torch.tensor(
                np.asarray(toks))}, SMAX)
        assert tc["prefix_0"]["ckv"].dtype == torch.bfloat16
        j16 = np.asarray(jnp.asarray(jl).astype(jnp.float32))
        t16 = tl.float().numpy()
        port = np.abs(t16 - j16).max() / np.abs(j16).max()
        if cfg.num_layers == 1:
            print(f"bf16 prefill logits at 1 layer, largest gap / "
                  f"max|logit|: port bf16 vs JAX bf16 {port:.3e}")
            _close(jl, tl, "bf16 prefill logits at 1 layer", 2e-2)
            continue
        j32 = np.asarray(ref["prefill"](p32, {"tokens": toks}, SMAX)[0])
        own = np.abs(j16 - j32).max() / np.abs(j32).max()
        vs32 = np.abs(t16 - j32).max() / np.abs(j32).max()
        print(f"bf16 prefill logits at {cfg.num_layers} layers, largest "
              f"gap / max|logit|: JAX bf16 vs JAX float32 {own:.3e}, port "
              f"bf16 vs JAX float32 {vs32:.3e}, port bf16 vs JAX bf16 "
              f"{port:.3e}")
        _close(j32, tl, "bf16 prefill logits vs float32", 2e-2)


@pytest.fixture(scope="module")
def grads(ref):
    """The reference's loss, metrics and gradients on 2 x 21 tokens, and
    the first AdamW update's metrics."""
    jm = ref["jm"]
    batch = {"tokens": jnp.asarray(ref["toks"], jnp.int32)}
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True))(ref["params"])
    opt = JAdamWConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=100)
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, g),
                grad_norm=float(jglobal_norm(g)),
                lr=float(jschedule(opt, jnp.asarray(1, jnp.int32))))


def test_loss_aux_loss_and_gradients_match_reference(ref, grads):
    model = _model(ref)
    loss, metrics = model.loss({"tokens": torch.tensor(ref["toks"])})
    assert abs(loss.item() - grads["loss"]) <= LOSS_RTOL * abs(grads["loss"])
    assert set(metrics) == set(grads["metrics"])
    assert grads["metrics"]["aux_loss"] > 0
    for k, v in grads["metrics"].items():
        assert abs(metrics[k].item() - v) <= LOSS_RTOL * max(abs(v), 1e-6), k
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss, list(params.values()))
    want = convert.model_params_from_numpy(ref["cfg"], grads["grads"], "cpu")
    assert set(want) == set(params)
    assert any(k.endswith("mixer.wkv_a") for k in params)
    for k, g in zip(params, got):
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= RTOL * max(np.abs(w).max(),
                                                         1e-30), k


def test_train_step_matches_reference(ref, grads):
    """One ``make_train_step`` step: the reference's loss, aux loss,
    ``grad_norm`` and ``lr``; the new parameters those of
    ``adamw_update`` on the step's own gradients, bit for bit."""
    model = _model(ref)
    batch = {"tokens": torch.tensor(ref["toks"])}
    opt = AdamWConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=100)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    loss, _ = model.loss(batch)
    g = dict(zip(params, torch.autograd.grad(loss,
                                             list(model.parameters()))))
    state = init_train_state(model, opt)
    want, _, _ = adamw_update(params, g, state["opt"], opt)
    new, metrics = make_train_step(model, opt)(state, batch)
    assert abs(metrics["loss"].item() - grads["loss"]) <= \
        LOSS_RTOL * abs(grads["loss"])
    assert abs(metrics["aux_loss"].item() - grads["metrics"]["aux_loss"]) \
        <= LOSS_RTOL * grads["metrics"]["aux_loss"]
    assert abs(metrics["grad_norm"].item() - grads["grad_norm"]) <= \
        LOSS_RTOL * grads["grad_norm"]
    assert abs(metrics["lr"].item() - grads["lr"]) <= 1e-6 * 3e-3
    assert int(new["opt"]["step"]) == 1
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k


# ------------------------------------------- the dense first layer alone

def test_dense_prefix_alone_matches_reference(ref, one_layer):
    """The model cut to its dense first layer with its MLA mixer and no
    MoE layer after it (the depth the card trains DeepSeek-V2 at):
    ``convert`` takes the JAX tree's empty stack; the prefill's logits
    and cache (an empty stack of latent entries), a decode step and the
    loss (its aux loss 0) match the reference's, and every parameter
    gets a finite gradient (the prefix's gradients are held leaf by leaf
    in ``test_loss_aux_loss_and_gradients_match_reference``)."""
    jm, params, cfg = one_layer["jm"], one_layer["params"], one_layer["cfg"]
    model = _model(ref, cfg, jax.tree.map(np.asarray, params))
    assert model.n_prefix == 1 and len(model.stack) == 0
    toks = ref["toks"]
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks[:, :T])}, SMAX)
    jd, jc = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, T]),
                                     jnp.asarray(T, jnp.int32))
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks[:, :T])}, SMAX)
        assert tc["stack"]["ckv"].shape == (0, B, SMAX,
                                            cfg.mla.kv_lora_rank)
        td, tc = model.decode_step(tc, torch.tensor(toks[:, T]), T)
    _close(jl, tl, "prefill logits")
    _close(jd, td, "decode logits")
    for k in jc:
        for leaf in jc[k]:
            _close(jc[k][leaf], tc[k][leaf], f"cache {k}.{leaf}")
    jloss, jmet = jax.jit(jm.loss)(params, {"tokens": jnp.asarray(toks)})
    loss, metrics = model.loss({"tokens": torch.tensor(toks)})
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert metrics["aux_loss"].item() == float(jmet["aux_loss"]) == 0.0
    got = torch.autograd.grad(loss, list(model.parameters()))
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in got)
