"""The MoE family against the JAX package at ``deepseek-moe-16b-smoke`` in
float32 on the CPU: routing, slot assignment and capacity; ties in the
top-k; ``apply_moe`` for both dispatches at the config's capacity factor
(1.25) and at 0.5, with and without ``no_drop``; ``DecoderLM``'s prefill
and four decode steps with every cache leaf; the loss, its aux loss and
every gradient leaf; one train step; a bf16 prefill; and what
``build_model`` and ``convert`` build and refuse.

The weights are the JAX model's own init, carried across by
``convert.model_params_from_numpy``; inputs come from numpy with a seed.

Tolerances: route indices, slot positions and keep masks equal; router
probabilities and gate weights within 1e-6 (float32 softmax of products
summed in another order); layer outputs, logits and cache entries within
1e-4 of the largest |value|; the loss, its metrics and the aux loss within
1e-5 relative, every gradient leaf within 1e-4 of its largest |value| (the
classes of ``test_torch_models.py`` and ``test_torch_train_model.py``); in
bfloat16 the prefill's logits within 2e-2 of the largest (``-s`` prints
the JAX package's own bf16-vs-float32 gap beside the port's gap to it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.models import moe as jM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import global_norm as jglobal_norm
from repro.optim import schedule as jschedule
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.training import init_train_state, make_train_step

RTOL = 1e-4
LOSS_RTOL = 1e-5
PROB_ATOL = 1e-6
ARCH = "deepseek-moe-16b"
B, T, STEPS = 2, 17, 4
CAPACITIES = (1.25, 0.5)        # the config's, and one that drops many


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
    gap = np.abs(j - t).max()
    assert gap <= rtol * max(np.abs(j).max(), 1e-6), (what, gap,
                                                       np.abs(j).max())


def _with_moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


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


def _model(ref, cfg=None):
    cfg = ref["cfg"] if cfg is None else cfg
    model = build_model(cfg, "cpu")
    assert isinstance(model, DecoderLM)
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, ref["np_params"], "cpu"), strict=True)
    return model


@pytest.fixture(scope="module")
def layer(ref):
    """The first MoE layer's weights, as the JAX subtree and as the port's
    module, and a (2, 32, D) input: two dispatch groups of 32 tokens."""
    jp = jax.tree.map(lambda a: a[0], ref["params"]["stack"]["ffn"])
    moe = _model(ref).stack[0].ffn
    assert isinstance(moe, M.MoE)
    x = np.random.default_rng(2).standard_normal(
        (2, 32, ref["cfg"].d_model)).astype(np.float32)
    return jp, moe, x


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("cf,no_drop", [(1.25, False), (0.5, False),
                                        (1.25, True)])
def test_route_positions_and_capacity_match_reference(ref, layer, cf,
                                                      no_drop):
    jp, moe, x = layer
    jm_cfg = _with_moe(ref["jcfg"], capacity_factor=cf).moe
    m = _with_moe(ref["cfg"], capacity_factor=cf).moe
    S = x.shape[1]
    for s in (1, 17, S, 100):
        assert M._capacity(m, s, no_drop) == jM._capacity(jm_cfg, s, no_drop)
    jprobs, jtopv, jtopi = jM._route(jm_cfg, jnp.asarray(x), jp["router"])
    probs, topv, topi = M._route(m, torch.tensor(x), moe.router.detach())
    assert torch.equal(topi, torch.tensor(np.asarray(jtopi)).long())
    for name, j, t in (("probs", jprobs, probs), ("gates", jtopv, topv)):
        assert np.abs(np.asarray(j) - t.numpy()).max() <= PROB_ATOL, name
    jpos, jkeep = jM._positions(jm_cfg, jtopi, S, no_drop)
    pos, keep = M._positions(m, topi, S, no_drop)
    assert torch.equal(pos, torch.tensor(np.asarray(jpos)).long())
    assert torch.equal(keep, torch.tensor(np.asarray(jkeep)))
    dropped = int((~keep).sum())
    assert dropped == 0 if no_drop else dropped > 0, dropped
    _close(jM._aux_loss(jm_cfg, jprobs, jtopi),
           M._aux_loss(m, probs, topi), "aux loss", LOSS_RTOL)


def test_top_k_ties_pick_the_lower_index(ref, layer):
    """Two experts with equal router columns tie exactly in every token's
    probabilities; both packages then pick the lower index first, as
    ``lax.top_k`` does (``torch.topk`` promises no order among equals)."""
    jp, moe, x = layer
    m = ref["cfg"].moe
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 2]
    jprobs, _, jtopi = jM._route(ref["jcfg"].moe, jnp.asarray(x),
                                 jnp.asarray(router))
    probs, _, topi = M._route(m, torch.tensor(x), torch.tensor(router))
    assert torch.equal(probs[..., 2], probs[..., 5])
    assert torch.equal(topi, torch.tensor(np.asarray(jtopi)).long())
    first = topi[..., 0]
    assert (first == 2).any()           # the tie is the top choice somewhere
    assert not ((first == 5) | (first == 6)).any()
    assert ((topi[..., 1] == 5) == (first == 2)).all()
    vals, idx = M._top_k(torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15]]), 3)
    assert idx.tolist() == [[0, 1, 3]] and vals.tolist() == [[0.25] * 3]


# ---------------------------------------------------------- apply_moe

@pytest.fixture(scope="module")
def moe_outputs(ref, layer):
    """The reference's ``apply_moe`` and its slot assignment for each
    dispatch x capacity factor x no_drop, compiled as one call."""
    jp, _, x = layer

    def run(p, x):
        out = {}
        for dispatch in ("einsum", "scatter"):
            for cf in CAPACITIES:
                cfg = _with_moe(ref["jcfg"], capacity_factor=cf,
                                dispatch=dispatch)
                xg = x.reshape(2, 32, -1)
                _, _, topi = jM._route(cfg.moe, xg, p["router"])
                for no_drop in (False, True):
                    y, aux = jM.apply_moe(p, cfg, x, no_drop=no_drop)
                    _, keep = jM._positions(cfg.moe, topi, 32, no_drop)
                    out[dispatch, cf, no_drop] = (y, aux, keep)
        return out

    return jax.jit(run)(jp, jnp.asarray(x))


@pytest.mark.parametrize("no_drop", (False, True))
@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("dispatch", ("einsum", "scatter"))
def test_apply_moe_matches_reference(ref, layer, moe_outputs, dispatch, cf,
                                     no_drop):
    _, moe, x = layer
    jy, jaux, jkeep = moe_outputs[dispatch, cf, no_drop]
    cfg = _with_moe(ref["cfg"], capacity_factor=cf, dispatch=dispatch)
    y, aux = M.apply_moe(moe, cfg, torch.tensor(x), no_drop=no_drop)
    _close(jy, y, f"{dispatch} {cf} {no_drop} output")
    _close(jaux, aux, f"{dispatch} {cf} {no_drop} aux", LOSS_RTOL)
    xg = torch.tensor(x).reshape(2, 32, -1)
    _, _, topi = M._route(cfg.moe, xg, moe.router.detach())
    _, keep = M._positions(cfg.moe, topi, 32, no_drop)
    assert torch.equal(keep, torch.tensor(np.asarray(jkeep)))
    dropped = int((~keep).sum())
    assert dropped == 0 if no_drop else dropped > 0, dropped


# ------------------------------------------------------------ the model

def test_prefill_and_four_decode_steps_match_reference(ref):
    model = _model(ref)
    toks, params = ref["toks"], ref["params"]
    jl, jc = ref["prefill"](params, {"tokens": jnp.asarray(toks[:, :T])},
                            T + 8)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks[:, :T])}, T + 8)
        empty = model.init_cache(B, T + 8)
    assert set(tc) == set(jc) == set(empty) == {"prefix_0", "stack"}
    _close(jl, tl, "prefill logits")
    for i in range(STEPS + 1):
        for k in jc:
            for leaf in ("k", "v"):
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


def test_bfloat16_prefill_matches_reference(ref):
    """The JAX init in bf16 (the router stays float32, as in the
    reference's init) on both sides: the prefill's logits. A routed model's
    logits jump where a token's k-th and (k+1)-th router probabilities
    tie within the two frameworks' bf16 rounding of the layers before;
    these weights have no such near tie on these tokens, and
    ``test_bfloat16_apply_moe_matches_reference`` holds the MoE's own bf16
    arithmetic on shared inputs, where the routes see the same input."""
    jcfg = ref["jcfg"].replace(dtype="bfloat16")
    cfg = ref["cfg"].replace(dtype="bfloat16")
    jm = jbuild_model(jcfg)
    params = jax.tree.map(lambda s, a: a.astype(s.dtype),
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          ref["params"])
    model = build_model(cfg, "cpu")
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu"), strict=True)
    assert model.stack[0].ffn.wi.dtype == torch.bfloat16
    assert model.stack[0].ffn.router.dtype == torch.float32
    toks = ref["toks"][:, :T]
    jl, _ = jax.jit(jm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks)}, T + 8)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks)}, T + 8)
    assert tc["stack"]["k"].dtype == torch.bfloat16
    _close(jl, tl, "bf16 prefill logits", 2e-2)
    j32, _ = ref["prefill"](ref["params"], {"tokens": jnp.asarray(toks)},
                            T + 8)
    j16, j32 = (np.asarray(jnp.asarray(a).astype(jnp.float32))
                for a in (jl, j32))
    own = np.abs(j16 - j32).max() / np.abs(j32).max()
    port = np.abs(tl.float().numpy() - j16).max() / np.abs(j16).max()
    print(f"bf16 prefill logits, largest gap / max|logit|: the JAX "
          f"package's bf16 vs its float32 {own:.3e}, the port's bf16 vs "
          f"the JAX package's {port:.3e}")


@pytest.mark.parametrize("dispatch", ("einsum", "scatter"))
def test_bfloat16_apply_moe_matches_reference(ref, layer, dispatch):
    """``apply_moe`` in bf16 (the layer's weights rounded to bf16, the
    router float32) on the same bf16 input in both packages, at the
    config's capacity factor: the output within 2e-2 of the largest, the
    aux loss within 1e-5 relative (its float32 router sees the same
    input)."""
    jp, moe, x = layer
    cfg = _with_moe(ref["cfg"], dispatch=dispatch)
    jcfg = _with_moe(ref["jcfg"], dispatch=dispatch)
    jp16 = {k: (v if k == "router" else jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), v)) for k, v in jp.items()}
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    jy, jaux = jax.jit(lambda p, x: jM.apply_moe(p, jcfg, x))(jp16, x16)
    moe16 = M.MoE(cfg, torch.bfloat16, generator=torch.Generator(),
                  device="cpu")
    moe16.load_state_dict({k: v.to(torch.float32 if k == "router"
                                   else torch.bfloat16)
                           for k, v in moe.state_dict().items()})
    with torch.inference_mode():
        y, aux = M.apply_moe(moe16, cfg, torch.tensor(
            np.asarray(x16.astype(jnp.float32))).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    _close(jy, y, f"bf16 {dispatch} output", 2e-2)
    _close(jaux, aux, f"bf16 {dispatch} aux", LOSS_RTOL)


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
    assert any(k.endswith("ffn.router") for k in params)
    for k, g in zip(params, got):
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= RTOL * max(np.abs(w).max(),
                                                         1e-30), k


def test_train_step_matches_reference(ref, grads):
    """One ``make_train_step`` step: the reference's loss, ``grad_norm``
    and ``lr``; the new parameters those of ``adamw_update`` on the step's
    own gradients, bit for bit."""
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


# ------------------------------------------------- what is still refused

def test_build_model_builds_moe_and_refuses_mla(ref):
    """DeepSeekMoE builds (its first layer a dense prefix of width
    ``dense_d_ff``, the rest MoE blocks) on the CPU when asked and on the
    card by default; so does DeepSeek-V2 (MoE with MLA mixers), whose
    sharded MLA flash decode is refused (out of scope on one card)."""
    model = build_model(ref["cfg"], "cpu")
    m = ref["cfg"].moe
    assert model.prefix_0.ffn.wi.shape == (ref["cfg"].d_model,
                                           2 * m.dense_d_ff)
    assert len(model.stack) == ref["cfg"].num_layers - 1
    assert all(isinstance(b.ffn, M.MoE) for b in model.stack)
    assert model.stack[0].ffn.shared.wi.shape[1] == 2 * m.num_shared * \
        m.d_expert
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(get_arch(ARCH).config)
    v2 = get_arch("deepseek-v2-236b").smoke
    mla = build_model(v2, "cpu")
    assert all(isinstance(b.ffn, M.MoE) for b in mla.stack)
    assert type(mla.prefix_0.mixer).__name__ == "MLA"
    with pytest.raises(NotImplementedError, match="out of scope"):
        build_model(v2.replace(flash_decode=True), "cpu")


def test_convert_checks_the_moe_stack_length(ref):
    """The JAX tree's ``stack`` holds the layers after the dense prefix;
    a config that counts otherwise is refused."""
    with pytest.raises(ValueError, match="layers"):
        convert.model_params_from_numpy(
            _with_moe(ref["cfg"], first_dense_layers=0), ref["np_params"])
    with pytest.raises(ValueError, match="layers"):
        convert.model_params_from_numpy(ref["cfg"].replace(num_layers=4),
                                        ref["np_params"])
