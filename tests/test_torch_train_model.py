"""The training slice's model side against the JAX package, at smoke sizes
in float32 on the CPU: ``chunked_xent``, the models' ``loss`` and its
gradients, the train step's metrics, and the autograd Functions around
kernels #4 and #5 built with their plain forward. The weights are the
port's seed-0 init, set into the JAX model's tree (so the JAX ``init`` is
traced, not compiled) and carried back into the port's model with
``convert.model_params_from_numpy``; token ids come from numpy with a seed.

Tolerances: ``chunked_xent`` and a model's loss and metrics within 1e-5
relative (float32 sums over the vocabulary, taken in another order; the
port does not pad the last chunk, whose padding adds exact zeros in the
reference); every gradient leaf within 1e-4 of its largest |value| (the
class of ``test_torch_models.py``); the train step's ``grad_norm`` within
1e-5 relative, its ``lr`` within 1e-6 relative. The Functions' gradients equal
autograd through the plain versions bit for bit (the backward is that
autograd, recomputed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.models import layers as jL
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import global_norm as jglobal_norm
from repro.optim import schedule as jschedule
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.linear_scan import ops as gla_ops
from repro_torch.kernels.linear_scan import ref as gla_ref
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ARCHS = ("qwen3-0.6b", "zamba2-7b", "gemma2-9b", "yi-6b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread (the test workers share the
    cores; more threads only wait on each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("cap,mask", [(None, False), (30.0, True)])
def test_chunked_xent_matches_reference(cap, mask):
    """Three chunks of 8 over 21 positions (a ragged last chunk), with and
    without the logit softcap and a mask."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 21, 16)).astype(np.float32)
    head = (3 * rng.standard_normal((40, 16))).astype(np.float32)
    lab = rng.integers(0, 40, (2, 21)).astype(np.int32)
    m = (rng.uniform(size=(2, 21)) > 0.3).astype(np.float32) if mask \
        else None
    jmask = None if m is None else jnp.asarray(m)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda x: jL.chunked_xent(
        x, jnp.asarray(head), jnp.asarray(lab), mask=jmask,
        logit_softcap=cap, chunk=8), has_aux=True))(jnp.asarray(h))
    ht = torch.tensor(h, requires_grad=True)
    tl, tm = L.chunked_xent(ht, torch.tensor(head), torch.tensor(lab),
                            mask=None if m is None else torch.tensor(m),
                            logit_softcap=cap, chunk=8)
    assert _rel(jl, tl.item()) <= LOSS_RTOL
    assert set(tm) == set(jm)
    for k in jm:
        assert _rel(jm[k], tm[k].item()) <= LOSS_RTOL, k
    # the checkpointed chunks give the gradient of the plain sum
    (tg,) = torch.autograd.grad(tl, ht)
    assert _rel(jg, tg.numpy()) <= GRAD_RTOL


def _jax_params(arch, jmodel):
    """The JAX model's float32 params tree, at the shapes of its ``init``
    (traced, not compiled), holding the port's seed-0 init: each stacked
    leaf gathers its layers' tensors, as ``convert.model_params_from_numpy``
    splits them."""
    cfg = get_arch(arch).smoke.replace(dtype="float32", remat="none")
    state = {k: v.numpy() for k, v in
             build_model(cfg, "cpu", seed=0).state_dict().items()}

    def fill(path, leaf):
        keys = [k.key for k in path]
        out = np.empty(leaf.shape, np.float32)
        for idx in np.ndindex(*leaf.shape[:convert.STACKED.get(keys[0], 0)]):
            out[idx] = state[".".join(
                [keys[0], *map(str, idx), *keys[1:]])]
        return jnp.asarray(out)
    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reference():
    """Per arch: the JAX smoke model's float32 params (``_jax_params``), a
    batch of 2 x 33 tokens, its (loss, metrics) and gradients, and the
    first AdamW update's metrics on those gradients (the global norm and
    the step-1 rate)."""
    out = {}
    opt = JAdamWConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=100)
    for arch in ARCHS:
        cfg = jget_arch(arch).smoke.replace(dtype="float32", remat="none")
        model = jbuild_model(cfg)
        params = _jax_params(arch, model)
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 33)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks)}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, batch), has_aux=True))(params)
        # the first AdamW update's metrics
        om = {"grad_norm": jglobal_norm(grads),
              "lr": jschedule(opt, jnp.asarray(1, jnp.int32))}
        out[arch] = dict(
            params=jax.tree.map(np.asarray, params), toks=toks,
            loss=float(loss), metrics={k: float(v) for k, v in
                                       metrics.items()},
            grads=jax.tree.map(np.asarray, grads),
            step={k: float(v) for k, v in om.items()})
    return out


def _port_model(arch, ref):
    cfg = get_arch(arch).smoke.replace(dtype="float32", remat="none")
    model = build_model(cfg, "cpu")
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, ref["params"], "cpu"), strict=True)
    return cfg, model


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(reference, arch):
    ref = reference[arch]
    cfg, model = _port_model(arch, ref)
    loss, metrics = model.loss({"tokens": torch.tensor(
        ref["toks"], dtype=torch.int64)})
    assert _rel(ref["loss"], loss.item()) <= LOSS_RTOL
    assert set(metrics) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(metrics[k].item() - v) <= LOSS_RTOL * max(abs(v), 1e-6), k
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    want = convert.model_params_from_numpy(cfg, ref["grads"], "cpu")
    assert set(want) == set(params)
    for (k, _), g in zip(params.items(), grads):
        assert _rel(want[k].numpy(), g.numpy()) <= GRAD_RTOL, k


@pytest.mark.parametrize("arch,compress", [("qwen3-0.6b", False),
                                           ("zamba2-7b", True)])
def test_train_step_metrics_and_update(reference, arch, compress):
    """``make_train_step``: the reference step's metrics, and the new
    parameters those of ``adamw_update`` on the step's own gradients (after
    the int8 round trip with ``compress``), bit for bit."""
    from repro_torch.optim import adamw_update, global_norm
    from repro_torch.optim.compression import roundtrip
    ref = reference[arch]
    cfg, model = _port_model(arch, ref)
    batch = {"tokens": torch.tensor(ref["toks"], dtype=torch.int64)}
    opt = AdamWConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=100)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    loss, _ = model.loss(batch)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(model.parameters()))))
    state = init_train_state(model, opt, compress=compress)
    ef0 = state.get("ef")
    if compress:
        grads, ef = roundtrip(grads, ef0)
    want, want_opt, _ = adamw_update(params, grads, state["opt"], opt)
    new, metrics = make_train_step(model, opt, compress=compress)(state,
                                                                  batch)
    expected = {"loss", "xent", "accuracy", "tokens", "grad_norm", "lr"}
    assert expected <= set(metrics)
    assert _rel(ref["loss"], metrics["loss"].item()) <= LOSS_RTOL
    if compress:    # the norm of what the round trip handed AdamW
        assert torch.equal(metrics["grad_norm"], global_norm(grads))
    else:
        assert _rel(ref["step"]["grad_norm"], metrics["grad_norm"].item()) \
            <= LOSS_RTOL
    assert abs(metrics["lr"].item() - ref["step"]["lr"]) <= 1e-6 * 3e-3
    assert int(new["opt"]["step"]) == 1
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
        assert torch.equal(new["opt"]["m"][k], want_opt["m"][k]), k
    if compress:
        assert all(torch.equal(new["ef"][k], ef[k]) for k in ef)


# ------------------------------------------- the Functions of kernels #4, #5

@pytest.mark.parametrize("opts", [
    dict(causal=True, window=None, softcap=None),
    dict(causal=True, window=7, softcap=20.0),
    dict(causal=False, window=None, softcap=None)])
def test_flash_attention_function_gradients_equal_plain_autograd(opts):
    """``ops.FlashAttention`` built with the plain forward: its output and
    the gradients to q, k and v are autograd's through
    ``ref.attention_chunked``, GQA with 2 query heads a KV head."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            requires_grad=True)
               for s in ((2, 24, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    kw = dict(opts, q_offset=0, length=None, scale=None)
    do = torch.tensor(rng.standard_normal((2, 24, 4, 16)).astype(np.float32))
    o = fa_ops.FlashAttention.apply(q, k, v, fa_ref.attention_chunked, kw)
    got = torch.autograd.grad(o, (q, k, v), do)
    o2 = fa_ref.attention_chunked(q, k, v, **kw)
    want = torch.autograd.grad(o2, (q, k, v), do)
    assert torch.equal(o, o2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a q that takes no gradient gets none
    o = fa_ops.FlashAttention.apply(q.detach(), k, v,
                                    fa_ref.attention_chunked, kw)
    assert len(torch.autograd.grad(o, (k, v), do)) == 2


@pytest.mark.parametrize("mode", ("mamba2", "rwkv6"))
def test_gla_function_gradients_equal_plain_autograd(mode):
    """``ops.GLAScan`` built with the plain forward: Mamba2's mode (q and k
    broadcast over the heads with stride 0, a scalar decay, an initial
    state) and RWKV6's (a per-channel decay, bonus, strict); gradients of
    a loss on both outputs, and of one on ``o`` alone (the final state
    unused, as a training forward leaves it), to every input given."""
    rng = np.random.default_rng(3)
    B, S, H, K, V = 2, 37, 3, 8, 8

    def t(*shape, scale=1.0):
        return torch.tensor((scale * rng.standard_normal(shape)).astype(
            np.float32), requires_grad=True)

    if mode == "mamba2":
        c, b, ld = t(B, S, K), t(B, S, K), t(B, S, H, scale=0.3)
        bonus, leaves, kw = None, [c, b], dict(strict=False, chunk=16)
    else:
        q, k, ld, bonus = t(B, S, H, K), t(B, S, H, K), \
            t(B, S, H, K, scale=0.3), t(H, K)
        leaves, kw = [q, k, bonus], dict(strict=True, chunk=16)
    v, h0 = t(B, S, H, V), t(B, H, K, V)
    leaves += [v, ld, h0]
    w = torch.tensor(rng.standard_normal((B, S, H, V)).astype(np.float32))
    for with_state in (True, False):
        res = []
        for fn in ("function", "plain"):
            if mode == "mamba2":
                q, k = (x[:, :, None].expand(B, S, H, K) for x in (c, b))
            args = (q, k, v, -torch.nn.functional.softplus(ld))
            if fn == "function":
                o, hT = gla_ops.GLAScan.apply(*args, bonus, h0,
                                              gla_ref.gla_chunked, kw)
            else:
                o, hT = gla_ref.gla_chunked(*args, bonus=bonus,
                                            initial_state=h0, **kw)
            loss = (o * w).sum() + ((hT * hT).sum() if with_state else 0.0)
            res.append((o, hT, torch.autograd.grad(loss, leaves)))
        (o1, h1, g1), (o2, h2, g2) = res
        assert torch.equal(o1, o2) and torch.equal(h1, h2)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2)), with_state


def test_cpu_calls_take_the_plain_routes_with_gradients():
    """On the CPU ``ops.attention`` and ``ops.gla`` are the plain versions
    (autograd records through them directly); no Function is involved."""
    q = torch.randn(1, 20, 2, 8, requires_grad=True)
    o = fa_ops.attention(q, q, q)
    assert "FlashAttention" not in type(o.grad_fn).__name__
    ld = -torch.rand(1, 20, 2)
    o, _ = gla_ops.gla(q, q, q, ld, chunk=8)
    assert "GLAScan" not in type(o.grad_fn).__name__
