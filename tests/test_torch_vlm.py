"""The VLM family against the JAX package at ``internvl2-2b-smoke`` in
float32 on the CPU: ``DecoderLM`` with a ``vision_embeds`` prefix (the stub
frontend's patch embeddings put in front of the tokens): the forward, the
prefill plus four decode steps with every cache leaf, the loss, its
metrics and every gradient leaf, one train step, a bf16 prefill; the
reference's scoring offset pinned in both packages; the zero vision
stub's gradient overflow at full depth, pinned in both packages;
``pad_kv_to``'s refusal; and both launchers on the CPU.

The weights are the JAX model's own init, carried across by
``convert.model_params_from_numpy``; tokens and vision embeddings come
from numpy with a seed.

Tolerances (the classes of ``test_torch_models.py`` and
``test_torch_train_model.py``): hidden states, logits and cache entries
within 1e-4 of the largest |value|; the loss and its metrics within 1e-5
relative, every gradient leaf within 1e-4 of its largest |value|; in
bfloat16 the prefill's logits within 2e-2 of the largest (``-s`` prints
the JAX package's own bf16-vs-float32 gap beside the port's gap to it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.models.transformer import _pad_kv_to as jpad_kv_to
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import global_norm as jglobal_norm
from repro.optim import schedule as jschedule
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models.model import prompt_start, stub_inputs
from repro_torch.models.transformer import DecoderLM, pad_kv_to
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.training import init_train_state, make_train_step

RTOL = 1e-4
LOSS_RTOL = 1e-5
ARCH = "internvl2-2b"
B, T, STEPS = 2, 11, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(j, t, what, rtol=RTOL):
    j = _np(j)
    t = t.detach().float().numpy()
    assert j.shape == t.shape, (what, j.shape, t.shape)
    gap = np.abs(j - t).max()
    assert gap <= rtol * max(np.abs(j).max(), 1e-6), (what, gap,
                                                       np.abs(j).max())


@pytest.fixture(scope="module")
def ref():
    """The float32 smoke config on both sides, the JAX model's init (as a
    JAX tree and as numpy), tokens, vision embeddings and the compiled
    reference calls."""
    jcfg = jget_arch(ARCH).smoke.replace(dtype="float32", remat="none")
    cfg = get_arch(ARCH).smoke.replace(dtype="float32", remat="none")
    assert cfg.family == "vlm"
    jm = jbuild_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, T + STEPS + 1))
    ve = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)
                             ).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, params=params,
                np_params=jax.tree.map(np.asarray, params), toks=toks, ve=ve,
                prefill=jax.jit(jm.prefill, static_argnums=2),
                decode=jax.jit(jm.decode_step))


def _model(ref, cfg=None, params=None):
    cfg = cfg or ref["cfg"]
    model = build_model(cfg, "cpu")
    assert isinstance(model, DecoderLM)
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, ref["np_params"] if params is None else params, "cpu"),
        strict=True)
    return model


def test_configs_hold_the_published_vision_tokens():
    assert get_arch(ARCH).config.vision_tokens == 256
    assert get_arch(ARCH).smoke.vision_tokens == 8
    cfg = get_arch(ARCH).smoke
    extra = stub_inputs(cfg, 3, "cpu")
    assert set(extra) == {"vision_embeds"}
    assert extra["vision_embeds"].shape == (3, 8, cfg.d_model)
    assert extra["vision_embeds"].dtype == torch.bfloat16
    assert not extra["vision_embeds"].any() and prompt_start(cfg) == 8


def test_forward_with_vision_embeds_matches_reference(ref):
    """``forward(tokens, vision_embeds)``: the hidden states of the vision
    positions and the tokens; without ``vision_embeds``, the tokens
    alone."""
    jm, model = ref["jm"], _model(ref)
    toks = ref["toks"][:, :T]
    jx, jaux = jax.jit(jm.forward)(ref["params"], jnp.asarray(toks),
                                   jnp.asarray(ref["ve"]))
    x, aux = model.forward(torch.tensor(toks), torch.tensor(ref["ve"]))
    assert x.shape == (B, ref["cfg"].vision_tokens + T, ref["cfg"].d_model)
    _close(jx, x, "forward")
    assert float(jaux) == 0.0 and aux == 0.0
    jx, _ = jax.jit(jm.forward)(ref["params"], jnp.asarray(toks))
    _close(jx, model.forward(torch.tensor(toks))[0], "forward, no vision")


def test_prefill_and_four_decode_steps_match_reference(ref):
    """The prefill of the vision prefix and T tokens, then four decode
    steps from position vision_tokens + T: every call's logits and every
    cache leaf after it."""
    model, params = _model(ref), ref["params"]
    toks, tv = ref["toks"], ref["cfg"].vision_tokens
    max_seq = tv + T + 8
    jl, jc = ref["prefill"](params, {"tokens": jnp.asarray(toks[:, :T]),
                                     "vision_embeds": jnp.asarray(ref["ve"])},
                            max_seq)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks[:, :T]),
                                "vision_embeds": torch.tensor(ref["ve"])},
                               max_seq)
        empty = model.init_cache(B, max_seq)
    assert set(tc) == set(jc) == set(empty) == {"stack"}
    _close(jl, tl, "prefill logits")
    for i in range(STEPS + 1):
        for k in jc["stack"]:
            assert empty["stack"][k].shape == tc["stack"][k].shape
            _close(jc["stack"][k], tc["stack"][k], f"cache {k} after {i}")
        if i == STEPS:
            break
        tok, pos = toks[:, T + i], tv + T + i
        jl, jc = ref["decode"](params, jc, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            tl, tc = model.decode_step(tc, torch.tensor(tok), pos)
        _close(jl, tl, f"decode {i} logits")


def test_bfloat16_prefill_matches_reference(ref):
    """The JAX init in bf16 (norms float32) on both sides, bf16 vision
    embeddings: the prefill's logits and its caches."""
    jcfg, cfg = (c.replace(dtype="bfloat16") for c in (ref["jcfg"],
                                                       ref["cfg"]))
    jm = jbuild_model(jcfg)
    params = jax.tree.map(lambda s, a: a.astype(s.dtype),
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          ref["params"])
    model = _model(ref, cfg, jax.tree.map(np.asarray, params))
    assert model.embed.dtype == torch.bfloat16
    toks, ve = ref["toks"][:, :T], ref["ve"]
    max_seq = cfg.vision_tokens + T + 8
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks),
                 "vision_embeds": jnp.asarray(ve, jnp.bfloat16)}, max_seq)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks),
                                "vision_embeds": torch.tensor(ve).to(
                                    torch.bfloat16)}, max_seq)
    assert tc["stack"]["k"].dtype == torch.bfloat16
    _close(jl, tl, "bf16 prefill logits", 2e-2)
    for k in ("k", "v"):
        _close(jc["stack"][k], tc["stack"][k], f"bf16 cache {k}", 2e-2)
    j32, _ = ref["prefill"](ref["params"], {
        "tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(ve)},
        max_seq)
    j16, j32 = _np(jl), _np(j32)
    print(f"bf16 prefill logits, largest gap / max|logit|: the JAX "
          f"package's bf16 vs its float32 "
          f"{np.abs(j16 - j32).max() / np.abs(j32).max():.3e}, the port's "
          f"bf16 vs the JAX package's "
          f"{np.abs(tl.float().numpy() - j16).max() / np.abs(j16).max():.3e}")


def _batches(ref):
    toks, ve = ref["toks"], ref["ve"]
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "vision_embeds": jnp.asarray(ve)},
            {"tokens": torch.tensor(toks), "vision_embeds": torch.tensor(ve)})


@pytest.fixture(scope="module")
def grads(ref):
    """The reference's loss, metrics and gradients on the batch with its
    vision embeddings, and the first AdamW update's metrics."""
    jm = ref["jm"]
    jbatch, _ = _batches(ref)
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True))(ref["params"])
    opt = JAdamWConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=100)
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, g),
                grad_norm=float(jglobal_norm(g)),
                lr=float(jschedule(opt, jnp.asarray(1, jnp.int32))))


def test_loss_and_gradients_match_reference(ref, grads):
    model = _model(ref)
    loss, metrics = model.loss(_batches(ref)[1])
    assert abs(loss.item() - grads["loss"]) <= LOSS_RTOL * abs(grads["loss"])
    assert set(metrics) == set(grads["metrics"])
    for k, v in grads["metrics"].items():
        assert abs(metrics[k].item() - v) <= LOSS_RTOL * max(abs(v), 1e-6), k
    # T + STEPS positions of each row are scored
    assert metrics["tokens"].item() == B * (T + STEPS)
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss, list(params.values()))
    want = convert.model_params_from_numpy(ref["cfg"], grads["grads"], "cpu")
    assert set(want) == set(params)
    for k, g in zip(params, got):
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= RTOL * max(np.abs(w).max(),
                                                         1e-30), k


def test_train_step_matches_reference(ref, grads):
    """One ``make_train_step`` step on the batch with its vision
    embeddings: the reference's loss, ``grad_norm`` and ``lr``; the new
    parameters those of ``adamw_update`` on the step's own gradients, bit
    for bit."""
    model = _model(ref)
    batch = _batches(ref)[1]
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
    assert abs(metrics["grad_norm"].item() - grads["grad_norm"]) <= \
        LOSS_RTOL * grads["grad_norm"]
    assert abs(metrics["lr"].item() - grads["lr"]) <= 1e-6 * 3e-3
    assert int(new["opt"]["step"]) == 1
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k


def test_vlm_loss_never_sees_the_token_it_scores_in_both_packages(ref):
    """The reference's VLM loss runs the forward on tokens[:, :-1] and
    scores x[:, tv - 1 : tv - 1 + S - 1] against tokens[:, 1:]: position
    tv - 1 + j has seen tokens 0..j-1 and is scored against token j + 1,
    so the last input token is scored (as a label) but never seen. In both
    packages, changing it leaves the scored hidden states unchanged bit
    for bit and moves the loss."""
    jm, model, cfg = ref["jm"], _model(ref), ref["cfg"]
    tv, S = cfg.vision_tokens, T + STEPS + 1
    other = ref["toks"].copy()
    other[:, S - 2] = (other[:, S - 2] + 1) % cfg.vocab_size
    jfwd = jax.jit(jm.forward)
    jloss = jax.jit(lambda t: jm.loss(ref["params"], {
        "tokens": t, "vision_embeds": jnp.asarray(ref["ve"])})[0])
    scored, losses = [], []
    for toks in (ref["toks"], other):
        jx, _ = jfwd(ref["params"], jnp.asarray(toks[:, :-1]),
                     jnp.asarray(ref["ve"]))
        with torch.no_grad():
            tx, _ = model.forward(torch.tensor(toks[:, :-1]),
                                  torch.tensor(ref["ve"]))
            tl, _ = model.loss({"tokens": torch.tensor(toks),
                                "vision_embeds": torch.tensor(ref["ve"])})
        scored.append((np.asarray(jx)[:, tv - 1:tv - 1 + S - 1],
                       tx[:, tv - 1:tv - 1 + S - 1]))
        losses.append((float(jloss(jnp.asarray(toks, jnp.int32))),
                       tl.item()))
    (j0, t0), (j1, t1) = scored
    assert np.array_equal(j0, j1) and torch.equal(t0, t1)
    assert losses[0][0] != losses[1][0] and losses[0][1] != losses[1][1]


def test_zero_vision_stub_overflows_gradients_in_both_packages(ref):
    """The launchers' zero ``vision_embeds`` (the reference's stub) at
    InternVL2-2B's 24 layers, smoke widths, float32: every vision
    position's residual stream stays exactly zero, where ``rms_norm``'s
    gradient is 1 / sqrt(eps) = 1000 at each of a layer's two norms, so
    the gradient reaching those positions overflows float32 (past ~17
    layers) and NaNs reach the embedding's and the early layers'
    gradients, in both packages, while the loss is finite. Seeded
    embeddings at the token embeddings' scale give finite gradients in
    both."""
    jcfg, cfg = (c.replace(num_layers=24) for c in (ref["jcfg"], ref["cfg"]))
    jm = jbuild_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = _model(ref, cfg, jax.tree.map(np.asarray, params))
    seeded = (cfg.d_model ** -0.5 * np.random.default_rng(2).standard_normal(
        ref["ve"].shape)).astype(np.float32)
    jgrad = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)[0]))
    for ve, finite in ((np.zeros_like(ref["ve"]), False), (seeded, True)):
        jloss, jg = jgrad(params, {"tokens": jnp.asarray(ref["toks"]),
                                   "vision_embeds": jnp.asarray(ve)})
        loss, _ = model.loss({"tokens": torch.tensor(ref["toks"]),
                              "vision_embeds": torch.tensor(ve)})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert np.isfinite(float(jloss)) and torch.isfinite(loss)
        assert all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(jg)) == finite
        assert all(bool(torch.isfinite(g).all()) for g in grads) == finite
        assert bool(jnp.isfinite(jg["embed"]).all()) == finite
        assert bool(torch.isfinite(grads[0]).all()) == finite


def test_pad_kv_to_raises_where_it_used_to_crop(ref):
    """A cache longer than ``max_seq`` raises in the port as ``jnp.pad``'s
    negative width raises in the reference; a VLM prefill whose vision
    prefix and prompt do not fit raises."""
    x = torch.zeros((2, 5, 3))
    assert pad_kv_to(x, 7).shape == (2, 7, 3)
    with pytest.raises(ValueError, match="max_seq 4"):
        pad_kv_to(x, 4)
    with pytest.raises(ValueError):
        jpad_kv_to(np.zeros((2, 5, 3), np.float32), 4)
    model = _model(ref)
    with pytest.raises(ValueError, match="does not fit"), \
            torch.inference_mode():
        model.prefill({"tokens": torch.tensor(ref["toks"][:, :T]),
                       "vision_embeds": torch.tensor(ref["ve"])}, T + 4)


def test_launchers_serve_and_train_the_vlm_on_cpu(capsys, monkeypatch):
    """``--arch internvl2-2b`` in both launchers (the stub's zero vision
    embeddings added to each batch); without ``--device`` they take the
    card and raise without one."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--carbon-aware", "--rounds", "1", "--gen", "2",
                 "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "admitted batch=" in out and "tok/s" in out
    res = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--log-every", "2"])
    assert len(res) == 2 and all(np.isfinite(res))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", ARCH, "--smoke", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", ARCH, "--smoke", "--steps", "1"])
