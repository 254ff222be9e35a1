"""RWKV6 against the JAX package at ``rwkv6-7b-smoke`` in float32 on the
CPU: the layer norms, the time and channel mixes (with and without carried
state, and their decode steps), ``RWKVLM``'s forward, prefill plus four
decode steps with every cache leaf, the loss and every gradient leaf, one
train step, and ``serve`` against the reference's serving loop; and the
model's gradients through ``ops.GLAScan`` (built with the plain forward)
against plain autograd.

The weights are the port's seed-0 init with every all-zero leaf (the LoRA
second factors, the norms' biases) replaced by a seeded normal draw, so
every product of the mixers carries signal; one numpy tree feeds both
sides (``convert.model_params_from_numpy`` for the port).

Tolerances, the classes of ``test_torch_models.py`` and
``test_torch_train_model.py``: outputs, logits and cache entries within
1e-4 of the largest |value| (both sides float32, sums in another order);
the loss and the step's metrics within 1e-5 relative, every gradient leaf
within 1e-4 of its largest |value|; the GLAScan gradients bit for bit. In
bfloat16 the prefill's logits within 2e-2 of the largest (the two
frameworks round bf16 operations at other places): here bf16 moves the
JAX package's own logits by 8.2e-3 of the largest from float32, and the
port's bf16 logits sit 6.5e-3 from JAX's (``-s`` prints both). Full
width in bf16 is held on the card (``chip_smoke.py``: decode against
prefill, 5e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.models import layers as jL
from repro.models import ssm as jS
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import global_norm as jglobal_norm
from repro.optim import schedule as jschedule
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.linear_scan import ops as gla_ops
from repro_torch.kernels.linear_scan import ref as gla_ref
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import RWKVLM
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.training import init_train_state, make_train_step

RTOL = 1e-4
LOSS_RTOL = 1e-5
ARCH = "rwkv6-7b"
B, T, STEPS = 2, 11, 4


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


@pytest.fixture(scope="module")
def ref():
    """The float32 smoke config on both sides, the shared numpy params
    (as a JAX tree), a token batch and the compiled reference calls."""
    jcfg = jget_arch(ARCH).smoke.replace(dtype="float32", remat="none")
    cfg = get_arch(ARCH).smoke.replace(dtype="float32", remat="none")
    jm = jbuild_model(jcfg)
    state = {k: v.numpy() for k, v in
             build_model(cfg, "cpu", seed=0).state_dict().items()}
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        keys = [k.key for k in path]
        out = np.empty(leaf.shape, np.float32)
        for idx in np.ndindex(*leaf.shape[:convert.STACKED.get(keys[0], 0)]):
            out[idx] = state[".".join([keys[0], *map(str, idx), *keys[1:]])]
        if not out.any():
            out = (0.1 * rng.standard_normal(out.shape)).astype(np.float32)
        return jnp.asarray(out)

    params = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    toks = rng.integers(0, cfg.vocab_size, (B, T + STEPS + 1))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, params=params,
                np_params=jax.tree.map(np.asarray, params), toks=toks,
                prefill=jax.jit(jm.prefill, static_argnums=2),
                decode=jax.jit(jm.decode_step))


def _model(ref):
    model = build_model(ref["cfg"], "cpu")
    assert isinstance(model, RWKVLM)
    model.load_state_dict(convert.model_params_from_numpy(
        ref["cfg"], ref["np_params"], "cpu"), strict=True)
    return model


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ------------------------------------------------------------------ layers

def test_layer_norms_match_reference():
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 7, 4, 16)) + 1).astype(np.float32)
    s, b = (rng.standard_normal((2, 4, 16)).astype(np.float32)
            for _ in range(2))
    tx = torch.tensor(x)
    _close(jL.layer_norm(x, s[0, 0], b[0, 0], 1e-5),
           L.layer_norm(tx, torch.tensor(s[0, 0]), torch.tensor(b[0, 0]),
                        1e-5), "layer_norm")
    _close(jL.group_norm_heads(x, s[0], b[0], 1e-5),
           L.group_norm_heads(tx, torch.tensor(s[0]), torch.tensor(b[0]),
                              1e-5), "group_norm_heads")
    # bf16 in, bf16 out: computed in float32 and cast back
    xb = torch.tensor(x).to(torch.bfloat16)
    yb = L.layer_norm(xb, torch.tensor(s[0, 0]), torch.tensor(b[0, 0]))
    assert yb.dtype == torch.bfloat16
    ln = L.init_ln(16, device="cpu", shape=(4, 16))
    assert ln["scale"].shape == (4, 16) and ln["scale"].dtype == torch.float32
    assert (ln["scale"] == 1).all() and not ln["bias"].any()


# ------------------------------------------------------------------ mixers

@pytest.fixture(scope="module")
def mixers(ref):
    """Inputs (numpy, from a seed) and the reference's mixer outputs for
    both cases, compiled as one call: ``apply_rwkv_tmix`` /
    ``apply_rwkv_cmix`` over 13 tokens from zero states or from carried
    shift and wkv states, returning their states, then two decode steps
    from those states."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    H, hd = S.rwkv_dims(cfg)
    rng = np.random.default_rng(4)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    xs = dict(x=draw(B, 13, cfg.d_model), sh=draw(B, 1, cfg.d_model),
              wkv=draw(B, H, hd, hd), x1=draw(2, B, 1, cfg.d_model))

    def run(lp, x, sh, wkv, x1):
        out = {}
        for with_state in (False, True):
            kw = dict(shift_state=sh, wkv_state=wkv) if with_state else {}
            y, (st, w) = jS.apply_rwkv_tmix(lp["tmix"], jcfg, x,
                                            return_state=True, **kw)
            ckw = {"shift_state": sh} if with_state else {}
            yc, sc = jS.apply_rwkv_cmix(lp["cmix"], jcfg, x,
                                        return_state=True, **ckw)
            steps, st0, w0 = [], st, w
            for t in range(2):
                y1, st, w = jS.apply_rwkv_tmix_decode(lp["tmix"], jcfg,
                                                      x1[t], st, w)
                yc1, sc = jS.apply_rwkv_cmix_decode(lp["cmix"], jcfg, x1[t],
                                                    sc)
                steps.append((y1, w, yc1))
            out[with_state] = dict(tmix=y, shift_t0=st0, wkv0=w0, cmix=yc,
                                   shift_t=st, shift_c=sc, steps=steps)
        return out

    return xs, jax.jit(run)(_layer0(ref["params"]["stack"]),
                            *(jnp.asarray(xs[k]) for k in ("x", "sh", "wkv",
                                                            "x1")))


@pytest.mark.parametrize("with_state", (False, True))
def test_rwkv_mixers_match_reference(ref, mixers, with_state):
    """``apply_rwkv_tmix`` / ``apply_rwkv_cmix`` over 13 tokens (from zero
    states, or from carried shift and wkv states), returning their states,
    then two decode steps from those states."""
    xs, full = mixers
    want = full[with_state]
    layer = _model(ref).stack[0]
    tx = torch.tensor(xs["x"])
    tkw = dict(shift_state=torch.tensor(xs["sh"]),
               wkv_state=torch.tensor(xs["wkv"])) if with_state else {}
    y, (sh_t, wkv) = layer.tmix(tx, return_state=True, **tkw)
    _close(want["tmix"], y, "tmix")
    _close(want["shift_t0"], sh_t, "tmix shift state")
    _close(want["wkv0"], wkv, "wkv state")
    tckw = {"shift_state": tkw["shift_state"]} if with_state else {}
    yc, sh_c = layer.cmix(tx, return_state=True, **tckw)
    _close(want["cmix"], yc, "cmix")
    for t, (jy, jwkv, jyc) in enumerate(want["steps"]):
        tx1 = torch.tensor(xs["x1"][t])
        y, sh_t, wkv = layer.tmix.decode(tx1, sh_t, wkv)
        _close(jy, y, f"tmix decode {t}")
        _close(jwkv, wkv, f"wkv state {t}")
        yc, sh_c = layer.cmix.decode(tx1, sh_c)
        _close(jyc, yc, f"cmix decode {t}")
        assert torch.equal(sh_t, tx1) and torch.equal(sh_c, tx1)
    _close(want["shift_t"], sh_t, "tmix shift state after decode")
    _close(want["shift_c"], sh_c, "cmix shift state after decode")


# ------------------------------------------------------------------ model

def test_forward_matches_reference(ref):
    jm, model = ref["jm"], _model(ref)
    toks = ref["toks"][:, :T]
    jx, jst = jax.jit(lambda p, t: jm.forward(p, t, collect=True))(
        ref["params"], jnp.asarray(toks))
    x, st = model.forward(torch.tensor(toks), collect=True)
    _close(jx, x, "forward")
    for name, j, t in zip(("shift_t", "wkv", "shift_c"), jst, st):
        _close(j, t, name)
    _close(jx, model.forward(torch.tensor(toks)), "forward, no states")


def test_prefill_and_four_decode_steps_match_reference(ref):
    model = _model(ref)
    toks, params = ref["toks"], ref["params"]
    jl, jc = ref["prefill"](params, {"tokens": jnp.asarray(toks[:, :T])},
                            T + 8)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks[:, :T])}, T + 8)
        empty = model.init_cache(B, T + 8)
    assert set(tc) == set(jc) == set(empty)
    for k in jc:
        assert empty[k].shape == tc[k].shape and empty[k].dtype == \
            tc[k].dtype, k
    assert tc["wkv"].dtype == torch.float32
    _close(jl, tl, "prefill logits")
    for i in range(STEPS + 1):
        for k in jc:
            _close(jc[k], tc[k], f"cache {k} after {i} steps")
        if i == STEPS:
            break
        tok = toks[:, T + i]
        jl, jc = ref["decode"](params, jc, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(T + i, jnp.int32))
        with torch.inference_mode():
            tl, tc = model.decode_step(tc, torch.tensor(tok), T + i)
        _close(jl, tl, f"decode {i} logits")


def test_bfloat16_prefill_matches_reference(ref):
    """The shared weights in bf16 (the float32 leaves stay float32, as in
    the reference's init): the prefill's logits and its wkv state."""
    jcfg = ref["jcfg"].replace(dtype="bfloat16")
    cfg = ref["cfg"].replace(dtype="bfloat16")
    jm = jbuild_model(jcfg)
    params = jax.tree.map(lambda s, a: a.astype(s.dtype),
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          ref["params"])
    model = build_model(cfg, "cpu")
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu"), strict=True)
    assert model.stack[0].tmix.wr.dtype == torch.bfloat16
    assert model.stack[0].tmix.u.dtype == torch.float32
    toks = ref["toks"][:, :T]
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks)}, T + 8)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks)}, T + 8)
    assert tc["wkv"].dtype == torch.float32
    assert tc["shift_t"].dtype == torch.bfloat16
    _close(jl, tl, "bf16 prefill logits", 2e-2)
    _close(jc["wkv"], tc["wkv"], "bf16 wkv state", 2e-2)
    j32, _ = ref["prefill"](ref["params"], {"tokens": jnp.asarray(toks)},
                            T + 8)
    j16, j32 = (np.asarray(jnp.asarray(a).astype(jnp.float32))
                for a in (jl, j32))
    scale = np.abs(j32).max()
    own = np.abs(j16 - j32).max() / scale
    port = np.abs(tl.float().numpy() - j16).max() / np.abs(j16).max()
    print(f"bf16 prefill logits, largest gap / max|logit|: the JAX "
          f"package's bf16 vs its float32 {own:.3e}, the port's bf16 vs "
          f"the JAX package's {port:.3e}")


@pytest.fixture(scope="module")
def grads(ref):
    """The reference's loss, metrics and gradients on 2 x 16 tokens, and
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


def test_loss_and_gradients_match_reference(ref, grads):
    model = _model(ref)
    loss, metrics = model.loss({"tokens": torch.tensor(ref["toks"])})
    assert abs(loss.item() - grads["loss"]) <= LOSS_RTOL * abs(grads["loss"])
    assert set(metrics) == set(grads["metrics"])
    for k, v in grads["metrics"].items():
        assert abs(metrics[k].item() - v) <= LOSS_RTOL * max(abs(v), 1e-6), k
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss, list(params.values()))
    want = convert.model_params_from_numpy(ref["cfg"], grads["grads"], "cpu")
    assert set(want) == set(params)
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
    assert abs(metrics["grad_norm"].item() - grads["grad_norm"]) <= \
        LOSS_RTOL * grads["grad_norm"]
    assert abs(metrics["lr"].item() - grads["lr"]) <= 1e-6 * 3e-3
    assert int(new["opt"]["step"]) == 1
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k


def test_gradients_through_glascan_equal_plain_autograd(ref, monkeypatch):
    """The model's RWKV6 scans through ``ops.GLAScan`` with the plain
    forward (the card's wiring: q, k, v, the float32 per-channel decay and
    the bonus ``u``, a parameter, strict): the loss and every gradient
    leaf bit for bit plain autograd's."""
    model = _model(ref)
    batch = {"tokens": torch.tensor(ref["toks"])}
    loss, _ = model.loss(batch)
    want = torch.autograd.grad(loss, list(model.parameters()))
    calls = []

    def through_function(q, k, v, log_decay, *, bonus=None, strict=False,
                         chunk=64, initial_state=None):
        calls.append((bonus is not None, strict, log_decay.dtype))
        return gla_ops.GLAScan.apply(q, k, v, log_decay, bonus,
                                     initial_state, gla_ref.gla_chunked,
                                     dict(strict=strict, chunk=chunk))

    monkeypatch.setattr(S.gla_ops, "gla", through_function)
    loss2, _ = model.loss(batch)
    got = torch.autograd.grad(loss2, list(model.parameters()))
    assert calls == [(True, True, torch.float32)] * ref["cfg"].num_layers
    assert torch.equal(loss, loss2)
    names = [k for k, _ in model.named_parameters()]
    for k, a, b in zip(names, got, want):
        assert torch.equal(a, b), k


def test_serve_matches_reference_loop(ref):
    """``serve(arch="rwkv6-7b", smoke=True, device="cpu")`` with the shared
    weights against the reference's loop (its ``prefill`` and
    ``decode_step`` from the same prompts, greedy): every call's logits,
    and the greedy tokens wherever the reference's top two differ by more
    than the gap."""
    kw = dict(batch=B, prompt_len=T, gen=STEPS, rounds=2)
    got = tserve.serve(ARCH, smoke=True, device="cpu", model=_model(ref),
                       keep_logits=True, verbose=False, **kw)
    rng = np.random.RandomState(0)
    for r in range(kw["rounds"]):
        toks = rng.randint(1, ref["cfg"].vocab_size, size=(B, T))
        lg, cache = ref["prefill"](ref["params"],
                                   {"tokens": jnp.asarray(toks)}, T + 8)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        want = [np.asarray(lg)]
        for i in range(STEPS):
            lg, cache = ref["decode"](ref["params"], cache, tok,
                                      jnp.asarray(T + i, jnp.int32))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            want.append(np.asarray(lg))
        assert got.tokens[r].shape == (B, STEPS + 1)
        for step, (t, j) in enumerate(zip(got.logits[r], want)):
            gap = np.abs(t.numpy() - j).max()
            assert gap <= RTOL * np.abs(j).max(), (r, step, gap)
            top2 = np.sort(j, -1)[:, -2:]
            decided = (top2[:, 1] - top2[:, 0]) > gap
            assert (got.tokens[r][:, step].numpy()
                    == j.argmax(-1))[decided].all(), (r, step)
            if not decided.all():
                break


def test_cli_serves_and_trains_rwkv_on_cpu(capsys, tmp_path):
    """``--arch rwkv6-7b`` runs with no new flag in both launchers."""
    from repro_torch.launch import train as ttrain
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--carbon-aware", "--rounds", "1", "--gen", "2",
                 "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "admitted batch=" in out and "tok/s" in out
    res = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--log-every", "2", "--ckpt-dir", str(tmp_path)])
    assert len(res) == 2 and all(np.isfinite(res))
