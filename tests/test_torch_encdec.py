"""The encoder-decoder family against the JAX package at
``whisper-base-smoke`` in float32 on the CPU: ``sinusoidal_positions``,
``EncDecLM``'s ``encode`` and ``decode_full`` (with every layer's self and
cross keys and values), the prefill plus four decode steps with the
``self_*`` and ``cross_*`` caches, the loss, its metrics and every
gradient leaf, one train step, a bf16 prefill, ``convert``'s refusal of a
wrong layer count, and both launchers on the CPU.

The weights are the JAX model's own init, carried across by
``convert.model_params_from_numpy``; tokens and frames come from numpy
with a seed.

Tolerances (the classes of ``test_torch_models.py`` and
``test_torch_train_model.py``): positions, hidden states, logits and
cache entries within 1e-4 of the largest |value|; the loss and its
metrics within 1e-5 relative, every gradient leaf within 1e-4 of its
largest |value|; in bfloat16 the prefill's logits within 2e-2 of the
largest (``-s`` prints the JAX package's own bf16-vs-float32 gap beside
the port's gap to it).
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
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.model import prompt_start, stub_inputs
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.training import init_train_state, make_train_step

RTOL = 1e-4
LOSS_RTOL = 1e-5
ARCH = "whisper-base"
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
    JAX tree and as numpy), tokens, frames and the compiled reference
    calls."""
    jcfg = jget_arch(ARCH).smoke.replace(dtype="float32", remat="none")
    cfg = get_arch(ARCH).smoke.replace(dtype="float32", remat="none")
    assert cfg.family == "encdec"
    jm = jbuild_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, T + STEPS + 1))
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                 ).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, params=params,
                np_params=jax.tree.map(np.asarray, params), toks=toks,
                frames=frames, prefill=jax.jit(jm.prefill, static_argnums=2),
                decode=jax.jit(jm.decode_step))


def _model(ref, cfg=None, params=None):
    cfg = cfg or ref["cfg"]
    model = build_model(cfg, "cpu")
    assert isinstance(model, EncDecLM)
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, ref["np_params"] if params is None else params, "cpu"),
        strict=True)
    return model


@pytest.mark.parametrize("n,d", [(1500, 512), (30, 64), (7, 5)])
def test_sinusoidal_positions_match_reference(n, d):
    """Whisper-base's 1,500 encoder positions at d_model 512, the smoke
    config's, and an odd width (d // 2 frequencies each way)."""
    pos = np.arange(n)
    got = L.sinusoidal_positions(torch.tensor(pos), d)
    assert got.dtype == torch.float32
    _close(jL.sinusoidal_positions(jnp.asarray(pos), d), got,
           f"sinusoidal {n} x {d}")
    # bf16 positions ask for float32 arithmetic all the same
    _close(jL.sinusoidal_positions(jnp.asarray(pos, jnp.bfloat16), d),
           L.sinusoidal_positions(torch.tensor(pos).to(torch.bfloat16), d),
           "bf16 positions")


def test_stub_frames_and_prompt_start():
    cfg = get_arch(ARCH).config
    assert (cfg.encoder_layers, cfg.encoder_seq) == (6, 1500)
    extra = stub_inputs(get_arch(ARCH).smoke, 3, "cpu")
    assert set(extra) == {"frames"} and not extra["frames"].any()
    assert extra["frames"].shape == (3, 30, 64)
    assert prompt_start(cfg) == 0


@pytest.fixture(scope="module")
def encoded(ref):
    """The reference's ``encode`` and ``decode_full`` (with each layer's
    self and cross keys and values) on the smoke batch."""
    jm, p = ref["jm"], ref["params"]

    def run(frames, toks):
        enc = jm.encode(p, frames)
        return enc, jm.decode_full(p, toks, enc, collect_kv=True)

    return jax.jit(run)(jnp.asarray(ref["frames"]),
                        jnp.asarray(ref["toks"][:, :T]))


def test_encode_matches_reference(ref, encoded):
    model = _model(ref)
    with torch.no_grad():
        _close(encoded[0], model.encode(torch.tensor(ref["frames"])),
               "encode")


def test_decode_full_matches_reference(ref, encoded):
    """The decoder over T tokens attending the reference's own encoder
    output: the hidden states and each layer's self and cross (k, v)."""
    model = _model(ref)
    jenc, (jx, ((jsk, jsv), (jck, jcv))) = encoded
    with torch.no_grad():
        x, skvs, ckvs = model.decode_full(torch.tensor(ref["toks"][:, :T]),
                                          torch.tensor(np.asarray(jenc)),
                                          collect_kv=True)
        _close(jx, x, "decode_full")
        for i in range(ref["cfg"].num_layers):
            for name, j, t in (("self k", jsk, skvs[i][0]),
                               ("self v", jsv, skvs[i][1]),
                               ("cross k", jck, ckvs[i][0]),
                               ("cross v", jcv, ckvs[i][1])):
                _close(j[i], t, f"layer {i} {name}")
        _close(jx, model.decode_full(torch.tensor(ref["toks"][:, :T]),
                                     torch.tensor(np.asarray(jenc))),
               "decode_full, no kv")


def test_prefill_and_four_decode_steps_match_reference(ref):
    """The prefill of the frames and T tokens, then four decode steps:
    every call's logits and the self and cross caches after it."""
    model, params = _model(ref), ref["params"]
    toks, max_seq = ref["toks"], T + 8
    jl, jc = ref["prefill"](params, {"tokens": jnp.asarray(toks[:, :T]),
                                     "frames": jnp.asarray(ref["frames"])},
                            max_seq)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks[:, :T]),
                                "frames": torch.tensor(ref["frames"])},
                               max_seq)
        empty = model.init_cache(B, max_seq)
    assert set(tc) == set(jc) == set(empty) == {"self_k", "self_v",
                                                 "cross_k", "cross_v"}
    _close(jl, tl, "prefill logits")
    for i in range(STEPS + 1):
        for k in jc:
            assert empty[k].shape == tc[k].shape and \
                empty[k].dtype == tc[k].dtype, k
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
    """The JAX init in bf16 (layer norms float32) on both sides, bf16
    frames: the prefill's logits and its caches."""
    jcfg, cfg = (c.replace(dtype="bfloat16") for c in (ref["jcfg"],
                                                       ref["cfg"]))
    jm = jbuild_model(jcfg)
    params = jax.tree.map(lambda s, a: a.astype(s.dtype),
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          ref["params"])
    model = _model(ref, cfg, jax.tree.map(np.asarray, params))
    assert model.embed.dtype == torch.bfloat16
    assert model.enc_norm["scale"].dtype == torch.float32
    toks, frames = ref["toks"][:, :T], ref["frames"]
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks),
                 "frames": jnp.asarray(frames, jnp.bfloat16)}, T + 8)
    with torch.inference_mode():
        tl, tc = model.prefill({"tokens": torch.tensor(toks),
                                "frames": torch.tensor(frames).to(
                                    torch.bfloat16)}, T + 8)
    _close(jl, tl, "bf16 prefill logits", 2e-2)
    for k in jc:
        assert tc[k].dtype == torch.bfloat16
        _close(jc[k], tc[k], f"bf16 cache {k}", 2e-2)
    j32, _ = ref["prefill"](ref["params"], {
        "tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, T + 8)
    j16, j32 = _np(jl), _np(j32)
    print(f"bf16 prefill logits, largest gap / max|logit|: the JAX "
          f"package's bf16 vs its float32 "
          f"{np.abs(j16 - j32).max() / np.abs(j32).max():.3e}, the port's "
          f"bf16 vs the JAX package's "
          f"{np.abs(tl.float().numpy() - j16).max() / np.abs(j16).max():.3e}")


def _batches(ref):
    toks, frames = ref["toks"], ref["frames"]
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "frames": jnp.asarray(frames)},
            {"tokens": torch.tensor(toks), "frames": torch.tensor(frames)})


@pytest.fixture(scope="module")
def grads(ref):
    """The reference's loss, metrics and gradients, and the first AdamW
    update's metrics."""
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
    assert "aux_loss" not in metrics
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
    """One ``make_train_step`` step on tokens and frames: the reference's
    loss, ``grad_norm`` and ``lr``; the new parameters those of
    ``adamw_update`` on the step's own gradients, bit for bit."""
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


@pytest.mark.parametrize("field", ("encoder_layers", "num_layers"))
def test_convert_rejects_a_wrong_layer_count(ref, field):
    """A JAX tree whose ``enc_stack`` (``dec_stack``) does not hold the
    config's encoder (decoder) layers is refused."""
    cfg = ref["cfg"].replace(**{field: 3})
    name = "enc_stack" if field == "encoder_layers" else "dec_stack"
    with pytest.raises(ValueError, match=f"{name}.*layers"):
        convert.model_params_from_numpy(cfg, ref["np_params"])


def test_launchers_serve_and_train_whisper_on_cpu(capsys, monkeypatch):
    """``--arch whisper-base`` in both launchers (the stub's zero frames
    added to each batch); without ``--device`` they take the card and
    raise without one."""
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
