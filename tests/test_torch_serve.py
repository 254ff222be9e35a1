"""Carbon-aware serving: the port's ``CarbonGate`` and ``serve`` against
the JAX package's gate and its serving loop (``repro.launch.serve``), at
smoke sizes in float32 on the CPU.

The gate's capacity and intensity agree to 1e-6 relative (the grid day
comes from the port's threefry stream, bitwise the reference's). ``serve``
with the JAX model's weights (``convert.model_params_from_numpy``) admits
the same batch sizes, returns logits within 1e-4 of the largest, and picks
the same greedy tokens wherever the reference's top-2 margin exceeds that
gap (a closer call may fall either way, and the rows then differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.train import CarbonGate as JCarbonGate
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve as S
from repro_torch.models import build_model

RTOL = 1e-4


@pytest.mark.parametrize("seed", (0, 5))
def test_carbon_gate_matches_reference(seed):
    want, got = JCarbonGate(seed), S.CarbonGate(seed)
    for name in ("intensity", "capacity"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.shape == (24,)
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), name
    # the admitted batch of round r, as the reference's loop computes it
    for r in range(30):
        cap = want.capacity[r % 24]
        assert got.admitted(r, 7) == max(1, int(round(7 * min(cap, 1.5))))


def _reference_loop(jm, params, cfg, *, batch, prompt_len, gen, rounds):
    """``repro.launch.serve.main``'s loop with the given weights: admitted
    batch sizes, and per round the logits of every call. A VLM's batch
    gets zero ``vision_embeds`` and decodes from prompt_len +
    vision_tokens, an encoder-decoder's gets zero ``frames``
    (``serve.py:57-66``)."""
    gate = JCarbonGate()
    rng = np.random.RandomState(0)
    max_seq = prompt_len + gen + 8
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, max_seq))
    decode = jax.jit(jm.decode_step)
    batches, logits = [], []
    for r in range(rounds):
        bsz = max(1, int(round(batch * min(gate.capacity[r % 24], 1.5))))
        toks = rng.randint(1, cfg.vocab_size,
                           size=(bsz, prompt_len)).astype(np.int32)
        inputs = {"tokens": jnp.asarray(toks)}
        if cfg.family == "vlm":
            inputs["vision_embeds"] = jnp.zeros(
                (bsz, cfg.vision_tokens, cfg.d_model), jnp.dtype(cfg.dtype))
        if cfg.family == "encdec":
            inputs["frames"] = jnp.zeros(
                (bsz, cfg.encoder_seq, cfg.d_model), jnp.dtype(cfg.dtype))
        lg, cache = prefill(params, inputs)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        kept = [np.asarray(lg)]
        pos0 = prompt_len + (cfg.vision_tokens if cfg.family == "vlm"
                             else 0)
        for i in range(gen):
            lg, cache = decode(params, cache, tok,
                               jnp.asarray(pos0 + i, jnp.int32))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            kept.append(np.asarray(lg))
        batches.append(bsz)
        logits.append(kept)
    return batches, logits


# Gemma2's smoke window is 16 keys: a 24-token prompt makes it bind in the
# prefill (queries 16..23) and at every decode step (positions 24..27)
PROMPTS = {"gemma2-9b": 24}


@pytest.mark.parametrize("arch", ("zamba2-7b", "qwen3-0.6b",
                                  "deepseek-moe-16b", "internvl2-2b",
                                  "whisper-base", "yi-6b", "gemma2-9b",
                                  "deepseek-67b"))
def test_serve_matches_reference_loop(arch):
    kw = dict(batch=3, prompt_len=PROMPTS.get(arch, 12), gen=4, rounds=2)
    jcfg = jget_arch(arch).smoke.replace(dtype="float32", remat="none")
    cfg = get_arch(arch).smoke.replace(dtype="float32", remat="none")
    if cfg.attn is not None and cfg.attn.pattern == "local_global":
        assert cfg.attn.window < kw["prompt_len"]     # the window binds
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu"))
    want_batches, want_logits = _reference_loop(jm, params, jcfg, **kw)
    got = S.serve(arch, smoke=True, device="cpu", carbon_aware=True,
                  model=model, keep_logits=True, **kw)
    assert got.batches == want_batches
    assert len(got.tokens) == kw["rounds"] and got.tokens_per_s > 0
    for r, (tl, jl) in enumerate(zip(got.logits, want_logits)):
        assert got.tokens[r].shape == (want_batches[r], kw["gen"] + 1)
        for step, (t, j) in enumerate(zip(tl, jl)):
            t = t.numpy()
            gap = np.abs(t - j).max()
            assert gap <= RTOL * np.abs(j).max(), (arch, r, step, gap)
            top2 = np.sort(j, -1)[:, -2:]
            decided = (top2[:, 1] - top2[:, 0]) > gap
            tok = got.tokens[r][:, step].numpy()
            assert (tok == j.argmax(-1))[decided].all(), (arch, r, step)
            if not decided.all():   # a tie: the rows follow other tokens
                break


def test_cli_runs_on_cpu_and_defaults_to_the_card(monkeypatch, capsys):
    S.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
            "--carbon-aware", "--rounds", "1", "--gen", "2",
            "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "admitted batch=" in out and "tok/s" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.main(["--smoke", "--rounds", "1"])
