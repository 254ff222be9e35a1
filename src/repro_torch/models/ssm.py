"""Recurrent mixers: Mamba2 (Zamba2's backbone) and RWKV6's time and
channel mixes. The counterpart of ``repro.models.ssm``.

Both reduce to the chunked gated linear attention of
``kernels.linear_scan``. Mamba2: a scalar per-head decay
``exp(-dt exp(A_log))``, dt folded into v, B and C broadcast over the heads
(a stride-0 ``expand``, never a copy). RWKV6: a per-channel decay
``exp(-exp(w0 + LoRA(x)))`` in float32, the bonus ``u`` on the current
token and the strict mode (a token sees the state before its own update).
A prefill runs the scan (kernel #5 on the card: ``gla_ssd.cu`` for bf16
Mamba2, ``gla_vec.cu`` for bf16 RWKV6, ``gla_scan.cu``, split TF32 on the
tensor cores, in float32), a
decode step the plain ``gla_step``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.linear_scan import ops as gla_ops
from repro_torch.models import layers as L

f32 = torch.float32


def mamba_dims(cfg):
    s = cfg.ssm
    E = s.expand * cfg.d_model
    H = E // s.head_dim
    conv_dim = E + 2 * s.state_dim
    return E, H, conv_dim


def mamba_state_shapes(cfg, batch: int):
    """(conv state, ssm state) shapes of one layer's decode cache."""
    s = cfg.ssm
    E, H, conv_dim = mamba_dims(cfg)
    return ((batch, s.conv_width - 1, conv_dim),
            (batch, H, s.state_dim, s.head_dim))


class Mamba2(nn.Module):
    """``init_mamba`` / ``apply_mamba`` / ``apply_mamba_decode``."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        s = cfg.ssm
        D = cfg.d_model
        E, H, conv_dim = mamba_dims(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H,
                                      dtype=f32, device=device))
        self.w_in = L.param(L.dense_init((D, 2 * E + 2 * s.state_dim + H),
                                         (0,), dtype, **kw))
        self.conv_w = L.param(L.dense_init((s.conv_width, conv_dim), (0,),
                                           dtype, **kw))
        self.conv_b = L.param(torch.zeros((conv_dim,), dtype=dtype,
                                          device=device))
        self.A_log = L.param(torch.log(torch.linspace(1.0, 16.0, H,
                                                      dtype=f32,
                                                      device=device)))
        self.dt_bias = L.param(torch.log(torch.expm1(dt)))
        self.D_skip = L.param(torch.ones((H,), dtype=f32, device=device))
        self.norm = L.param(L.init_rms(E, device=device))
        self.w_out = L.param(L.dense_init((E, D), (0,), dtype, **kw))

    def _proj(self, x):
        s = self.cfg.ssm
        E, H, _ = mamba_dims(self.cfg)
        N = s.state_dim
        zxbcdt = x @ self.w_in
        return torch.split(zxbcdt, [E, E, N, N, H], dim=-1)

    def _causal_conv(self, conv_in, conv_state):
        """conv_in: (B, S, Cd); conv_state: (B, cw - 1, Cd) -> (out, new
        state)."""
        cw = self.cfg.ssm.conv_width
        full = torch.cat([conv_state.to(conv_in.dtype), conv_in], 1)
        S = conv_in.shape[1]
        out = sum(full[:, i:i + S] * self.conv_w[i][None, None]
                  for i in range(cw))
        out = F.silu(out + self.conv_b[None, None])
        return out, full[:, -(cw - 1):]

    def _ssm_inputs(self, xc, Bc, Cc, dt):
        s = self.cfg.ssm
        E, H, _ = mamba_dims(self.cfg)
        x = dt.to(f32) + self.dt_bias
        dt = torch.logaddexp(x, torch.zeros_like(x))     # softplus
        log_decay = -torch.exp(self.A_log) * dt                  # (B, S, H)
        xh = xc.reshape(xc.shape[:-1] + (H, s.head_dim))
        v = xh * dt[..., None].to(xh.dtype)
        k = Bc[..., None, :].expand(Bc.shape[:-1] + (H, s.state_dim))
        q = Cc[..., None, :].expand(Cc.shape[:-1] + (H, s.state_dim))
        return q, k, v, log_decay, xh

    def _out(self, o, xh, z):
        E, H, _ = mamba_dims(self.cfg)
        o = o + (self.D_skip[..., None] * xh.to(f32)).to(o.dtype)
        o = o.reshape(o.shape[:-2] + (E,))
        o = L.rms_norm(o * F.silu(z), self.norm, self.cfg.norm_eps)
        return o @ self.w_out

    def _split_conv(self, conv_out):
        E, N = self.cfg.ssm.expand * self.cfg.d_model, self.cfg.ssm.state_dim
        return torch.split(conv_out, [E, N, N], dim=-1)

    def forward(self, x, *, state=None, return_state: bool = False):
        """``apply_mamba``. x: (B, S, D); state: (conv_state, ssm_state) or
        None."""
        cs_shape, _ = mamba_state_shapes(self.cfg, x.shape[0])
        conv_state = state[0] if state is not None else \
            torch.zeros(cs_shape, dtype=x.dtype, device=x.device)
        ssm_state = state[1] if state is not None else None
        z, xin, Bc, Cc, dt = self._proj(x)
        conv_in = torch.cat([xin, Bc, Cc], -1)
        conv_out, conv_state = self._causal_conv(conv_in, conv_state)
        xc, Bc, Cc = self._split_conv(conv_out)
        q, k, v, log_decay, xh = self._ssm_inputs(xc, Bc, Cc, dt)
        o, ssm_state = gla_ops.gla(q, k, v, log_decay,
                                   chunk=self.cfg.ssm.chunk,
                                   initial_state=ssm_state)
        y = self._out(o, xh, z)
        return (y, (conv_state, ssm_state)) if return_state else y

    def decode(self, x, conv_state, ssm_state):
        """``apply_mamba_decode``: one token. x: (B, 1, D); returns (y,
        conv_state, ssm_state)."""
        z, xin, Bc, Cc, dt = self._proj(x)
        conv_in = torch.cat([xin, Bc, Cc], -1)
        conv_out, conv_state = self._causal_conv(conv_in, conv_state)
        xc, Bc, Cc = self._split_conv(conv_out)
        q, k, v, log_decay, xh = self._ssm_inputs(xc, Bc, Cc, dt)
        o, ssm_state = gla_ops.gla_step(q[:, 0], k[:, 0], v[:, 0],
                                        log_decay[:, 0], ssm_state)
        return self._out(o[:, None], xh, z), conv_state, ssm_state


# -------------------------------------------------------------------- RWKV6

def rwkv_dims(cfg):
    """(heads, head dim) of the RWKV6 time mix."""
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def _shift(x, x_prev):
    """Token shift: y_t = x_{t-1}, y_0 = the carried x_prev (B, 1, D)."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], 1)


class RWKVTimeMix(nn.Module):
    """``init_rwkv_tmix`` / ``apply_rwkv_tmix`` /
    ``apply_rwkv_tmix_decode``, with the reference's parameter names: the
    token-shift mix (``mu_x``, ``mu`` and its LoRA ``mix_w1`` /
    ``mix_w2``), the decay (``w0`` and its LoRA ``w1`` / ``w2``), the bonus
    ``u``, the projections ``wr``, ``wk``, ``wv``, ``wg``, ``wo`` and the
    per-head norm ``ln_x``. The mix and decay parameters are float32 and
    cast to the input's type where the reference casts them; the decay is
    formed in float32."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        r = cfg.rwkv
        D = cfg.d_model
        H, hd = rwkv_dims(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)

        def full(shape, v):
            return L.param(torch.full(shape, v, dtype=f32, device=device))

        self.mu_x = full((D,), 0.5)
        self.mu = full((5, D), 0.5)
        self.mix_w1 = L.param(L.dense_init((D, 5 * r.mix_lora), (0,), f32,
                                           **kw))
        self.mix_w2 = full((5, r.mix_lora, D), 0.0)
        self.w0 = L.param(torch.linspace(-6.0, 0.0, D, dtype=f32,
                                         device=device))
        self.w1 = L.param(L.dense_init((D, r.decay_lora), (0,), f32, **kw))
        self.w2 = full((r.decay_lora, D), 0.0)
        self.u = L.param(0.1 * torch.randn((H, hd), dtype=f32, device=device,
                                           generator=generator))
        for name in ("wr", "wk", "wv", "wg"):
            setattr(self, name, L.param(L.dense_init((D, D), (0,), dtype,
                                                     **kw)))
        self.ln_x = L.init_ln(D, device=device, shape=(H, hd))
        self.wo = L.param(L.dense_init((D, D), (0,), dtype, **kw))

    def _inputs(self, x, xx):
        """(r, k, v) (B, S, H, hd), the gate g (B, S, D) and the float32
        log decay (B, S, H, hd) of x and its shift difference xx."""
        r = self.cfg.rwkv
        B, S, D = x.shape
        H, hd = rwkv_dims(self.cfg)
        dt = x.dtype
        xxx = x + xx * self.mu_x.to(dt)
        mix = torch.tanh(xxx @ self.mix_w1.to(dt)).reshape(
            B, S, 5, r.mix_lora)
        mix = torch.einsum("bsfm,fmd->bsfd", mix, self.mix_w2.to(dt)) \
            + self.mu.to(dt)
        xw, xk, xv, xr, xg = (x + xx * mix[:, :, i] for i in range(5))
        rr = (xr @ self.wr).reshape(B, S, H, hd)
        k = (xk @ self.wk).reshape(B, S, H, hd)
        v = (xv @ self.wv).reshape(B, S, H, hd)
        g = F.silu(xg @ self.wg)
        lora = torch.tanh(xw @ self.w1.to(dt)) @ self.w2.to(dt)
        log_w = -torch.exp(self.w0 + lora.to(f32))
        return rr, k, v, g, log_w.reshape(B, S, H, hd)

    def _out(self, o, g):
        o = L.group_norm_heads(o, self.ln_x["scale"], self.ln_x["bias"],
                               self.cfg.norm_eps)
        return (o.reshape(g.shape) * g) @ self.wo

    def forward(self, x, *, shift_state=None, wkv_state=None,
                return_state: bool = False):
        """``apply_rwkv_tmix``. x: (B, S, D); shift_state (B, 1, D);
        wkv_state (B, H, hd, hd) float32. With ``return_state``, also
        (x[:, -1:], the final wkv state)."""
        B, S, D = x.shape
        if shift_state is None:
            shift_state = torch.zeros((B, 1, D), dtype=x.dtype,
                                      device=x.device)
        rr, k, v, g, log_w = self._inputs(x, _shift(x, shift_state) - x)
        o, wkv_state = gla_ops.gla(rr, k, v, log_w, bonus=self.u,
                                   strict=True, chunk=self.cfg.rwkv.chunk,
                                   initial_state=wkv_state)
        y = self._out(o, g)
        return (y, (x[:, -1:], wkv_state)) if return_state else y

    def decode(self, x, shift_state, wkv_state):
        """``apply_rwkv_tmix_decode``: one token, x (B, 1, D). Returns (y,
        the new shift state x, the new wkv state)."""
        rr, k, v, g, log_w = self._inputs(x, shift_state.to(x.dtype) - x)
        o, wkv_state = gla_ops.gla_step(rr[:, 0], k[:, 0], v[:, 0],
                                        log_w[:, 0], wkv_state,
                                        bonus=self.u, strict=True)
        return self._out(o, g[:, 0])[:, None], x, wkv_state


class RWKVChannelMix(nn.Module):
    """``init_rwkv_cmix`` / ``apply_rwkv_cmix`` / ``apply_rwkv_cmix_decode``:
    the token-shift mix (``mu_k``, ``mu_r``), a squared-ReLU MLP (``wk``,
    ``wv``) and its sigmoid receptance gate (``wr``)."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        kw = dict(generator=generator, device=device)
        self.mu_k = L.param(torch.full((D,), 0.5, dtype=f32, device=device))
        self.mu_r = L.param(torch.full((D,), 0.5, dtype=f32, device=device))
        self.wk = L.param(L.dense_init((D, Fd), (0,), dtype, **kw))
        self.wv = L.param(L.dense_init((Fd, D), (0,), dtype, **kw))
        self.wr = L.param(L.dense_init((D, D), (0,), dtype, **kw))

    def _mix(self, x, xx):
        xk = x + xx * self.mu_k.to(x.dtype)
        xr = x + xx * self.mu_r.to(x.dtype)
        v = torch.square(F.relu(xk @ self.wk)) @ self.wv
        return torch.sigmoid(xr @ self.wr) * v

    def forward(self, x, *, shift_state=None, return_state: bool = False):
        """``apply_rwkv_cmix``. x: (B, S, D). With ``return_state``, also
        x[:, -1:]."""
        B, S, D = x.shape
        if shift_state is None:
            shift_state = torch.zeros((B, 1, D), dtype=x.dtype,
                                      device=x.device)
        y = self._mix(x, _shift(x, shift_state) - x)
        return (y, x[:, -1:]) if return_state else y

    def decode(self, x, shift_state):
        """``apply_rwkv_cmix_decode``: one token; returns (y, x)."""
        return self._mix(x, shift_state.to(x.dtype) - x), x
