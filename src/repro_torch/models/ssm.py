"""Recurrent mixer: Mamba2 (Zamba2's backbone). The counterpart of
``repro.models.ssm``'s Mamba2 part (``mamba_dims`` .. ``apply_mamba_decode``);
RWKV6 waits for its model (ROADMAP.md queue 1, item 4).

Mamba2 reduces to the chunked gated linear attention of
``kernels.linear_scan``: a scalar per-head decay ``exp(-dt exp(A_log))``,
dt folded into v, B and C broadcast over the heads (a stride-0 ``expand``,
never a copy). A prefill runs the scan (kernel #5 on the card), a decode
step ``gla_step``.
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
