"""Selective-state-space (Mamba) control block SS2DCondV10, masked-dense.

Twin of ``actalker_tpu/models/ssm.py``: ``SS2DUnit`` (parameters and
``weights()``) and ``SS2DCondV10`` on its masked-dense path. Per control
branch (audio / expression): project the tokens with ``in_proj``, append the
projected identity and control tokens, scan both directions, keep the scan
output at the tokens the region mask selects and the projection elsewhere,
then sum the branches -> LayerNorm -> ``out_proj``.

Tokens the mask does not select, and rows past a branch's tail, are made
exact identity steps of the recurrence (their delta projection gets -1e9,
so softplus(delta) == 0): the state seen by selected tokens is exactly the
one the reference's gather/scatter formulation computes. Every width runs
all its (branch, direction) scans as one call of the grouped op, K1
(``ops.selective_scan.ssm_scan_grouped``); its gradient runs the adjoint
kernel K6 once per group. The static-capacity gather of the JAX package is
a speed path with the same output and is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.attention_blocks import (
    downsample_ip_mask, expand_mask_rows)
from actalker_tpu_torch.models.common import LayerNormF32, Linear
from actalker_tpu_torch.ops.selective_scan import (
    LANES, MASK_LANE, ssm_scan_grouped)


class SS2DUnit(nn.Module):
    """Parameters of one bidirectional selective scan (two directions) with
    the reference's names and shapes. The scan itself runs inside
    ``SS2DCondV10`` through the grouped op."""

    def __init__(self, d_inner: int, d_state: int, dt_rank: int):
        super().__init__()
        k, d, n = 2, d_inner, d_state
        self.rank = dt_rank
        self.x_proj_weight = nn.Parameter(torch.zeros(k, self.rank + 2 * n, d))
        self.dt_projs_weight = nn.Parameter(torch.zeros(k, d, self.rank))
        self.dt_projs_bias = nn.Parameter(torch.zeros(k, d))
        self.A_logs = nn.Parameter(
            torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(k * d, 1))
        self.Ds = nn.Parameter(torch.ones(k * d))

    def weights(self):
        return (self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias,
                self.A_logs, self.Ds)


class SS2DCondV10(nn.Module):
    """Masked-select dual-branch SSM control block.

    Ablation flags as in the JAX package: ``use_id=False`` drops the
    identity token, ``use_audio`` / ``use_exp`` drop a branch, and
    ``no_scan=True`` makes each branch's output its input projection."""

    def __init__(self, d_model: int, d_cond: int = 1024, d_state: int = 16,
                 expand: int = 2, use_id: bool = True, use_audio: bool = True,
                 use_exp: bool = True, no_scan: bool = False):
        super().__init__()
        if not (use_audio or use_exp):
            raise ValueError("cannot ablate both the audio and expression branches")
        d_inner = expand * d_model
        self.d_inner, self.d_state = d_inner, d_state
        self.rank = math.ceil(d_model / 16)
        self.use_id, self.use_audio, self.use_exp = use_id, use_audio, use_exp
        self.no_scan = no_scan
        if use_id:
            self.id_proj = Linear(d_cond, d_inner, bias=False)
        for on, name, proj, unit in ((use_audio, "1", "audio_proj", "audio_unit"),
                                     (use_exp, "2", "exp_proj", "exp_unit")):
            if not on:
                continue
            setattr(self, f"in_proj{name}", Linear(d_model, d_inner, bias=False))
            if not no_scan:
                setattr(self, proj, Linear(d_cond, d_inner, bias=False))
                setattr(self, unit, SS2DUnit(d_inner, d_state, self.rank))
        self.out_norm = LayerNormF32(d_inner)
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, x, id_emb, audio_cond, exp_cond, audio_mask, exp_mask):
        """x (B, L, C) tokens; id_emb (B, 1, d_cond); audio_cond (B, Sa,
        d_cond); exp_cond (B, Se, d_cond); masks (Bm, 1, H, W) or None."""
        b, l, _ = x.shape
        dt, di, n, rank = x.dtype, self.d_inner, self.d_state, self.rank
        branches = []
        if self.use_audio:
            branches.append(("1", "audio_proj", audio_cond, audio_mask,
                             "audio_unit"))
        if self.use_exp:
            branches.append(("2", "exp_proj", exp_cond, exp_mask, "exp_unit"))

        if self.no_scan:
            y = sum(getattr(self, f"in_proj{name}")(x)
                    for name, *_ in branches)
            return self.out_proj(self.out_norm(y))

        id_tok = F.silu(self.id_proj(id_emb)) if self.use_id else None
        nb = len(branches)
        tails, sels, units = [], [], []
        for name, proj, cond, mask, unit in branches:
            cond_tok = F.silu(getattr(self, proj)(cond))
            parts = ([id_tok] if id_tok is not None else []) + [cond_tok]
            tails.append(torch.cat(
                [t.expand((b,) + tuple(t.shape[1:])) for t in parts], dim=1))
            if mask is None:
                sels.append(torch.ones(b, l, dtype=torch.bool, device=x.device))
            else:
                # the reference selects tokens whose bicubic-downsampled mask
                # value reaches 1
                m = downsample_ip_mask(mask, l)[..., 0] >= 1.0 - 1e-6
                sels.append(expand_mask_rows(m, b))
            units.append(getattr(self, unit))
        ntoks = [t.shape[1] for t in tails]
        lt = l + max(ntoks)

        # arranged (L, B, .) buffers: token rows, then each branch's tail
        w_in = torch.cat([getattr(self, f"in_proj{name}").weight
                          for name, *_ in branches]).to(dt)
        xz = x.new_zeros(lt, b, nb * di)
        xz[:l] = F.linear(x.transpose(0, 1), w_in)
        active = torch.zeros(lt, b, nb, dtype=torch.bool, device=x.device)
        for bi in range(nb):
            xz[l:l + ntoks[bi], :, bi * di:(bi + 1) * di] = tails[bi].transpose(0, 1)
            active[:l, :, bi] = sels[bi].transpose(0, 1)
            active[l:l + ntoks[bi], :, bi] = True

        g = 2 * nb
        slab = x.new_zeros(lt, b, g * LANES)
        dtw = torch.zeros(g, LANES, di, dtype=torch.float32, device=x.device)
        a_g, d_g, b_g = [], [], []
        for bi, unit in enumerate(units):
            xw, dtw_u, dtb, a_log, d_skip = unit.weights()
            xz_b = xz[:, :, bi * di:(bi + 1) * di]
            inact = (~active[:, :, bi]).to(dt)
            for k in range(2):
                gi = 2 * bi + k
                slab[:, :, gi * LANES:gi * LANES + rank + 2 * n] = \
                    F.linear(xz_b, xw[k].to(dt))
                slab[:, :, gi * LANES + MASK_LANE] = inact
                dtw[gi, :rank] = dtw_u[k].t().float()
                dtw[gi, MASK_LANE] = -1e9
                a_g.append(-torch.exp(a_log[k * di:(k + 1) * di].float()))
                d_g.append(d_skip[k * di:(k + 1) * di].float())
                b_g.append(dtb[k].float())
        y_g = ssm_scan_grouped(xz, slab, dtw, torch.stack(a_g),
                               torch.stack(d_g), torch.stack(b_g), rank)
        y = None
        for bi in range(nb):
            y_b = (y_g[:l, :, 2 * bi * di:(2 * bi + 1) * di]
                   + y_g[:l, :, (2 * bi + 1) * di:(2 * bi + 2) * di])
            out = torch.where(active[:l, :, bi, None], y_b,
                              xz[:l, :, bi * di:(bi + 1) * di])
            y = out if y is None else y + out
        y = y.transpose(0, 1)                                   # (b, l, di)
        return self.out_proj(self.out_norm(y))
