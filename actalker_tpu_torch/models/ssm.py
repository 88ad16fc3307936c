"""Selective-state-space (Mamba) control blocks: the bidirectional scan unit
``SS2DUnit`` and the masked-dense control block ``SS2DCondV10``.

Twin of ``actalker_tpu/models/ssm.py``. ``SS2DUnit`` scans a (B, L, d_inner)
sequence in ``num_direction`` directions (even ones left to right, odd ones
right to left) with per-direction input / dt projections and S4D-real state
matrices: it arranges the tokens once (L-major) and runs one K5 call per
direction (``ops.selective_scan.ssm_scan_arranged``; K6 in its gradient).
The SS2D lineage (``models/ssm_spatial.py``) is built from it.

``SS2DCondV10``, per control branch (audio / expression): project the
tokens with ``in_proj``, append the projected identity and control tokens,
scan both directions, keep the scan output at the tokens the region mask
selects and the projection elsewhere, then sum the branches -> LayerNorm ->
``out_proj``. Tokens the mask does not select, and rows past a branch's
tail, are made exact identity steps of the recurrence (their delta
projection gets -1e9, so softplus(delta) == 0): the state seen by selected
tokens is exactly the one the reference's gather/scatter formulation
computes. Every width runs all its (branch, direction) scans as one call of
the grouped op, K1 (``ops.selective_scan.ssm_scan_grouped``); its gradient
runs the adjoint kernel K6 once per group.

Static-capacity gather (``capacity_frac``, the JAX package's speed path of
modes 0 and 1): given an upper bound on each branch's selected fraction,
the block scans a compact buffer instead of every token, and works in x's
own (B, L) token order. At a token a branch does not select, the branch's
output is its input projection, so with W1, W2 the branches' ``in_proj``
weights

    y = x (W1 + W2)^T + sum_b sum_{r selected by b} (scan_b[r] - x[r] W_b^T)

The first term is one GEMM with the weights summed in fp32 and rounded
once to x's dtype: the product is rounded once, and the summed weight's
own rounding adds about as much again (``test_torch_kernels_cuda``'s
res-72 block holds the bf16 error against fp32 to the separate products'
error).
A branch's K = ceil(frac * L) (rounded up to 8) slots take its selected
tokens in token order (a cumsum slot assignment, the reference's
``masked_select`` order), then its tail; those rows of x alone are
gathered and projected by W_b into K1's arranged buffer, and K1 walks
max(K + tail) rows. Each branch then adds its scan's difference from the
projection, formed in fp32 and rounded once, into y at its selected tokens
in one indexed add (``ops.selective_scan.gather_delta_add``, one kernel
launch on the card; an empty slot writes nothing, and a token both
branches select takes both). No (L, B)-ordered or full-width copy is made:
y goes to the out-norm (K7 on the card) as it is. A branch switched off by
its gate (frac 0) scans its tail only. More selected tokens than K break
the contract: ``capacity_overflow="nan"`` poisons the output of each batch
row that overflows, ``"drop"`` leaves the extra tokens at their
projection. The JAX package poisons its whole call, which under its
serving vmap is one identity; here the rows of one identity share its
mask, so an identity that overflows turns NaN whole and the others of its
call stay finite.

While spans are on (``utils/observability``), each call counts the (row,
branch) slots K1 walks (``ssm.k1_slots``) and those active
(``ssm.k1_active``), and the gather's slots (``ssm.gather_slots``, the
capacities times the batch) and the selected tokens within them
(``ssm.gather_selected``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.attention_blocks import (
    downsample_ip_mask, expand_mask_rows)
from actalker_tpu_torch.models.common import LayerNormF32, Linear
from actalker_tpu_torch.ops.selective_scan import (
    LANES, MASK_LANE, gather_delta_add, ssm_scan, ssm_scan_arranged,
    ssm_scan_grouped)
from actalker_tpu_torch.utils.observability import count, enabled


def scan_one_direction(u, delta, A, Bm, Cm, D, bias, reverse: bool, dtype
                       ) -> torch.Tensor:
    """(B, L, d) scan in one direction through the arranged op, cast to
    ``dtype`` (twin of ``_scan_one_direction`` on its Pallas path)."""
    return ssm_scan(u, delta, A, Bm, Cm, D, bias, reverse=reverse).to(dtype)


class SS2DUnit(nn.Module):
    """Selective scan over (B, L, d_inner) sequences in ``num_direction``
    directions, with the reference's parameter names and shapes
    (``SS2D_Unit``, ``mamba_layer.py:1394-1553``)."""

    def __init__(self, d_inner: int, d_state: int = 16, dt_rank=None,
                 num_direction: int = 2):
        super().__init__()
        k, d, n = num_direction, d_inner, d_state
        self.d_inner, self.d_state, self.num_direction = d, n, k
        self.rank = dt_rank or math.ceil(d_inner / 2 / 16)
        self.x_proj_weight = nn.Parameter(torch.zeros(k, self.rank + 2 * n, d))
        self.dt_projs_weight = nn.Parameter(torch.zeros(k, d, self.rank))
        self.dt_projs_bias = nn.Parameter(torch.zeros(k, d))
        self.A_logs = nn.Parameter(
            torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(k * d, 1))
        self.Ds = nn.Parameter(torch.ones(k * d))

    def weights(self):
        return (self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias,
                self.A_logs, self.Ds)

    def scan_arranged(self, x_a, tm_a=None):
        """Scan every direction of an arranged buffer and sum them.

        x_a: (Lp, Bp, Dp), Dp >= d_inner, zero in channels past d_inner;
        tm_a: (Lp, Bp) bool or None; False rows (pads or deselected tokens)
        get delta -1e9, exact identity steps. The projections run in the
        arranged layout with zero-padded weights, so pad channels are
        transparent. Returns (Lp, Bp, Dp) in x_a's dtype."""
        dp = x_a.shape[2]
        d, n, rank = self.d_inner, self.d_state, self.rank
        y = None
        for k in range(self.num_direction):
            x_dbl = F.linear(x_a, F.pad(self.x_proj_weight[k].to(x_a.dtype),
                                        (0, dp - d)))
            dtw = F.pad(self.dt_projs_weight[k].to(x_a.dtype), (0, 0, 0, dp - d))
            dt_a = F.linear(x_dbl[..., :rank], dtw)
            if tm_a is not None:
                dt_a = dt_a.masked_fill(~tm_a[..., None], -1e9)
            bc_a = F.pad(x_dbl[..., rank:rank + 2 * n], (0, LANES - 2 * n))
            A = -torch.exp(self.A_logs[k * d:(k + 1) * d].float())
            yk = ssm_scan_arranged(x_a, dt_a, bc_a, A, self.Ds[k * d:(k + 1) * d],
                                   self.dt_projs_bias[k], reverse=k % 2 == 1)
            y = yk if y is None else y + yk
        return y

    def forward(self, x, transparent_mask=None):
        """x (B, L, d_inner); transparent_mask (B, L) bool or None, False ->
        the token is an identity step of the scan. The tokens are arranged
        once, without padding (K5 takes any (L, B, D)); returns (B, L,
        d_inner) in x's dtype."""
        x_a = x.transpose(0, 1).contiguous()
        tm_a = None if transparent_mask is None else transparent_mask.transpose(0, 1)
        return self.scan_arranged(x_a, tm_a).transpose(0, 1)


class SS2DCondV10(nn.Module):
    """Masked-select dual-branch SSM control block.

    Ablation flags as in the JAX package: ``use_id=False`` drops the
    identity token, ``use_audio`` / ``use_exp`` drop a branch, and
    ``no_scan=True`` makes each branch's output its input projection.
    ``capacity_frac`` (audio, exp) switches on the gather path (module
    docstring); None scans every token (masked-dense)."""

    def __init__(self, d_model: int, d_cond: int = 1024, d_state: int = 16,
                 expand: int = 2, use_id: bool = True, use_audio: bool = True,
                 use_exp: bool = True, no_scan: bool = False,
                 capacity_frac: Optional[Tuple[float, float]] = None,
                 capacity_overflow: str = "nan"):
        super().__init__()
        if not (use_audio or use_exp):
            raise ValueError("cannot ablate both the audio and expression branches")
        if capacity_overflow not in ("nan", "drop"):
            raise ValueError(f"capacity_overflow {capacity_overflow!r}: "
                             "'nan' or 'drop'")
        self.capacity_frac = capacity_frac
        self.capacity_overflow = capacity_overflow
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

    tp = None

    def _whole(self, y):
        """(B, L, d_inner) -> out_norm -> out_proj; under tensor parallelism
        (``parallel/tensor.py`` sets ``tp``: this rank holds d_inner / tp
        channels) the channels are all-gathered first."""
        if self.tp is not None:
            from actalker_tpu_torch.parallel.tensor import gather_last

            y = gather_last(y, self.tp)
        return self.out_proj(self.out_norm(y))

    def forward(self, x, id_emb, audio_cond, exp_cond, audio_mask, exp_mask):
        """x (B, L, C) tokens; id_emb (B, 1, d_cond); audio_cond (B, Sa,
        d_cond); exp_cond (B, Se, d_cond); masks (Bm, 1, H, W) or None."""
        b, l, c = x.shape
        dt, di = x.dtype, self.d_inner
        branches = []
        if self.use_audio:
            branches.append(("1", "audio_proj", audio_cond, audio_mask,
                             "audio_unit"))
        if self.use_exp:
            branches.append(("2", "exp_proj", exp_cond, exp_mask, "exp_unit"))

        if self.no_scan:
            y = sum(getattr(self, f"in_proj{name}")(x)
                    for name, *_ in branches)
            return self._whole(y)
        if self.tp is not None:       # the fused in_proj reads x below
            from actalker_tpu_torch.parallel.tensor import copy_to

            x = copy_to(x, self.tp)

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
        ws = [getattr(self, f"in_proj{name}").weight for name, *_ in branches]
        caps = self._capacities([br[0] for br in branches],
                                [br[3] for br in branches], l)
        if all(k == l for k in caps):
            # masked-dense: arranged (L, B, .) buffers of the token rows,
            # then each branch's tail
            w_in = torch.cat(ws).to(dt)
            lt = l + max(ntoks)
            xz = x.new_zeros(lt, b, nb * di)
            xz[:l] = F.linear(x.transpose(0, 1), w_in)
            active = torch.zeros(lt, b, nb, dtype=torch.bool, device=x.device)
            for bi in range(nb):
                xz[l:l + ntoks[bi], :, bi * di:(bi + 1) * di] = \
                    tails[bi].transpose(0, 1)
                active[:l, :, bi] = sels[bi].transpose(0, 1)
                active[l:l + ntoks[bi], :, bi] = True
            y_g = self._scan(xz, active, units)
            y = sum(torch.where(active[:l, :, bi, None], self._branch_sum(y_g, bi, l),
                                xz[:l, :, bi * di:(bi + 1) * di])
                    for bi in range(nb))
            self._count(lt, b, nb, active, caps)
            return self._whole(y.transpose(0, 1))               # (b, l, di)

        # gather, in x's own (B, L) order: at a token a branch does not scan,
        # its output is its projection, so y starts as one GEMM with the
        # branches' weights summed in fp32 (or wider) and rounded once
        acc = torch.promote_types(dt, torch.float32)
        y = F.linear(x, sum(w.to(acc) for w in ws).to(dt))      # (b, l, di)
        x_rows = x.reshape(b * l, c)
        lt = max(k + t for k, t in zip(caps, ntoks))
        u_g = x.new_zeros(lt, b, nb * di)
        active = torch.zeros(lt, b, nb, dtype=torch.bool, device=x.device)
        gathered = []
        overflow = torch.zeros(b, dtype=torch.bool, device=x.device)
        for bi in range(nb):
            k, sl = caps[bi], slice(bi * di, (bi + 1) * di)
            tok, act = _compact_rows(sels[bi], k)               # (k, b) each
            if k < l:   # the capacity contract, checked on the device
                overflow = overflow | (sels[bi].sum(1) > k)
            # each slot's token (an empty slot's is zeroed, so a poisoned
            # row cannot reach the scan of the others), projected by the
            # branch's own weight alone
            x_g = x_rows.index_select(0, tok.reshape(-1))
            x_g.masked_fill_(~act.reshape(-1, 1), 0.0)
            # projected straight into K1's buffer (beta 0: not read)
            u_g[:k, :, sl].view(k * b, di).addmm_(x_g, ws[bi].to(dt).t(), beta=0)
            u_g[k:k + ntoks[bi], :, sl] = tails[bi].transpose(0, 1)
            active[:k, :, bi] = act
            active[k:k + ntoks[bi], :, bi] = True
            gathered.append((tok, act))
        y_g = self._scan(u_g, active, units)
        for bi, (tok, act) in enumerate(gathered):
            # at its selected tokens the branch's scan replaces its
            # projection: add the difference, formed in fp32 and rounded
            # once; a token both branches select takes both
            k = caps[bi]
            gather_delta_add(y, y_g[:k, :, 2 * bi * di:(2 * bi + 2) * di],
                             u_g[:k, :, bi * di:(bi + 1) * di], tok, act)
        self._count(lt, b, nb, active, caps)
        out = self._whole(y)
        if self.capacity_overflow == "nan":
            # per batch row, so that rows which keep their budget (the
            # other identities of a batched serving call) stay finite
            out.masked_fill_(overflow[:, None, None], float("nan"))
        return out

    @staticmethod
    def _count(lt: int, b: int, nb: int, active, caps: List[int]) -> None:
        """The block's K1 and gather counters (module docstring)."""
        if enabled():
            count("ssm.k1_slots", lt * b * nb)
            count("ssm.k1_active", active)
            count("ssm.gather_slots", sum(caps) * b)
            count("ssm.gather_selected", sum(active[:k, :, bi].sum()
                                             for bi, k in enumerate(caps)))

    def _capacities(self, names: List[str], masks, l: int) -> List[int]:
        """Token slots per branch: L (every token) without a fraction or a
        mask, else ceil(frac * L) rounded up to 8 and at most L."""
        if self.capacity_frac is None:
            return [l] * len(names)
        by_name = {"1": self.capacity_frac[0], "2": self.capacity_frac[1]}
        caps = []
        for name, mask in zip(names, masks):
            fr = by_name[name]
            if fr is None or mask is None:
                caps.append(l)
                continue
            k = int(math.ceil(min(max(fr, 0.0), 1.0) * l))
            caps.append(min(l, -(-k // 8) * 8) if k else 0)
        return caps

    def _branch_sum(self, y_g, bi: int, rows: int) -> torch.Tensor:
        """Branch ``bi``'s two directions of the scan output, first ``rows``."""
        di = self.d_inner
        return (y_g[:rows, :, 2 * bi * di:(2 * bi + 1) * di]
                + y_g[:rows, :, (2 * bi + 1) * di:(2 * bi + 2) * di])

    def _scan(self, xz, active, units) -> torch.Tensor:
        """One K1 call over the arranged branch slabs ``xz`` (L, B, nb*di):
        per (branch, direction) group the [dts | B | C | inactivity] slab,
        the delta weights with their -1e9 mask row, A, D and the bias.
        Rows where ``active`` (L, B, nb) is False are identity steps."""
        lt, b, _ = xz.shape
        dt, di, n, rank = xz.dtype, self.d_inner, self.d_state, self.rank
        g = 2 * len(units)
        slab = xz.new_zeros(lt, b, g * LANES)
        dtw = torch.zeros(g, LANES, di, dtype=torch.float32, device=xz.device)
        a_g, d_g, b_g = [], [], []
        for bi, unit in enumerate(units):
            xw, dtw_u, dtb, a_log, d_skip = unit.weights()
            xz_b = xz[:, :, bi * di:(bi + 1) * di]
            inact = (~active[:, :, bi]).to(dt)
            for k in range(2):
                gi = 2 * bi + k
                x_dbl = F.linear(xz_b, xw[k].to(dt))
                if self.tp is not None:     # a partial sum over d_inner
                    from actalker_tpu_torch.parallel.tensor import reduce_from

                    x_dbl = reduce_from(x_dbl, self.tp)
                slab[:, :, gi * LANES:gi * LANES + rank + 2 * n] = x_dbl
                slab[:, :, gi * LANES + MASK_LANE] = inact
                dtw[gi, :rank] = dtw_u[k].t().float()
                dtw[gi, MASK_LANE] = -1e9
                a_g.append(-torch.exp(a_log[k * di:(k + 1) * di].float()))
                d_g.append(d_skip[k * di:(k + 1) * di].float())
                b_g.append(dtb[k].float())
        return ssm_scan_grouped(xz, slab, dtw, torch.stack(a_g),
                                torch.stack(d_g), torch.stack(b_g), rank)


def _compact_rows(sel: torch.Tensor, k: int):
    """The gather's slot assignment for one branch: ``sel`` (B, L) bool ->
    (rows, active), each (k, B). Slot j of column c takes the j-th selected
    token of row c in token order (a cumsum, stable: the reference's
    ``masked_select`` order); ``rows`` is that token's row c * L + t of the
    (B * L, .) tokens, the column's last token for a slot no token fills
    (``active`` False), and tokens past k are dropped. No host
    synchronization."""
    b, l = sel.shape
    pos = torch.cumsum(sel.to(torch.int32), dim=1) - 1
    slots = torch.where(sel & (pos < k), pos, torch.full_like(pos, k)).long()
    tok = torch.full((b, k + 1), l, dtype=torch.long, device=sel.device)
    tok.scatter_(1, slots, torch.arange(l, device=sel.device).expand(b, l))
    tok = tok[:, :k].t()                                        # (k, b)
    act = tok < l
    rows = torch.arange(b, device=sel.device) * l + tok.clamp_max(l - 1)
    return rows, act
