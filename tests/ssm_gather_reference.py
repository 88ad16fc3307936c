"""A plain restatement of ``SS2DCondV10``'s gather path as it stood before
it worked in token order: both branches projected for every token in the
(L, B)-transposed order (one (L, B, nb * d_inner) product), each branch's
selected slots gathered from its column slice, the scan output scattered
back over a copy of the slice with a scratch row, the branches summed and
the poison added before the out-norm. It reuses the block's own slot
assignment, scan and out-norm / out-projection, so a difference from the
block is a difference in the token-order arithmetic alone. Imports no
JAX, so the card tests use it too."""
import torch
import torch.nn.functional as F

from actalker_tpu_torch.models import ssm
from actalker_tpu_torch.models.attention_blocks import (
    downsample_ip_mask, expand_mask_rows)


def old_gather_forward(blk: ssm.SS2DCondV10, x, id_emb, audio_cond, exp_cond,
                       audio_mask, exp_mask) -> torch.Tensor:
    b, l, _ = x.shape
    dt, di = x.dtype, blk.d_inner
    branches = []
    if blk.use_audio:
        branches.append(("1", "audio_proj", audio_cond, audio_mask, "audio_unit"))
    if blk.use_exp:
        branches.append(("2", "exp_proj", exp_cond, exp_mask, "exp_unit"))
    if blk.no_scan:
        return blk._whole(sum(getattr(blk, f"in_proj{name}")(x)
                              for name, *_ in branches))
    id_tok = F.silu(blk.id_proj(id_emb)) if blk.use_id else None
    nb = len(branches)
    tails, sels, units = [], [], []
    for name, proj, cond, mask, unit in branches:
        cond_tok = F.silu(getattr(blk, proj)(cond))
        parts = ([id_tok] if id_tok is not None else []) + [cond_tok]
        tails.append(torch.cat(
            [t.expand((b,) + tuple(t.shape[1:])) for t in parts], dim=1))
        if mask is None:
            sels.append(torch.ones(b, l, dtype=torch.bool, device=x.device))
        else:
            m = downsample_ip_mask(mask, l)[..., 0] >= 1.0 - 1e-6
            sels.append(expand_mask_rows(m, b))
        units.append(getattr(blk, unit))
    ntoks = [t.shape[1] for t in tails]
    w_in = torch.cat([getattr(blk, f"in_proj{name}").weight
                      for name, *_ in branches]).to(dt)
    caps = blk._capacities([br[0] for br in branches],
                           [br[3] for br in branches], l)
    assert not all(k == l for k in caps), "the gather path only"
    xz_full = F.linear(x.transpose(0, 1), w_in)                # (l, b, nb*di)
    lt = max(k + t for k, t in zip(caps, ntoks))
    u_g = x.new_zeros(lt, b, nb * di)
    active = torch.zeros(lt, b, nb, dtype=torch.bool, device=x.device)
    gathered = []
    overflow = torch.zeros(b, dtype=torch.bool, device=x.device)
    for bi in range(nb):
        k, cols = caps[bi], slice(bi * di, (bi + 1) * di)
        rows, act = ssm._compact_rows(sels[bi], k)
        # the slot's token as a row of the flattened (L * B, .) slab, L * B
        # (a scratch row) for an empty slot
        rows = torch.where(act, (rows % l) * b + rows // l, l * b)
        if k < l:
            overflow = overflow | (sels[bi].sum(1) > k)
        xz_b = xz_full[:, :, cols].reshape(l * b, di)
        gath = xz_b.index_select(0, rows.clamp_max(l * b - 1).reshape(-1)
                                 ).reshape(k, b, di)
        gath = torch.where(act[..., None], gath, 0.0)
        u_g[:k, :, cols] = gath
        u_g[k:k + ntoks[bi], :, cols] = tails[bi].transpose(0, 1)
        active[:k, :, bi] = act
        active[k:k + ntoks[bi], :, bi] = True
        gathered.append((xz_b, gath, rows, act))
    y_g = blk._scan(u_g, active, units)
    outs = []
    for bi, (xz_b, gath, rows, act) in enumerate(gathered):
        k = caps[bi]
        upd = torch.where(act[..., None], blk._branch_sum(y_g, bi, k), gath)
        out = torch.cat([xz_b, xz_b.new_zeros(1, di)])
        out.index_copy_(0, rows.reshape(-1), upd.reshape(k * b, di))
        outs.append(out[:l * b].reshape(l, b, di))
    y = sum(outs)
    if blk.capacity_overflow == "nan":
        y = y + torch.where(overflow, float("nan"), 0.0).to(dt)[None, :, None]
    return blk._whole(y.transpose(0, 1))
