"""Plain fp32 operations of the reference: products, convolutions, norms,
attention and the selective scan, with no kernel, cache or batching trick.

Every product goes through ``linear`` / ``conv2d`` / ``conv3d`` so that the
control (``set_precision("fp8")``) can round each product's two operands
to float8 e4m3 with a per-tensor scale, as an fp8 GEMM with fp32
accumulation would, and keep everything else as it is. The default
("fp32") computes in float32; callers turn TF32 off (``fp32_matmul``).

Attention and the scan work in blocks of rows so that their fp32
intermediates stay under about ``BLOCK_BYTES`` each: the cells run 100
rows of 5184 tokens, whose whole (B, H, S, S) scores would take 54 GB.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BLOCK_BYTES = 2 ** 30
FP8_MAX = 448.0                     # largest finite float8 e4m3

_PRECISION = {"mode": "fp32"}


def set_precision(mode: str) -> None:
    """"fp32" (the reference) or "fp8" (the control: e4m3 operands of every
    product)."""
    if mode not in ("fp32", "fp8"):
        raise ValueError(f"precision {mode!r}: 'fp32' or 'fp8'")
    _PRECISION["mode"] = mode


def fp32_matmul() -> None:
    """Products in true float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale (its absolute
    maximum onto 448); the gradient passes straight through."""
    if t.dtype is torch.float8_e4m3fn:
        return t
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = FP8_MAX / amax
    q = (t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q.to(t.dtype) - t).detach()


def _operands(*ts):
    if _PRECISION["mode"] == "fp8":
        return tuple(_fp8(t) for t in ts)
    return ts


def linear(x, w, b=None):
    x, w = _operands(x, w)
    return F.linear(x, w, b)


def conv2d_nhwc(x, w, b, stride=1, padding=0):
    """NHWC input, torch (O, I, kh, kw) weights."""
    x, w = _operands(x, w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, padding)
    return y.permute(0, 2, 3, 1)


def temporal_conv(x, w, b):
    """(3, 1, 1) conv over the frame axis of (B, F, H, W, C), zero-padded:
    y_f = W0 x_{f-1} + W1 x_f + W2 x_{f+1} + b, three products on the
    channels-last data."""
    x, w = _operands(x, w)
    zero = torch.zeros_like(x[:, :1])
    prev = torch.cat([zero, x[:, :-1]], dim=1)
    nxt = torch.cat([x[:, 1:], zero], dim=1)
    w = w[..., 0, 0]                                   # (O, I, 3)
    return (F.linear(prev, w[..., 0]) + F.linear(x, w[..., 1], b)
            + F.linear(nxt, w[..., 2]))


def group_norm(x, weight, bias, groups: int, eps: float):
    """GroupNorm over the last (channel) axis: statistics over every axis
    but the first and the last, per group of channels."""
    n, c = x.shape[0], x.shape[-1]
    xs = x.reshape(n, -1, groups, c // groups)
    mean = xs.mean(dim=(1, 3), keepdim=True)
    var = xs.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xs - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return y * weight + bias


def layer_norm(x, weight, bias, eps: float):
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


class _Recomputed(torch.autograd.Function):
    """``fn(*tensors)`` run without a graph; the backward runs it again with
    one and takes its gradients, so only the inputs are kept (a checkpoint
    that nests inside the UNet's block checkpoints)."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return fn(*tensors)

    @staticmethod
    def backward(ctx, grad):
        ins = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.fn(*ins)
        want = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(out, want, grad, allow_unused=True))
        return (None, *(next(got) if t.requires_grad else None for t in ins))


def recomputed(fn, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Recomputed.apply(fn, *tensors)
    return fn(*tensors)


def _attend(q4, k4, v4):
    """(b, H, Sq, D) x (b, H, Sk, D) softmax attention, in blocks of
    queries whose fp32 scores stay under ``BLOCK_BYTES``."""
    b, h, sq, d = q4.shape
    step = max(1, BLOCK_BYTES // (4 * b * h * k4.shape[2]))
    parts = []
    for j in range(0, sq, step):
        s = torch.matmul(q4[:, :, j:j + step], k4.transpose(-1, -2)) * d ** -0.5
        parts.append(torch.matmul(torch.softmax(s, dim=-1), v4))
    return torch.cat(parts, dim=2)


def attention(q, k, v, heads: int):
    """Softmax attention: q (B, Sq, H*D), k / v (B, Sk, H*D) -> (B, Sq,
    H*D), scale D^-0.5, in blocks of batch rows; under autograd each block
    is recomputed in the backward, so only q / k / v are kept."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    q4 = q.reshape(b, sq, heads, d).transpose(1, 2)
    k4 = k.reshape(b, sk, heads, d).transpose(1, 2)
    v4 = v.reshape(b, sk, heads, d).transpose(1, 2)
    rows = max(1, BLOCK_BYTES // (4 * heads * sk * min(sq, 1024)))
    outs = [recomputed(_attend, q4[i:i + rows], k4[i:i + rows], v4[i:i + rows])
            for i in range(0, b, rows)]
    return torch.cat(outs).transpose(1, 2).reshape(b, sq, c)


def frame_attention(q, k, v, num_frames: int, heads: int):
    """Attention across the frames of each token: q / k / v (B*F, S, C)."""
    bf, s, c = q.shape
    b, d = bf // num_frames, c // heads
    q5, k5, v5 = (t.reshape(b, num_frames, s, heads, d) for t in (q, k, v))
    scores = torch.einsum("bfshd,bgshd->bshfg", q5, k5) * d ** -0.5
    o = torch.einsum("bshfg,bgshd->bfshd", torch.softmax(scores, dim=-1), v5)
    return o.reshape(bf, s, c)


def _scan_rows(u, delta, A, Bm, Cm, D):
    """The S6 recurrence h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t,
    y_t = <C_t, h_t> + D u_t, left to right over (B, L, D), in blocks of
    about sqrt(L) tokens: the prefixes inside every block at once, one
    token a step, then the blocks' entry states one block a step."""
    b, l, d = u.shape
    n = A.shape[-1]
    chunk = max(8, int(math.isqrt(l)))
    pad = (-l) % chunk
    if pad:     # delta 0 is the identity step
        u, delta = F.pad(u, (0, 0, 0, pad)), F.pad(delta, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    dA = torch.exp(delta[..., None] * A).reshape(b, nc, chunk, d, n)
    dBu = ((delta * u)[..., None] * Bm[:, :, None, :]).reshape(b, nc, chunk, d, n)
    # unbind, not indexing: its gradient is one stack, where each index's
    # would be a zero tensor of the whole block
    dAs, dBus = dA.unbind(2), dBu.unbind(2)
    h, ap = dBus[0], dAs[0]
    hs, aps = [h], [ap]
    for t in range(1, chunk):
        h = torch.addcmul(dBus[t], dAs[t], h)
        ap = ap * dAs[t]
        hs.append(h)
        aps.append(ap)
    entry = torch.zeros_like(h[:, 0])
    entries = [entry]
    for h_end, a_end in zip(hs[-1].unbind(1)[:-1], aps[-1].unbind(1)[:-1]):
        entry = torch.addcmul(h_end, a_end, entry)
        entries.append(entry)
    h = torch.addcmul(torch.stack(hs, 2), torch.stack(aps, 2),
                      torch.stack(entries, 1)[:, :, None])
    y = (h.reshape(b, nc * chunk, d, n) * Cm[:, :, None, :]).sum(-1)
    return y[:, :l] + D * u[:, :l]


def selective_scan(u, delta, A, Bm, Cm, D, reverse: bool = False):
    """(B, L, D) scan, fp32, right to left when ``reverse``; delta already
    passed through softplus (0 at a token that is an identity step), in
    blocks of rows; under autograd each block is recomputed in the
    backward."""
    if reverse:
        u, delta, Bm, Cm = (t.flip(1) for t in (u, delta, Bm, Cm))
    b, l, d = u.shape
    # a block keeps a few (rows, L, D, N) fp32 tensors alive, and under
    # autograd its recompute keeps its steps' too: half the rows there
    budget = (2 if torch.is_grad_enabled() else 4) * BLOCK_BYTES
    blocks = -(-4 * b * l * d * A.shape[-1] // budget)
    rows = -(-b // blocks)
    y = torch.cat([recomputed(_scan_rows, u[i:i + rows], delta[i:i + rows], A,
                              Bm[i:i + rows], Cm[i:i + rows], D)
                   for i in range(0, b, rows)])
    return y.flip(1) if reverse else y
