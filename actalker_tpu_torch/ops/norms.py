"""LayerNorm and GroupNorm with fp32 statistics and an fp32 affine (K7-LN,
K7-GN), and the default lowering's variant of each.

Twin of ``actalker_tpu/ops/norms.py``. Both normalize channel-last tensors:
LayerNorm over the last axis, GroupNorm over every axis but the first and
the last (x (N, ..., C) is taken as (N, M, C)) and the C / G channels of
each group. Statistics are E[x] and E[x^2] in fp32 with the variance
clamped at 0; the affine runs in fp32 and the output is cast once to the
input dtype.

``io_affine=True`` (internal: ``models/common.py`` passes it for the
default lowering) computes that lowering's function instead, the plain
branch's: the same statistics and fp32 affine (a, b), both rounded to the
input dtype, then ``x * a + b`` as an elementwise mul and add in that
dtype, each rounded. The kernels take it as a compile-time variant of their
apply step; ``kernel_takes`` says which calls they take.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. ``LayerNormFn`` / ``GroupNormFn`` run the kernel forward and
differentiate the plain version in their backward, as the JAX package's
``_ln_bwd`` / ``_gn_bwd`` recompute through ``_ln_xla`` / ``_gn_xla``.
"""
from __future__ import annotations

import functools

import torch

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, cuda_tensors_ok, fp32_of, needs_grad,
    stream_of)

LN_KERNEL = Kernel("layer_norm", replaces="actalker_tpu/ops/norms.py:35")
GN_KERNEL = Kernel("group_norm", replaces="actalker_tpu/ops/norms.py:119")

_DTYPES = (torch.bfloat16, torch.float32)
_F32 = (torch.float32,)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

# K7-GN's geometry (csrc/group_norm.cu): most threads a block, a TMA box's
# extent, the largest (portable) cluster
GN_MAX_THREADS, GN_MAX_BOX, GN_MAX_CLUSTER = 512, 256, 8
# statistics: blocks a launch aims at (two an SM, one wave), at most this
# many an image (the finalize adds their partials); two-pass: elements an
# apply block walks
GN_STATS_BLOCKS, GN_MAX_CHUNKS, GN_APPLY_ELEMS = 264, 1024, 32768
# cluster: threads a CTA aims at, x bytes a CTA holds (two CTAs an SM with
# their sums), the fewest CTAs a launch takes the cluster path with
GN_CLUSTER_THREADS, GN_CLUSTER_X_BYTES, GN_CLUSTER_MIN_CTAS = 256, 96 * 1024, 132
# the narrowest slice row a cluster CTA loads (narrower rows waste DRAM
# bursts)
GN_MIN_SLICE_BYTES = 128


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _lanes(nvec: int, threads: int):
    """(column lanes, row lanes) of a block of about ``threads`` threads
    over ``nvec`` 16-byte vectors a row (the kernels' ``col_lanes``)."""
    cw = min(nvec, threads)
    return cw, max(1, threads // cw)


@functools.lru_cache(maxsize=512)
def gn_plan(n: int, m: int, c: int, groups: int, itemsize: int,
            path: str | None = None) -> dict:
    """K7-GN's launch plan for x (n, m, c) of ``itemsize``-byte elements in
    ``groups`` groups, as ``csrc/group_norm.cu`` checks it (cached: one
    dict per shape, not to be changed).

    ``stats``: the statistics launch (K8's statistics, and the first pass
    of the two-pass path): blocks of ``rows`` rows (``chunks`` an image,
    about ``GN_STATS_BLOCKS`` in all), ``threads`` threads, ``smem`` bytes,
    the ``part`` buffer's float2 count. ``cluster`` (None where no cluster
    holds an image's slice): ``sc`` channels a slice (whole groups, a
    multiple of 16 bytes, at most a TMA box, at least
    ``GN_MIN_SLICE_BYTES`` a row where C allows), clusters of ``p`` CTAs of
    ``rows_cta`` rows, loaded as ``nbox`` boxes of ``box_rows`` rows,
    ``threads``, ``smem``; the widest slice that fits
    ``GN_CLUSTER_X_BYTES`` a CTA, on the fewest CTAs. ``path``: the
    group norm's ("cluster" where one fits and the launch has at least
    ``GN_CLUSTER_MIN_CTAS`` CTAs, else "two_pass"); a given ``path`` is
    taken if it can be. ``apply_rows``: rows an apply block walks."""
    vec = 16 // itemsize
    nvec, cg = c // vec, c // groups
    cw, rl = _lanes(nvec, GN_MAX_THREADS)
    threads = cw * rl
    stripes = max(1, threads // groups)

    want = min(GN_MAX_CHUNKS, -(-GN_STATS_BLOCKS // n))
    rows = max(4 * rl, -(-m // want))
    chunks = -(-m // rows)
    stats = {"rows": rows, "chunks": chunks, "threads": threads,
             "smem": 8 * max(rl * c, stripes * groups + groups),
             "part": n * chunks * groups}
    clus = None
    slices = [sc for sc in range(cg, min(c, GN_MAX_BOX) + 1, cg)
              if c % sc == 0 and sc * itemsize % 16 == 0
              and sc * itemsize >= min(GN_MIN_SLICE_BYTES, c * itemsize)]
    for sc in sorted(slices, reverse=True):
        p = 1
        while clus is None and p <= GN_MAX_CLUSTER:
            rows_cta = -(-m // p)
            nbox = -(-rows_cta // GN_MAX_BOX)
            box_rows = _round_up(-(-rows_cta // nbox), 8)
            xbytes = nbox * box_rows * sc * itemsize
            if xbytes <= GN_CLUSTER_X_BYTES:
                ccw, crl = _lanes(sc * itemsize // 16, GN_CLUSTER_THREADS)
                clus = {"sc": sc, "slices": c // sc, "p": p,
                        "rows_cta": rows_cta, "box_rows": box_rows,
                        "nbox": nbox, "threads": ccw * crl,
                        "smem": (_round_up(xbytes, 128) + crl * sc * 8
                                 + sc // cg * 8 + sc * 8 + 8),
                        "ctas": n * (c // sc) * p}
            p *= 2
        if clus is not None:
            break
    if path is None:
        path = ("cluster" if clus is not None
                and clus["ctas"] >= GN_CLUSTER_MIN_CTAS else "two_pass")
    elif path == "cluster" and clus is None:
        raise ValueError(f"K7-GN: no cluster holds an image of ({n}, {m}, {c})")
    return {"path": path, "stats": stats, "cluster": clus,
            "apply_rows": max(1, -(-GN_APPLY_ELEMS // c))}


def kernel_takes(x, groups: int | None = None) -> bool:
    """Whether K7 takes this norm call, from x's metadata alone: a
    non-empty CUDA tensor of bf16 or fp32 with C % 8 == 0; a group norm
    (``groups`` given) also of rank >= 3 and whole groups. Everything else
    about the operands (gamma / beta's dtype and device, layout,
    alignment) the wrapper normalizes or refuses with an error."""
    c = x.shape[-1] if x.ndim else 0
    return (x.is_cuda and x.dtype in _DTYPES and c % 8 == 0 and x.numel() > 0
            and (groups is None or (x.ndim >= 3 and groups > 0
                                    and c % groups == 0)))


def layer_norm_ref(x, gamma, beta, eps: float = 1e-5,
                   io_affine: bool = False) -> torch.Tensor:
    """Plain version of K7-LN (twin of ``_ln_xla``); ``io_affine``: of its
    default-lowering variant (the plain ``LayerNormF32``)."""
    if io_affine:
        mean = x.mean(dim=-1, keepdim=True, dtype=torch.float32)
        var = (x.float().square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        a = torch.rsqrt(var + eps) * gamma.float()
        b = beta.float() - mean * a
        return x * a.to(x.dtype) + b.to(x.dtype)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mu.square()).clamp_min(0.0)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
            + beta.float()).to(x.dtype)


def gn_affine(x, gamma, beta, groups: int, eps: float):
    """Per-(N, C) fp32 (a, b) of GroupNorm with statistics over every axis
    but the first and the last (twin of ``resconv._gn_affine``)."""
    n, c = x.shape[0], x.shape[-1]
    dims = tuple(range(1, x.ndim - 1))
    s1 = x.mean(dim=dims, dtype=torch.float32)                      # (N, C)
    s2 = x.float().square().mean(dim=dims)
    m1 = s1.reshape(n, groups, c // groups).mean(-1)
    m2 = s2.reshape(n, groups, c // groups).mean(-1)
    inv = torch.rsqrt((m2 - m1.square()).clamp_min(0.0) + eps)
    a = inv.repeat_interleave(c // groups, dim=1) * gamma.float()[None]
    b = beta.float()[None] - m1.repeat_interleave(c // groups, dim=1) * a
    return a, b


def group_norm_ref(x, gamma, beta, groups: int = 32, eps: float = 1e-5,
                   io_affine: bool = False) -> torch.Tensor:
    """Plain version of K7-GN (twin of ``_gn_xla``); ``io_affine``: of its
    default-lowering variant (the plain ``GroupNorm32``)."""
    a, b = gn_affine(x, gamma, beta, groups, eps)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    if io_affine:
        return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)
    return (x.float() * a.reshape(shape) + b.reshape(shape)).to(x.dtype)


def _check_affine_args(name, x, gamma, beta):
    c = x.shape[-1]
    if c % 8 or gamma.shape != (c,) or beta.shape != (c,):
        check(c % 8 == 0, f"{name}: C={c} must be a multiple of 8")
        check(False, f"{name}: gamma / beta must be ({c},)")


_NORM_DTYPES = {"x": _DTYPES, "gamma": _F32, "beta": _F32}


def _entry(base: str, dtype, io_affine: bool) -> str:
    """A C entry's name: ``<base>_[io_]<bf16|f32>``."""
    return f"{base}_{'io_' if io_affine else ''}{_SUFFIX[dtype]}"


def _ln_launch(x, xp: int, gp: int, bp: int, y, eps: float, dev: int,
               io_affine: bool = False) -> None:
    """K7-LN's launch on x's device ``dev``: x / y contiguous of one dtype,
    (..., C), normalized over C; xp / gp / bp the pointers of x, gamma and
    beta (fp32 (C,))."""
    c = x.shape[-1]
    LN_KERNEL.launch(_entry("layer_norm", x.dtype, io_affine), "ppppiifp", xp,
                     gp, bp, y.data_ptr(), x.numel() // c, c, eps,
                     torch._C._cuda_getCurrentRawStream(dev))


def layer_norm_launch(x, gamma, beta, y, eps: float,
                      io_affine: bool = False) -> None:
    """The bare K7-LN launch into y, on operands that pass the wrapper's
    checks; no checks (the launch alone, for timing)."""
    _ln_launch(x, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y, eps,
               x.get_device(), io_affine)


def _layer_norm_fwd(x, gamma, beta, eps: float,
                    io_affine: bool = False) -> torch.Tensor:
    """K7-LN launch (plain version for CPU tensors). The kernel takes x in
    its own shape (no reshape or view per call)."""
    if not x.is_cuda:
        return layer_norm_ref(x, gamma, beta, eps, io_affine)
    c = x.shape[-1]
    if not (c % 8 == 0 and gamma.shape == (c,) and beta.shape == (c,)
            and cuda_tensors_ok((x, gamma, beta), _NORM_DTYPES)):
        _check_affine_args("K7-LN", x, gamma, beta)
        x, gamma, beta = x.contiguous(), fp32_of(gamma), fp32_of(beta)
        check_cuda_tensors("K7-LN", (x, gamma, beta), _NORM_DTYPES)
    y = torch.empty_like(x)
    _ln_launch(x, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y, eps,
               x.get_device(), io_affine)
    return y


def _gn_operands(name, x, gamma, beta, groups):
    """x contiguous on its card (any shape (N, ..., C)), fp32 gamma / beta:
    the operands as given when they already are, else normalized, or a
    ValueError naming what the kernel does not take."""
    c = x.shape[-1]
    if (x.ndim >= 3 and c % 8 == 0 and groups > 0 and c % groups == 0
            and gamma.shape == (c,) and beta.shape == (c,)
            and cuda_tensors_ok((x, gamma, beta), _NORM_DTYPES)):
        return x, gamma, beta
    _check_affine_args(name, x, gamma, beta)
    if not (x.ndim >= 3 and groups > 0 and c % groups == 0):
        check(False, f"{name}: x {tuple(x.shape)} with {groups} groups")
    x, gamma, beta = x.contiguous(), fp32_of(gamma), fp32_of(beta)
    check_cuda_tensors(name, (x, gamma, beta), _NORM_DTYPES)
    return x, gamma, beta


# (device index, stream) -> (fp32 scratch, uint32 arrival counters): the
# statistics launch's partial sums and (a, b), and its counters, which the
# kernel leaves zeroed; kept per stream, so launches that may overlap never
# share them
_GN_SCRATCH: dict = {}


def _gn_scratch(x, stream: int, floats: int, n: int):
    """(fp32 scratch of at least ``floats``, counters of at least ``n``)
    for launches on ``stream``, grown when a call needs more."""
    key = (x.device.index, stream)
    have = _GN_SCRATCH.get(key)
    if have is None or have[0].numel() < floats or have[1].numel() < n:
        old_f, old_n = (have[0].numel(), have[1].numel()) if have else (0, 0)
        have = (torch.empty(max(floats, old_f), dtype=torch.float32, device=x.device),
                torch.zeros(max(n, old_n), dtype=torch.int32, device=x.device))
        _GN_SCRATCH[key] = have
    return have


def _nmc(x):
    """x (N, ..., C) as (N, M, C)."""
    n, c = x.shape[0], x.shape[-1]
    return n, x.numel() // (n * c), c


def _gn_stats_ptrs(x, plan, stream):
    """Pointers (part, count, a, b) into the cached scratch for ``plan``'s
    statistics launch: part 16-byte aligned, a / b (N, C) fp32."""
    n, _, c = _nmc(x)
    part = _round_up(2 * plan["stats"]["part"], 4)
    buf, count = _gn_scratch(x, stream, part + 2 * n * c, n)
    base = buf.data_ptr()
    return base, count.data_ptr(), base + 4 * part, base + 4 * (part + n * c)


def group_norm_affine(x, gamma, beta, groups: int, eps: float):
    """The per-(N, C) fp32 GroupNorm affine (a, b): K7-GN's statistics
    launch on CUDA tensors (one launch; x read once), ``gn_affine`` on CPU
    tensors."""
    if not x.is_cuda:
        return gn_affine(x, gamma, beta, groups, eps)
    x, gamma, beta = _gn_operands("K7-GN", x, gamma, beta, groups)
    n, m, c = _nmc(x)
    plan = gn_plan(n, m, c, groups, x.element_size())
    st, stream = plan["stats"], stream_of(x)
    ab = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    part, count, _, _ = _gn_stats_ptrs(x, plan, stream)
    GN_KERNEL.launch(f"gn_stats_{_SUFFIX[x.dtype]}", "pppppppiiiiiiifp",
                     x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), part,
                     count, ab.data_ptr(), ab.data_ptr() + 4 * n * c, n, m, c,
                     groups, st["rows"], st["threads"], st["smem"], eps, stream)
    return ab[0], ab[1]


def group_norm_launch(x, gamma, beta, groups: int, eps: float, y,
                      plan: dict, io_affine: bool = False) -> None:
    """K7-GN into y on ``plan`` (``gn_plan``'s, its ``path``), on operands
    that pass the wrapper's checks: x / y (N, ..., C) contiguous."""
    n, m, c = _nmc(x)
    stream = stream_of(x)
    if plan["path"] == "cluster":
        cl = plan["cluster"]
        GN_KERNEL.launch(_entry("group_norm_cluster", x.dtype, io_affine),
                         "ppppiiiiiiiiiiifp",
                         x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                         y.data_ptr(), n, m, c, groups, cl["sc"], cl["p"],
                         cl["rows_cta"], cl["box_rows"], cl["nbox"],
                         cl["threads"], cl["smem"], eps, stream)
        return
    st = plan["stats"]
    part, count, a, b = _gn_stats_ptrs(x, plan, stream)
    GN_KERNEL.launch(_entry("group_norm_two_pass", x.dtype, io_affine),
                     "ppppppppiiiiiiiifp",
                     x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), part,
                     count, a, b, y.data_ptr(), n, m, c, groups, st["rows"],
                     plan["apply_rows"], st["threads"], st["smem"], eps, stream)


def _group_norm_fwd(x, gamma, beta, groups: int, eps: float,
                    io_affine: bool = False) -> torch.Tensor:
    """K7-GN launch (plain version for CPU tensors): one launch where a
    cluster holds an image's slice, else two (``gn_plan``)."""
    if not x.is_cuda:
        return group_norm_ref(x, gamma, beta, groups, eps, io_affine)
    x, gamma, beta = _gn_operands("K7-GN", x, gamma, beta, groups)
    n, m, c = _nmc(x)
    y = torch.empty_like(x)
    group_norm_launch(x, gamma, beta, groups, eps, y,
                      gn_plan(n, m, c, groups, x.element_size()), io_affine)
    return y


class LayerNormFn(torch.autograd.Function):
    """K7-LN forward; the backward differentiates ``layer_norm_ref`` (of
    the same variant). Only x, gamma and beta are saved."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, io_affine):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.io_affine = eps, io_affine
        return _layer_norm_fwd(x, gamma, beta, eps, io_affine)

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = layer_norm_ref(*ins, ctx.eps, ctx.io_affine)
        return (*torch.autograd.grad(out, ins, dy), None, None)


class GroupNormFn(torch.autograd.Function):
    """K7-GN forward; the backward differentiates ``group_norm_ref`` (of
    the same variant). Only x, gamma and beta are saved."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, io_affine):
        ctx.save_for_backward(x, gamma, beta)
        ctx.groups, ctx.eps, ctx.io_affine = groups, eps, io_affine
        return _group_norm_fwd(x, gamma, beta, groups, eps, io_affine)

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = group_norm_ref(*ins, ctx.groups, ctx.eps, ctx.io_affine)
        return (*torch.autograd.grad(out, ins, dy), None, None, None)


def layer_norm(x, gamma, beta, eps: float = 1e-5,
               io_affine: bool = False) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C); gamma / beta (C,);
    differentiable through ``LayerNormFn`` when autograd needs it.
    ``io_affine``: the default lowering's variant (module docstring)."""
    if needs_grad(x, gamma, beta):
        return LayerNormFn.apply(x, gamma, beta, eps, io_affine)
    return _layer_norm_fwd(x, gamma, beta, eps, io_affine)


def group_norm(x, gamma, beta, groups: int = 32, eps: float = 1e-5,
               io_affine: bool = False) -> torch.Tensor:
    """GroupNorm of x (N, ..., C) with ``groups`` channel groups; gamma /
    beta (C,); differentiable through ``GroupNormFn`` when autograd needs
    it. ``io_affine``: the default lowering's variant (module docstring)."""
    if needs_grad(x, gamma, beta):
        return GroupNormFn.apply(x, gamma, beta, groups, eps, io_affine)
    return _group_norm_fwd(x, gamma, beta, groups, eps, io_affine)
