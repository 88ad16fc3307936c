"""Tensor parallelism: Megatron-style sharded layers over a process group
(the JAX package's ``_TP_RULES`` / ``shard_params``, where GSPMD places
the collectives; here each rank holds its slice of the weights and the
layers call the collectives themselves).

``shard_modules_`` walks the trainable modules and, where the rules of
``parallel/mesh.py`` (``param_tp_axis``) shard a layer and its widths
divide by the tp size, replaces each sharded parameter by this rank's
slice and switches the layer to its tensor-parallel forward:

  * attention (``Attention``, ``_FrameSelfAttention``): ``to_q`` / ``to_k``
    / ``to_v`` and the IP branches' ``to_k_ip`` / ``to_v_ip``
    column-parallel by whole heads (K2 / K3 on heads / tp), ``to_out``
    row-parallel; an attention whose heads do not divide stays whole;
  * GEGLU (``FeedForward``): ``proj_in`` column-parallel with matching
    value and gate columns (H / tp of each), ``proj_out`` row-parallel: one
    K4 call on (C, 2 H / tp) and (H / tp, C), its partial output
    all-reduced, the bias added once after;
  * the SSM block (``SS2DCondV10``): ``in_proj1/2``, ``audio_proj``,
    ``exp_proj``, ``id_proj`` column-parallel over d_inner, and the units'
    per-channel parameters (``x_proj_weight``, ``dt_projs_weight``,
    ``dt_projs_bias``, ``A_logs``, ``Ds``) sharded over d_inner: K1 scans
    d_inner / tp channels; ``x_dbl`` (a sum over d_inner) is all-reduced
    before the scan reads dt / B / C; the output is all-gathered for
    ``out_norm`` and ``out_proj``, which stay whole;
  * the convolutions the rule ``conv\\d?`` names (the resnets' ``conv1`` /
    ``conv2``, 2-D and temporal, and the down / up samplers' ``conv``):
    output channels sharded (K8 on C_out / tp in the fused-norm
    configuration), all-gathered for the GroupNorm that follows;
  * the heads: ``proj1`` (all-gathered) and ``proj2`` column-parallel,
    ``proj3`` row-parallel.

A column-parallel layer's input passes ``copy_to`` (identity forward,
all-reduce of the gradient), a row-parallel layer's output ``reduce_from``
(all-reduce forward, identity backward), a gather ``gather_last``
(all-gather forward, this rank's slice of the gradient backward). Every
other parameter is whole on every rank and receives the same gradient on
each. ``TPPlan`` records each sharded parameter's ``Layout`` so that a
full state dict can be cut into slices and the slices gathered back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn


class TPGroup(NamedTuple):
    group: Any        # the process group of this rank's tp peers
    size: int
    rank: int         # this rank's index within it


# ------------------------------------------------------------- collectives

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(tp.size)]
        dist.all_gather(parts, x.contiguous(), group=tp.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.tp.rank * ctx.n, ctx.n).contiguous(), None


def copy_to(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return _CopyToTP.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return _ReduceFromTP.apply(x, tp.group)


def gather_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return _GatherLast.apply(x, tp)


# ------------------------------------------------------------------ layouts

@dataclasses.dataclass(frozen=True)
class Layout:
    """How a parameter of ``full_shape`` is cut over tp ranks: viewed as
    ``pre_shape`` (default: the full shape), a contiguous block along
    ``axis`` a rank; ``full_axis`` is the dimension of the full shape that
    shrinks (GEGLU's (2H, C) is viewed as (2, H, C) and cut along H, so a
    rank holds H / tp value rows, then as many gate rows)."""

    full_shape: Tuple[int, ...]
    axis: int
    pre_shape: Optional[Tuple[int, ...]] = None
    full_axis: Optional[int] = None

    def _pre(self):
        return self.pre_shape or self.full_shape

    def local_shape(self, size: int) -> Tuple[int, ...]:
        shape = list(self.full_shape)
        fa = self.axis if self.full_axis is None else self.full_axis
        shape[fa] //= size
        return tuple(shape)

    def local(self, full: torch.Tensor, size: int, rank: int) -> torch.Tensor:
        pre = self._pre()
        n = pre[self.axis] // size
        return full.reshape(pre).narrow(self.axis, rank * n, n).reshape(
            self.local_shape(size)).clone()

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        pre = list(self._pre())
        pre[self.axis] //= len(parts)
        return torch.cat([p.reshape(pre) for p in parts], self.axis).reshape(
            self.full_shape)


@dataclasses.dataclass
class TPPlan:
    """The sharded parameters: artifact -> parameter key -> Layout."""

    tp: TPGroup
    layouts: Dict[str, Dict[str, Layout]]

    def sharded_params(self, modules: Dict[str, nn.Module]) -> List[nn.Parameter]:
        return [p for name, m in modules.items()
                for k, p in m.named_parameters() if k in self.layouts.get(name, {})]

    def gather(self, name: str, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Artifact ``name``'s local state dict (or any dict keyed alike, an
        EMA's) -> the whole one, on every rank (a collective)."""
        lay, tp = self.layouts.get(name, {}), self.tp
        out = {}
        for k, v in sd.items():
            if k in lay:
                parts = [torch.empty_like(v) for _ in range(tp.size)]
                dist.all_gather(parts, v.detach().contiguous(), group=tp.group)
                out[k] = lay[k].join(parts)
            else:
                out[k] = v
        return out

    def cut(self, name: str, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole state dict of artifact ``name`` -> this rank's slices."""
        lay, tp = self.layouts.get(name, {}), self.tp
        return {k: lay[k].local(v, tp.size, tp.rank) if k in lay else v
                for k, v in sd.items()}


# ------------------------------------------------------------------ sharding

def shard_modules_(modules: Dict[str, nn.Module], tp: TPGroup,
                   min_size: int = 2 ** 14) -> TPPlan:
    """Shard ``modules`` (artifact -> module, whole and equal on every rank
    of ``tp``) in place; returns the plan. A layer is sharded when the rules
    (``mesh.param_tp_axis``, which keeps a weight under ``min_size``
    elements whole) shard its weight and its widths divide by tp."""
    from actalker_tpu_torch.parallel.mesh import param_tp_axis
    from actalker_tpu_torch.models.attention_blocks import (
        Attention, FeedForward, _FrameSelfAttention)
    from actalker_tpu_torch.models.common import Conv2d, TemporalConv
    from actalker_tpu_torch.models.projections import (
        AudioProjModel, IDProjModel, VasaProjModel)
    from actalker_tpu_torch.models.ssm import SS2DCondV10

    plan = TPPlan(tp, {})
    s = tp.size

    for art, root in modules.items():
        lay = plan.layouts.setdefault(art, {})

        def put(prefix: str, p_name: str, module: nn.Module, layout: Layout):
            p = getattr(module, p_name)
            lay[f"{prefix}.{p_name}" if prefix else p_name] = layout
            with torch.no_grad():
                p.data = layout.local(p.data, s, tp.rank)

        def linear(prefix, lin, mode):
            w = lin.weight.shape
            put(prefix, "weight", lin, Layout(tuple(w), 1 if mode == "row" else 0))
            if lin.bias is not None and mode != "row":
                put(prefix, "bias", lin, Layout(tuple(lin.bias.shape), 0))
            lin.tp, lin.tp_mode = tp, mode

        def ruled(key, p):
            return param_tp_axis(key, tuple(p.shape), min_size) is not None

        for name, m in list(root.named_modules()):
            pre = f"{name}." if name else ""
            if isinstance(m, (Attention, _FrameSelfAttention)):
                if m.heads % s or not ruled(pre + "to_q.weight", m.to_q.weight):
                    continue
                for proj in ("to_q", "to_k", "to_v"):
                    linear(pre + proj, getattr(m, proj), "col")
                for i in range(getattr(m, "num_adapters", 0)):
                    for kv in ("to_k_ip", "to_v_ip"):
                        linear(f"{pre}processor.{kv}.{i}",
                               getattr(m.processor, kv)[i], "col")
                linear(pre + "to_out.0", m.to_out[0], "row")
                m.heads //= s
                if hasattr(m, "inner"):
                    m.inner //= s
            elif isinstance(m, FeedForward):
                p1, p2 = m.net[0].proj, m.net[2]
                hidden = p2.weight.shape[1]
                if hidden % s or not ruled(pre + "net.0.proj.weight", p1.weight):
                    continue
                c = p1.weight.shape[1]
                put(pre + "net.0.proj", "weight", p1,
                    Layout((2 * hidden, c), 1, (2, hidden, c), 0))
                put(pre + "net.0.proj", "bias", p1, Layout((2 * hidden,), 1, (2, hidden), 0))
                put(pre + "net.2", "weight", p2, Layout(tuple(p2.weight.shape), 1))
                m.tp = tp
            elif isinstance(m, SS2DCondV10):
                di = m.d_inner
                first = "in_proj1" if m.use_audio else "in_proj2"
                if di % s or not ruled(f"{pre}{first}.weight", getattr(m, first).weight):
                    continue
                for proj in ("in_proj1", "in_proj2", "id_proj", "audio_proj", "exp_proj"):
                    if hasattr(m, proj):
                        linear(pre + proj, getattr(m, proj), "col")
                for unit_name in ("audio_unit", "exp_unit"):
                    unit = getattr(m, unit_name, None)
                    if unit is None:
                        continue
                    k, n = unit.num_direction, unit.d_state
                    u = pre + unit_name
                    put(u, "x_proj_weight", unit,
                        Layout(tuple(unit.x_proj_weight.shape), 2))
                    put(u, "dt_projs_weight", unit,
                        Layout(tuple(unit.dt_projs_weight.shape), 1))
                    put(u, "dt_projs_bias", unit, Layout((k, di), 1))
                    put(u, "A_logs", unit, Layout((k * di, n), 1, (k, di, n), 0))
                    put(u, "Ds", unit, Layout((k * di,), 1, (k, di), 0))
                    unit.d_inner //= s
                m.d_inner //= s
                m.tp = tp
            elif isinstance(m, (Conv2d, TemporalConv)):
                if m.weight.shape[0] % s or not ruled(pre + "weight", m.weight):
                    continue
                put(name, "weight", m, Layout(tuple(m.weight.shape), 0))
                if m.bias is not None:
                    put(name, "bias", m, Layout(tuple(m.bias.shape), 0))
                m.tp = tp
            elif isinstance(m, (AudioProjModel, IDProjModel)):
                lins = (m.proj1, m.proj2, m.proj3)
                if any(l.weight.shape[0 if i < 2 else 1] % s
                       or not ruled(f"{pre}proj{i + 1}.weight", l.weight)
                       for i, l in enumerate(lins)):
                    continue
                for proj, mode in (("proj1", "col_gather"), ("proj2", "col"),
                                   ("proj3", "row")):
                    linear(pre + proj, getattr(m, proj), mode)
            elif isinstance(m, VasaProjModel):
                if m.proj1.weight.shape[0] % s or not ruled(pre + "proj1.weight",
                                                             m.proj1.weight):
                    continue
                linear(pre + "proj1", m.proj1, "col_gather")
    return plan


def tp_width_error(block_out_channels: Sequence[int], tp: int) -> Optional[str]:
    """Why ``tp`` cannot shard a UNet of these widths, or None: every
    width the sharded layers split (the convolutions' C, the GEGLU's 4 C,
    the SSM's 2 C) must divide by it."""
    for c in block_out_channels:
        if c % tp:
            return (f"--tp {tp} does not divide the UNet width {c} "
                    f"(block_out_channels {tuple(block_out_channels)})")
    return None
