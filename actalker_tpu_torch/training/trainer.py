"""Training step: EDM diffusion fine-tuning of the UNet and its conditioning
heads. Twin of ``actalker_tpu/training/trainer.py``:

    sigma ~ exp(N(P_mean, P_std))            (log-normal EDM sampling)
    x_sigma = x0 + sigma * n                  (+ offset noise)
    D(x) = c_skip x_sigma + c_out F(c_in x_sigma; 0.25 ln sigma)
    loss = lambda(sigma) * ||D(x) - x0||^2,  lambda = (1 + sigma^2) / sigma^2

with c_skip = 1/(1+sigma^2), c_out = -sigma/sqrt(1+sigma^2), c_in =
1/sqrt(1+sigma^2) and per-sample conditioning dropout. A batch is raw-head
(the heads run inside the differentiable step, so all five trainable
artifacts get gradients) or pre-encoded (projected tokens and pose
features; a trainer over ``{"unet": unet}`` alone then trains the UNet,
as the JAX package's ``make_train_step`` on a bare UNet apply does).

The optimizer is ``optax.MultiSteps(chain(clip_by_global_norm, adamw), k)``
written out: gradients of k micro-steps are summed in ``.grad`` and their
mean is clipped as ``g / norm * max_norm`` when ``norm >= max_norm``, then
``torch.optim.AdamW`` (decoupled decay, the same beta / eps) applies it on
every k-th micro-step. Parameters (fp32 masters) and optimizer state are
fp32; the UNet computes in ``dtype``. ``ShardedOptimizer`` is the same
optimizer under ZeRO-2 over a process group (the reference's DeepSpeed
``ds_zero2_8gpu.yaml``; the JAX package's ``shard_opt_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from actalker_tpu_torch.models.conditioning import Conditioning
from actalker_tpu_torch.parallel.mesh import ALIGN_BYTES, BUCKET_ELEMS, ZeroLayout


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 4
    cond_dropout_prob: float = 0.10
    noise_offset: float = 0.05
    sigma_p_mean: float = 0.7
    sigma_p_std: float = 1.6


class TrainBatch(NamedTuple):
    """One batch in the JAX package's layouts (channels last), with either
    conditioning contract per field:
      * raw (``audio_feats``, ``id_embed``, ``vasa_expr`` + ``vasa_rot``,
        ``pose_pixels``): the inputs of the trainable heads, which run
        inside the differentiable step;
      * pre-encoded (``audio_tokens``, ``id_tokens``, ``vasa_tokens``,
        ``pose_fea``): the heads' outputs, made by the batch builder
        (``BatchBuilder(raw_heads=False)``); only the UNet sees them.
    A raw field that is set takes precedence over its pre-encoded twin."""

    latents: torch.Tensor        # (B, F, h, w, 4) clean video latents
    ref_latents: torch.Tensor    # (B, h, w, 4) reference latent
    motion_buckets: torch.Tensor  # (B, 2)
    fps: torch.Tensor            # (B,)
    audio_mask: Optional[torch.Tensor] = None    # (B, 1, H, W)
    exp_mask: Optional[torch.Tensor] = None      # (B, 1, H, W)
    audio_feats: Optional[torch.Tensor] = None   # (B, F, 10, 5, 384)
    id_embed: Optional[torch.Tensor] = None      # (B, 512)
    vasa_expr: Optional[torch.Tensor] = None     # (B, F, 512)
    vasa_rot: Optional[torch.Tensor] = None      # (B, F, 3)
    pose_pixels: Optional[torch.Tensor] = None   # (B[, F], H, W, 3)
    id_tokens: Optional[torch.Tensor] = None     # (B, 1, d)
    audio_tokens: Optional[torch.Tensor] = None  # (B, F, 32, d)
    vasa_tokens: Optional[torch.Tensor] = None   # (B, F, 1, d)
    pose_fea: Optional[torch.Tensor] = None      # (B, F, h, w, c0)


class LossDraws(NamedTuple):
    """The four random draws of one ``diffusion_loss`` call (JAX draws them
    from ``jax.random.split(key, 4)``)."""

    sigma_normal: torch.Tensor   # (B,) standard normal
    noise: torch.Tensor          # latents' shape, standard normal
    offset: torch.Tensor         # (B, 1, 1, 1, 1) standard normal
    drop: torch.Tensor           # (B,) bool, conditioning dropped


def sample_draws(batch: TrainBatch, cfg: TrainConfig,
                 generator: torch.Generator, world: int = 1,
                 rank: int = 0) -> LossDraws:
    """The draws of one micro-step. Under data parallelism ``batch`` is
    this rank's rows of a global batch of ``world`` such blocks: every rank
    draws the global batch's draws from the same seeded generator and keeps
    its own rows, so the sharded step is the single-process step (the JAX
    step draws the global batch from one key and the mesh slices it)."""
    lat = batch.latents
    b, dev = lat.shape[0], lat.device
    n = world * b
    kw = dict(generator=generator, device=dev)
    draws = LossDraws(torch.randn(n, **kw), torch.randn((n,) + lat.shape[1:], **kw),
                      torch.randn(n, 1, 1, 1, 1, **kw),
                      torch.rand(n, **kw) < cfg.cond_dropout_prob)
    if world == 1:
        return draws
    return LossDraws(*(d[rank * b:(rank + 1) * b] for d in draws))


def acc_dtype(dtype) -> torch.dtype:
    """The loss's accumulation dtype: fp32, or float64 for a float64 step
    (the CPU parity tests)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def head_tokens(modules: Dict[str, nn.Module], batch: TrainBatch,
                keep: torch.Tensor, dtype=torch.bfloat16):
    """The conditioning of the step. ``keep`` (B,) is 1.0 / 0.0. A raw field
    runs its trainable head inside the differentiable graph, a dropped
    sample's inputs zeroed before the projection (so it equals the
    inference pipeline's unconditional branch); a pre-encoded field's
    tokens are zeroed instead, and ``pose_fea`` passes as it is. Returns
    (id (B,1,d), audio (B,F,32,d), vasa (B,F,1,d), pose_fea (B,F,h,w,c0))."""
    b, f = batch.latents.shape[:2]
    if batch.audio_feats is not None:
        audio = modules["audio_proj"](
            (batch.audio_feats * keep[:, None, None, None, None]).to(acc_dtype(dtype)))
    else:
        audio = batch.audio_tokens * keep[:, None, None, None]
    if batch.id_embed is not None:
        idt = modules["id_proj"](batch.id_embed * keep[:, None])[:, None, :]
    else:
        idt = batch.id_tokens * keep[:, None, None]
    if batch.vasa_expr is not None:
        proj = modules["vasa_proj"](batch.vasa_expr * keep[:, None, None])
        rot = batch.vasa_rot * keep[:, None, None]
        # rotation + translation * 0 (reference Inference.py:498-505)
        pose6 = torch.cat([rot, torch.zeros_like(rot)], dim=-1)
        vasa = torch.cat([proj, pose6], dim=-1)[:, :, None, :]
    else:
        vasa = batch.vasa_tokens * keep[:, None, None, None]
    if batch.pose_pixels is None:
        return idt, audio, vasa, batch.pose_fea
    px = batch.pose_pixels
    if px.ndim == 4:     # one static pose image for every frame
        px = px[:, None].expand(b, f, *px.shape[1:])
    # the JAX guider computes in fp32 on the input rounded to ``dtype``
    pose_fea = modules["pose_guider"](px.to(dtype).to(acc_dtype(dtype)))
    return idt, audio, vasa, pose_fea


def diffusion_loss(modules: Dict[str, nn.Module], batch: TrainBatch,
                   cfg: TrainConfig, draws: Optional[LossDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.bfloat16):
    """Scalar loss and metrics. The random draws come from ``draws`` or, if
    it is None, from ``generator``."""
    if draws is None:
        draws = sample_draws(batch, cfg, generator)
    b, f = batch.latents.shape[:2]
    acc = acc_dtype(dtype)
    sigma = torch.exp(cfg.sigma_p_mean
                      + cfg.sigma_p_std * draws.sigma_normal.to(acc))
    sig = sigma.reshape(b, 1, 1, 1, 1)
    noise = draws.noise.to(acc)
    if cfg.noise_offset:
        noise = noise + cfg.noise_offset * draws.offset.to(acc)
    x0 = batch.latents.to(acc)
    x_sigma = x0 + sig * noise

    keep = torch.where(draws.drop, 0.0, 1.0).to(x0.device)
    id_tok, audio, vasa, pose_fea = head_tokens(modules, batch, keep, dtype)
    cond = Conditioning(
        id_tokens=id_tok.repeat_interleave(f, dim=0).to(dtype),
        audio_tokens=audio.reshape(b * f, *audio.shape[2:]).to(dtype),
        vasa_tokens=vasa.reshape(b * f, *vasa.shape[2:]).to(dtype),
        audio_mask=batch.audio_mask, exp_mask=batch.exp_mask)

    c_in = 1.0 / torch.sqrt(sig ** 2 + 1.0)
    c_skip = 1.0 / (sig ** 2 + 1.0)
    c_out = -sig / torch.sqrt(sig ** 2 + 1.0)
    t_cont = 0.25 * torch.log(sigma)
    ref = batch.ref_latents[:, None].to(acc).expand(x0.shape)
    inp = torch.cat([c_in * x_sigma, ref], dim=-1).to(dtype)
    added = torch.stack([batch.fps, batch.motion_buckets[:, 0],
                         batch.motion_buckets[:, 1]], dim=-1).to(dtype)
    model_out = modules["unet"](inp, t_cont.to(dtype), cond, added,
                                pose_fea.to(dtype)).to(acc)
    denoised = c_skip * x_sigma + c_out * model_out
    weight = (sig ** 2 + 1.0) / sig ** 2
    loss = torch.mean(weight * torch.square(denoised - x0))
    return loss, {"loss": loss.detach(), "sigma_mean": sigma.mean().detach()}


class Optimizer:
    """``optax.MultiSteps(chain(clip_by_global_norm(max), adamw(...)), k)``:
    call ``step()`` after every micro-step's backward. Gradients sum in
    ``.grad``; every k-th call divides by k, clips by the global norm and
    applies AdamW, then clears them. A parameter the forward never reads
    gets a zero gradient at the commit, so AdamW still decays it, as
    ``optax.adamw`` decays every parameter."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.k = max(1, cfg.grad_accum_steps)
        self.max_norm = cfg.max_grad_norm
        self.mini_step = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2),
            eps=cfg.adam_eps, weight_decay=cfg.weight_decay)

    def step(self):
        """Returns (committed, global norm of the applied mean gradient or
        None)."""
        self.mini_step += 1
        if self.mini_step < self.k:
            return False, None
        self.mini_step = 0
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.k > 1:
            torch._foreach_div_(grads, float(self.k))
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        # optax: where(norm < max, g, g / norm * max)
        clip = norm >= self.max_norm
        torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clip, self.max_norm, 1.0))
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        return True, norm


class ShardedOptimizer:
    """ZeRO-2 twin of ``Optimizer`` over the process group's ranks (the same
    contract: call ``step()`` after every micro-step's backward; the result
    is ``MultiSteps(chain(clip_by_global_norm, adamw), k)`` over the global
    batch).

    The parameters become views into one flat buffer
    (``parallel/mesh.ZeroLayout``; no second copy, so ``load_state_dict``
    writes into them). A hook on each parameter copies its gradient into
    the staging buffer of its bucket and frees ``.grad``; a bucket whose
    elements have all arrived is reduce-scattered (sum / world: each
    rank's loss is a mean over its own rows) into this rank's fp32
    accumulator shard, so only buckets still filling hold full gradients.
    ``step()`` then sends the buckets that parameters the forward never
    read kept open (their gradient is zero, so AdamW still decays them),
    and checks that every rank sent the buckets in one order. At the
    commit: divide by k, take the global norm from an all-reduce of the
    shards' squared norms, clip as optax does, run AdamW (decoupled decay)
    on the shard with moments of ``ceil(N / world)`` elements, then
    all-gather the updated parameters bucket by bucket.

    Under tensor parallelism ``group`` is this rank's data-parallel group
    (the ranks holding the same slices) and ZeRO-2 runs over it; the
    parameters are this rank's (``parallel/tensor.py``), those in
    ``tp_sharded`` slices of a whole one. The global norm then counts each
    slice once (its squares summed over ``tp_group``) and each whole
    parameter once (the same on every tp rank)."""

    def __init__(self, params, cfg: TrainConfig, group=None, tp_group=None,
                 tp_sharded=()):
        self.params = [p for p in params if p.requires_grad]
        self.k = max(1, cfg.grad_accum_steps)
        self.max_norm = cfg.max_grad_norm
        self.cfg = cfg
        self.mini_step = self.step_count = 0
        self.group, self.tp_group = group, tp_group
        self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
        # the backward reaches the last-registered parameters first
        order = self.params[::-1]
        dtype, dev = self.params[0].dtype, self.params[0].device
        self.layout = ZeroLayout([p.numel() for p in order], self.world, BUCKET_ELEMS,
                                 align=ALIGN_BYTES // self.params[0].element_size())
        if any(p.dtype != dtype or p.device != dev for p in self.params):
            raise ValueError("ShardedOptimizer: parameters of one dtype and "
                             "device (the fp32 masters) only")
        self.flat = torch.zeros(self.layout.padded, dtype=dtype, device=dev)
        self._where = {}
        with torch.no_grad():
            for p, off in zip(order, self.layout.offsets):
                n = p.numel()
                self.flat[off:off + n].copy_(p.detach().reshape(-1))
                p.data = self.flat[off:off + n].view_as(p)
                self._where[id(p)] = (off, n)
        shard = self.layout.shard_numel
        # 1 where the flat element belongs to a tp slice, in this rank's shard
        mask = torch.zeros(self.layout.padded, dtype=dtype, device=dev)
        sliced = {id(p) for p in tp_sharded}
        for p in order:
            if id(p) in sliced:
                off, n = self._where[id(p)]
                mask[off:off + n] = 1.0
        self.tp_mask = torch.cat([mask[b.start + self.rank * b.chunk:
                                       b.start + (self.rank + 1) * b.chunk]
                                  for b in self.layout.buckets]) if sliced else None
        self.grad = torch.zeros(shard, dtype=dtype, device=dev)
        self.exp_avg = torch.zeros(shard, dtype=dtype, device=dev)
        self.exp_avg_sq = torch.zeros(shard, dtype=dtype, device=dev)
        self._staged: Dict[int, torch.Tensor] = {}
        self._reset_backward()
        self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                       for p in order]

    def _reset_backward(self):
        self._pending = [b.real for b in self.layout.buckets]
        self._seen = set()
        self._sent = []

    def _own(self, t: torch.Tensor, b) -> torch.Tensor:
        """This rank's chunk of bucket ``b`` in a shard-sized tensor."""
        return t[b.shard_start:b.shard_start + b.chunk]

    def _on_grad(self, p: torch.Tensor) -> None:
        if id(p) in self._seen:
            raise RuntimeError("a parameter's gradient arrived twice in one "
                               "backward")
        self._seen.add(id(p))
        off, n = self._where[id(p)]
        g = p.grad.reshape(-1)
        for j in self.layout.buckets_of(off, n):
            b = self.layout.buckets[j]
            lo, hi = max(off, b.start), min(off + n, b.stop)
            self._stage(j)[lo - b.start:hi - b.start].copy_(g[lo - off:hi - off])
            self._pending[j] -= hi - lo
            if self._pending[j] == 0:
                self._send(j)
        p.grad = None

    def _stage(self, j: int) -> torch.Tensor:
        if j not in self._staged:
            b = self.layout.buckets[j]
            self._staged[j] = self.flat.new_zeros(self.world * b.chunk)
        return self._staged[j]

    def _send(self, j: int) -> None:
        """Reduce-scatter bucket ``j`` into the accumulator shard."""
        b = self.layout.buckets[j]
        out = self.flat.new_empty(b.chunk)
        dist.reduce_scatter_tensor(out, self._stage(j), group=self.group)
        del self._staged[j]
        self._own(self.grad, b).add_(out, alpha=1.0 / self.world)
        self._sent.append(j)

    def _finish_backward(self) -> None:
        for j, left in enumerate(self._pending):
            if left:
                self._send(j)
        # every rank must have summed the same bucket at each call: a
        # polynomial hash of the order sent (exact in float64)
        sig = 0
        for j in self._sent:
            sig = (sig * 1000003 + j + 1) % (2 ** 31 - 1)
        t = torch.tensor([sig, -sig], dtype=torch.float64, device=self.flat.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        if t[0].item() != -t[1].item():
            raise RuntimeError("ranks reduced their gradient buckets in "
                               "different orders")
        self._reset_backward()

    def step(self):
        """Returns (committed, global norm of the applied mean gradient or
        None)."""
        self._finish_backward()
        self.mini_step += 1
        if self.mini_step < self.k:
            return False, None
        self.mini_step = 0
        g = self.grad
        if self.k > 1:
            g.div_(float(self.k))
        if self.tp_mask is None:
            sq = torch.linalg.vector_norm(g).square().reshape(1)
            dist.all_reduce(sq, group=self.group)
        else:       # [slices, whole parameters], the slices over tp too
            g2 = g.square()
            sliced = (g2 * self.tp_mask).sum()
            sq = torch.stack([sliced, g2.sum() - sliced])
            dist.all_reduce(sq, group=self.group)
            dist.all_reduce(sq[:1], group=self.tp_group)
            sq = sq.sum().reshape(1)
        norm = sq.sqrt()[0]
        # optax: where(norm < max, g, g / norm * max)
        clip = norm >= self.max_norm
        g.div_(torch.where(clip, norm, 1.0))
        g.mul_(torch.where(clip, self.max_norm, 1.0))
        self._adamw()
        g.zero_()
        return True, norm

    @torch.no_grad()
    def _adamw(self) -> None:
        """``torch.optim.AdamW``'s update on this rank's shard, a bucket's
        chunk at a time, then the all-gather of each bucket."""
        c = self.cfg
        self.step_count += 1
        lr, b1, b2 = c.learning_rate, c.adam_b1, c.adam_b2
        step_size = lr / (1 - b1 ** self.step_count)
        bc2_sqrt = (1 - b2 ** self.step_count) ** 0.5
        for b in self.layout.buckets:
            start = b.start + self.rank * b.chunk
            p = self.flat[start:start + b.chunk]
            g, m, v = (self._own(t, b) for t in (self.grad, self.exp_avg,
                                                 self.exp_avg_sq))
            p.mul_(1 - lr * c.weight_decay)
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / bc2_sqrt).add_(c.adam_eps)
            p.addcdiv_(m, denom, value=-step_size)
            dist.all_gather_into_tensor(self.flat[b.start:b.stop], p.clone(),
                                        group=self.group)


def make_optimizer(modules: Dict[str, nn.Module], cfg: TrainConfig) -> Optimizer:
    return Optimizer([p for m in modules.values() for p in m.parameters()], cfg)


class Trainer:
    """One differentiable micro-step over the trainable modules (``unet``,
    ``pose_guider``, ``audio_proj``, ``id_proj``, ``vasa_proj``; the
    IP-adapter rows live in the UNet) followed by the optimizer.

    With ``sharded`` (a process group is up) the batch is this rank's rows
    of the global batch, the optimizer is ``ShardedOptimizer`` over the
    group's ranks, the draws are the global batch's rows of this rank, and
    the returned ``loss`` is the global mean. Under tensor parallelism
    ``tp_plan`` (``parallel/tensor.shard_modules_``) names the sliced
    parameters and ``group`` is the data-parallel group: the ranks of one
    tp group take the same rows and the same draws."""

    def __init__(self, modules: Dict[str, nn.Module], cfg: TrainConfig,
                 dtype=torch.bfloat16, sharded: bool = False, group=None,
                 tp_plan=None):
        self.modules, self.cfg, self.dtype = modules, cfg, dtype
        self.sharded, self.group = sharded, group
        if sharded:
            self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
            self.optimizer = ShardedOptimizer(
                [p for m in modules.values() for p in m.parameters()], cfg, group,
                None if tp_plan is None else tp_plan.tp.group,
                () if tp_plan is None else tp_plan.sharded_params(modules))
        else:
            self.world, self.rank = 1, 0
            self.optimizer = make_optimizer(modules, cfg)

    def step(self, batch: TrainBatch, draws: Optional[LossDraws] = None,
             generator: Optional[torch.Generator] = None) -> Dict:
        if draws is None:
            draws = sample_draws(batch, self.cfg, generator, self.world, self.rank)
        loss, metrics = diffusion_loss(self.modules, batch, self.cfg, draws,
                                       generator, self.dtype)
        loss.backward()
        metrics["commit"], metrics["grad_norm"] = self.optimizer.step()
        if self.sharded:
            total = metrics["loss"].reshape(1).clone()
            dist.all_reduce(total, group=self.group)
            metrics["loss"] = total[0] / self.world
        return metrics
