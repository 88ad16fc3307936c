"""Driver of the fine-tuning traffic: micro-steps of the port's
``training.trainer.Trainer`` at ``configs/train.yaml``'s operating point.

Set-up builds the five trainable modules (UNet with block checkpointing,
pose guider, audio / identity / expression heads) with seeded fp32
weights, the ``Trainer`` over them, and drives that same trainer from the
seed through its first ``follow_commits`` accumulation cycles, recording
each micro-step's loss, the first commit's gradient as the optimizer got
it (AdamW's first moment after one step, over 1 - beta1), and each
parameter's change after the last of them. Every micro-step takes a new
batch and new loss draws made on the device from the seed (raw-head
batches, as ``train.py --synthetic`` makes them). The window then goes on
with the same trainer; a call is one accumulation cycle, its commit
included, and the unit is the micro-step.

The check runs the plain fp32 reference (``reference/train.py``) through
the same first cycles from weights made again from the seed and compares
the three readings by the worst micro-step or parameter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Dict, List

import torch

from portbench import roofline, weights
from portbench.drivers import sampler as base
from portbench.reference import heads as ref_heads
from portbench.reference import ops as ref_ops
from portbench.reference import train as ref_train
from portbench.reference.unet import UNet

# limits of the compared numbers, set from the readings in PERF.md; the
# first gradient's gap (``grad_err``) is printed but not compared: neither
# the control nor a fault reads 3x / 10x its sound readings
LIMIT = {"loss_err": 0.01, "change_err": 0.055}
# a parameter whose reference gradient is under this share of the median
# parameter's moves under Adam by round-off alone: left out of the change
NOUGHT = 1e-3


def reference_modules(config: dict) -> Dict[str, torch.nn.Module]:
    """The five trainable modules of the reference, on the meta device."""
    h = config["heads"]
    sizes = base.sizes_of(config)
    with torch.device("meta"):
        return {"unet": UNet(sizes),
                "pose_guider": ref_heads.PoseGuider(
                    sizes.block_out_channels[0], h["pose_guider"]["block_out_channels"]),
                "audio_proj": ref_heads.AudioProjModel(),
                "id_proj": ref_heads.IDProjModel(),
                "vasa_proj": ref_heads.VasaProjModel(output_dim=h["vasa_proj"]["output_dim"])}


def seeded(mods, seed: int, dev) -> Dict[str, Dict[str, torch.Tensor]]:
    return {n: weights.seeded_state(m, seed, dev, salt=i)
            for i, (n, m) in enumerate(mods.items())}


def batch_of(config: dict, seed: int, i: int, dev) -> dict:
    """Micro-step ``i``'s raw-head batch (one clip) and loss draws."""
    t = config["training"]
    f, px = t["n_sample_frames"], t["image_size"]
    hw, b = px // 8, t["train_bs"]
    g = weights.generator(seed, 2000 + i, dev)

    def rn(*s):
        return torch.randn(*s, generator=g, device=dev)

    batch = {"latents": rn(b, f, hw, hw, 4), "ref_latents": rn(b, hw, hw, 4),
             "audio_feats": rn(b, f, 10, 5, 384), "id_embed": rn(b, 512),
             "vasa_expr": rn(b, f, 512), "vasa_rot": rn(b, f, 3),
             "pose_pixels": torch.rand(b, px, px, 3, generator=g, device=dev),
             "audio_mask": torch.ones(b, 1, px, px, device=dev),
             "exp_mask": torch.ones(b, 1, px, px, device=dev),
             "motion_buckets": torch.full((b, 2), t["motion_bucket_id"], device=dev),
             "fps": torch.full((b,), t["fps"], device=dev)}
    draws = {"sigma_normal": rn(b), "noise": rn(b, f, hw, hw, 4),
             "offset": rn(b, 1, 1, 1, 1),
             "drop": torch.rand(b, generator=g, device=dev) < t["conditioning_dropout_prob"]}
    return batch, draws


def train_config(config: dict) -> dict:
    return dict(config["training"])


@dataclasses.dataclass
class State:
    config: dict
    traffic: dict
    seed: int
    dev: torch.device
    sizes: object
    trainer: object = None
    mods: dict = None
    micro: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    first_grad: Dict[str, float] = None
    change: Dict[str, float] = None
    window_losses: List[torch.Tensor] = dataclasses.field(default_factory=list)
    commits: int = 0


def _port_modules(config: dict, seed: int, dev):
    from actalker_tpu_torch.models.pose_guider import PoseGuider
    from actalker_tpu_torch.models.projections import (
        AudioProjModel, IDProjModel, VasaProjModel)
    from actalker_tpu_torch.models.unet import UNetSpatioTemporalCondition

    sizes = base.sizes_of(config)
    dt = base.dtype_of(config)
    h = config["heads"]
    with torch.device("meta"):
        mods = {"unet": UNetSpatioTemporalCondition(base.port_unet_config(sizes), dtype=dt),
                "pose_guider": PoseGuider(sizes.block_out_channels[0],
                                          tuple(h["pose_guider"]["block_out_channels"])),
                "audio_proj": AudioProjModel(), "id_proj": IDProjModel(),
                "vasa_proj": VasaProjModel(output_dim=h["vasa_proj"]["output_dim"])}
    base._log("module trees built")
    states = seeded(reference_modules(config), seed, dev)
    base._sync(dev)
    base._log("weights drawn")
    for n, m in mods.items():
        m.to_empty(device=dev)
        m.load_state_dict(states[n], strict=True)
        m.train()
    return mods


def _port_batch(config: dict, seed: int, i: int, dev):
    from actalker_tpu_torch.training.trainer import LossDraws, TrainBatch

    b, d = batch_of(config, seed, i, dev)
    return (TrainBatch(**b), LossDraws(d["sigma_normal"], d["noise"], d["offset"],
                                       d["drop"]))


def _named(mods) -> Dict[str, torch.Tensor]:
    return {f"{n}.{k}": p for n, m in mods.items() for k, p in m.named_parameters()}


def _micro_step(st: State):
    batch, draws = _port_batch(st.config, st.seed, st.micro, st.dev)
    m = st.trainer.step(batch, draws=draws)
    st.micro += 1
    st.commits += int(m["commit"])
    return m


def setup(cell, seed: int, dev) -> State:
    from actalker_tpu_torch.training.trainer import TrainConfig, Trainer

    config, traffic = cell.config, cell.traffic
    base.build_kernels(dev, ("ssm_scan_grouped", "ssm_scan_bwd", "mha", "mha_bwd",
                             "frame_attention", "geglu_mlp"))
    st = State(config, traffic, seed, dev, base.sizes_of(config))
    base._log("kernels loaded")
    st.mods = _port_modules(config, seed, dev)
    base._log("weights made")
    t = config["training"]
    tcfg = TrainConfig(
        learning_rate=t["learning_rate"], adam_b1=t["adam_beta1"],
        adam_b2=t["adam_beta2"], adam_eps=t["adam_epsilon"],
        weight_decay=t["adam_weight_decay"], max_grad_norm=t["max_grad_norm"],
        grad_accum_steps=t["gradient_accumulation_steps"],
        cond_dropout_prob=t["conditioning_dropout_prob"], noise_offset=t["noise_offset"],
        sigma_p_mean=t["sigma_p_mean"], sigma_p_std=t["sigma_p_std"])
    st.trainer = Trainer(st.mods, tcfg, base.dtype_of(config))
    named = _named(st.mods)
    k, b1 = tcfg.grad_accum_steps, tcfg.adam_b1
    for cycle in range(traffic["follow_commits"]):
        for _ in range(k):
            st.losses.append(float(_micro_step(st)["loss"]))
        base._log(f"commit {cycle + 1} followed")
        if cycle == 0:
            state = st.trainer.optimizer.adamw.state
            # an optimizer that holds no first moment got no gradient
            st.first_grad = {n: float(state[p]["exp_avg"].norm()) / (1.0 - b1)
                             if "exp_avg" in state.get(p, {}) else 0.0
                             for n, p in named.items()}
    st.change = _changes(named, config, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return st


@torch.no_grad()
def _changes(named: Dict[str, torch.Tensor], config: dict, seed: int, dev):
    """Each parameter's change from the seeded start: name -> norm."""
    start = {f"{n}.{k}": v for n, sd in seeded(reference_modules(config), seed, dev).items()
             for k, v in sd.items()}
    return {n: float((p.detach().float() - start[n]).norm()) for n, p in named.items()}


def call(st: State) -> int:
    k = st.trainer.optimizer.k
    for _ in range(k):
        st.window_losses.append(_micro_step(st)["loss"])
    return k


@contextlib.contextmanager
def instrument(st: State, readings):
    kernels = base.kernel_objects(("ssm_scan_grouped", "ssm_scan_bwd", "mha",
                                   "mha_bwd", "frame_attention", "geglu_mlp"))
    before = {n: k.launches for n, k in kernels.items()}
    commits = st.commits
    try:
        yield
    finally:
        readings.launches = {n: k.launches - before[n] for n, k in kernels.items()}
        readings.commits = st.commits - commits


def outcome(st: State):
    bad = sum(1 for l in st.window_losses if not bool(torch.isfinite(l)))
    return len(st.window_losses), bad


def yardsticks(st: State, readings) -> None:
    t = st.config["training"]
    readings.bounds = roofline.micro_step_bounds(
        st.sizes, t["n_sample_frames"], t["image_size"] // 8)


def end_to_end(st: State, window_s: float, units: int) -> dict:
    return {"micro_step_s": window_s / units}


def release(st: State) -> None:
    st.trainer = st.mods = None
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_run(config: dict, seed: int, dev, micro_steps: int, flops=None,
                  keep_frames=None, scale_update=None):
    """The reference through ``micro_steps`` micro-steps from the seeded
    start: (losses, first commit's gradient norms, changes) by name.
    ``keep_frames`` and ``scale_update`` ((name, factor): every commit's
    update of that parameter scaled) plant the faults the limits are read
    against (``portbench/readings.py``)."""
    ref_ops.fp32_matmul()
    mods = reference_modules(config)
    for n, sd in seeded(mods, seed, dev).items():
        mods[n].load_state_dict(sd, strict=True, assign=True)
        mods[n].train()
    named = _named(mods)
    opt = ref_train.AdamW(list(named.values()), train_config(config))
    losses = []
    for i in range(micro_steps):
        batch, draws = batch_of(config, seed, i, dev)
        ctx = flops if (flops is not None and i == 0) else contextlib.nullcontext()
        with ctx:
            loss = ref_train.loss_of(mods, batch, draws, config["training"],
                                     keep_frames)
        loss.backward()
        losses.append(float(loss.detach()))
        before = None
        if scale_update is not None:
            before = named[scale_update[0]].detach().clone()
        if opt.step() and before is not None:
            with torch.no_grad():
                p = named[scale_update[0]]
                p.copy_(before + scale_update[1] * (p - before))
    grads = dict(zip(named, opt.first_grads))
    change = _changes(named, config, seed, dev)
    return losses, grads, change


def worst(prog: Dict[str, float], ref: Dict[str, float], n: int = 4):
    """The ``n`` parameters whose norms differ most against the larger of
    their reference norm and the median's: [(name, prog, ref)]."""
    import statistics

    med = statistics.median(ref.values())
    key = sorted(ref, key=lambda k: -abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return [(k, prog[k], ref[k]) for k in key[:n]]


def moved(change: Dict[str, float], ref_grad: Dict[str, float]) -> Dict[str, float]:
    """The changes of the parameters whose reference gradient is not
    nought to rounding (at least ``NOUGHT`` of the median's)."""
    import statistics

    med = statistics.median(ref_grad.values())
    return {n: c for n, c in change.items() if ref_grad[n] >= NOUGHT * med}


def compare(prog_losses, prog_grad, prog_change, ref_losses, ref_grad, ref_change):
    """(loss_err, grad_err, change_err): the worst micro-step's relative
    loss gap; the worst parameter's gap of norms against the larger of its
    reference norm and the median parameter's, for the first gradient and
    for the change (leaving out parameters whose reference gradient is
    nought to rounding)."""
    import statistics

    loss_err = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses))
    med_g = statistics.median(ref_grad.values())
    grad_err = max(abs(prog_grad[n] - g) / max(g, med_g, 1e-30) for n, g in ref_grad.items())
    kept = moved(ref_change, ref_grad)
    med_c = statistics.median(kept.values())
    change_err = max(abs(prog_change[n] - ref_change[n]) / max(ref_change[n], med_c, 1e-30)
                     for n in kept)
    return loss_err, grad_err, change_err


def check(st: State, trace: bool, readings) -> list:
    counter = None
    if trace:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
    losses, grads, change = reference_run(st.config, st.seed, st.dev,
                                          len(st.losses), counter)
    if counter is not None:
        # forward + backward: twice the forward's products again (block
        # checkpointing's recompute not counted)
        readings.flops_per_unit = 3.0 * counter.get_total_flops()
    errs = dict(zip(("loss_err", "grad_err", "change_err"),
                    compare(st.losses, st.first_grad, st.change, losses, grads, change)))
    print(f"[portbench] grad_err {errs['grad_err']!r} (not compared); worst "
          f"gradients {worst(st.first_grad, grads)}; worst changes "
          f"{worst(st.change, moved(change, grads))}", file=sys.stderr)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    return [(n, errs[n], lim) for n, lim in LIMIT.items()]
