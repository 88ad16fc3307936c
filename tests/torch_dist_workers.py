"""Rank functions of the port's data-parallel tests: each runs in a spawned
process (``run_ranks``), joins a gloo group on a free local port, works on
the CPU and writes what it saw to ``out/rank<r>.pt``. This module imports
no JAX, so a rank starts in the seconds torch's import takes."""
import dataclasses
import os
import socket

import numpy as np
import torch
import torch.multiprocessing as mp

from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.parallel import distributed as P
from actalker_tpu_torch.parallel.mesh import shard_batch
from actalker_tpu_torch.training import train as TR
from actalker_tpu_torch.training import trainer as T

GLOBAL_BATCH = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, world: int, *args) -> None:
    """``fn(rank, world, port, *args)`` in ``world`` spawned processes."""
    mp.start_processes(fn, args=(world, free_port()) + args, nprocs=world,
                       join=True, start_method="spawn")


def join(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(2)
    assert P.init_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}",
                              world_size=world, rank=rank)


def micro_config() -> UNetConfig:
    return dataclasses.replace(UNetConfig().micro(), gradient_checkpointing=True)


def micro_modules():
    """The five trainable micro modules, seeded, computing in float64."""
    mods = TR.build_modules(micro_config(), "cpu", torch.float64)
    return {n: m.double() for n, m in mods.items()}


def global_batches(n: int = 2):
    """``n`` float64 global batches of GLOBAL_BATCH rows (2 frames, 8 x 8
    latents)."""
    gen = TR.synthetic_batches(GLOBAL_BATCH, 2, 8, seed=3)
    out = []
    for _ in range(n):
        b = next(gen)
        out.append(T.TrainBatch(*(x.double() if torch.is_tensor(x) else x
                                  for x in b)))
    return out


def train_config(max_grad_norm: float) -> T.TrainConfig:
    """k = 2. ``adam_eps`` 1: AdamW's first update is otherwise near
    sign(g), which turns the last-bit differences of gradients near zero
    into whole steps; with eps 1 the update stays proportional to the
    gradient, so comparing updates compares the gradients."""
    return T.TrainConfig(grad_accum_steps=2, learning_rate=1e-3, adam_eps=1.0,
                         max_grad_norm=max_grad_norm, cond_dropout_prob=0.5)


def run_commit(trainer, batches, rank=None, world=None):
    """Two micro-steps (one commit) from generator seed 7; the records."""
    gen = torch.Generator().manual_seed(7)
    recs = []
    for gb in batches:
        b = gb if rank is None else shard_batch(gb, world, rank)
        m = trainer.step(b, generator=gen)
        recs.append({"loss": float(m["loss"]), "commit": m["commit"],
                     "grad_norm": None if m["grad_norm"] is None
                     else float(m["grad_norm"])})
    return recs


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def commit_rank(rank, world, port, out, max_grad_norm):
    """One sharded commit over the global batches. Rank 0 also runs the
    single-process ``Trainer`` on the same global batches and records, per
    artifact, the rel L2 of the sharded parameters and of their update
    against it; every rank records whether its parameters equal rank 0's
    and what its optimizer state holds."""
    join(rank, world, port)
    mods = micro_modules()
    before = torch.cat([p.detach().reshape(-1).clone() for m in mods.values()
                        for p in m.parameters()])
    trainer = T.Trainer(mods, train_config(max_grad_norm), torch.float64,
                        sharded=True)
    opt = trainer.optimizer
    recs = run_commit(trainer, global_batches(), rank, world)
    ref = opt.flat.clone()
    P.dist.broadcast(ref, 0)
    res = {"records": recs, "numel": opt.layout.numel,
           "same_as_rank0": torch.equal(ref, opt.flat),
           "moments": [opt.exp_avg.numel(), opt.exp_avg_sq.numel()],
           "grad": opt.grad.numel(),
           "bytes": {"masters": opt.flat.numel() * 8, "grads": opt.grad.numel() * 8,
                     "moments": (opt.exp_avg.numel() + opt.exp_avg_sq.numel()) * 8},
           "views": all(p.untyped_storage().data_ptr()
                        == opt.flat.untyped_storage().data_ptr()
                        for m in mods.values() for p in m.parameters()),
           "aligned": all((p.data_ptr() - opt.flat.data_ptr()) % 256 == 0
                          for m in mods.values() for p in m.parameters())}
    if rank == 0:
        single = micro_modules()
        res["single_records"] = run_commit(
            T.Trainer(single, train_config(max_grad_norm), torch.float64),
            global_batches())
        res["params_rel"], res["update_rel"] = {}, {}
        off = 0
        for name, m in mods.items():
            a = torch.cat([p.detach().reshape(-1) for p in m.parameters()])
            b = torch.cat([p.detach().reshape(-1) for p in single[name].parameters()])
            b0 = before[off:off + a.numel()]
            off += a.numel()
            res["params_rel"][name] = rel_l2(a, b)
            res["update_rel"][name] = rel_l2(a - b0, b - b0)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    P.dist.destroy_process_group()


def train_main_rank(rank, world, port, out, argv):
    """``train.main`` under torchrun's environment on the CPU; records
    whether the parameters it started from equal the latest checkpoint's
    and whether its final parameters equal rank 0's."""
    from actalker_tpu_torch.io import checkpoint as ckpt

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    out_dir = argv[argv.index("--output") + 1]
    seen = {}

    def observe(trainer, rec):
        if rec is None and ckpt.latest_checkpoint(out_dir) is not None:
            saved = ckpt.restore_checkpoint(out_dir)["params"]
            seen["resumed_equal"] = all(
                torch.equal(v, saved[n][k])
                for n, m in trainer.modules.items() for k, v in m.state_dict().items())

    assert P.init_distributed("cpu")     # from the environment, as torchrun
    res = TR.main(argv, observe=observe)
    flat = torch.cat([p.detach().reshape(-1) for m in res["modules"].values()
                      for p in m.parameters()])
    ref = flat.clone()
    P.dist.broadcast(ref, 0)
    torch.save({"records": res["records"], "start_step": res["start_step"],
                "final_step": res["final_step"], "exported": res["exported"],
                "same_as_rank0": torch.equal(ref, flat), **seen},
               os.path.join(out, f"rank{rank}.pt"))
    P.dist.destroy_process_group()


def serve_pipeline():
    """A seeded micro pipeline (tiny VAE) whose UNet computes in float64."""
    from actalker_tpu_torch.io.init import random_init_
    from actalker_tpu_torch.models.vae import VAEConfig
    from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline, PipelineModules

    with torch.device("meta"):
        mods = PipelineModules.create(
            unet_config=dataclasses.replace(UNetConfig().micro(),
                                            block_out_channels=(64, 64)),
            vae_config=VAEConfig().tiny(), dtype=torch.float64)
    for i, m in enumerate(mods.named().values()):
        random_init_(m, seed=i, device="cpu").eval()
    mods.unet.double()
    # weights visible in the output (random_init_'s 0.02 barely moves it)
    with torch.no_grad():
        for p in mods.unet.parameters():
            p.mul_(5.0)
    return ACTalkerPipeline(mods, dtype=torch.float64)


def serve_config():
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig

    return SamplerConfig(num_inference_steps=2, frames_per_batch=2, overlap=0,
                         shift_offset=1, gate=(1, 0))


SERVE_BOXES = (16, 28, 40)


def prepare_identity(pipe, cfg, i, nf=3, px=64):
    """``prepare_sampling`` for identity i: its own tokens, seed and a face
    box of side SERVE_BOXES[i] as the audio mask (mode 0)."""
    box = SERVE_BOXES[i]
    rng = np.random.default_rng(30 + i)
    mask = np.zeros((1, 1, px, px), np.float32)
    mask[..., 8:8 + box, 12:12 + box] = 1.0
    return pipe.prepare_sampling(
        rng.uniform(-1, 1, (px, px, 3)).astype(np.float32),
        rng.standard_normal(512).astype(np.float32),
        rng.standard_normal((nf, 32, 1024)).astype(np.float32),
        np.zeros((nf, 32, 1024), np.float32),
        rng.standard_normal((nf, 1, 1024)).astype(np.float32),
        np.zeros((nf, 1, 1024), np.float32),
        rng.uniform(0, 1, (nf, px, px, 3)).astype(np.float32), cfg, seed=i,
        audio_mask=mask)


def sample_all(pipe, cfg, n_identities, group=None):
    """``serving.sample_video_batch`` over every identity's prepared
    inputs (the UNet's SSM budget left as it is: masked-dense)."""
    from actalker_tpu_torch.pipeline import serving

    prep = [prepare_identity(pipe, cfg, i) for i in range(n_identities)]
    return serving.sample_video_batch(
        pipe.m.unet, cfg, prep[0][0], serving.stack_buffers([p[1] for p in prep]),
        torch.stack([p[2] for p in prep]), [p[3] for p in prep], torch.float64,
        group=group)


def serve_rank(rank, world, port, out, n_identities):
    """This rank's block of the identities through the rank-split
    ``generate_latents_batch``; rank 0 saves what it gathered, with the
    budgets the UNet was given."""
    join(rank, world, port)
    pipe, cfg = serve_pipeline(), serve_config()
    rows = P.rank_block(n_identities)
    seen = []
    real = pipe.m.unet.set_mask_capacity
    pipe.m.unet.set_mask_capacity = lambda c: (seen.append(c), real(c))[1]
    got = pipe.generate_latents_batch(
        [prepare_identity(pipe, cfg, i) for i in range(rows.start, rows.stop)],
        cfg, group=P.dist.group.WORLD)
    # the low-level entry: every rank passes all identities' inputs
    low = sample_all(pipe, cfg, n_identities, group=P.dist.group.WORLD)
    torch.save({"latents": got, "low": low, "budgets": seen,
                "rows": (rows.start, rows.stop)}, os.path.join(out, f"rank{rank}.pt"))
    P.dist.destroy_process_group()
