"""Process-group set-up for data-parallel runs, twin of
``actalker_tpu/parallel/distributed.py``.

The reference trains with accelerate + DeepSpeed ZeRO-2 over NCCL
(``ds_zero2_8gpu.yaml``); the port launches one process a card with
``torchrun``, which exports ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``:

    torchrun --nproc_per_node N -m actalker_tpu_torch.training.train ...

``init_distributed`` joins that group (NCCL on the card, gloo only for
``--device cpu``) and pins the rank's card; without the environment or
explicit arguments it does nothing, and the helpers below then answer for
one process (rank 0 of 1). A failed ``init_process_group`` raises: no run
carries on single-process when it was asked to be distributed.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Join the process group that torchrun's environment (or the explicit
    ``init_method`` / ``world_size`` / ``rank``) describes. Returns whether
    a process group is up; False, touching nothing, when neither asks for
    one. The backend is NCCL for a CUDA ``device`` and gloo for the CPU;
    on the card the rank takes ``cuda:LOCAL_RANK`` (else ``cuda:rank``)."""
    env = os.environ
    want = (init_method is not None or world_size is not None
            or "WORLD_SIZE" in env)
    if not want:
        return False
    if dist.is_initialized():
        return True
    world = int(world_size if world_size is not None else env["WORLD_SIZE"])
    rank = int(rank if rank is not None else env["RANK"])
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the NCCL process group; "
                               "pass --device cpu for gloo on the CPU")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    return True


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group)


def mesh_groups(dp: int, tp: int):
    """The (dp, tp) rank layout with tp the fast axis, as the JAX package's
    ``make_mesh`` reshapes its devices (dp, tp): rank = i_dp * tp + i_tp.
    Builds every dp and tp subgroup (each rank takes part in every
    ``new_group`` call) and returns (this rank's dp group, its tp group,
    i_dp, i_tp)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp != world:
        raise ValueError(f"dp {dp} x tp {tp} != world {world}")
    mine_dp = mine_tp = None
    for i_tp in range(tp):
        g = dist.new_group([i_dp * tp + i_tp for i_dp in range(dp)])
        if rank % tp == i_tp:
            mine_dp = g
    for i_dp in range(dp):
        g = dist.new_group([i_dp * tp + i_tp for i_tp in range(tp)])
        if rank // tp == i_dp:
            mine_tp = g
    return mine_dp, mine_tp, rank // tp, rank % tp


def local_batch_slice(global_batch: int, world: Optional[int] = None,
                      rank: Optional[int] = None) -> slice:
    """This rank's rows of a global batch that divides evenly over the
    ranks."""
    world = world_size() if world is None else world
    rank = get_rank() if rank is None else rank
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{world} ranks")
    per = global_batch // world
    return slice(per * rank, per * (rank + 1))


def rank_block(n: int, world: Optional[int] = None,
               rank: Optional[int] = None) -> slice:
    """This rank's contiguous block of ``n`` items (identities): blocks of
    ceil(n / world) in rank order, the last one shorter or empty."""
    world = world_size() if world is None else world
    rank = get_rank() if rank is None else rank
    per = -(-n // world)
    return slice(min(n, per * rank), min(n, per * (rank + 1)))


def all_reduce_max(values: List[float], device, group=None) -> List[float]:
    """Element-wise MAX of ``values`` over the ranks of ``group``."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


_MAX_DIMS = 8


def gather_blocks(block: Optional[torch.Tensor], device,
                  dtype=torch.float32, group=None) -> Optional[torch.Tensor]:
    """Concatenate every rank's ``block`` on rank 0, in rank order. A block
    has a leading axis of any length and the same trailing axes and dtype
    on every rank; a rank with nothing passes None. Returns the
    concatenation on rank 0 and None on the others. The blocks travel
    padded to the longest, as NCCL's gather wants equal sizes."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    meta = torch.zeros(_MAX_DIMS + 1, dtype=torch.int64, device=device)
    if block is not None:
        if block.ndim > _MAX_DIMS or block.dtype != dtype:
            raise ValueError(f"gather_blocks: {block.ndim}-d {block.dtype} block")
        meta[0] = block.ndim
        meta[1:1 + block.ndim] = torch.tensor(block.shape)
    metas = [torch.empty_like(meta) for _ in range(world)]
    dist.all_gather(metas, meta, group=group)
    metas = [m.tolist() for m in metas]
    shapes = {tuple(m[2:1 + m[0]]) for m in metas if m[0]}
    if len(shapes) != 1:
        raise ValueError(f"gather_blocks: trailing shapes {shapes} across ranks")
    trailing = shapes.pop()
    lens = [m[1] if m[0] else 0 for m in metas]
    padded = torch.zeros((max(lens),) + trailing, dtype=dtype, device=device)
    if block is not None:
        padded[:block.shape[0]] = block
    root = dist.get_global_rank(group, 0) if group is not None else 0
    bufs = [torch.empty_like(padded) for _ in range(world)] if rank == 0 else None
    dist.gather(padded, bufs, dst=root, group=group)
    if rank != 0:
        return None
    return torch.cat([b[:n] for b, n in zip(bufs, lens)])
