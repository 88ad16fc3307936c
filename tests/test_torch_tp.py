"""PyTorch port, tensor parallelism on the CPU: gloo process groups of
spawned ranks (``tests/torch_dist_workers.py``).

* tp 2 and dp 2 x tp 2 commits of the micro model in float64 (and tp 2 in
  the fused-norm configuration) against the single-process ``Trainer``;
* the rule table at flagship widths against the JAX package's
  ``param_pspec``, each difference listed; ``per_rank_bytes_tp``.
``train.main --tp 2`` and its export: ``test_torch_tp_train.py``.
"""
import math
import os

import numpy as np
import pytest
import torch

from actalker_tpu_torch.models.unet import UNetConfig
from tests import torch_dist_workers as DW
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)


def _ranks(tmp_path, fn, world, *args):
    os.makedirs(tmp_path, exist_ok=True)
    out = str(tmp_path)
    DW.run_ranks(fn, world, out, *args)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ------------------------------------------------------ tensor parallelism

@pytest.mark.parametrize("dp,tp,max_norm,fused", [(1, 2, 1e6, False), (2, 2, 1e-4, False),
                                                  (1, 2, 1e6, True)],
                         ids=["tp 2", "dp 2 x tp 2 clipped", "tp 2 fused-norm"])
def test_tp_commit_equals_single_process(tmp_path, dp, tp, max_norm, fused):
    """One commit (k = 2) of the micro model with block checkpointing in
    float64, every rule-matched layer sliced: the losses rel 1e-9, the
    clipped norm rel 1e-8, the gathered parameters after the commit rel L2
    1e-9 per artifact against the single-process ``Trainer``. (The losses
    read ~4e-11, not the data-parallel test's 1e-12: a tp split sums the
    row-parallel and ``x_dbl`` partial products in another float64 order,
    and the scan and the norm statistics, fp32 in any model, round a few
    of those last-bit differences the other way.)"""
    res = _ranks(tmp_path, DW.tp_commit_rank, dp * tp, dp, tp, max_norm, fused)
    r0 = res[0]
    single = r0["single_records"]
    assert [r["layout"] for r in res] == [(i // tp, i % tp) for i in range(dp * tp)]
    for got in (r["records"] for r in res):
        assert [x["commit"] for x in got] == [False, True]
        for a, b in zip(got, single):
            assert abs(a["loss"] - b["loss"]) <= 1e-9 * abs(b["loss"])
        assert abs(got[1]["grad_norm"] - single[1]["grad_norm"]) \
            <= 1e-8 * single[1]["grad_norm"]
    assert (single[1]["grad_norm"] >= max_norm) == (max_norm < 1.0)
    for name, rel in r0["params_rel"].items():
        assert rel <= 1e-9, (name, rel)
    sliced = r0["sliced"]
    # every kind of sharded layer took part
    for pat in ("attn1.to_q.weight", "attn2.processor.to_k_ip.0.weight",
                "ff.net.0.proj.weight", "ff_in.net.2.weight", "in_proj1.weight",
                "audio_unit.x_proj_weight", "A_logs", "spatial_res_block.conv1.weight",
                "temporal_res_block.conv2.weight", "downsamplers.0.conv.weight"):
        assert any(k.endswith(pat) for k in sliced["unet"]), pat
    assert sliced["audio_proj"] == ["proj1.bias", "proj1.weight", "proj2.bias",
                                    "proj2.weight", "proj3.weight"]
    assert sliced["pose_guider"] == []


# flax kernel axis -> torch weight axis, by the exporter's kind
_AXIS = {"linear": {0: 1, 1: 0}, "conv2": {0: 2, 1: 3, 2: 1, 3: 0},
         "conv3": {0: 2, 1: 3, 2: 4, 3: 1, 4: 0}, "raw": None}
_CONVERTERS = {"unet": None, "pose_guider": "convert_pose_guider",
               "audio_proj": "convert_audio_proj", "id_proj": "convert_id_proj",
               "vasa_proj": "convert_vasa_proj"}


def _jax_axes(art, module):
    """The JAX package's tp axis (as the torch tensor's axis, None when it
    replicates) of each of the port module's keys at tp = 2: its
    ``param_pspec`` (min_size 2 ** 14, as its train.py) on the flax path the
    exporter maps the key to, kept only where the axis divides (as its
    ``shard_params``)."""
    from actalker_tpu.parallel.mesh import param_pspec
    from actalker_tpu_torch.io import jax_export as X

    sd = module.state_dict()
    cap = X._CaptureSD(sd.keys())
    if art == "unet":
        X.convert_unet(cap, **X.unet_block_kwargs(module.config))
    else:
        getattr(X, _CONVERTERS[art])(cap)
    out = {}
    for path, key, kind in cap.spec:
        if key not in sd or kind.startswith("bn_"):
            continue
        flax_shape = X._KINDS[kind][0](np.broadcast_to(np.float32(0), tuple(sd[key].shape))).shape
        spec = tuple(param_pspec(f"{art}/{path}", flax_shape))
        axis = next((i for i, a in enumerate(spec) if a == "tp"), None)
        if axis is not None and flax_shape[axis] % 2:
            axis = None
        if axis is not None and _AXIS[kind] is not None:
            axis = _AXIS[kind][axis]
        out[key] = axis
    return out


def test_rule_table_at_flagship_widths_against_jax():
    """The port's sharding of the five trainable modules at their published
    widths (``UNetConfig()``; shapes only, on the meta device) at tp = 2
    against the JAX rules, mapped through the exporter's names. Every
    difference falls in one of the listed cases:
      * replicated where JAX shards: heads % tp (the 5-head attention at
        C = 320: GSPMD splits a head, the port's kernels take whole heads);
        the SSM's out_proj (its LayerNorm needs the whole d_inner);
      * sharded where JAX replicates: a sliced layer's bias (JAX keeps
        tensors under 2 ** 14 elements whole) and the SSM units'
        per-channel vectors (dt_projs_bias, A_logs, Ds), which go with
        d_inner;
      * another axis: the temporal convs' output channels, where the JAX
        rule names axis 3 of the (kt, kh, kw, in, out) kernel, its input
        channels.
    The port's own rules (``parallel/mesh.param_tp_axis``) name the plan's
    axis for every sliced weight."""
    from actalker_tpu_torch.parallel import mesh as M
    from actalker_tpu_torch.parallel import tensor as TPT

    with torch.device("meta"):
        from actalker_tpu_torch.models.pose_guider import PoseGuider
        from actalker_tpu_torch.models.projections import (
            AudioProjModel, IDProjModel, VasaProjModel)
        from actalker_tpu_torch.models.unet import UNetSpatioTemporalCondition

        mods = {"unet": UNetSpatioTemporalCondition(UNetConfig()),
                "pose_guider": PoseGuider(embedding_channels=320),
                "audio_proj": AudioProjModel(), "id_proj": IDProjModel(),
                "vasa_proj": VasaProjModel()}
    jax_axes = {art: _jax_axes(art, m) for art, m in mods.items()}
    odd_heads = {n + "." for n, a in mods["unet"].named_modules()
                 if hasattr(a, "heads") and hasattr(a, "to_q") and a.heads % 2}
    full = {art: {k: tuple(v.shape) for k, v in m.state_dict().items()}
            for art, m in mods.items()}
    plan = TPT.shard_modules_(mods, TPT.TPGroup(None, 2, 0))
    cases = {"heads % tp": [], "out_proj": [], "bias": [], "ssm vectors": [],
             "temporal conv axis": []}
    n_sliced = 0
    for art, m in mods.items():
        for key, shape in full[art].items():
            lay = plan.layouts[art].get(key)
            mine = None if lay is None else (lay.full_axis if lay.full_axis is not None
                                            else lay.axis)
            n_sliced += lay is not None
            if lay is not None and key.endswith("weight") and lay.pre_shape is None:
                assert M.param_tp_axis(key, shape) == mine, key
            theirs = jax_axes[art].get(key)
            if mine == theirs:
                continue
            if mine is None and art == "unet" and any(key.startswith(n) for n in odd_heads):
                cases["heads % tp"].append(key)
            elif mine is None and key.endswith("out_proj.weight"):
                cases["out_proj"].append(key)
            elif theirs is None and key.endswith("bias") and not key.endswith("dt_projs_bias"):
                cases["bias"].append(key)
            elif theirs is None and key.rsplit(".", 1)[-1] in ("dt_projs_bias", "A_logs", "Ds"):
                cases["ssm vectors"].append(key)
            elif "temporal_res_block.conv" in key and (mine, theirs) == (0, 1):
                cases["temporal conv axis"].append(key)
            else:
                raise AssertionError(f"{art} {key}: port axis {mine}, JAX axis {theirs}")
    assert n_sliced > 100
    assert all(cases.values()), {k: len(v) for k, v in cases.items()}
    # the bytes a rank holds: tp slices / tp, then ZeRO-2 over dp
    n_all = sum(math.prod(x) for x in full["unet"].values())
    n_sl = 2 * sum(p.numel() for p in plan.sharded_params({"unet": mods["unet"]}))
    assert M.per_rank_bytes_tp(0, n_all, 4, 1) == M.per_rank_bytes(n_all, 4)
    two = M.per_rank_bytes_tp(n_sl, n_all - n_sl, 1, 2)
    assert two["masters"] == 4 * (n_sl // 2 + n_all - n_sl) and two["total"] == 4 * two["masters"]
    # the odd-head attentions are res-64's, C = 320 in 5 heads of 64
    assert {mods["unet"].get_submodule(n[:-1]).to_q.weight.shape[1]
            for n in odd_heads} == {320}
