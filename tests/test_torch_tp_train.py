"""PyTorch port, ``train.main --tp 2`` on 2 spawned gloo ranks on the CPU
(``tests/torch_dist_workers.py``): the single process's losses, a resume
from the gathered checkpoint, and the export as one-card files."""
import os
import re

import numpy as np
import torch

from actalker_tpu.io import weights as JW
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu_torch.io import weights as TW
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.training import train as TR
from tests import torch_dist_workers as DW
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "configs", "train.yaml")


def _ranks(tmp_path, fn, world, *args):
    os.makedirs(tmp_path, exist_ok=True)
    out = str(tmp_path)
    DW.run_ranks(fn, world, out, *args)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _config(tmp_path):
    """configs/train.yaml with a commit every micro-step, a checkpoint every
    micro-step and the EMA on; AdamW's eps 1, as ``torch_dist_workers.
    train_config`` sets it, keeps an update proportional to its gradient."""
    with open(CFG) as f:
        text = f.read()
    for key, val in (("gradient_accumulation_steps", "1"), ("learning_rate", "1.0e-2"),
                     ("adam_epsilon", "1.0"), ("checkpointing_steps", "1"),
                     ("use_ema", "true")):
        text = re.sub(rf"{key}: *[^\n#]*", f"{key}: {val}", text)
    path = str(tmp_path / "train.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def test_train_main_tp_exports_one_card_files(tmp_path):
    """``train.main --tp 2`` on 2 ranks (fp32 micro model, a commit, a
    checkpoint and the EMA every micro-step): the single process's losses
    (rel 1e-5) and an export whose six files load with ``strict=True``
    into one process's modules and into the JAX package's converters,
    equal to the single-process run's (rel L2 1e-5); then a resume from its
    own gathered checkpoint."""
    cfg = _config(tmp_path)
    base = ["--config", cfg, "--micro-model", "--synthetic", "3", "--device", "cpu"]
    single = TR.main(base + ["--steps", "3", "--output", str(tmp_path / "one"),
                             "--export-reference", str(tmp_path / "one_x")])
    run = base + ["--output", str(tmp_path / "tp"), "--tp", "2"]
    res = _ranks(tmp_path / "a", DW.tp_main_rank, 2,
                 run + ["--steps", "3", "--export-reference", str(tmp_path / "tp_x")])
    more = _ranks(tmp_path / "b", DW.tp_main_rank, 2, run + ["--steps", "4"])
    assert [r["tp"] for r in res] == [(2, 0), (2, 1)] and res[0]["n_sliced"] > 50
    assert [(r["start_step"], r["final_step"]) for r in more] == [(3, 4), (3, 4)]
    assert all(np.isfinite(x["loss"]) for x in more[0]["records"])
    for a, b in zip(res[0]["records"], single["records"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    assert res[1]["exported"] == [] and len(res[0]["exported"]) == 6
    mods = TR.build_modules(UNetConfig().micro(), "cpu", torch.float32)
    want = {os.path.basename(p): torch.load(p) for p in single["exported"]}
    for path in res[0]["exported"]:
        sd = torch.load(path)
        ref = want[os.path.basename(path)]
        assert sd.keys() == ref.keys()
        num = sum(float((sd[k] - ref[k]).double().square().sum()) for k in ref)
        den = sum(float(ref[k].double().square().sum()) for k in ref)
        assert (num / den) ** 0.5 <= 1e-5, path
    sds = {os.path.basename(p).rsplit("-", 1)[0]: torch.load(p) for p in res[0]["exported"]}
    for stem, name in TW.REFERENCE_ARTIFACTS.items():
        if stem != "adapter_module":
            mods[name].load_state_dict(sds[stem], strict=True)
    TW.load_adapter_modules(mods["unet"], {k: v.numpy() for k, v in
                                           sds["adapter_module"].items()})
    npy = {k: {n: v.numpy() for n, v in sd.items()} for k, sd in sds.items()}
    JW.convert_unet(npy["unet"], **JW.unet_block_kwargs(JUNetConfig().micro()))
    JW.convert_audio_proj(npy["audio_linear"])
    JW.convert_id_proj(npy["id_proj_model"])
    JW.convert_vasa_proj(npy["vasa_linear"])
    JW.convert_pose_guider(npy["pose_guider"])
