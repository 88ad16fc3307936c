"""Seeded stand-ins for the six evaluation checkpoints and the two DWPose
files, at their published widths and keyed as the reference's files (the
repository holds none of the real ones): what the evaluation and DWPose
tests and ``chip_smoke.py`` run with (``write_seeded_weights``,
``write_seeded_dwpose``). The scores and poses they give check the
plumbing, not a clip.
"""
from __future__ import annotations

import os
from typing import Callable, Dict

import torch
import torch.nn as nn

from actalker_tpu_torch.evaluation.i3d import InceptionI3D
from actalker_tpu_torch.evaluation.inception import FIDInceptionV3
from actalker_tpu_torch.evaluation.lpips import LPIPSAlex
from actalker_tpu_torch.evaluation.s3fd import S3FDNet
from actalker_tpu_torch.evaluation.syncnet import SyncNet
from actalker_tpu_torch.models.common import FrozenBatchNorm
from actalker_tpu_torch.models.rtmpose import RTMPoseNet
from actalker_tpu_torch.models.senet import SENet50
from actalker_tpu_torch.models.yolox import YoloXNet

# metric key -> (file name under the weights directory, the network)
EVAL_FILES: Dict[str, tuple] = {
    "syncnet": ("syncnet_v2.model", SyncNet),
    "s3fd": ("sfd_face.pth", S3FDNet),
    "fid_inception": ("pt_inception-2015-12-05.pth", FIDInceptionV3),
    "i3d": ("i3d_rgb_charades.pt", InceptionI3D),
    "senet50": ("senet50_ft_weight.pth", SENet50),
    "lpips": ("lpips_alex.pth", LPIPSAlex),
}
# the DWPose files (``tools/download_models.py``'s names under checkpoints/):
# YOLOX-L and RTMPose-l wholebody (133 keypoints, 288 x 384)
DWPOSE_FILES: Dict[str, tuple] = {
    "yolox": ("yolox_l.pth", YoloXNet),
    "dwpose": ("dw-ll_ucoco_384.pth", RTMPoseNet),
}


@torch.no_grad()
def seeded(build: Callable[[], nn.Module], seed: int) -> nn.Module:
    """``build()`` under ``torch.manual_seed(seed)`` (torch's default
    initializers), its BatchNorm statistics drawn away from the identity
    (means N(0, 0.05^2), variances U(0.7, 1.4)) and LPIPS's heads made
    non-negative, as the released ones are; in eval mode."""
    torch.manual_seed(seed)
    net = build()
    for m in net.modules():
        if isinstance(m, (nn.modules.batchnorm._BatchNorm, FrozenBatchNorm)):
            m.running_mean.normal_(0.0, 0.05)
            m.running_var.uniform_(0.7, 1.4)
    if isinstance(net, LPIPSAlex):
        for lin in net.lins:
            lin.model[1].weight.abs_()
    return net.eval()


def write_seeded_weights(out_dir: str, seed: int = 0) -> Dict[str, str]:
    """Write the six files under ``out_dir``; returns key -> path."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for i, (key, (name, build)) in enumerate(EVAL_FILES.items()):
        paths[key] = os.path.join(out_dir, name)
        torch.save(seeded(build, seed + i).state_dict(), paths[key])
    return paths



def write_seeded_dwpose(out_dir: str, seed: int = 0) -> Dict[str, str]:
    """Write the two DWPose files under ``out_dir``; returns key -> path."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for i, (key, (name, build)) in enumerate(DWPOSE_FILES.items()):
        paths[key] = os.path.join(out_dir, name)
        torch.save(seeded(build, seed + i).state_dict(), paths[key])
    return paths
