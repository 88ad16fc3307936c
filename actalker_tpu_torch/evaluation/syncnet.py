"""SyncNet audio and lip towers for Sync-C / Sync-D, twin of
``actalker_tpu/evaluation/syncnet.py`` and keyed as the reference's
``eval/sync/SyncNetModel.py`` class ``S`` (``syncnet_v2.model``:
``netcnnaud.K`` / ``netfcaud.K`` / ``netcnnlip.K`` / ``netfclip.K``, the
Sequential indices of its layers). ``forward_aud``: (N, 1, 13, 20) MFCC
windows -> (N, 1024); ``forward_lip``: (N, 3, 5, 224, 224) BGR frame stacks
-> (N, 1024). Eval-mode BatchNorm (eps 1e-5); the scoring lives in
``evaluation/sync_eval.py::score_tube``.
"""
from __future__ import annotations

import torch
import torch.nn as nn


def _fc(dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(512, 512), nn.BatchNorm1d(512), nn.ReLU(),
                         nn.Linear(512, dim))


class SyncNet(nn.Module):
    def __init__(self, num_layers_in_fc_layers: int = 1024):
        super().__init__()
        self.netcnnaud = nn.Sequential(
            nn.Conv2d(1, 64, 3, 1, 1), nn.BatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d((1, 1), (1, 1)),
            nn.Conv2d(64, 192, 3, 1, 1), nn.BatchNorm2d(192), nn.ReLU(),
            nn.MaxPool2d((3, 3), (1, 2)),
            nn.Conv2d(192, 384, 3, padding=1), nn.BatchNorm2d(384), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.BatchNorm2d(256), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.BatchNorm2d(256), nn.ReLU(),
            nn.MaxPool2d((3, 3), (2, 2)),
            nn.Conv2d(256, 512, (5, 4), padding=0), nn.BatchNorm2d(512), nn.ReLU())
        self.netfcaud = _fc(num_layers_in_fc_layers)
        self.netfclip = _fc(num_layers_in_fc_layers)
        self.netcnnlip = nn.Sequential(
            nn.Conv3d(3, 96, (5, 7, 7), (1, 2, 2), 0), nn.BatchNorm3d(96), nn.ReLU(),
            nn.MaxPool3d((1, 3, 3), (1, 2, 2)),
            nn.Conv3d(96, 256, (1, 5, 5), (1, 2, 2), (0, 1, 1)), nn.BatchNorm3d(256),
            nn.ReLU(), nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
            nn.Conv3d(256, 256, (1, 3, 3), padding=(0, 1, 1)), nn.BatchNorm3d(256),
            nn.ReLU(),
            nn.Conv3d(256, 256, (1, 3, 3), padding=(0, 1, 1)), nn.BatchNorm3d(256),
            nn.ReLU(),
            nn.Conv3d(256, 256, (1, 3, 3), padding=(0, 1, 1)), nn.BatchNorm3d(256),
            nn.ReLU(), nn.MaxPool3d((1, 3, 3), (1, 2, 2)),
            nn.Conv3d(256, 512, (1, 6, 6), padding=0), nn.BatchNorm3d(512), nn.ReLU())

    def forward_aud(self, x: torch.Tensor) -> torch.Tensor:
        mid = self.netcnnaud(x)
        return self.netfcaud(mid.reshape(mid.shape[0], -1))

    def forward_lip(self, x: torch.Tensor) -> torch.Tensor:
        mid = self.netcnnlip(x)
        return self.netfclip(mid.reshape(mid.shape[0], -1))

    def forward(self, audio, lips):
        return self.forward_aud(audio), self.forward_lip(lips)
