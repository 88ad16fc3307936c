"""Build ``TrainBatch`` tensors from raw dataset samples, twin of
``actalker_tpu/training/batch_builder.py``: the frozen encoders (the VAE,
whisper, the VASA towers, ArcFace) turn the host samples of
``training/data.py`` into the trainer's batch, channels last, on the
pipeline's device.

Raw-sample contract (what ``PortraitAudioDataset`` emits): pixel ``frames``
/ ``ref_frame`` in [-1, 1], a 112x112 ``head_crop`` in [-1, 1] (ArcFace's
input), 256x256 ``vasa_face`` / ``vasa_pose`` crops in [0, 1] (the VASA
towers' inputs), the ``audio_features`` log-mel (80, <= 3000) of the clip's
30-second window with the window-local ``audio_offset`` and the clip's
``audio_step``, and the mask / bucket scalars.

The batch carries the trainable heads' inputs (whisper windows, the ArcFace
embedding, the VASA expression and rotation, the pose pixels), and the
train step runs the heads (the JAX builder's ``raw_heads=True``, which its
``train.py`` always passes). Its pre-encoded mode, where the builder
projects the conditioning and the step trains the UNet alone, has no
caller and is not ported.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from actalker_tpu_torch.training.trainer import TrainBatch
from actalker_tpu_torch.utils.observability import get_logger

log = get_logger("batch_builder")


class BatchBuilder:
    def __init__(self, pipe, fps: float = 12.5,
                 arcface: Optional[torch.nn.Module] = None,
                 encode_chunk: int = 16):
        """``pipe``: an ``ACTalkerPipeline`` whose heads are the trainer's own
        modules. ``arcface``: an optional module mapping (B, 112, 112, 3) in
        [-1, 1] to (B, 512); without it identity conditioning is a zero
        embedding, said once.
        ``encode_chunk``: at most this many frames per VAE call (a global
        batch of frames in one encode holds multi-GiB activations).
        ``seconds`` holds the last call's time, the device synchronized."""
        self.pipe = pipe
        self.fps = fps
        self.arcface = arcface
        self.encode_chunk = encode_chunk
        self.device = pipe.device
        self.seconds = 0.0
        self._warned: set = set()

    def _warn_once(self, key: str, msg: str) -> None:
        if key not in self._warned:
            self._warned.add(key)
            log.warning(msg)

    def _t(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _id_embeds(self, samples) -> torch.Tensor:
        if self.arcface is not None and all("head_crop" in s for s in samples):
            return self.arcface(self._t(np.stack([s["head_crop"] for s in samples]))
                                ).float()
        self._warn_once(
            "id", "no ArcFace module or no head crops: identity "
            "conditioning is a zero embedding")
        return torch.zeros(len(samples), 512, device=self.device)

    def _whisper(self, mel: np.ndarray) -> np.ndarray:
        return self.pipe.encode_audio_windows(mel[None])[0].float().cpu().numpy()

    def _audio_windows(self, s: Dict[str, Any], f: int) -> Optional[np.ndarray]:
        """Per-frame (f, 10, 5, 384) whisper-state windows, or None: the
        states of the sample's mel, zero-padded 4 front / 6 back, windows of
        10 starting at 2 x the clip offset, 2 x ``audio_step`` apart (2
        states per video frame at the raw 25 fps; the CLI's assembly, the
        reference's ``Inference.py:450-461``). A mel wider than one
        3000-frame window (a pre-computed whole-clip mel) is encoded in
        3000-frame chunks."""
        mel = s.get("audio_features")
        if mel is None:
            return None
        mel = np.asarray(mel, np.float32)
        offset = int(s.get("audio_offset", 0))
        step = int(s.get("audio_step", 1))
        raw_fps = float(s.get("fps", 25.0)) * step
        if abs(raw_fps - 25.0) > 0.5:
            self._warn_once(
                "fps", f"clip raw fps {raw_fps:.4g} != 25 but whisper "
                "states run at 2 per 25fps video frame — audio "
                "conditioning will drift (resample the corpus to 25 fps)")
        if mel.shape[-1] <= 3000:
            # windows arrive silence-padded to 3000 in the sample domain;
            # shorter ones (test fakes, trimmed windows) are padded here
            feats = self._whisper(np.pad(mel, ((0, 0), (0, 3000 - mel.shape[-1]))))
        else:
            feats = np.concatenate([self._whisper(mel[:, i:i + 3000])
                                    for i in range(0, mel.shape[-1], 3000)])
        feats = np.concatenate(
            [np.zeros_like(feats[:4]), feats, np.zeros_like(feats[:6])])
        feats = feats[2 * offset:]
        need = 2 * step * (f - 1) + 10
        if len(feats) < need:  # never a ragged per-frame window stack
            feats = np.concatenate(
                [feats, np.zeros((need - len(feats),) + feats.shape[1:],
                                 feats.dtype)])
        return np.stack([feats[i * 2 * step: i * 2 * step + 10]
                         for i in range(f)])

    def _has_vasa(self, s: Dict[str, Any]) -> bool:
        return ("vasa_face" in s and "vasa_pose" in s
                and self.pipe.m.vasa_expression is not None)

    def _vasa_raw(self, s: Dict[str, Any], f: int):
        """Raw (expr (f, 512), rot (f, 3)) from the frozen VASA towers;
        zeros when the sample carries no driving crops (their projection is
        the pipeline's unconditional branch)."""
        if self._has_vasa(s):
            return self.pipe.encode_vasa_video(
                np.asarray(s["vasa_face"], np.float32),
                np.asarray(s["vasa_pose"], np.float32))
        self._warn_once(
            "vasa", "no VASA towers / driving crops: expression "
            "conditioning is zero")
        return np.zeros((f, 512), np.float32), np.zeros((f, 3), np.float32)

    def _encode_chunked(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> latent means (N, h, w, 4) fp32, at most
        ``encode_chunk`` frames per VAE call; the last call is padded with
        copies of its final frame, so every call has one shape."""
        n, ck = x.shape[0], self.encode_chunk
        outs = []
        for i in range(0, n, ck):
            c = x[i:i + ck]
            keep = c.shape[0]
            if n > ck and keep < ck:
                c = torch.cat([c, c[-1:].expand((ck - keep,) + tuple(c.shape[1:]))])
            outs.append(self.pipe.m.vae.encode(c)[:keep].float())
        return torch.cat(outs)

    @torch.no_grad()
    def __call__(self, samples: List[Dict[str, Any]]) -> TrainBatch:
        t0 = time.perf_counter()
        scale = self.pipe.m.vae.config.scaling_factor
        frames = self._t(np.stack([s["frames"] for s in samples]))
        b, f, hh, ww, _ = frames.shape
        latents = self._encode_chunked(frames.reshape(b * f, hh, ww, 3))
        latents = latents.reshape(b, f, *latents.shape[1:]) * scale
        ref_latents = self._encode_chunked(        # unscaled (concat cond)
            self._t(np.stack([s["ref_frame"] for s in samples])))
        pose_imgs = self._t(np.stack([
            np.repeat(s["pose_mask"][..., None], 3, axis=-1) for s in samples]))

        zeros_w = np.zeros((f, 10, 5, 384), np.float32)
        windows = [self._audio_windows(s, f) for s in samples]
        vr = [self._vasa_raw(s, f) for s in samples]

        # per-sample region masks (B, 1, H, W): the reference dataset emits
        # one mouth / exp mask per sample (its dataset :725-735)
        batch = TrainBatch(
            latents=latents, ref_latents=ref_latents,
            audio_mask=self._t(np.stack([s["mouth_mask"] for s in samples]))[:, None],
            exp_mask=self._t(np.stack([s["exp_mask"] for s in samples]))[:, None],
            motion_buckets=self._t(np.array(
                [[s["motion_bucket"], s["motion_bucket_exp"]] for s in samples])),
            fps=self._t(np.array([float(s.get("fps", self.fps)) for s in samples])),
            audio_feats=self._t(np.stack([zeros_w if w is None else w for w in windows])),
            id_embed=self._id_embeds(samples),
            vasa_expr=self._t(np.stack([e for e, _ in vr])),
            vasa_rot=self._t(np.stack([r for _, r in vr])),
            pose_pixels=pose_imgs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - t0
        return batch
