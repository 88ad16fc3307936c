"""Configuration: the two-level YAML reader the training and inference
entry points share, and the inference config, twin of
``actalker_tpu/config.py``.

``InferenceConfig`` keeps the reference's public surface
(``config/inference.yaml``, loaded at ``Inference.py:607-610``): the same
YAML (read by ``read_config``, no PyYAML) or an importable ``.py`` config
(``import_filename``) maps onto the sampler's config; unknown keys land in
``extras``. ``MODE_GATES`` is the reference's mode -> (audio, vasa) gate
table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from actalker_tpu_torch.pipeline.sampler import SamplerConfig


def _scalar(text: str):
    s = text.strip()
    if s in ("", "~", "null"):
        return None
    if len(s) >= 2 and s[0] in "'\"" and s[-1] == s[0]:
        return s[1:-1]
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    if s.startswith("[") and s.endswith("]"):
        return [_scalar(x) for x in s[1:-1].split(",") if x.strip()]
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def read_config(path: str) -> Dict:
    """The two-level ``key: value`` YAML of ``configs/train.yaml`` and
    ``configs/inference.yaml`` (sections of scalars, inline ``[a, b]``
    lists, ``#`` comments), read without PyYAML, which the card's machine
    does not have."""
    out: Dict = {}
    section = None
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            key, sep, val = line.strip().partition(":")
            if not sep:
                raise ValueError(f"{path}:{n}: expected 'key: value'")
            if line[0] not in " \t":
                section = None
                if val.strip():
                    out[key] = _scalar(val)
                else:
                    section = out[key] = {}
            elif section is None:
                raise ValueError(f"{path}:{n}: indented line outside a section")
            else:
                section[key] = _scalar(val)
    return out



@dataclasses.dataclass
class InferenceConfig:
    # sampling
    num_inference_steps: int = 25
    fps: float = 12.5
    decode_chunk_size: int = 10
    motion_bucket_id: float = 12
    motion_bucket_id_exp: float = 20
    image_size: int = 576
    area: float = 1.2
    frame_num: int = 500
    step: int = 2
    overlap: int = 0
    shift_offset: int = 7
    n_sample_frames: int = 25
    min_appearance_guidance_scale: float = 2.0
    max_appearance_guidance_scale: float = 2.0
    audio_guidance_scale: float = 7.5
    vasa_guidance_scale: float = 3.0
    i2i_noise_strength: float = 1.0
    noise_aug_strength: float = 0.0
    ip_audio_scale: float = 1.25
    vasa_expression_dim: int = 1018
    crop: bool = False
    expand_ratio: float = 0.9
    aspect_type: str = "9:16"
    use_bfr: bool = False
    use_interframe: bool = False
    use_teeth_enhance: bool = False
    seed: Optional[int] = 72589
    weight_dtype: str = "bf16"
    # the VAE's compute dtype ("bf16" or "fp32", the reference's upcast)
    vae_dtype: str = "bf16"
    # UNet windows per call within a denoise step (0 = all in one batch)
    windows_per_call: int = 0
    # the reference's ablation UNets as config: any subset of
    # {"audio", "vasa", "id", "ssd", "cross_attn"}
    ablate: Tuple[str, ...] = ()
    # paths
    pretrained_model_name_or_path: str = ""
    unet_checkpoint_path: str = ""
    pose_guider_checkpoint_path: str = ""
    audio_linear_checkpoint_path: str = ""
    adapter_module_checkpoint_path: str = ""
    id_proj_checkpoint_path: str = ""
    vasa_linear_checkpoint_path: str = ""
    vasa_checkpoint_path: str = ""
    whisper_model: str = ""
    det_checkpoint_path: str = "checkpoints/yolov5m-face.pth"
    face_landmark_checkpoint_path: str = ""
    scrfd_checkpoint_path: str = "checkpoints/scrfd_10g_bnkps.pth"
    arcface_checkpoint_path: str = "checkpoints/arcface_r50.pth"
    bfr_checkpoint_path: str = ""
    teeth_checkpoint_path: str = ""
    rife_checkpoint_path: str = ""
    output_dir: str = "exp_output"
    exp_name: str = "actalker_tpu"
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str) -> "InferenceConfig":
        return cls.from_dict(read_config(path))

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "InferenceConfig":
        raw = dict(raw)
        data = raw.pop("data", {}) or {}
        if "n_sample_frames" in data:
            raw["n_sample_frames"] = data["n_sample_frames"]
        model_paths = raw.pop("model_paths", {}) or {}
        if "whisper_model" in model_paths:
            raw["whisper_model"] = model_paths["whisper_model"]
        if "ablate" in raw:
            raw["ablate"] = tuple(raw["ablate"] or ())
        elif "unet_cls" in raw:
            raw["ablate"] = unet_cls_to_ablate(str(raw["unet_cls"]))
        fields = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in raw.items() if k in fields})
        cfg.extras = {k: v for k, v in raw.items() if k not in fields}
        return cfg

    def sampler_config(self, gate: Tuple[int, int]) -> SamplerConfig:
        return SamplerConfig(
            num_inference_steps=self.num_inference_steps,
            frames_per_batch=self.n_sample_frames,
            overlap=self.overlap,
            shift_offset=self.shift_offset,
            fps=self.fps,
            motion_bucket_id=self.motion_bucket_id,
            motion_bucket_id_exp=self.motion_bucket_id_exp,
            noise_aug_strength=self.noise_aug_strength,
            min_guidance1=self.min_appearance_guidance_scale,
            max_guidance1=self.max_appearance_guidance_scale,
            guidance2=self.audio_guidance_scale,
            guidance3=self.vasa_guidance_scale,
            i2i_noise_strength=self.i2i_noise_strength,
            gate=gate,
            windows_per_call=self.windows_per_call,
        )


MODE_GATES = {0: (1, 0), 1: (0, 1), 2: (1, 1), 3: (1, 1)}


def unet_cls_to_ablate(unet_cls: str) -> Tuple[str, ...]:
    """The reference's dotted ``_wo_*`` UNet path (``Inference.py:54-55``)
    -> the ablate tuple."""
    return tuple(key for key in ("audio", "id", "ssd", "cross_attn", "vasa")
                 if f"_wo_{key}" in unet_cls)


def import_filename(path: str):
    """Import a python file as a module (the reference's ``.py`` configs,
    ``src/utils/util.py:27-32``), under a name unique to its path."""
    import importlib.util
    import os
    import sys

    stem = os.path.splitext(os.path.basename(path))[0]
    name = f"_actalker_cfg_{stem}_{abs(hash(os.path.abspath(path))) & 0xffffff:x}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_config(path: str) -> InferenceConfig:
    """A YAML config or an importable ``.py`` one exposing ``cfg``
    (``Inference.py:607-612``)."""
    if path.endswith(".py"):
        return InferenceConfig.from_dict(dict(import_filename(path).cfg))
    return InferenceConfig.from_yaml(path)
