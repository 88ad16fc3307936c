"""Seeded parameter initialization, the inference-precision cast and the
loading of the reference's checkpoints.

Twin of ``actalker_tpu/io/init.py``: ``random_init_`` fills every parameter
with ``standard_normal * 0.02`` from a seed (the ``random_like`` /
``--random-weights`` semantics), drawing from a ``torch.Generator`` on the
target device so a full-width UNet initializes on the card in seconds;
``cast_params_bf16_`` mirrors ``cast_params_bf16``. ``lineage_init_`` gives
the SS2D lineage (``models/ssm_spatial.py``) the JAX package's own
initializers instead, which keep the scan's range of decays.

``load_checkpoints`` (twin of ``convert_checkpoint_params``) loads the
reference's on-disk artifacts into the port's modules, whose keys are the
files' own, with ``strict=True``: the six ``.pth`` files
(``load_reference_checkpoints``, which the trainer shares), and, where they
exist, the SVD-XT VAE's ``.safetensors`` (read by ``read_safetensors``,
without the ``safetensors`` package), whisper-tiny's ``pytorch_model.bin``
and the VASA MX31c checkpoint's ``generator`` / ``pose_model`` dicts.
``load_arcface`` / ``load_yoloface`` / ``load_scrfd`` /
``load_face_landmarker`` / ``load_bfr`` / ``load_teeth`` / ``load_rife``
load ArcFace's, the face stack's and the post-passes' files the same way,
``load_yolox`` / ``load_dwpose`` the DWPose detector's and pose model's,
in fp32, and ``load_syncnet`` / ``load_s3fd`` / ``load_fid_inception`` /
``load_i3d`` / ``load_senet50`` / ``load_lpips`` the six evaluation
networks' (the names the JAX package's ``convert_*`` functions read).
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Mapping, Optional, Set

import torch
import torch.nn as nn

from actalker_tpu_torch.io import weights as W

# scan state parameters stay fp32 (the scan contract, and the reference's
# own fp32 override of its mamba parameters)
FP32_PARAMS = ("A_logs", "dt_projs_weight", "dt_projs_bias")


INIT_SCALE = 0.02


@torch.no_grad()
def random_init_(module: nn.Module, seed: int, device) -> nn.Module:
    """Materialize ``module`` (possibly built on the meta device) on
    ``device`` with fp32 parameters ~ N(0, INIT_SCALE^2), drawn in
    ``named_parameters`` order from one generator seeded with ``seed``."""
    module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for _, p in module.named_parameters():
        p.data = torch.randn(p.shape, generator=gen, device=device) * INIT_SCALE
    return module


@torch.no_grad()
def cast_params_bf16_(module: nn.Module) -> nn.Module:
    """In place: >= 2-D fp32 parameters become bf16; 1-D parameters (biases,
    norm affines, ``Ds``) and the scan's ``A_logs`` / ``dt_projs_weight`` /
    ``dt_projs_bias`` stay fp32."""
    for name, p in module.named_parameters():
        if (p.ndim >= 2 and p.dtype == torch.float32
                and name.rsplit(".", 1)[-1] not in FP32_PARAMS):
            p.data = p.data.to(torch.bfloat16)
    return module


# flax's lecun_normal: a normal truncated to +-2 std, rescaled by the std of
# the standard normal truncated there, so the variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lineage_init_(module: nn.Module, seed: int, device) -> nn.Module:
    """Materialize ``module`` (possibly built on the meta device) on
    ``device`` with fp32 parameters from the JAX package's recipes, drawn
    in ``named_parameters`` order from one generator seeded with ``seed``:

      * ``x_proj_weight`` (K, R + 2N, D) ~ U(+-D^-0.5); ``dt_projs_weight``
        (K, D, R) ~ U(+-R^-0.5);
      * ``dt_projs_bias``: the inverse softplus of dt = exp(U(log 1e-3,
        log 0.1)) clamped at 1e-4;
      * ``A_logs`` = log(1..N) per row (S4D-real), ``Ds`` = 1;
      * other >= 2-D weights (dense, conv) lecun-normal over their fan-in,
        1-D weights (norm scales) 1, biases 0.

    ``random_init_``'s N(0, 0.02^2) would put every A near -1 and hide the
    scan's range of decays."""
    module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("x_proj_weight", "dt_projs_weight"):
            bound = p.shape[-1] ** -0.5
            p.uniform_(-bound, bound, generator=gen)
        elif leaf == "dt_projs_bias":
            lo, hi = math.log(1e-3), math.log(0.1)
            u = torch.rand(p.shape, generator=gen, device=device)
            dt = torch.exp(u * (hi - lo) + lo).clamp_min(1e-4)
            p.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif leaf == "A_logs":
            n = p.shape[-1]
            p.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                           device=device)).expand(p.shape))
        elif leaf == "Ds" or (leaf == "weight" and p.ndim == 1):
            p.fill_(1.0)
        elif leaf == "weight":
            std = p[0].numel() ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
        else:
            p.zero_()
    return module


# ------------------------------------------------------------ checkpoints

_CKPT_KEYS = {"unet": "unet_checkpoint_path",
              "pose_guider": "pose_guider_checkpoint_path",
              "audio_proj": "audio_linear_checkpoint_path",
              "id_proj": "id_proj_checkpoint_path",
              "vasa_proj": "vasa_linear_checkpoint_path"}


def load_reference_checkpoints(mods, ckpt_cfg: Dict) -> list:
    """Start from the reference's ``.pth`` artifacts where the config names
    them (``checkpoints:`` section); returns the loaded artifact names."""
    loaded = []
    for name, key in _CKPT_KEYS.items():
        path = (ckpt_cfg or {}).get(key) or ""
        if not path:
            continue
        sd = torch.load(path, map_location="cpu", weights_only=True)
        mods[name].load_state_dict(sd, strict=True)
        loaded.append(name)
    adapter = (ckpt_cfg or {}).get("adapter_module_checkpoint_path") or ""
    if adapter:
        W.load_adapter_modules(mods["unet"], {
            k: v.float().numpy() for k, v in torch.load(
                adapter, map_location="cpu", weights_only=True).items()})
        loaded.append("adapter_module")
    return loaded


_SAFETENSORS_DTYPES = {"F16": torch.float16, "BF16": torch.bfloat16,
                       "F32": torch.float32}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors: an 8-byte little-endian header
    length, a JSON header (name -> dtype, shape, data offsets), then the raw
    little-endian tensors. F16, BF16 and F32 entries; others raise."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}; "
                             f"read are {sorted(_SAFETENSORS_DTYPES)}")
        begin, end = meta["data_offsets"]
        count = (end - begin) // dtype.itemsize
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) \
            if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(meta["shape"])
    return out


def load_state_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` or ``torch.save`` state dict (a ``state_dict``
    entry unwrapped), as CPU tensors."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["state_dict"] if "state_dict" in sd else sd


def whisper_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The encoder's entries of an HF whisper state dict (``encoder.*`` of
    ``WhisperModel``, ``model.encoder.*`` of the generation model), keyed
    as ``models/whisper.py::WhisperEncoder``."""
    out = {}
    for key, val in sd.items():
        for prefix in ("model.encoder.", "encoder."):
            if key.startswith(prefix):
                out[key[len(prefix):]] = val
                break
    return out


def vasa_state_dicts(ck: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The MX31c checkpoint -> {"vasa_expression": the ``generator``'s
    ``expression_model.*`` entries without that prefix, "vasa_pose": its
    ``pose_model``} (the reference's ``Inference.py:149-154``)."""
    pre = "expression_model."
    return {"vasa_expression": {k[len(pre):]: v for k, v in ck["generator"].items()
                                if k.startswith(pre)},
            "vasa_pose": dict(ck["pose_model"])}


def vae_path(cfg) -> str:
    return os.path.join(cfg.pretrained_model_name_or_path or "", "vae",
                        "diffusion_pytorch_model.fp16.safetensors")


def whisper_path(cfg) -> str:
    return os.path.join(cfg.whisper_model or "", "pytorch_model.bin")


def load_checkpoints(cfg, modules: Mapping[str, nn.Module]) -> Optional[Set[str]]:
    """Load the reference's artifacts named by ``cfg`` (an InferenceConfig)
    into ``modules`` (name -> module: unet, pose_guider, audio_proj,
    id_proj, vasa_proj, vae, whisper, vasa_expression, vasa_pose), each with
    ``strict=True``. Returns None, loading nothing, when the UNet checkpoint
    is absent; else the names of the modules loaded (the adapter rows ride
    the UNet's). The frozen encoders load only where their files exist."""
    def have(p):
        return bool(p) and os.path.exists(p)

    if not have(cfg.unet_checkpoint_path):
        return None
    paths = {key: getattr(cfg, key) for key in
             list(_CKPT_KEYS.values()) + ["adapter_module_checkpoint_path"]}
    loaded = set(load_reference_checkpoints(modules, paths)) - {"adapter_module"}
    return loaded | load_frozen_encoders(cfg, modules)


def load_frozen_encoders(cfg, modules: Mapping[str, nn.Module]) -> Set[str]:
    """Load the frozen encoders' files that ``cfg`` names and that exist (the
    SVD-XT VAE under ``pretrained_model_name_or_path``, whisper under
    ``whisper_model``, the VASA towers from ``vasa_checkpoint_path``) into
    ``modules`` with ``strict=True``; returns the names loaded."""
    loaded = set()
    if os.path.exists(vae_path(cfg)):
        modules["vae"].load_state_dict(read_safetensors(vae_path(cfg)),
                                       strict=True)
        loaded.add("vae")
    if os.path.exists(whisper_path(cfg)):
        modules["whisper"].load_state_dict(
            whisper_state_dict(load_state_file(whisper_path(cfg))), strict=True)
        loaded.add("whisper")
    if cfg.vasa_checkpoint_path and os.path.exists(cfg.vasa_checkpoint_path):
        ck = torch.load(cfg.vasa_checkpoint_path, map_location="cpu",
                        weights_only=True)
        for name, sd in vasa_state_dicts(ck).items():
            modules[name].load_state_dict(sd, strict=True)
            loaded.add(name)
    return loaded


# ------------------------------------------------ face stack and post-passes

def _load_net(build, sd: Mapping[str, torch.Tensor], device) -> nn.Module:
    """``build()`` on the meta device, ``sd`` loaded into it with
    ``strict=True``, then on ``device`` in fp32 for inference."""
    with torch.device("meta"):
        net = build()
    net.load_state_dict(sd, strict=True, assign=True)
    return net.to(device=device, dtype=torch.float32).eval()


def load_arcface(path: str, device):
    """The ArcFace file (insightface's iresnet50 ``backbone.pth``) ->
    iresnet50."""
    from actalker_tpu_torch.models.arcface import iresnet50

    return _load_net(iresnet50, load_state_file(path), device)


def load_yoloface(path: str, device):
    """``yolov5m-face.pth`` (``model.N.*``; a file without the ``model.``
    prefix takes it) -> YoloFaceNet (m: 0.75 / 0.67)."""
    from actalker_tpu_torch.models.yoloface import YoloFaceNet

    sd = {k if k.startswith("model.") else f"model.{k}": v
          for k, v in load_state_file(path).items()}
    return _load_net(YoloFaceNet, sd, device)


def load_scrfd(path: str, device):
    """``scrfd_10g_bnkps.pth`` -> ScrfdNet (10G-bnkps)."""
    from actalker_tpu_torch.models.scrfd import ScrfdNet

    return _load_net(ScrfdNet, load_state_file(path), device)


def load_face_landmarker(path: str, device):
    """The RTMPose face head (``face_landmark_checkpoint_path``) ->
    RTMPoseNet at RTMPose-m face6."""
    from actalker_tpu_torch.frontend.landmarks import face6_config
    from actalker_tpu_torch.models.rtmpose import RTMPoseNet

    return _load_net(lambda: RTMPoseNet(face6_config()), load_state_file(path), device)


def load_yolox(path: str, device):
    """``checkpoints/yolox_l.pth`` (Megvii's, its ``model`` entry
    unwrapped) -> YoloXNet at YOLOX-L (depth and width 1.0; the detector
    takes 640 x 640)."""
    from actalker_tpu_torch.models.yolox import YoloXNet

    sd = load_state_file(path)
    return _load_net(YoloXNet, sd["model"] if "model" in sd else sd, device)


def load_dwpose(path: str, device):
    """``checkpoints/dw-ll_ucoco_384.pth`` (mmpose keys) -> RTMPoseNet at
    RTMPose-l wholebody (133 keypoints, input 288 x 384: the
    ``RTMPoseConfig()`` defaults)."""
    from actalker_tpu_torch.models.rtmpose import RTMPoseNet

    return _load_net(RTMPoseNet, load_state_file(path), device)


def load_bfr(path: str, device):
    """``enhance-512.pth`` -> GPENGenerator, its size, style width, MLP depth
    and channel multiplier read off the file (512, 512, 8 and 2 there)."""
    from actalker_tpu_torch.models.stylegan2 import GPENGenerator, channels

    sd = load_state_file(path)
    # one conv weight an encoder level: ecd0.0.0 (1x1), ecdK.0.1 (after the blur)
    size = 2 ** (1 + sum(re.fullmatch(r"ecd\d+\.0\.[01]\.weight", k) is not None
                         for k in sd))
    kw = dict(size=size, style_dim=sd["final_linear.0.weight"].shape[0],
              n_mlp=sum(re.fullmatch(r"generator\.style\.\d+\.weight", k) is not None
                        for k in sd),
              channel_multiplier=sd["ecd0.0.0.weight"].shape[0] // channels(1)[size])
    return _load_net(lambda: GPENGenerator(**kw), sd, device)


def load_teeth(path: str, device):
    """The teeth enhancer's state dict (the PNNX export's flat names) ->
    TeethEnhancer."""
    from actalker_tpu_torch.models.teeth import TeethEnhancer

    return _load_net(TeethEnhancer, load_state_file(path), device)


def load_rife(path: str, device):
    """``flownet.pkl`` (its ``module.`` prefix stripped) -> IFNet, its
    width read off the file (c = 90 there)."""
    from actalker_tpu_torch.models.rife import IFNet

    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in load_state_file(path).items()}
    c = 2 * sd["block0.conv0.0.0.weight"].shape[0]
    return _load_net(lambda: IFNet(c), sd, device)


# ------------------------------------------------------ evaluation networks

def load_syncnet(path: str, device):
    """``syncnet_v2.model`` (``netcnnaud.*`` / ``netfcaud.*`` /
    ``netcnnlip.*`` / ``netfclip.*``) -> SyncNet."""
    from actalker_tpu_torch.evaluation.syncnet import SyncNet

    return _load_net(SyncNet, load_state_file(path), device)


def load_s3fd(path: str, device):
    """``sfd_face.pth`` -> S3FDNet."""
    from actalker_tpu_torch.evaluation.s3fd import S3FDNet

    return _load_net(S3FDNet, load_state_file(path), device)


def load_fid_inception(path: str, device):
    """``pt_inception-2015-12-05.pth`` (pytorch-fid's) -> FIDInceptionV3."""
    from actalker_tpu_torch.evaluation.inception import FIDInceptionV3

    return _load_net(FIDInceptionV3, load_state_file(path), device)


def load_i3d(path: str, device):
    """``i3d_rgb_charades.pt`` (pytorch_i3d's ``InceptionI3d``) ->
    InceptionI3D, its class count read off the ``logits`` conv."""
    from actalker_tpu_torch.evaluation.i3d import InceptionI3D

    sd = load_state_file(path)
    n = sd["logits.conv3d.weight"].shape[0]
    return _load_net(lambda: InceptionI3D(num_classes=n), sd, device)


def load_senet50(path: str, device):
    """``senet50_ft_weight.pth`` (the names ``convert_senet50`` reads) ->
    SENet50, its class count read off ``fc``."""
    from actalker_tpu_torch.models.senet import SENet50

    sd = load_state_file(path)
    n = sd["fc.weight"].shape[0]
    return _load_net(lambda: SENet50(num_classes=n), sd, device)


def load_lpips(path: str, device):
    """``lpips_alex.pth``, the ``lpips`` package's ``LPIPS(net='alex')``
    state dict -> LPIPSAlex. The package registers its heads twice
    (``linK`` and ``lins.K``); a file holding one of the two names fills
    the other."""
    from actalker_tpu_torch.evaluation.lpips import LPIPSAlex

    sd = dict(load_state_file(path))
    for k in range(5):
        a, b = f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"
        if a in sd or b in sd:
            sd.setdefault(a, sd.get(b))
            sd.setdefault(b, sd[a])
    return _load_net(LPIPSAlex, sd, device)
