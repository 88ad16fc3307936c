"""Weight bridge: reference-keyed state dicts into the port's modules.

The port's modules carry the reference's diffusers / ACTalker key names, so
a state dict in the reference's layout loads with ``strict=True``. The
exporters of ``io/jax_export.py`` (the port's numpy-only copy of the JAX
package's) turn a JAX parameter tree into exactly such dicts, and the same
door takes the reference's six ``.pth`` files once they are on disk:

  * UNet: ``export_unet`` (the ``unet-*.pth`` layout, IP-adapter rows
    included) plus ``export_adapter_modules`` (the ``adapter_module-*.pth``
    ModuleList, applied in ``attn_processors`` order);
  * heads: ``export_audio_proj`` / ``export_id_proj`` /
    ``export_vasa_proj`` / ``export_pose_guider``;
  * VAE: ``export_state_dict(convert_vae, ...)``.

The way back out, ``export_reference_checkpoint``, writes the six ``.pth``
files from the port's modules.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from actalker_tpu_torch.io import jax_export as W

_ADAPTER_KEY = re.compile(r"(\d+)\.to_([kv])_ip\.(\d+)\.weight")


def to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy state dict -> fp32 torch tensors (``load_state_dict`` casts
    them to each parameter's dtype)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


@torch.no_grad()
def load_adapter_modules(unet, adapter_sd: Mapping[str, np.ndarray]) -> None:
    """Apply an ``adapter_module-*.pth`` dict (keys ``{idx}.to_{k,v}_ip.{i}
    .weight``) to the UNet's cross-attentions in ``attn_processors`` order
    (the reference's ``load_adapter_states``)."""
    attn2 = list(unet.attn2_modules())
    for key, val in to_torch(adapter_sd).items():
        m = _ADAPTER_KEY.fullmatch(key)
        if m is None:
            raise KeyError(f"unexpected adapter key {key!r}")
        idx, kv, i = int(m.group(1)), m.group(2), int(m.group(3))
        getattr(attn2[idx].processor, f"to_{kv}_ip")[i].weight.copy_(val)


def load_unet(unet, unet_sd: Mapping[str, np.ndarray],
              adapter_sd: Optional[Mapping[str, np.ndarray]] = None) -> None:
    unet.load_state_dict(to_torch(unet_sd), strict=True)
    if adapter_sd is not None:
        load_adapter_modules(unet, adapter_sd)


def unet_state_dicts_from_jax(params: Mapping, cfg):
    """JAX UNet params -> (``unet-*.pth`` dict, ``adapter_module-*.pth``
    dict) for the block layout of ``cfg`` (a UNetConfig of either package)."""
    kw = W.unet_block_kwargs(cfg)
    return W.export_unet(params, **kw), W.export_adapter_modules(params, **kw)


def vae_state_dict_from_jax(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    return W.export_state_dict(W.convert_vae, params,
                               block_out_channels=cfg.block_out_channels,
                               layers_per_block=cfg.layers_per_block)


def load_pipeline_from_jax(modules, params: Mapping) -> None:
    """Load every port module from the JAX pipeline's parameter dict (keys
    unet / vae / audio_proj / id_proj / vasa_proj / pose_guider)."""
    unet_sd, adapter_sd = unet_state_dicts_from_jax(params["unet"],
                                                    modules.unet.config)
    load_unet(modules.unet, unet_sd, adapter_sd)
    modules.vae.load_state_dict(to_torch(vae_state_dict_from_jax(
        params["vae"], modules.vae.config)), strict=True)
    for name, export in (("audio_proj", W.export_audio_proj),
                         ("id_proj", W.export_id_proj),
                         ("vasa_proj", W.export_vasa_proj),
                         ("pose_guider", W.export_pose_guider)):
        getattr(modules, name).load_state_dict(
            to_torch(export(params[name])), strict=True)


# the reference's six trainable artifacts: file stem -> module name
REFERENCE_ARTIFACTS = {"unet": "unet", "adapter_module": "unet",
                       "pose_guider": "pose_guider", "audio_linear": "audio_proj",
                       "id_proj_model": "id_proj", "vasa_linear": "vasa_proj"}


def adapter_state_dict(unet, unet_sd=None) -> Dict[str, torch.Tensor]:
    """The ``adapter_module-*.pth`` dict: every cross-attention's IP rows,
    indexed in ``attn_processors`` order (inverse of
    ``load_adapter_modules``), from the module or from ``unet_sd`` (a whole
    UNet state dict, the tensor-parallel export's)."""
    names = {id(m): n for n, m in unet.named_modules()}
    sd = {}
    for idx, attn in enumerate(unet.attn2_modules()):
        for i in range(attn.num_adapters):
            for kv in ("k", "v"):
                sd[f"{idx}.to_{kv}_ip.{i}.weight"] = (
                    getattr(attn.processor, f"to_{kv}_ip")[i].weight if unet_sd is None
                    else unet_sd[f"{names[id(attn)]}.processor.to_{kv}_ip.{i}.weight"])
    return sd


@torch.no_grad()
def reference_state_dicts(modules, state_dicts=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Module dict (unet / pose_guider / audio_proj / id_proj / vasa_proj)
    -> the six reference state dicts as fp32 CPU tensors (the modules'
    keys are the reference's already). ``state_dicts`` (module name ->
    whole state dict) replaces the modules' own, as under tensor
    parallelism, where a module holds its rank's slices."""
    sds = state_dicts or {n: m.state_dict() for n, m in modules.items()}
    out = {}
    for stem, name in REFERENCE_ARTIFACTS.items():
        sd = (adapter_state_dict(modules[name], state_dicts and sds[name])
              if stem == "adapter_module" else sds[name])
        out[stem] = {k: v.detach().float().cpu().clone() for k, v in sd.items()}
    return out


def export_reference_checkpoint(modules, out_dir: str, step: int,
                                state_dicts=None) -> List[str]:
    """Write ``{unet,pose_guider,audio_linear,adapter_module,id_proj_model,
    vasa_linear}-<step>.pth`` (the reference's ``Inference.py:80-142``
    contract); returns the paths. ``state_dicts`` as
    ``reference_state_dicts``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for stem, sd in reference_state_dicts(modules, state_dicts).items():
        paths.append(os.path.join(out_dir, f"{stem}-{step}.pth"))
        torch.save(sd, paths[-1])
    return paths
