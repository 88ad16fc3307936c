"""Weight bridge: reference-keyed state dicts into the port's modules.

The port's modules carry the reference's diffusers / ACTalker key names, so
a state dict in the reference's layout loads with ``strict=True``. The JAX
package's exporters (``actalker_tpu.io.weights``, which imports no JAX)
turn its parameter trees into exactly such dicts, and the same door takes
the reference's six ``.pth`` files once they are on disk:

  * UNet: ``export_unet`` (the ``unet-*.pth`` layout, IP-adapter rows
    included) plus ``export_adapter_modules`` (the ``adapter_module-*.pth``
    ModuleList, applied in ``attn_processors`` order);
  * heads: ``export_audio_proj`` / ``export_id_proj`` /
    ``export_vasa_proj`` / ``export_pose_guider``;
  * VAE: ``export_state_dict(convert_vae, ...)``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from actalker_tpu.io import weights as W

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
