"""JAX parameter trees -> reference-keyed torch state dicts (numpy only).

The port's own copy of the exporters of ``actalker_tpu/io/weights.py``
(that module imports no JAX, but the port imports nothing of the JAX
package): the converter tables (``convert_unet`` / heads / ``convert_vae``),
captured in a stand-in state dict and replayed backwards by
``export_state_dict``, turn a Flax parameter tree of numpy arrays into the
state dicts the reference's six ``.pth`` files hold. Layout rules:

  * Linear  (out,in)        <-> kernel (in,out)
  * Conv2d  (o,i,kh,kw)     <-> kernel (kh,kw,i,o)
  * Conv3d  (o,i,kt,kh,kw)  <-> kernel (kt,kh,kw,i,o)
  * LayerNorm/GroupNorm weight <-> scale

The transposes are linear, so a gradient tree exports the same way.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np


def t_linear(w):
    return np.transpose(w, (1, 0))


def t_conv2d(w):
    return np.transpose(w, (2, 3, 1, 0))


def t_conv3d(w):
    return np.transpose(w, (2, 3, 4, 1, 0))


def t_conv1d(w):
    return np.transpose(w, (2, 1, 0))


def set_in(tree: Dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


# kind -> (torch->flax transform, flax->torch inverse)
_KINDS = {
    "linear": (t_linear, t_linear),                        # 2-D transpose
    "conv2": (t_conv2d, lambda w: np.transpose(w, (3, 2, 0, 1))),
    "conv3": (t_conv3d, lambda w: np.transpose(w, (4, 3, 0, 1, 2))),
    "conv1": (t_conv1d, t_conv1d),
    "raw": (np.asarray, np.asarray),
}


class _CaptureSD:
    """Stand-in state dict that records the (flax path, torch key, kind)
    assignments a converter would make, instead of converting — the shared
    spec that makes every converter invertible (``export_state_dict``).

    ``__contains__`` answers True so every OPTIONAL module's entries are
    captured; export prunes entries whose flax path is absent from the
    actual params tree."""

    def __init__(self):
        self.spec = []  # (flax_path, torch_key, kind)

    def __contains__(self, key) -> bool:
        return True

    def __getitem__(self, key):  # never materialized in capture mode
        raise KeyError(key)


def _put(dst: Dict, sd: Mapping, path: str, key: str, kind: str = "raw",
         optional: bool = False) -> None:
    """One converter assignment: ``dst[path] = fwd_kind(sd[key])``.

    In capture mode (``sd`` is a ``_CaptureSD``) the assignment is recorded
    rather than executed."""
    if isinstance(sd, _CaptureSD):
        sd.spec.append((path, key, kind))
        return
    if optional and key not in sd:
        return
    set_in(dst, path, _KINDS[kind][0](np.asarray(sd[key])))


def _norm(dst: Dict, prefix: str, sd: Mapping, src: str) -> None:
    _put(dst, sd, f"{prefix}/scale", f"{src}.weight")
    _put(dst, sd, f"{prefix}/bias", f"{src}.bias")


def _linear(dst: Dict, prefix: str, sd: Mapping, src: str, bias=True) -> None:
    _put(dst, sd, f"{prefix}/kernel", f"{src}.weight", "linear")
    if bias:
        _put(dst, sd, f"{prefix}/bias", f"{src}.bias", optional=True)


def _conv2(dst: Dict, prefix: str, sd: Mapping, src: str) -> None:
    _put(dst, sd, f"{prefix}/kernel", f"{src}.weight", "conv2")
    _put(dst, sd, f"{prefix}/bias", f"{src}.bias", optional=True)


def _conv3(dst: Dict, prefix: str, sd: Mapping, src: str) -> None:
    _put(dst, sd, f"{prefix}/kernel", f"{src}.weight", "conv3")
    _put(dst, sd, f"{prefix}/bias", f"{src}.bias", optional=True)


# ---------------------------------------------------------------- attention

def _attention(dst, prefix, sd, src, num_adapters=0):
    _linear(dst, f"{prefix}/to_q", sd, f"{src}.to_q")
    _linear(dst, f"{prefix}/to_k", sd, f"{src}.to_k")
    _linear(dst, f"{prefix}/to_v", sd, f"{src}.to_v")
    _linear(dst, f"{prefix}/to_out", sd, f"{src}.to_out.0")
    for i in range(num_adapters):
        _put(dst, sd, f"{prefix}/to_k_ip_{i}/kernel",
             f"{src}.processor.to_k_ip.{i}.weight", "linear", optional=True)
        _put(dst, sd, f"{prefix}/to_v_ip_{i}/kernel",
             f"{src}.processor.to_v_ip.{i}.weight", "linear", optional=True)


def _feedforward(dst, prefix, sd, src):
    _linear(dst, f"{prefix}/proj_in", sd, f"{src}.net.0.proj")
    _linear(dst, f"{prefix}/proj_out", sd, f"{src}.net.2")


def _basic_block(dst, prefix, sd, src, num_adapters=2):
    _norm(dst, f"{prefix}/norm1", sd, f"{src}.norm1")
    _attention(dst, f"{prefix}/attn1", sd, f"{src}.attn1")
    _norm(dst, f"{prefix}/norm2", sd, f"{src}.norm2")
    _attention(dst, f"{prefix}/attn2", sd, f"{src}.attn2", num_adapters)
    _norm(dst, f"{prefix}/norm3", sd, f"{src}.norm3")
    _feedforward(dst, f"{prefix}/ff", sd, f"{src}.ff")


def _temporal_block(dst, prefix, sd, src, num_adapters=2):
    _norm(dst, f"{prefix}/norm_in", sd, f"{src}.norm_in")
    _feedforward(dst, f"{prefix}/ff_in", sd, f"{src}.ff_in")
    _norm(dst, f"{prefix}/norm1", sd, f"{src}.norm1")
    _attention(dst, f"{prefix}/attn1", sd, f"{src}.attn1")
    _norm(dst, f"{prefix}/norm2", sd, f"{src}.norm2")
    _attention(dst, f"{prefix}/attn2", sd, f"{src}.attn2", num_adapters)
    _norm(dst, f"{prefix}/norm3", sd, f"{src}.norm3")
    _feedforward(dst, f"{prefix}/ff", sd, f"{src}.ff")


def _ssm_unit(dst, prefix, sd, src):
    for name in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias",
                 "A_logs", "Ds"):
        _put(dst, sd, f"{prefix}/{name}", f"{src}.{name}")


def _mamba_v10(dst, prefix, sd, src):
    for p in ("in_proj1", "in_proj2", "audio_proj", "exp_proj", "id_proj",
              "out_proj"):
        _linear(dst, f"{prefix}/{p}", sd, f"{src}.{p}")
    _norm(dst, f"{prefix}/out_norm", sd, f"{src}.out_norm")
    _ssm_unit(dst, f"{prefix}/audio_unit", sd, f"{src}.audio_unit")
    _ssm_unit(dst, f"{prefix}/exp_unit", sd, f"{src}.exp_unit")


def _resnet2d(dst, prefix, sd, src, temb=True):
    _norm(dst, f"{prefix}/norm1", sd, f"{src}.norm1")
    _conv2(dst, f"{prefix}/conv1", sd, f"{src}.conv1")
    if temb and f"{src}.time_emb_proj.weight" in sd:
        _linear(dst, f"{prefix}/time_emb_proj", sd, f"{src}.time_emb_proj")
    _norm(dst, f"{prefix}/norm2", sd, f"{src}.norm2")
    _conv2(dst, f"{prefix}/conv2", sd, f"{src}.conv2")
    if f"{src}.conv_shortcut.weight" in sd:
        _conv2(dst, f"{prefix}/conv_shortcut", sd, f"{src}.conv_shortcut")


def _resnet_temporal(dst, prefix, sd, src):
    _norm(dst, f"{prefix}/norm1", sd, f"{src}.norm1")
    _conv3(dst, f"{prefix}/conv1", sd, f"{src}.conv1")
    if f"{src}.time_emb_proj.weight" in sd:
        _linear(dst, f"{prefix}/time_emb_proj", sd, f"{src}.time_emb_proj")
    _norm(dst, f"{prefix}/norm2", sd, f"{src}.norm2")
    _conv3(dst, f"{prefix}/conv2", sd, f"{src}.conv2")
    if f"{src}.conv_shortcut.weight" in sd:
        _conv3(dst, f"{prefix}/conv_shortcut", sd, f"{src}.conv_shortcut")


def _st_resblock(dst, prefix, sd, src):
    _resnet2d(dst, f"{prefix}/spatial_res_block", sd, f"{src}.spatial_res_block")
    _resnet_temporal(dst, f"{prefix}/temporal_res_block", sd,
                     f"{src}.temporal_res_block")
    _put(dst, sd, f"{prefix}/time_mixer/mix_factor",
         f"{src}.time_mixer.mix_factor")


def _transformer_st(dst, prefix, sd, src, num_layers=1, mamba=True):
    _norm(dst, f"{prefix}/norm", sd, f"{src}.norm")
    _linear(dst, f"{prefix}/proj_in", sd, f"{src}.proj_in")
    _linear(dst, f"{prefix}/proj_out", sd, f"{src}.proj_out")
    _linear(dst, f"{prefix}/time_pos_embed/linear_1", sd,
            f"{src}.time_pos_embed.linear_1")
    _linear(dst, f"{prefix}/time_pos_embed/linear_2", sd,
            f"{src}.time_pos_embed.linear_2")
    for i in range(num_layers):
        _basic_block(dst, f"{prefix}/block_{i}", sd,
                     f"{src}.transformer_blocks.{i}")
        if mamba and f"{src}.mamba_blocks.{i}.in_proj1.weight" in sd:
            _mamba_v10(dst, f"{prefix}/mamba_{i}", sd, f"{src}.mamba_blocks.{i}")
        _temporal_block(dst, f"{prefix}/temporal_block_{i}", sd,
                        f"{src}.temporal_transformer_blocks.{i}")
        # reference shares one time_mixer across layers (num_layers == 1)
        _put(dst, sd, f"{prefix}/time_mixer_{i}/mix_factor",
             f"{src}.time_mixer.mix_factor")


def convert_unet(sd: Mapping[str, np.ndarray],
                 down_block_types=("cross", "cross", "cross", "plain"),
                 up_block_types=("plain", "cross", "cross", "cross"),
                 layers_per_block=2) -> Dict:
    """diffusers/ACTalker UNet state dict -> params for
    ``UNetSpatioTemporalCondition``."""
    dst: Dict = {}
    _conv2(dst, "conv_in", sd, "conv_in")
    for mod in ("time_embedding", "add_embedding"):
        _linear(dst, f"{mod}/linear_1", sd, f"{mod}.linear_1")
        _linear(dst, f"{mod}/linear_2", sd, f"{mod}.linear_2")
    for i, kind in enumerate(down_block_types):
        base = f"down_blocks.{i}"
        out = f"down_blocks_{i}"
        for j in range(layers_per_block):
            _st_resblock(dst, f"{out}/resnet_{j}", sd, f"{base}.resnets.{j}")
            if kind == "cross":
                _transformer_st(dst, f"{out}/attention_{j}", sd,
                                f"{base}.attentions.{j}")
        if f"{base}.downsamplers.0.conv.weight" in sd:
            _conv2(dst, f"{out}/downsampler/conv", sd,
                   f"{base}.downsamplers.0.conv")
    _st_resblock(dst, "mid_block/resnet_0", sd, "mid_block.resnets.0")
    _st_resblock(dst, "mid_block/resnet_1", sd, "mid_block.resnets.1")
    _transformer_st(dst, "mid_block/attention_0", sd, "mid_block.attentions.0",
                    mamba=False)
    for i, kind in enumerate(up_block_types):
        base = f"up_blocks.{i}"
        out = f"up_blocks_{i}"
        for j in range(layers_per_block + 1):
            _st_resblock(dst, f"{out}/resnet_{j}", sd, f"{base}.resnets.{j}")
            if kind == "cross":
                _transformer_st(dst, f"{out}/attention_{j}", sd,
                                f"{base}.attentions.{j}")
        if f"{base}.upsamplers.0.conv.weight" in sd:
            _conv2(dst, f"{out}/upsampler/conv", sd, f"{base}.upsamplers.0.conv")
    _norm(dst, "conv_norm_out", sd, "conv_norm_out")
    _conv2(dst, "conv_out", sd, "conv_out")
    return {"params": dst}


def unet_block_kwargs(cfg) -> Dict:
    """convert_unet/export_unet block-layout kwargs from a ``UNetConfig``
    (flagship default, micro/tiny test layouts)."""
    kind = lambda t: "cross" if t.startswith("CrossAttn") else "plain"
    return dict(
        down_block_types=tuple(kind(t) for t in cfg.down_block_types),
        up_block_types=tuple(kind(t) for t in cfg.up_block_types),
        layers_per_block=cfg.layers_per_block,
    )


def ip_adapter_attn2_paths(down_block_types=("cross", "cross", "cross", "plain"),
                           up_block_types=("plain", "cross", "cross", "cross"),
                           layers_per_block=2) -> list:
    """Ordered list of attn2 param paths matching torch's attn_processors
    traversal order (named_children, registration order: down -> mid -> up;
    within a transformer: spatial block then temporal block)."""
    paths = []

    def add_transformer(prefix):
        paths.append(f"{prefix}/block_0/attn2")
        paths.append(f"{prefix}/temporal_block_0/attn2")

    for i, kind in enumerate(down_block_types):
        if kind == "cross":
            for j in range(layers_per_block):
                add_transformer(f"down_blocks_{i}/attention_{j}")
    add_transformer("mid_block/attention_0")
    for i, kind in enumerate(up_block_types):
        if kind == "cross":
            for j in range(layers_per_block + 1):
                add_transformer(f"up_blocks_{i}/attention_{j}")
    return paths


# ------------------------------------------------------------------ heads

def convert_audio_proj(sd) -> Dict:
    dst: Dict = {}
    for p in ("proj1", "proj2", "proj3"):
        _linear(dst, p, sd, p)
    _norm(dst, "norm", sd, "norm")
    return {"params": dst}


def convert_id_proj(sd) -> Dict:
    dst: Dict = {}
    for p in ("proj1", "proj2", "proj3"):
        _linear(dst, p, sd, p)
    return {"params": dst}


def convert_vasa_proj(sd) -> Dict:
    dst: Dict = {}
    _linear(dst, "proj1", sd, "proj1")
    _norm(dst, "norm", sd, "norm")
    return {"params": dst}


def convert_pose_guider(sd, n_blocks: int = None) -> Dict:
    dst: Dict = {}
    _conv2(dst, "conv_in", sd, "conv_in")
    i = 0
    while (i < n_blocks if n_blocks is not None
           else f"blocks.{i}.weight" in sd):
        _conv2(dst, f"blocks_{i}", sd, f"blocks.{i}")
        i += 1
    _conv2(dst, "conv_out", sd, "conv_out")
    return {"params": dst}


# ----------------------------------------------------- export (flax -> torch)

def _flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten_params(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def export_state_dict(convert_fn, params: Mapping, strict: bool = True,
                      **kwargs) -> Dict[str, np.ndarray]:
    """Invert a converter: flax params -> reference-keyed torch state dict.

    Re-runs ``convert_fn`` in capture mode to obtain its
    (flax path, torch key, kind) assignment spec, then replays it backward
    with the inverse layout transforms. Entries whose flax path is absent
    from ``params`` are pruned (optional modules); with ``strict`` every
    param leaf must be covered by the spec. Completes the reference
    checkpoint contract round trip
    (the reference's ``Inference.py:80-142``): a model fine-tuned here can
    be re-exported to the six ``.pth`` state dicts.
    """
    cap = _CaptureSD()
    convert_fn(cap, **kwargs)
    tree = params.get("params", params)
    flat = _flatten_params(tree)
    sd: Dict[str, np.ndarray] = {}
    covered = set()
    for path, key, kind in cap.spec:
        if path in flat:
            sd[key] = _KINDS[kind][1](flat[path])
            covered.add(path)
    if strict:
        left = sorted(set(flat) - covered)
        if left:
            raise ValueError(
                f"export spec missed {len(left)} params: {left[:8]}")
    return sd


def _complete_attn_qk(sd: Dict[str, np.ndarray]) -> None:
    """Fill reference-contract q/k rows the flax tree legitimately lacks.

    Attention over a single-token context is its value row (softmax over one
    key is identically 1), so the framework never creates ``to_q``/``to_k``
    (or ``to_k_ip`` for the 1-token vasa adapter) there. The torch contract
    has those weights; zeros are an exact functional stand-in."""
    for key in [k for k in sd if k.endswith(".to_v.weight")]:
        base = key[: -len(".to_v.weight")]
        if f"{base}.to_q.weight" not in sd:
            inner = sd[key].shape[0]
            qdim = sd[f"{base}.to_out.0.weight"].shape[0]
            sd[f"{base}.to_q.weight"] = np.zeros((inner, qdim), sd[key].dtype)
        if f"{base}.to_k.weight" not in sd:
            sd[f"{base}.to_k.weight"] = np.zeros_like(sd[key])
    for key in [k for k in sd if re.search(r"\.to_v_ip\.\d+\.weight$", k)]:
        kk = key.replace(".to_v_ip.", ".to_k_ip.")
        if kk not in sd:
            sd[kk] = np.zeros_like(sd[key])


def export_unet(params: Mapping, **block_kwargs) -> Dict[str, np.ndarray]:
    """UNet params -> ``unet-<step>.pth``-shaped state dict (includes the
    IP-adapter ``...processor.to_{k,v}_ip.{i}.weight`` rows, as torch's
    ``unet.state_dict()`` does once ``add_ip_adapters`` has run)."""
    sd = export_state_dict(convert_unet, params, **block_kwargs)
    _complete_attn_qk(sd)
    return sd


def export_adapter_modules(params: Mapping, num_adapters: int = 2,
                           **block_kwargs) -> Dict[str, np.ndarray]:
    """UNet params -> ``adapter_module-<step>.pth`` (ModuleList of IP
    processors in ``attn_processors`` order — inverse of
    ``load_adapter_modules``)."""
    tree = params.get("params", params)
    flat = _flatten_params(tree)
    sd: Dict[str, np.ndarray] = {}
    for idx, path in enumerate(ip_adapter_attn2_paths(**block_kwargs)):
        for i in range(num_adapters):
            kv = f"{path}/to_v_ip_{i}/kernel"
            if kv not in flat:
                continue
            sd[f"{idx}.to_v_ip.{i}.weight"] = t_linear(flat[kv])
            kk = f"{path}/to_k_ip_{i}/kernel"
            # singleton-context adapters never create to_k_ip (value-row
            # shortcut); zeros are the exact functional stand-in
            sd[f"{idx}.to_k_ip.{i}.weight"] = (
                t_linear(flat[kk]) if kk in flat
                else np.zeros_like(sd[f"{idx}.to_v_ip.{i}.weight"]))
    return sd


def export_audio_proj(params: Mapping) -> Dict[str, np.ndarray]:
    return export_state_dict(convert_audio_proj, params)


def export_id_proj(params: Mapping) -> Dict[str, np.ndarray]:
    return export_state_dict(convert_id_proj, params)


def export_vasa_proj(params: Mapping) -> Dict[str, np.ndarray]:
    return export_state_dict(convert_vasa_proj, params)


def export_pose_guider(params: Mapping) -> Dict[str, np.ndarray]:
    tree = params.get("params", params)
    n_blocks = sum(1 for k in tree if str(k).startswith("blocks_"))
    return export_state_dict(convert_pose_guider, params, n_blocks=n_blocks)


def export_lineage(params: Mapping) -> Dict[str, np.ndarray]:
    """SS2D-lineage params (``models/ssm_spatial.py``, ``SS2DUnit``) -> the
    port module's state dict. The port's module names follow the JAX tree,
    so each leaf maps mechanically: a dense kernel (in, out) -> ``weight``
    (out, in); a conv kernel (kh, kw, i, o) -> ``weight`` (o, i, kh, kw);
    a LayerNorm ``scale`` -> ``weight``; anything else keeps its name."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in _flatten_params(params.get("params", params)).items():
        *mods, leaf = path.split("/")
        if leaf == "kernel":
            leaf, v = "weight", _KINDS["linear" if v.ndim == 2 else "conv2"][1](v)
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(mods + [leaf])] = v
    return sd


# one name per module of the lineage, as the other exporters have
export_ss2d_unit = export_ss2d_spatial = export_lineage
export_ss2d_cond_v5 = export_ss2d_cond_v6 = export_ss2d_cond_v9 = export_lineage
export_mamba_upnet = export_lineage


def convert_vae(sd: Mapping[str, np.ndarray], block_out_channels=(128, 256, 512, 512),
                layers_per_block=2) -> Dict:
    """diffusers AutoencoderKLTemporalDecoder state dict -> VAE params."""
    dst: Dict = {}
    n_levels = len(block_out_channels)
    # encoder
    _conv2(dst, "encoder/conv_in", sd, "encoder.conv_in")
    for i in range(n_levels):
        for j in range(layers_per_block):
            _resnet2d(dst, f"encoder/down_{i}_resnet_{j}", sd,
                      f"encoder.down_blocks.{i}.resnets.{j}", temb=False)
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            _conv2(dst, f"encoder/down_{i}_downsample", sd,
                   f"encoder.down_blocks.{i}.downsamplers.0.conv")
    _resnet2d(dst, "encoder/mid_resnet_0", sd,
              "encoder.mid_block.resnets.0", temb=False)
    _resnet2d(dst, "encoder/mid_resnet_1", sd,
              "encoder.mid_block.resnets.1", temb=False)
    att = "encoder.mid_block.attentions.0"
    _norm(dst, "encoder/mid_attn/group_norm", sd, f"{att}.group_norm")
    _linear(dst, "encoder/mid_attn/to_q", sd, f"{att}.to_q")
    _linear(dst, "encoder/mid_attn/to_k", sd, f"{att}.to_k")
    _linear(dst, "encoder/mid_attn/to_v", sd, f"{att}.to_v")
    _linear(dst, "encoder/mid_attn/to_out", sd, f"{att}.to_out.0")
    _norm(dst, "encoder/conv_norm_out", sd, "encoder.conv_norm_out")
    _conv2(dst, "encoder/conv_out", sd, "encoder.conv_out")
    _conv2(dst, "quant_conv", sd, "quant_conv")
    # temporal decoder
    _conv2(dst, "decoder/conv_in", sd, "decoder.conv_in")
    for j in range(layers_per_block):
        _st_resblock(dst, f"decoder/mid_resnet_{j}", sd,
                     f"decoder.mid_block.resnets.{j}")
    datt = "decoder.mid_block.attentions.0"
    _norm(dst, "decoder/mid_attn/group_norm", sd, f"{datt}.group_norm")
    _linear(dst, "decoder/mid_attn/to_q", sd, f"{datt}.to_q")
    _linear(dst, "decoder/mid_attn/to_k", sd, f"{datt}.to_k")
    _linear(dst, "decoder/mid_attn/to_v", sd, f"{datt}.to_v")
    _linear(dst, "decoder/mid_attn/to_out", sd, f"{datt}.to_out.0")
    for i in range(n_levels):
        for j in range(layers_per_block + 1):
            _st_resblock(dst, f"decoder/up_{i}_resnet_{j}", sd,
                         f"decoder.up_blocks.{i}.resnets.{j}")
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            _conv2(dst, f"decoder/up_{i}_upsample/conv", sd,
                   f"decoder.up_blocks.{i}.upsamplers.0.conv")
    _norm(dst, "decoder/conv_norm_out", sd, "decoder.conv_norm_out")
    _conv2(dst, "decoder/conv_out", sd, "decoder.conv_out")
    _conv3(dst, "decoder/time_conv_out", sd, "decoder.time_conv_out")
    return {"params": dst}
