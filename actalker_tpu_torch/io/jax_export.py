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


_FC_CHANNELS = 512   # ArcFace's last stage width, the C of its fc input


def _fc_chw_to_hwc(w):
    out, n = w.shape
    side = int(round((n // _FC_CHANNELS) ** 0.5))
    return np.transpose(w.reshape(out, _FC_CHANNELS, side, side),
                        (2, 3, 1, 0)).reshape(n, out)


def _fc_hwc_to_chw(k):
    n, out = k.shape
    side = int(round((n // _FC_CHANNELS) ** 0.5))
    return np.transpose(k.reshape(side, side, _FC_CHANNELS, out),
                        (3, 2, 0, 1)).reshape(out, n)


# kind -> (torch->flax transform, flax->torch inverse)
_KINDS = {
    "linear": (t_linear, t_linear),                        # 2-D transpose
    "conv2": (t_conv2d, lambda w: np.transpose(w, (3, 2, 0, 1))),
    "conv3": (t_conv3d, lambda w: np.transpose(w, (4, 3, 0, 1, 2))),
    "conv1": (t_conv1d, t_conv1d),
    "raw": (np.asarray, np.asarray),
    # ArcFace's fc: torch (out, C*H*W) <-> flax kernel (H*W*C, out)
    "fc_chw": (lambda w: _fc_chw_to_hwc(w), lambda k: _fc_hwc_to_chw(k)),
    # torch's transposed conv (in, out, kh, kw) flips its kernel; flax's
    # ConvTranspose (kh, kw, in, out) does not, so the layout carries the
    # flip
    "convT_flip": (lambda w: np.flip(np.transpose(w, (2, 3, 0, 1)), (0, 1)),
                   lambda k: np.transpose(np.flip(k, (0, 1)), (2, 3, 0, 1))),
    # StyleGAN2's modulated conv (1, out, in, k, k), the noise weight (1,),
    # ToRGB's bias (1, 3, 1, 1) and the constant input (1, C, 4, 4)
    "modconv": (lambda w: t_conv2d(w[0]),
                lambda k: np.transpose(k, (3, 2, 0, 1))[None]),
    "scalar": (lambda w: w.reshape(()), lambda k: k.reshape(1)),
    "rgb_bias": (lambda w: w.reshape(-1), lambda k: k.reshape(1, -1, 1, 1)),
    "nchw": (lambda w: np.transpose(w, (0, 2, 3, 1)),
             lambda k: np.transpose(k, (0, 3, 1, 2))),
    # the BatchNorm of a conv the JAX package folds (``_fold``): exported
    # as the identity over the folded conv (weight 1, mean 0, var 1 - eps,
    # the folded bias as its bias)
    "bn_one": (None, np.ones_like),
    "bn_zero": (None, np.zeros_like),
    "bn_var_0.001": (None, lambda b: np.full_like(b, 1.0 - 1e-3)),
    "bn_var_1e-05": (None, lambda b: np.full_like(b, 1.0 - 1e-5)),
}


class _CaptureSD:
    """Stand-in state dict that records the (flax path, torch key, kind)
    assignments a converter would make, instead of converting — the shared
    spec that makes every converter invertible (``export_state_dict``).

    Without ``keys``, ``__contains__`` answers True so every OPTIONAL
    module's entries are captured; export prunes entries whose flax path is
    absent from the actual params tree. With ``keys`` (the port module's
    state-dict keys) it holds exactly those, so a converter that discovers
    its modules from the keys (``for k in sd``, ``while key in sd``) sees
    the checkpoint's layout."""

    def __init__(self, keys=None):
        self.spec = []  # (flax_path, torch_key, kind)
        self.keys = None if keys is None else list(keys)
        self._held = set(self.keys or ())

    def __contains__(self, key) -> bool:
        return self.keys is None or key in self._held

    def __iter__(self):
        return iter(self.keys or ())

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


# --------------------------------------------------------------- encoders

def convert_whisper_encoder(sd, layers: int = 4) -> Dict:
    """HF ``WhisperModel`` state dict (``encoder.*`` keys) -> WhisperEncoder
    params."""
    dst: Dict = {}
    _put(dst, sd, "conv1/kernel", "encoder.conv1.weight", "conv1")
    _put(dst, sd, "conv1/bias", "encoder.conv1.bias")
    _put(dst, sd, "conv2/kernel", "encoder.conv2.weight", "conv1")
    _put(dst, sd, "conv2/bias", "encoder.conv2.bias")
    _put(dst, sd, "embed_positions", "encoder.embed_positions.weight")
    for i in range(layers):
        p, s = f"layers_{i}", f"encoder.layers.{i}"
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            _norm(dst, f"{p}/{ln}", sd, f"{s}.{ln}")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(dst, f"{p}/{proj}", sd, f"{s}.self_attn.{proj}")
        for fc in ("fc1", "fc2"):
            _linear(dst, f"{p}/{fc}", sd, f"{s}.{fc}")
    _norm(dst, "layer_norm", sd, "encoder.layer_norm")
    return {"params": dst}


def convert_vasa_expression(sd) -> Dict:
    """The MX31c ``generator`` dict (``expression_model.resnet50.*``) ->
    HeadExpression params."""
    dst: Dict = {}
    r = "expression_model.resnet50"
    _put(dst, sd, "conv1/kernel", f"{r}.conv1.weight", "conv2")
    _norm(dst, "gn1", sd, f"{r}.gn1")
    for i, blocks in enumerate((3, 4, 6, 3)):
        for j in range(blocks):
            s, p = f"{r}.layer{i + 1}.{j}", f"layer{i + 1}_{j}"
            for n in ("1", "2", "3"):
                _put(dst, sd, f"{p}/conv{n}/kernel", f"{s}.conv{n}.weight", "conv2")
                _norm(dst, f"{p}/gn{n}", sd, f"{s}.gn{n}")
            if f"{s}.downsample.0.weight" in sd:
                _put(dst, sd, f"{p}/downsample_conv/kernel",
                     f"{s}.downsample.0.weight", "conv2")
                _norm(dst, f"{p}/downsample_gn", sd, f"{s}.downsample.1")
    _linear(dst, "fc", sd, f"{r}.fc")
    return {"params": dst}


def convert_vasa_pose(sd) -> Dict:
    """The MX31c ``pose_model`` dict (``head_pose_net.*``) -> HeadPose
    params."""
    dst: Dict = {}
    r = "head_pose_net"
    _put(dst, sd, "conv1/kernel", f"{r}.conv1.weight", "conv2")
    _norm(dst, "bn1", sd, f"{r}.bn1")
    for i, blocks in enumerate((2, 2, 2, 2)):
        for j in range(blocks):
            s, p = f"{r}.layer{i + 1}.{j}", f"layer{i + 1}_{j}"
            for n in ("1", "2"):
                _put(dst, sd, f"{p}/conv{n}/kernel", f"{s}.conv{n}.weight", "conv2")
                _norm(dst, f"{p}/bn{n}", sd, f"{s}.bn{n}")
            if f"{s}.shortcut.0.weight" in sd:
                _put(dst, sd, f"{p}/shortcut_conv/kernel",
                     f"{s}.shortcut.0.weight", "conv2")
                _norm(dst, f"{p}/shortcut_gn", sd, f"{s}.shortcut.1")
    _linear(dst, "fc", sd, f"{r}.fc")
    return {"params": dst}


def convert_arcface(sd, layers=(3, 4, 14, 3)) -> Dict:
    """insightface iResNet ``backbone.pth`` -> IResNet params. ``fc`` takes
    the flattened (C, H, W) map in torch and the (H, W, C) map in the JAX
    package, so its input rows are reordered (kind "fc_chw")."""
    dst: Dict = {}

    def bn(prefix, src):
        _bn_stats(dst, prefix, sd, src)

    _put(dst, sd, "conv1/kernel", "conv1.weight", "conv2")
    bn("bn1", "bn1")
    _put(dst, sd, "prelu/alpha", "prelu.weight")
    for i, blocks in enumerate(layers):
        for j in range(blocks):
            s, p = f"layer{i + 1}.{j}", f"layer{i + 1}_{j}"
            for n in ("1", "2"):
                _put(dst, sd, f"{p}/conv{n}/kernel", f"{s}.conv{n}.weight", "conv2")
            for n in ("1", "2", "3"):
                bn(f"{p}/bn{n}", f"{s}.bn{n}")
            _put(dst, sd, f"{p}/prelu/alpha", f"{s}.prelu.weight")
            if f"{s}.downsample.0.weight" in sd:
                _put(dst, sd, f"{p}/downsample_conv/kernel",
                     f"{s}.downsample.0.weight", "conv2")
                bn(f"{p}/downsample_bn", f"{s}.downsample.1")
    bn("bn2", "bn2")
    _put(dst, sd, "fc/kernel", "fc.weight", "fc_chw")
    _put(dst, sd, "fc/bias", "fc.bias")
    bn("features", "features")
    return {"params": dst}


# ------------------------------------------------ face stack and post-passes

def _fold(dst: Dict, sd: Mapping, path: str, conv: str, bn: str,
          eps: float) -> None:
    """A conv + BatchNorm pair of the checkpoint -> one flax conv with the
    BatchNorm folded in (``path/kernel``, ``path/bias``). Exported as the
    folded kernel and an identity BatchNorm (kinds ``bn_*``)."""
    if isinstance(sd, _CaptureSD):
        sd.spec += [(f"{path}/kernel", f"{conv}.weight", "conv2"),
                    (f"{path}/bias", f"{bn}.bias", "raw"),
                    (f"{path}/bias", f"{bn}.weight", "bn_one"),
                    (f"{path}/bias", f"{bn}.running_mean", "bn_zero"),
                    (f"{path}/bias", f"{bn}.running_var", f"bn_var_{eps:g}")]
        return
    w = np.asarray(sd[f"{conv}.weight"], np.float32)
    g, b, m, v = (np.asarray(sd[f"{bn}.{n}"], np.float32) for n in
                  ("weight", "bias", "running_mean", "running_var"))
    s = g / np.sqrt(v + eps)
    bias = b - m * s
    if f"{conv}.bias" in sd:
        bias = bias + np.asarray(sd[f"{conv}.bias"], np.float32) * s
    set_in(dst, f"{path}/kernel", t_conv2d(w * s[:, None, None, None]))
    set_in(dst, f"{path}/bias", bias)


def _bn_stats(dst: Dict, prefix: str, sd: Mapping, src: str) -> None:
    _norm(dst, prefix, sd, src)
    _put(dst, sd, f"{prefix}/mean", f"{src}.running_mean")
    _put(dst, sd, f"{prefix}/var", f"{src}.running_var")


def convert_rife(sd) -> Dict:
    """RIFE ``flownet.pkl`` (``module.`` stripped) -> IFNet params. The
    transposed convs' kernels are flipped (kind ``convT_flip``), which the
    JAX package's own ``convert_rife`` omits."""
    dst: Dict = {}

    def convprelu(prefix, src):
        _conv2(dst, f"{prefix}/conv", sd, f"{src}.0")
        _put(dst, sd, f"{prefix}/prelu/alpha", f"{src}.1.weight")

    for bi in range(3):
        p = f"block{bi}"
        convprelu(f"{p}/conv0_0", f"{p}.conv0.0")
        convprelu(f"{p}/conv0_1", f"{p}.conv0.1")
        for ci in range(4):
            for j in range(2):
                convprelu(f"{p}/convblock{ci}_{j}", f"{p}.convblock{ci}.{j}")
        for t in ("conv1", "conv2"):
            for j, idx in ((0, 0), (1, 2)):
                _put(dst, sd, f"{p}/{t}_{j}/kernel", f"{p}.{t}.{idx}.weight",
                     "convT_flip")
                _put(dst, sd, f"{p}/{t}_{j}/bias", f"{p}.{t}.{idx}.bias")
            _put(dst, sd, f"{p}/{t}_prelu/alpha", f"{p}.{t}.1.weight")
    return {"params": dst}


def convert_teeth(sd) -> Dict:
    """The teeth enhancer's PNNX export (flat ``encoder_blocks_K_J_*`` /
    ``convbn2d_N`` / ``*_mid_blocks_*`` / ``decoder_conv_out4_*``
    attributes) -> TeethEnhancer params."""
    dst: Dict = {}

    def res(prefix, norm_src, convbn_idx, conv2_src, residual_src=None):
        _bn_stats(dst, f"{prefix}/norm1", sd, norm_src)
        _conv2(dst, f"{prefix}/conv1", sd, f"convbn2d_{convbn_idx}")
        _conv2(dst, f"{prefix}/conv2", sd, conv2_src)
        if residual_src is not None:
            _conv2(dst, f"{prefix}/residual_func", sd, residual_src)

    def attn(prefix, src):
        _bn_stats(dst, f"{prefix}/norm", sd, f"{src}_norm")
        for nm in ("q", "k", "v", "proj_out"):
            _conv2(dst, f"{prefix}/{nm}", sd, f"{src}_{nm}")

    _conv2(dst, "encoder_conv_in", sd, "encoder_conv_in")
    res("encoder_res_0", "encoder_blocks_0_0_norm1", 0, "encoder_blocks_0_0_conv2")
    for i in range(1, 6):
        _conv2(dst, f"encoder_down_{i}", sd, f"encoder_blocks_{i}_0_conv")
        res(f"encoder_res_{i}", f"encoder_blocks_{i}_1_norm1", i,
            f"encoder_blocks_{i}_1_conv2",
            f"encoder_blocks_{i}_1_residual_func" if i < 5 else None)
    attn("encoder_attn", "encoder_blocks_5_2")
    res("encoder_mid_res1", "encoder_mid_blocks_0_norm1", 6,
        "encoder_mid_blocks_0_conv2")
    attn("encoder_mid_attn", "encoder_mid_blocks_1")
    res("encoder_mid_res2", "encoder_mid_blocks_2_norm1", 7,
        "encoder_mid_blocks_2_conv2")
    _bn_stats(dst, "encoder_out_norm", sd, "encoder_conv_out_0")
    _conv2(dst, "encoder_conv_out", sd, "encoder_conv_out_2")
    _conv2(dst, "decoder_conv_in", sd, "decoder_conv_in")
    res("decoder_mid_res1", "decoder_mid_blocks_0_norm1", 8,
        "decoder_mid_blocks_0_conv2")
    attn("decoder_mid_attn", "decoder_mid_blocks_1")
    res("decoder_mid_res2", "decoder_mid_blocks_2_norm1", 9,
        "decoder_mid_blocks_2_conv2")
    res("decoder_res_0", "decoder_blocks_0_0_norm1", 10, "decoder_blocks_0_0_conv2")
    attn("decoder_attn", "decoder_blocks_0_1")
    for i in range(1, 6):
        _conv2(dst, f"decoder_up_{i}", sd, f"decoder_blocks_{i}_0_conv")
        res(f"decoder_res_{i}", f"decoder_blocks_{i}_1_norm1", 10 + i,
            f"decoder_blocks_{i}_1_conv2",
            f"decoder_blocks_{i}_1_residual_func" if i > 1 else None)
    _bn_stats(dst, "decoder_out_norm", sd, "decoder_conv_out4_0")
    _conv2(dst, "decoder_conv_out", sd, "decoder_conv_out4_1")
    return {"params": dst}


def convert_bfr(sd) -> Dict:
    """BFR ``enhance-512.pth`` (FullGenerator_paper) -> GPENGenerator
    params. The encoder, style MLP and synthesis depths are read off the
    keys."""
    dst: Dict = {}

    def lin(prefix, src):
        _put(dst, sd, f"{prefix}/weight", f"{src}.weight", "linear")
        _put(dst, sd, f"{prefix}/bias", f"{src}.bias")

    def modconv(prefix, src):
        _put(dst, sd, f"{prefix}/weight", f"{src}.weight", "modconv")
        lin(f"{prefix}/modulation", f"{src}.modulation")

    def styled(prefix, src):
        modconv(f"{prefix}/conv", f"{src}.conv")
        _put(dst, sd, f"{prefix}/noise/weight", f"{src}.noise.weight", "scalar")
        _put(dst, sd, f"{prefix}/bias", f"{src}.activate.bias")

    def torgb(prefix, src):
        modconv(f"{prefix}/conv", f"{src}.conv")
        _put(dst, sd, f"{prefix}/bias", f"{src}.bias", "rgb_bias")

    _put(dst, sd, "ecd0/weight", "ecd0.0.0.weight", "conv2")
    _put(dst, sd, "ecd0_bias", "ecd0.0.1.bias")
    k = 1
    while f"ecd{k}.0.1.weight" in sd:
        _put(dst, sd, f"ecd{k}/weight", f"ecd{k}.0.1.weight", "conv2")
        _put(dst, sd, f"ecd{k}_bias", f"ecd{k}.0.2.bias")
        k += 1
    lin("final_linear", "final_linear.0")
    i = 1
    while f"generator.style.{i}.weight" in sd:
        lin(f"mlp_{i - 1}", f"generator.style.{i}")
        i += 1
    _put(dst, sd, "input", "generator.input.input", "nchw")
    styled("conv1", "generator.conv1")
    torgb("to_rgb1", "generator.to_rgb1")
    j = 0
    while f"generator.convs.{2 * j}.conv.weight" in sd:
        styled(f"conv_{j + 3}_up", f"generator.convs.{2 * j}")
        styled(f"conv_{j + 3}", f"generator.convs.{2 * j + 1}")
        torgb(f"to_rgb_{j + 3}", f"generator.to_rgbs.{j}")
        j += 1
    return {"params": dst}


def _flax_path(head: str, rest, container: str) -> str:
    """A conv's module path -> its flax path: ``head`` (the JAX module's
    name), then the remaining parts with the Sequential ``container``
    dropped and its indices ``N`` named ``{container}N``, as the JAX
    modules name them."""
    return "/".join([head] + [f"{container}{p}" if p.isdigit() else p
                              for p in rest if p != container])


def convert_yoloface(sd) -> Dict:
    """A yolov5-face state dict (``model.N.*``; BatchNorm eps 1e-3) ->
    YoloFaceNet params with every BatchNorm folded; the Detect convs are
    ``model.23.m.{0,1,2}``."""
    dst: Dict = {}
    for k in sd:
        if not (k.startswith("model.") and k.endswith(".conv.weight")):
            continue
        pref = k[:-len(".conv.weight")]
        _, idx, *rest = pref.split(".")
        path = _flax_path(f"m{idx}", rest, "m")
        _fold(dst, sd, f"{path}/conv", f"{pref}.conv", f"{pref}.bn", 1e-3)
    for i in range(3):
        _conv2(dst, f"det{i}", sd, f"model.23.m.{i}")
    return {"params": dst}


def convert_scrfd(sd) -> Dict:
    """An insightface SCRFD state dict (mmdet names: ``backbone.stem.*``,
    ``backbone.layerN.*``, ``neck.{lateral,fpn,downsample,pafpn}_convs.*``,
    ``bbox_head.cls_convs.*``, ``bbox_head.stride_{cls,reg,kps}.*``) ->
    ScrfdNet params with the BatchNorms folded (the head's GroupNorms
    stay)."""
    dst: Dict = {}
    for i in range(3):
        _fold(dst, sd, f"backbone/stem{i}/conv", f"backbone.stem.{3 * i}",
              f"backbone.stem.{3 * i + 1}", 1e-5)
    for k in sd:
        m = re.fullmatch(r"backbone\.layer(\d+)\.(\d+)\.conv1\.weight", k)
        if not m:
            continue
        t = f"backbone.layer{m[1]}.{m[2]}"
        f = f"backbone/layer{int(m[1]) - 1}_{m[2]}"
        _fold(dst, sd, f"{f}/conv1/conv", f"{t}.conv1", f"{t}.bn1", 1e-5)
        _fold(dst, sd, f"{f}/conv2/conv", f"{t}.conv2", f"{t}.bn2", 1e-5)
        if f"{t}.downsample.1.weight" in sd:
            # [AvgPool, conv, BN] at a stride, [conv, BN] without
            c = 1 if f"{t}.downsample.2.weight" in sd else 0
            _fold(dst, sd, f"{f}/downsample/conv", f"{t}.downsample.{c}",
                  f"{t}.downsample.{c + 1}", 1e-5)
    for name, src, n in (("lateral", "lateral_convs", 3), ("fpn", "fpn_convs", 3),
                         ("down", "downsample_convs", 2),
                         ("pafpn", "pafpn_convs", 2)):
        for i in range(n):
            _fold(dst, sd, f"neck/{name}{i}/conv", f"neck.{src}.{i}.conv",
                  f"neck.{src}.{i}.bn", 1e-5)
    j = 0
    while f"bbox_head.cls_convs.{j}.conv.weight" in sd:
        _conv2(dst, f"head_conv{j}/conv", sd, f"bbox_head.cls_convs.{j}.conv")
        _norm(dst, f"head_conv{j}/gn", sd, f"bbox_head.cls_convs.{j}.gn")
        j += 1
    for i in range(3):
        for name, src in (("cls_out", "stride_cls"), ("bbox_out", "stride_reg"),
                          ("kps_out", "stride_kps")):
            _conv2(dst, f"{name}{i}", sd, f"bbox_head.{src}.{i}")
    return {"params": dst}


# Megvii YOLOX module prefix -> the JAX module's name
_YOLOX_NAMES = {
    "backbone.backbone.stem.conv": "stem/conv",
    **{f"backbone.backbone.dark{d}.{i}": f"dark{d}_{i}"
       for d, n in ((2, 2), (3, 2), (4, 2), (5, 3)) for i in range(n)},
    **{f"backbone.{s}": s for s in ("lateral_conv0", "C3_p4", "reduce_conv1",
                                    "C3_p3", "bu_conv2", "C3_n3", "bu_conv1",
                                    "C3_n4")},
    **{f"head.stems.{i}": f"stem{i}" for i in range(3)},
    **{f"head.{k}_convs.{i}.{j}": f"{k}_conv{i}_{j}"
       for k in ("cls", "reg") for i in range(3) for j in range(2)},
}


def convert_yolox(sd) -> Dict:
    """A Megvii YOLOX state dict (the port's ``YoloXNet``, ``yolox_l.pth``)
    -> the JAX package's YoloXNet params, every BatchNorm (eps 1e-3) folded
    into its conv; the head's 1x1 prediction convs keep their bias."""
    dst: Dict = {}
    for k in sd:
        if not k.endswith(".conv.weight") or k[:-len("conv.weight")] + "bn.weight" not in sd:
            continue
        pref = k[:-len(".conv.weight")]
        head = max((p for p in _YOLOX_NAMES if pref.startswith(p)), key=len)
        rest = pref[len(head):].strip(".").split(".")
        path = _flax_path(_YOLOX_NAMES[head], [p for p in rest if p and p != "conv"], "m")
        _fold(dst, sd, f"{path}/conv", f"{pref}.conv", f"{pref}.bn", 1e-3)
    for kind in ("cls_pred", "reg_pred", "obj_pred"):
        for i in range(3):
            _conv2(dst, f"{kind}{i}", sd, f"head.{kind}s.{i}")
    return {"params": dst}


def _rtm_head(pref: str) -> str:
    """``backbone.stem.N`` / ``backbone.stageS.I`` -> the JAX module name
    (``stemN``; a stage's first module is its conv, the SPP the second of
    stage 4, the CSP layer the last)."""
    _, stage, idx = pref.split(".")[:3]
    if stage == "stem":
        return f"stem{idx}"
    if idx == "0":
        return f"{stage}_conv"
    return f"{stage}_spp" if stage == "stage4" and idx == "1" else f"{stage}_csp"


def convert_rtmpose(sd) -> Dict:
    """An mmpose RTMPose state dict (``backbone.stem.*``,
    ``backbone.stageN.*``, ``head.*``) -> RTMPoseNet params with the
    BatchNorms (eps 1e-5) folded."""
    dst: Dict = {}
    for k in sd:
        if k.endswith(".conv.weight") and k.startswith("backbone."):
            pref = k[:-len(".conv.weight")]
            path = _flax_path(_rtm_head(pref), pref.split(".")[3:], "blocks")
            _fold(dst, sd, f"{path}/conv", f"{pref}.conv", f"{pref}.bn", 1e-5)
        elif k.endswith("attention.fc.weight"):
            pref = k[:-len(".fc.weight")]
            path = _flax_path(_rtm_head(pref), pref.split(".")[3:], "blocks")
            _conv2(dst, f"{path}/fc", sd, f"{pref}.fc")
    _conv2(dst, "final_layer", sd, "head.final_layer")
    _put(dst, sd, "mlp_norm/g", "head.mlp.0.g")
    _linear(dst, "mlp", sd, "head.mlp.1", bias=False)
    _put(dst, sd, "gau/ln/g", "head.gau.ln.g")
    _linear(dst, "gau/uv", sd, "head.gau.uv")
    _linear(dst, "gau/o", sd, "head.gau.o")
    for leaf in ("gamma", "beta"):
        _put(dst, sd, f"gau/{leaf}", f"head.gau.{leaf}")
    _put(dst, sd, "gau/res_scale", "head.gau.res_scale.scale")
    _linear(dst, "cls_x", sd, "head.cls_x", bias=False)
    _linear(dst, "cls_y", sd, "head.cls_y", bias=False)
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
                      keys=None, **kwargs) -> Dict[str, np.ndarray]:
    """Invert a converter: flax params -> reference-keyed torch state dict.

    Re-runs ``convert_fn`` in capture mode to obtain its
    (flax path, torch key, kind) assignment spec, then replays it backward
    with the inverse layout transforms. Entries whose flax path is absent
    from ``params`` are pruned (optional modules); with ``strict`` every
    param leaf must be covered by the spec. ``keys`` (the target module's
    state-dict keys) serve converters that discover modules from the
    keys. Completes the reference
    checkpoint contract round trip
    (the reference's ``Inference.py:80-142``): a model fine-tuned here can
    be re-exported to the six ``.pth`` state dicts.
    """
    cap = _CaptureSD(keys)
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


def export_whisper(params: Mapping) -> Dict[str, np.ndarray]:
    """WhisperEncoder params -> the ``encoder.*`` entries of whisper-tiny's
    ``pytorch_model.bin``."""
    return export_state_dict(convert_whisper_encoder, params)


def export_vasa_expression(params: Mapping) -> Dict[str, np.ndarray]:
    """HeadExpression params -> the MX31c ``generator`` entries
    (``expression_model.resnet50.*``)."""
    return export_state_dict(convert_vasa_expression, params)


def export_vasa_pose(params: Mapping) -> Dict[str, np.ndarray]:
    """HeadPose params -> the MX31c ``pose_model`` dict."""
    return export_state_dict(convert_vasa_pose, params)


def export_arcface(params: Mapping) -> Dict[str, np.ndarray]:
    """IResNet-50 params -> insightface's ``backbone.pth`` dict."""
    return export_state_dict(convert_arcface, params)


def export_rife(params: Mapping) -> Dict[str, np.ndarray]:
    """IFNet params -> ``flownet.pkl``'s entries (``module.`` stripped),
    the transposed convs' kernels flipped back."""
    return export_state_dict(convert_rife, params)


def export_teeth(params: Mapping) -> Dict[str, np.ndarray]:
    """TeethEnhancer params -> the PNNX export's flat entries."""
    return export_state_dict(convert_teeth, params)


def export_bfr(params: Mapping, keys) -> Dict[str, np.ndarray]:
    """GPENGenerator params -> ``enhance-512.pth``'s entries; ``keys``: the
    port module's state-dict keys (its depths)."""
    return export_state_dict(convert_bfr, params, keys=keys)


def export_yoloface(params: Mapping, keys) -> Dict[str, np.ndarray]:
    """Folded YoloFaceNet params -> a yolov5-face state dict keyed as
    ``keys`` (the port module's), each BatchNorm the identity."""
    return export_state_dict(convert_yoloface, params, keys=keys)


def export_scrfd(params: Mapping, keys) -> Dict[str, np.ndarray]:
    """Folded ScrfdNet params -> an SCRFD state dict keyed as ``keys``,
    each BatchNorm the identity over its folded conv."""
    return export_state_dict(convert_scrfd, params, keys=keys)


def export_rtmpose(params: Mapping, keys) -> Dict[str, np.ndarray]:
    """Folded RTMPoseNet params -> an mmpose RTMPose state dict keyed as
    ``keys``, each BatchNorm the identity."""
    return export_state_dict(convert_rtmpose, params, keys=keys)


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
