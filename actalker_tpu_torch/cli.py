"""Inference CLI of the port, after ``actalker_tpu/cli.py`` (the reference's
``Inference.py:597-613`` surface):

    python -m actalker_tpu_torch.cli --config configs/inference.yaml \\
        --ref face.png --audio speech.wav [--video drive.mp4] --mode 0|1|2 \\
        [--batch] [--random-weights] [--frame-limit N] [--device cuda|cpu]

Mode 0 is audio only, 1 expression (VASA) only, 2 both. The checkpoints the
config names are loaded where they exist (``io/init.py::load_checkpoints``);
``--random-weights`` runs the whole stack on seeded weights. It runs on the
card (``--device cuda``, the default, in the config's ``weight_dtype``) or
on the CPU in fp32. A config key ``micro_model: true`` selects the micro
UNet and the tiny VAE (tests, smoke runs).

``generate_frames`` runs the stages to the finished frames (a caller may
hand it the face detector and reads the per-stage times): the learned face
detector (YOLOv5-face, else SCRFD, else the cascade), the preprocessing,
the reference-image BFR before the ArcFace crop (``use_bfr``), the UNet
and the decode, then ``postprocess_frames``: teeth enhancement
(``use_teeth_enhance``), frame BFR (``extras.use_bfr_frames``) and RIFE
frame doubling (``use_interframe``), each only where its checkpoint exists.
``write_outputs`` writes the mp4s. The networks of the face stack and the
post-passes run in fp32.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from actalker_tpu_torch.config import MODE_GATES, InferenceConfig, load_config
from actalker_tpu_torch.frontend import audio as A
from actalker_tpu_torch.frontend import preprocess as P
from actalker_tpu_torch.frontend import video as V
from actalker_tpu_torch.frontend.enhance import enhance_face, enhance_teeth
from actalker_tpu_torch.frontend.face import (
    NoCascadeModelError, detect_face, resolve_face_detector)
from actalker_tpu_torch.frontend.landmarks import (
    NoFaceError, resolve_landmark_estimator)
from actalker_tpu_torch.io import init as I
from actalker_tpu_torch.io.init import (
    cast_params_bf16_, load_checkpoints, load_state_file, random_init_)
from actalker_tpu_torch.models.arcface import iresnet50
from actalker_tpu_torch.models.rife import interpolate_pairs
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.models.vae import VAEConfig
from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline, PipelineModules

TAG = "[actalker_tpu_torch]"
_DTYPES = {"fp16": torch.bfloat16, "bf16": torch.bfloat16, "fp32": torch.float32}
# the modules a UNet checkpoint must come with; a missing VAE or audio
# encoder is refused (random frozen encoders corrupt generation silently)
EXPECTED = {"unet", "pose_guider", "audio_proj", "id_proj", "vasa_proj",
            "vae", "whisper"}


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    return device


def build_pipeline(cfg: InferenceConfig, random_weights: bool,
                   device: torch.device) -> ACTalkerPipeline:
    """The pipeline's modules on ``device``: seeded (``random_init_``), then
    the configured checkpoints over them unless ``random_weights``. bf16
    weights on the card where the config asks for them (the scan's state
    parameters and 1-D ones stay fp32), fp32 on the CPU."""
    on_card = device.type == "cuda"
    dtype = _DTYPES[cfg.weight_dtype] if on_card else torch.float32
    vae_dtype = _DTYPES[cfg.vae_dtype] if on_card else torch.float32
    ucfg, vcfg = UNetConfig(ablate=tuple(cfg.ablate)), VAEConfig()
    if cfg.extras.get("micro_model"):
        ucfg, vcfg = ucfg.micro(), vcfg.tiny()
    with torch.device("meta"):
        mods = PipelineModules.create(unet_config=ucfg, vae_config=vcfg,
                                      dtype=dtype, vae_dtype=vae_dtype,
                                      vasa_expression_dim=cfg.vasa_expression_dim)
    for i, mod in enumerate(mods.named().values()):
        random_init_(mod, seed=i, device=device)
    loaded = None if random_weights else load_checkpoints(cfg, mods.named())
    if loaded is None:
        print(f"{TAG} using random weights (no checkpoints found or "
              "--random-weights)")
    else:
        missing = EXPECTED - loaded
        hard = {"vae", "whisper"} & missing
        if hard and not cfg.extras.get("allow_random_encoders"):
            raise SystemExit(
                f"{TAG} unet checkpoint loaded but required frozen encoders "
                f"are missing: {sorted(hard)} — supply them "
                "(download_models.py), use --random-weights, or set "
                "extras.allow_random_encoders for smoke runs")
        if missing:
            print(f"{TAG} missing checkpoints {sorted(missing)}: those stay "
                  "random")
        # random VASA towers must not pass for loaded ones: without them
        # modes 1 / 2 take zero expression tokens, loudly
        if "vasa_expression" not in loaded:
            mods.vasa_expression = mods.vasa_pose = None
    for mod in mods.named().values():
        if dtype == torch.bfloat16:
            cast_params_bf16_(mod)
        mod.eval()
    return ACTalkerPipeline(mods, dtype=dtype)


def identity_embedding(cfg: InferenceConfig, head_crop: np.ndarray,
                       device: torch.device) -> np.ndarray:
    """ArcFace's (512,) embedding of the (112, 112, 3) head crop, or zeros
    where its checkpoint is absent (the reference run without the
    encoder)."""
    if not os.path.exists(cfg.arcface_checkpoint_path):
        print(f"{TAG} WARNING: arcface weights not found at "
              f"{cfg.arcface_checkpoint_path}; identity conditioning is a "
              "zero embedding")
        return np.zeros(512, np.float32)
    net = iresnet50()
    net.load_state_dict(load_state_file(cfg.arcface_checkpoint_path), strict=True)
    net = net.to(device).eval()
    with torch.no_grad():
        x = torch.from_numpy(np.asarray(head_crop, np.float32))[None].to(device)
        return net(x)[0].float().cpu().numpy()


def _have(path: str) -> bool:
    return bool(path) and os.path.exists(path)


def _numpy_fn(net, device: torch.device):
    """numpy in, numpy out over ``net`` on ``device`` (the enhance glue's
    callables); a tuple of outputs stays a tuple."""
    @torch.no_grad()
    def fn(x):
        y = net(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device))
        if isinstance(y, tuple):
            return tuple(t.cpu().numpy() for t in y)
        return y.cpu().numpy()
    return fn


def face_landmarks(estimator, image_u8: np.ndarray, box):
    """The estimator's (5, 2) landmarks, or None where its host code finds
    no face or a degenerate box (``enhance_face`` then aligns on the box
    prior, which is said on stderr)."""
    try:
        return estimator(image_u8, box)
    except (NoFaceError, np.linalg.LinAlgError) as e:
        print(f"{TAG} landmarks unavailable ({e}); aligning on the face-box "
              "prior", file=sys.stderr)
        return None


def _u8(frame01: np.ndarray) -> np.ndarray:
    return (frame01 * 255).round().astype(np.uint8)


def postprocess_frames(cfg: InferenceConfig, frames01: np.ndarray, face_box,
                       landmarks=None, device=torch.device("cuda"),
                       stages=None) -> np.ndarray:
    """The post-passes on the decoded frames ((F, H, W, 3) in [0, 1]), in
    the JAX CLI's order, each only where it is asked for and its checkpoint
    exists: teeth enhancement on the lower half of ``face_box``
    (``use_teeth_enhance``), frame BFR aligned on ``landmarks`` (5, 2) or
    the box prior (``extras.use_bfr_frames``; the reference enhances only
    the reference image), then RIFE (``use_interframe``: 2F - 1 frames).
    ``stages`` (a ``_Stages``) times each pass."""
    stages = stages or _Stages(device)
    if cfg.use_teeth_enhance and _have(cfg.teeth_checkpoint_path):
        with stages("teeth"):
            fn = _numpy_fn(I.load_teeth(cfg.teeth_checkpoint_path, device), device)
            x1, y1, x2, y2 = face_box
            mouth = (x1, y1 + (y2 - y1) / 2, x2, y2)
            frames01 = np.stack([enhance_teeth(_u8(f), mouth, fn) for f in frames01]
                                ).astype(np.float32) / 255
    if cfg.extras.get("use_bfr_frames") and _have(cfg.bfr_checkpoint_path):
        with stages("bfr_frames"):
            fn = _numpy_fn(I.load_bfr(cfg.bfr_checkpoint_path, device), device)
            frames01 = np.stack([enhance_face(_u8(f), face_box, fn, landmarks=landmarks)
                                 for f in frames01]).astype(np.float32) / 255
    if cfg.use_interframe and _have(cfg.rife_checkpoint_path):
        with stages("rife"):
            net = I.load_rife(cfg.rife_checkpoint_path, device)
            with torch.no_grad():
                frames01 = interpolate_pairs(
                    net, torch.from_numpy(np.ascontiguousarray(frames01, np.float32))
                    .to(device)).cpu().numpy()
    return frames01


class _Stages:
    """Wall-clock seconds per stage, the device synchronized at each end."""

    def __init__(self, device: torch.device):
        self.device, self.seconds = device, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)


def generate_frames(cfg: InferenceConfig, args, gate, pipe_cache: Dict,
                    detector=None) -> Dict:
    """The CLI's stages up to the decoded frames: preprocess (face box,
    masks, the ArcFace crop and embedding), mel, whisper, tokens (audio and
    VASA), ``generate_latents``, decode. ``detector`` (any ``image -> box``
    callable) replaces the configured one. Returns frames01 (F, H, W, 3) in
    [0, 1], the preprocessed image, the pipeline, the tokens and masks the
    sampler took, and ``seconds`` by stage."""
    device = resolve_device(args.device)
    stages = _Stages(device)
    with stages("detect"):
        if detector is None:
            try:
                detector = resolve_face_detector(cfg.det_checkpoint_path,
                                                 cfg.scrfd_checkpoint_path, device)
            except NoCascadeModelError as e:
                print(f"{TAG} face detector unavailable ({e}); full-image bbox")
        ref_rgb = P.read_image(args.ref)
        bbox = detect_face(ref_rgb, detector) if detector is not None else None
    if bbox is None:
        print(f"{TAG} no face detected; using full-image bbox")
    with stages("preprocess"):
        pre = P.preprocess_reference_image(
            ref_rgb, bbox, image_size=cfg.image_size, area=cfg.area,
            crop=cfg.crop, expand_ratio=cfg.expand_ratio,
            aspect_type=cfg.aspect_type)
    h, w = pre.ref_img.shape[:2]
    # landmarks come from the learned networks only (a detector with
    # ``detect``), as in the JAX CLI
    estimator = None
    if hasattr(detector, "detect") and (
            (cfg.use_bfr and _have(cfg.bfr_checkpoint_path))
            or cfg.use_teeth_enhance or cfg.extras.get("use_bfr_frames")):
        with stages("landmarks"):
            estimator = resolve_landmark_estimator(
                cfg.det_checkpoint_path, cfg.scrfd_checkpoint_path,
                cfg.face_landmark_checkpoint_path, device)
    if cfg.use_bfr and _have(cfg.bfr_checkpoint_path):
        # BFR of the processed reference image before the ArcFace crop
        # (the reference's test_preprocess.py:286-304), aligned on the
        # landmarks of the face re-detected in it
        u8 = _u8(pre.ref_img * 0.5 + 0.5)
        lm5, rbox = None, pre.bbox_ref
        if estimator is not None:
            with stages("landmarks"):
                rbox = detect_face(u8, detector) or rbox
                lm5 = face_landmarks(estimator, u8, rbox)
        with stages("bfr_ref"):
            bfr = _numpy_fn(I.load_bfr(cfg.bfr_checkpoint_path, device), device)
            enhanced = enhance_face(u8, rbox, bfr, landmarks=lm5)
            pre.ref_img = enhanced.astype(np.float32) / 127.5 - 1.0
            # the ArcFace crop, refreshed from the enhanced image
            bx1, by1, bx2, by2 = [int(max(v, 0)) for v in pre.bbox_ref]
            head = enhanced[by1:max(by2, by1 + 1), bx1:max(bx2, bx1 + 1)]
            if head.size:
                pre.head_crop = (P.resize_image(head, (112, 112)).astype(np.float32)
                                 / 127.5 - 1.0)
    with stages("preprocess"):
        id_embed = identity_embedding(cfg, pre.head_crop, device)
    with stages("mel"):
        mel, audio_len = A.whisper_features(args.audio)
    limit = args.frame_limit or cfg.frame_num
    num_frames = min(limit, audio_len) // cfg.step
    if num_frames < 1:
        raise SystemExit(f"{TAG} {args.audio}: too short for one frame")

    # the models depend on neither the mode nor the inputs: one build per
    # image size and device serves every run of a batch
    key = (h, w, str(device))
    pipe = pipe_cache.get(key)
    if pipe is None:
        pipe = pipe_cache[key] = build_pipeline(cfg, args.random_weights, device)

    with stages("whisper"):
        feats = np.concatenate([
            pipe.encode_audio_windows(mel[None, :, i:i + 3000])[0].float().cpu().numpy()
            for i in range(0, mel.shape[-1], 3000)])[:audio_len * 2]
        feats = np.concatenate([np.zeros_like(feats[:4]), feats,
                                np.zeros_like(feats[:6])])
    with stages("tokens"):
        audio_tok, audio_unc = pipe.audio_tokens_per_frame(feats, num_frames,
                                                           step=cfg.step)
        # VASA tokens from the driving video (modes 1 / 2): one square crop
        # around the first frame's face -> both towers (the reference's
        # Inference.py:478-505, test_preprocess.py:314-421)
        if args.mode != 0 and args.video and pipe.m.vasa_expression is not None:
            frames = V.read_frames(args.video, limit=num_frames * cfg.step)
            fh, fw = frames.shape[1:3]
            vbox = detect_face(frames[0], detector) if detector is not None else None
            sq = P.process_bbox(list(vbox or (0, 0, fw, fh)), 1.0, fh, fw)
            x1, y1, x2, y2 = [int(max(v, 0)) for v in sq]
            x2, y2 = min(x2, fw), min(y2, fh)
            crops = np.stack([
                P.resize_image(f[y1:y2, x1:x2], (256, 256)).astype(np.float32) / 255.0
                for f in frames[::cfg.step][:num_frames]])
            expr, rot = pipe.encode_vasa_video(crops, crops)
            vasa_tok, vasa_unc = pipe.vasa_tokens(expr, rot, num_frames,
                                                  cfg.vasa_expression_dim)
        else:
            if args.mode != 0:
                print(f"{TAG} VASA weights or driving video unavailable; zero "
                      "expression tokens")
            vasa_tok, vasa_unc = pipe.vasa_tokens(None, None, num_frames,
                                                  cfg.vasa_expression_dim)
    pose_imgs = np.repeat(pre.pose_img[None], num_frames, axis=0)
    # region masks (the reference's pipeline :702-711): mode 2 all ones;
    # modes 0 / 1 gate the one active branch by the face box, which also
    # turns on the SSM blocks' gather path
    face_mask = None
    if tuple(gate) != (1, 1):
        face_mask = pre.pose_img[None, None, :, :, 0].astype(np.float32)
    masks = dict(audio_mask=face_mask if tuple(gate) == (1, 0) else None,
                 exp_mask=face_mask if tuple(gate) == (0, 1) else None)
    scfg = cfg.sampler_config(tuple(gate))
    with stages("generate_latents"):
        latents = pipe.generate_latents(
            pre.ref_img, id_embed, audio_tok, audio_unc, vasa_tok, vasa_unc,
            pose_imgs, scfg, seed=cfg.seed or 0, **masks)
    with stages("decode"):
        frames01 = np.clip(pipe.decode_latents(latents, cfg.decode_chunk_size)
                           * 0.5 + 0.5, 0, 1)
    # the frame passes align on the first frame's landmarks
    flm5 = None
    if estimator is not None and (cfg.use_teeth_enhance
                                  or cfg.extras.get("use_bfr_frames")):
        with stages("landmarks"):
            flm5 = face_landmarks(estimator, _u8(frames01[0]), pre.bbox_ref)
    decoded = frames01
    frames01 = postprocess_frames(cfg, frames01, pre.bbox_ref, landmarks=flm5,
                                  device=device, stages=stages)
    return dict(frames01=frames01, decoded=decoded, pre=pre, pipe=pipe,
                num_frames=num_frames, id_embed=id_embed,
                tokens=(audio_tok, audio_unc, vasa_tok, vasa_unc),
                pose_imgs=pose_imgs, masks=masks, latents=latents,
                landmarks=flm5, seconds=stages.seconds, stages=stages)


def write_outputs(cfg: InferenceConfig, args, run: Dict) -> str:
    """Write ``<ref>.mp4`` and ``<ref>_audio.mp4`` (the driving audio muxed)
    under ``output_dir / exp_name``; returns the latter's path. Adds the
    "write" stage to ``run["seconds"]``."""
    out_dir = os.path.join(cfg.output_dir, cfg.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.basename(args.ref)
    if getattr(args, "out_tag", None):      # batch mode: unique per item
        base = f"{base}.{args.out_tag}"
    with run["stages"]("write"):
        V.write_video(os.path.join(out_dir, f"{base}.mp4"), run["frames01"],
                      fps=cfg.fps)
        out_audio = os.path.join(out_dir, f"{base}_audio.mp4")
        V.write_video(out_audio, run["frames01"], fps=cfg.fps,
                      audio_path=args.audio)
    return out_audio


def _run_single(cfg, args, gate, pipe_cache, interactive, t0=None):
    t0 = t0 or time.time()
    run = generate_frames(cfg, args, gate, pipe_cache)
    out_audio = write_outputs(cfg, args, run)
    print(f"wrote {out_audio} ({run['num_frames']} frames) in "
          f"{time.time() - t0:.1f}s | stages (s) "
          f"{ {k: round(v, 3) for k, v in run['seconds'].items()} }")
    if not interactive:
        return
    # the re-run loop: a new YAML regenerates without reloading the models
    # (the reference's Inference.py:379-400)
    pipe, pre = run["pipe"], run["pre"]
    out_dir = os.path.dirname(out_audio)
    base = os.path.basename(args.ref)
    while True:
        try:
            path = input("\nInference completed. Enter a new YAML config to "
                         "run again (or press Enter to exit): ").strip()
        except (EOFError, OSError):
            break
        if not path:
            break
        if not os.path.exists(path):
            print(f"config {path} not found")
            continue
        new_cfg = load_config(path)
        t1 = time.time()
        latents = pipe.generate_latents(
            pre.ref_img, run["id_embed"], *run["tokens"], run["pose_imgs"],
            new_cfg.sampler_config(tuple(gate)), seed=new_cfg.seed or 0,
            **run["masks"])
        frames01 = np.clip(pipe.decode_latents(latents, new_cfg.decode_chunk_size)
                           * 0.5 + 0.5, 0, 1)
        out2 = os.path.join(out_dir, f"{base}_rerun.mp4")
        V.write_video(out2, frames01, fps=new_cfg.fps, audio_path=args.audio)
        print(f"wrote {out2} in {time.time() - t1:.1f}s")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="YAML or .py config (the reference's surface)")
    parser.add_argument("--ref", type=str, required=True,
                        help="reference image; with --batch, a comma-"
                             "separated list")
    parser.add_argument("--audio", type=str, required=True,
                        help="driving audio; with --batch, one file or a "
                             "comma-separated list matching --ref")
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--mode", type=int, default=0,
                        help="0: audio, 1: vasa, 2: both")
    parser.add_argument("--batch", action="store_true",
                        help="several refs, the loaded models reused")
    parser.add_argument("--random-weights", action="store_true")
    parser.add_argument("--frame-limit", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    gate = MODE_GATES[args.mode]
    t0 = time.time()
    if args.batch:
        refs = [r for r in args.ref.split(",") if r]
        audios = [a for a in args.audio.split(",") if a]
        if len(audios) == 1:
            audios = audios * len(refs)
        if len(audios) != len(refs):
            raise SystemExit(f"--batch: {len(audios)} audio files for "
                             f"{len(refs)} refs")
        pipes: Dict = {}
        for i, (ref, aud) in enumerate(zip(refs, audios)):
            stem = os.path.splitext(os.path.basename(aud))[0]
            run_args = argparse.Namespace(**{**vars(args), "ref": ref,
                                             "audio": aud, "batch": False,
                                             "out_tag": f"{stem}.{i}"})
            _run_single(cfg, run_args, gate, pipes, interactive=False)
        return
    _run_single(cfg, args, gate, {}, interactive=True, t0=t0)


if __name__ == "__main__":
    main()
