"""PyTorch port, checkpoint loading (CPU): seeded reference-keyed files
written to a temporary directory — the six ``.pth`` artifacts, the SVD-XT
VAE's ``.safetensors``, whisper's ``pytorch_model.bin`` and the VASA MX31c
checkpoint — loaded through ``io/init.py::load_checkpoints`` with
``strict=True`` into fresh modules, which must then hold the files'
values exactly; the port's safetensors reader against the ``safetensors``
package's ``numpy.load_file`` (F16, BF16, F32), exactly; and the CLI's rule
that a UNet checkpoint without its VAE or audio encoder is refused.
"""
import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from actalker_tpu_torch.config import InferenceConfig
from actalker_tpu_torch.io import init as I
from actalker_tpu_torch.io import weights as W
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.models.vae import VAEConfig
from actalker_tpu_torch.pipeline.pipeline import PipelineModules
from actalker_tpu_torch.training import train
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)

MICRO = dict(unet_config=UNetConfig().micro(), vae_config=VAEConfig().tiny(),
             dtype=torch.float32)


def _modules(seed):
    with torch.device("meta"):
        mods = PipelineModules.create(**MICRO)
    for i, m in enumerate(mods.named().values()):
        I.random_init_(m, seed=seed + i, device="cpu")
    return mods


def _write_all(tmp_path, mods, vae=True, whisper=True, vasa=True):
    """The reference's files for ``mods`` under ``tmp_path``; returns the
    config naming them."""
    named = mods.named()
    paths = {}
    for stem, sd in W.reference_state_dicts(named).items():
        paths[stem] = str(tmp_path / f"{stem}-7.pth")
        torch.save(sd, paths[stem])
    root = tmp_path / "svd"
    if vae:
        os.makedirs(root / "vae")
        save_file({k: v.half().numpy() for k, v in named["vae"].state_dict().items()},
                  str(I.vae_path(InferenceConfig(pretrained_model_name_or_path=str(root)))))
    wdir = tmp_path / "whisper"
    if whisper:
        os.makedirs(wdir)
        sd = {f"encoder.{k}": v for k, v in named["whisper"].state_dict().items()}
        sd["decoder.embed_tokens.weight"] = torch.zeros(4, 4)
        torch.save(sd, str(wdir / "pytorch_model.bin"))
    vasa_path = ""
    if vasa:
        vasa_path = str(tmp_path / "MX31c.ckpt")
        torch.save({"generator": {**{f"expression_model.{k}": v for k, v in
                                     named["vasa_expression"].state_dict().items()},
                                  "motion_model.weight": torch.zeros(2)},
                    "pose_model": named["vasa_pose"].state_dict(),
                    "step": 31000}, vasa_path)
    return InferenceConfig(
        pretrained_model_name_or_path=str(root),
        unet_checkpoint_path=paths["unet"],
        adapter_module_checkpoint_path=paths["adapter_module"],
        pose_guider_checkpoint_path=paths["pose_guider"],
        audio_linear_checkpoint_path=paths["audio_linear"],
        id_proj_checkpoint_path=paths["id_proj_model"],
        vasa_linear_checkpoint_path=paths["vasa_linear"],
        vasa_checkpoint_path=vasa_path, whisper_model=str(wdir),
        extras={"micro_model": True})


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    src = _modules(seed=10)
    return src, _write_all(tmp_path_factory.mktemp("ck"), src)


def test_load_checkpoints_loads_every_file_strictly(written):
    src, cfg = written
    dst = _modules(seed=50)
    loaded = I.load_checkpoints(cfg, dst.named())
    assert loaded == {"unet", "pose_guider", "audio_proj", "id_proj", "vasa_proj",
                      "vae", "whisper", "vasa_expression", "vasa_pose"}
    for name, m in dst.named().items():
        want = src.named()[name].state_dict()
        for k, v in m.state_dict().items():
            ref = want[k].half().float() if name == "vae" else want[k]
            torch.testing.assert_close(v, ref, rtol=0, atol=0, msg=f"{name}.{k}")


def test_adapter_rows_come_from_their_own_file(written, tmp_path):
    """The IP adapter rows load from ``adapter_module-*.pth`` after the
    UNet file: a file with other rows wins over the UNet's copy."""
    src, cfg = written
    rows = {k: torch.full_like(v, 0.5) for k, v in
            W.adapter_state_dict(src.unet).items()}
    path = str(tmp_path / "adapter_module-9.pth")
    torch.save(rows, path)
    dst = _modules(seed=60)
    I.load_checkpoints(dataclasses.replace(cfg, adapter_module_checkpoint_path=path),
                       dst.named())
    for k, v in W.adapter_state_dict(dst.unet).items():
        assert (v == 0.5).all(), k


def test_no_unet_checkpoint_loads_nothing(written):
    _, cfg = written
    dst = _modules(seed=70)
    before = {k: v.clone() for k, v in dst.vae.state_dict().items()}
    assert I.load_checkpoints(dataclasses.replace(cfg, unet_checkpoint_path=""),
                              dst.named()) is None
    for k, v in dst.vae.state_dict().items():
        assert torch.equal(v, before[k])


def test_trainer_shares_the_loader(written):
    """The trainer's ``checkpoints:`` section goes through the same
    ``load_reference_checkpoints``."""
    src, cfg = written
    assert train.load_reference_checkpoints is I.load_reference_checkpoints
    mods = train.build_modules(UNetConfig().micro(), "cpu", torch.float32, seed=5)
    ck = {k: getattr(cfg, k) for k in ("unet_checkpoint_path", "pose_guider_checkpoint_path",
                                        "audio_linear_checkpoint_path",
                                        "id_proj_checkpoint_path",
                                        "vasa_linear_checkpoint_path")}
    assert train.load_reference_checkpoints(mods, ck) == [
        "unet", "pose_guider", "audio_proj", "id_proj", "vasa_proj"]
    for k, v in mods["pose_guider"].state_dict().items():
        assert torch.equal(v, src.pose_guider.state_dict()[k])


@pytest.mark.parametrize("dtype", ["F16", "BF16", "F32"])
def test_safetensors_reader_equals_the_package(tmp_path, dtype):
    np_dtype = {"F16": np.float16, "BF16": ml_dtypes.bfloat16, "F32": np.float32}[dtype]
    rng = np.random.default_rng(0)
    arrays = {"a.weight": rng.standard_normal((3, 5)).astype(np_dtype),
              "b": rng.standard_normal((7,)).astype(np_dtype),
              "scalar": np.asarray(1.5, np_dtype),
              "empty": np.zeros((0, 4), np_dtype),
              "c.d.e": rng.standard_normal((2, 3, 4)).astype(np_dtype)}
    path = str(tmp_path / "t.safetensors")
    save_file(arrays, path, metadata={"format": "pt"})
    want = load_file(path)
    got = I.read_safetensors(path)
    assert sorted(got) == sorted(want)
    torch_dtype = {"F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32}[dtype]
    for k, v in want.items():
        assert got[k].dtype == torch_dtype and tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].float().numpy(), v.astype(np.float32))


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "i.safetensors")
    save_file({"i": np.arange(4, dtype=np.int64)}, path)
    with pytest.raises(ValueError, match="I64"):
        I.read_safetensors(path)


def test_whisper_keys_of_either_model(written):
    sd = {"model.encoder.conv1.weight": 1, "encoder.layer_norm.bias": 2,
          "model.decoder.x": 3, "proj_out.weight": 4}
    assert I.whisper_state_dict(sd) == {"conv1.weight": 1, "layer_norm.bias": 2}


# ------------------------------------------------------ the CLI's refusal

@pytest.mark.parametrize("drop", ["vae", "whisper"])
def test_unet_checkpoint_without_a_frozen_encoder_exits(tmp_path, drop, capsys):
    from actalker_tpu_torch import cli

    src = _modules(seed=80)
    cfg = _write_all(tmp_path, src, vae=drop != "vae", whisper=drop != "whisper")
    with pytest.raises(SystemExit, match=f"required frozen encoders are missing: "
                                         f"\\['{drop}'\\]"):
        cli.build_pipeline(cfg, random_weights=False, device=torch.device("cpu"))
    cfg.extras["allow_random_encoders"] = True
    pipe = cli.build_pipeline(cfg, random_weights=False, device=torch.device("cpu"))
    assert f"missing checkpoints ['{drop}']" in capsys.readouterr().out
    assert pipe.m.vasa_expression is not None


def test_loaded_run_without_vasa_drops_the_towers(tmp_path):
    """A loaded UNet whose config names no VASA checkpoint: the random
    towers are dropped, so modes 1 / 2 take zero expression tokens."""
    from actalker_tpu_torch import cli

    src = _modules(seed=90)
    cfg = _write_all(tmp_path, src, vasa=False)
    pipe = cli.build_pipeline(cfg, random_weights=False, device=torch.device("cpu"))
    assert pipe.m.vasa_expression is None and pipe.m.vasa_pose is None
    for k, v in pipe.m.unet.state_dict().items():
        assert torch.equal(v, src.unet.state_dict()[k]), k


def test_identity_embedding_loads_arcface_or_gives_zeros(tmp_path, capsys):
    """The CLI's ArcFace step: the file at ``arcface_checkpoint_path``
    (insightface's keys, its BatchNorm counters included) loaded with
    ``strict=True``; zeros, said on stdout, where it is absent."""
    from actalker_tpu_torch import cli
    from actalker_tpu_torch.models.arcface import iresnet50

    net = iresnet50()
    I.random_init_(net, seed=3, device="cpu")
    with torch.no_grad():
        for name, buf in net.named_buffers():
            buf.copy_(torch.rand_like(buf) + 0.5 if name.endswith("var")
                      else torch.randn_like(buf) * 0.1)
    sd = dict(net.state_dict())
    sd["bn1.num_batches_tracked"] = torch.tensor(100)
    path = str(tmp_path / "arcface_r50.pth")
    torch.save(sd, path)
    crop = np.random.default_rng(0).uniform(-1, 1, (112, 112, 3)).astype(np.float32)
    cpu = torch.device("cpu")
    got = cli.identity_embedding(InferenceConfig(arcface_checkpoint_path=path), crop, cpu)
    with torch.no_grad():
        want = net.eval()(torch.from_numpy(crop)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    zero = cli.identity_embedding(InferenceConfig(arcface_checkpoint_path=""), crop, cpu)
    assert zero.shape == (512,) and not zero.any()
    assert "zero embedding" in capsys.readouterr().out
