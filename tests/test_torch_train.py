"""PyTorch port, the training slice against the JAX package (fp32, CPU).

* ``diffusion_loss`` on raw-head batches with the micro modules: the port
  gets the four draws JAX takes from ``jax.random.split(key, 4)``; loss
  rel 1e-5, each artifact's flattened parameter gradient rel L2 1e-4
  (exported through the same exporters as the parameters).
* The optimizer alone: the same numpy gradients into optax's
  ``MultiSteps(chain(clip_by_global_norm, adamw), 2)`` and the port's, over
  two commits (one clipped, one not): parameters rel L2 1e-6 (a few ulps:
  AdamW's decay and step round in another order).
* EMA gating, checkpoints (save / rotate / latest / restore), the six
  reference ``.pth`` files against the JAX export, the config reader, and
  ``training.train.main`` end to end with a resume.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from actalker_tpu.io import weights as W
from actalker_tpu.io.init import init_pipeline_params
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu.pipeline.pipeline import PipelineModules as JModules
from actalker_tpu.training import trainer as JT
from actalker_tpu.training.train import (
    export_reference_checkpoint as j_export, synthetic_batches as j_batches)
from actalker_tpu_torch.io import checkpoint as ckpt
from actalker_tpu_torch.io import weights as TW
from actalker_tpu_torch.io.weights import to_torch
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.training import ema as E, train as TR, trainer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS = {"audio_proj": W.export_audio_proj, "id_proj": W.export_id_proj,
         "vasa_proj": W.export_vasa_proj, "pose_guider": W.export_pose_guider}


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def micro():
    """JAX micro modules with random params, and the port's five trainable
    modules loaded from them through the exporters."""
    jmods = JModules.create(unet_config=JUNetConfig(scan_impl="blocked").micro(),
                            dtype=jnp.float32)
    full = init_pipeline_params(jmods, jax.random.PRNGKey(0), image_size=(64, 64),
                                latent_size=(8, 8), use_eval_shape=True, seed=0)
    params = {k: full[k] for k in TR.TRAINABLE}
    ucfg = UNetConfig().micro()
    mods = TR.build_modules(ucfg, "cpu", torch.float32)
    TW.load_unet(mods["unet"], *TW.unet_state_dicts_from_jax(params["unet"], ucfg))
    for name, export in HEADS.items():
        mods[name].load_state_dict(to_torch(export(params[name])), strict=True)
    return jmods, params, mods, ucfg


def _port_batch(jbatch):
    """The JAX raw-head batch as the port's: its set fields (the
    pre-encoded ones are unset)."""
    assert set(jbatch._fields) == set(T.TrainBatch._fields)
    return T.TrainBatch(**{k: torch.from_numpy(np.array(getattr(jbatch, k)))
                           for k in T.TrainBatch._fields
                           if getattr(jbatch, k) is not None})


def test_diffusion_loss_and_head_gradients_match_jax(micro):
    jmods, params, mods, ucfg = micro
    cfg = T.TrainConfig(cond_dropout_prob=0.5)
    jcfg = JT.TrainConfig(cond_dropout_prob=0.5)
    jbatch = next(j_batches(2, 2, 8, 32, seed=3, raw_heads=True))
    key = jax.random.PRNGKey(5)
    applies = {k: getattr(jmods, k).apply for k in TR.TRAINABLE}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.diffusion_loss(applies, p, jbatch, key, jcfg,
                                    dtype=jnp.float32), has_aux=True))(params)
    # the same four draws, from the same keys
    b = 2
    k_sig, k_noise, k_off, k_drop = jax.random.split(key, 4)
    draws = T.LossDraws(*(torch.from_numpy(np.array(x)) for x in (
        jax.random.normal(k_sig, (b,)),
        jax.random.normal(k_noise, jbatch.latents.shape),
        jax.random.normal(k_off, (b, 1, 1, 1, 1)),
        jax.random.bernoulli(k_drop, 0.5, (b,)))))
    for m in mods.values():
        m.zero_grad(set_to_none=True)
    loss, metrics = T.diffusion_loss(mods, _port_batch(jbatch), cfg, draws=draws,
                                     dtype=torch.float32)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = {"unet": W.export_unet(jgrads["unet"], **W.unet_block_kwargs(ucfg))}
    want.update({n: f(jgrads[n]) for n, f in HEADS.items()})
    for art, sd in want.items():
        got = dict(mods[art].named_parameters())
        for k, g in sd.items():         # exporter-filled rows: never read
            if not np.any(g):
                assert got[k].grad is None or not got[k].grad.any(), (art, k)
        flat = np.concatenate([
            np.zeros(got[k].numel(), np.float32) if got[k].grad is None
            else got[k].grad.numpy().ravel() for k in sd])
        assert _rel(flat, np.concatenate([np.ravel(g) for g in sd.values()])) \
            < 1e-4, art


def test_synthetic_batches_equal_jax():
    jb = next(j_batches(1, 2, 8, 32, seed=7, raw_heads=True))
    pb = next(TR.synthetic_batches(1, 2, 8, seed=7))
    for k, v in jb._asdict().items():
        if v is None:                           # pre-encoded: not generated
            assert getattr(pb, k) is None, k
            continue
        np.testing.assert_array_equal(getattr(pb, k).numpy(), np.asarray(v),
                                      err_msg=k)


def _grad_stream(rng, shapes, n=4):
    # micro-step gradients: the first commit's mean is large (clipped), the
    # second's small (not clipped)
    return [{k: (rng.standard_normal(s) * (3.0 if i < 2 else 0.05)).astype(np.float32)
             for k, s in shapes.items()} for i in range(n)]


def test_optimizer_matches_optax_with_accumulation():
    """``unused`` stands for a weight the forward never reads: it gets no
    ``.grad`` in the port and zero gradients in optax, and both decay it."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "unused": (4,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = _grad_stream(rng, shapes)
    for g in grads:
        g["unused"] = np.zeros_like(g["unused"])
    cfg = T.TrainConfig(grad_accum_steps=2, learning_rate=1e-2, max_grad_norm=1.0)
    tx = JT.make_optimizer(JT.TrainConfig(grad_accum_steps=2, learning_rate=1e-2,
                                          max_grad_norm=1.0))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = T.Optimizer(list(tp.values()), cfg)
    commits = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():       # backward sums into .grad
            if k == "unused":
                continue
            gk = torch.from_numpy(g[k])
            p.grad = gk.clone() if p.grad is None else p.grad + gk
        committed, norm = opt.step()
        commits.append(committed)
        for k in tp:
            assert _rel(tp[k], jp[k]) < 1e-6, k
    assert commits == [False, True, False, True]
    assert not any(p.grad is not None for p in tp.values())
    assert not torch.equal(tp["unused"].detach(), torch.from_numpy(p0["unused"]))


def test_ema_moves_only_on_commit():
    mods = {"m": torch.nn.Linear(3, 2)}
    ema = E.ema_init(mods)
    before = {k: v.clone() for k, v in ema["m"].items()}
    with torch.no_grad():
        mods["m"].weight.add_(1.0)
    E.ema_step(ema, mods, committed=False, decay=0.9)
    for k in before:
        torch.testing.assert_close(ema["m"][k], before[k], rtol=0, atol=0)
    E.ema_step(ema, mods, committed=True, decay=0.9)
    w = mods["m"].weight.detach()
    torch.testing.assert_close(ema["m"]["weight"], before["weight"] * 0.9 + w * 0.1)


def test_checkpoint_save_rotate_latest_restore(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_checkpoint(d) is None
    for step in range(1, 6):
        ckpt.save_checkpoint(d, step, {"params": {"m": {"w": torch.full((2,), float(step))}}},
                             total_limit=3)
    assert ckpt.list_checkpoints(d) == [3, 4, 5]
    assert ckpt.latest_checkpoint(d) == 5
    assert ckpt.restore_checkpoint(d)["params"]["m"]["w"].tolist() == [5.0, 5.0]
    assert ckpt.restore_checkpoint(d, 4)["params"]["m"]["w"].tolist() == [4.0, 4.0]
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"))


def test_reference_export_equals_jax_export(micro, tmp_path):
    """The six .pth files from the port's modules equal the JAX driver's
    export of the same parameters, key for key and value for value."""
    _, params, mods, ucfg = micro
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    j_export(host, str(tmp_path / "jax"), 7, ucfg=JUNetConfig().micro())
    paths = TW.export_reference_checkpoint(mods, str(tmp_path / "port"), 7)
    assert len(paths) == 6
    for path in paths:
        name = os.path.basename(path)
        want = torch.load(str(tmp_path / "jax" / name), weights_only=True)
        got = torch.load(path, weights_only=True)
        assert set(got) == set(want), name
        for k in want:
            assert got[k].dtype == torch.float32
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_read_config_equals_yaml():
    yaml = pytest.importorskip("yaml")
    path = os.path.join(ROOT, "configs", "train.yaml")
    with open(path) as f:
        assert TR.read_config(path) == yaml.safe_load(f)


def test_train_main_cpu_end_to_end_and_resume(tmp_path):
    out, ref = str(tmp_path / "run"), str(tmp_path / "ref")
    cfg = os.path.join(ROOT, "configs", "train.yaml")
    seen = []
    res = TR.main(["--config", cfg, "--micro-model", "--synthetic", "3",
                   "--steps", "3", "--device", "cpu", "--output", out,
                   "--export-reference", ref],
                  observe=lambda trainer, rec: seen.append(rec))
    assert seen[0] is None and len(seen) == 4
    assert res["final_step"] == 3 and ckpt.list_checkpoints(out) == [3]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [__import__("json").loads(x) for x in f]
    assert [x["step"] for x in lines] == [0, 1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines)
    assert sorted(os.listdir(ref)) == sorted(
        f"{n}-3.pth" for n in TW.REFERENCE_ARTIFACTS)
    # resume: starts from checkpoint-3 with its parameters
    saved = ckpt.restore_checkpoint(out)["params"]["unet"]
    res2 = TR.main(["--config", cfg, "--micro-model", "--synthetic", "2",
                    "--steps", "5", "--device", "cpu", "--output", out],
                   observe=lambda trainer, rec: rec is None and [
                       torch.testing.assert_close(
                           trainer.modules["unet"].state_dict()[k], v)
                       for k, v in saved.items()])
    assert res2["start_step"] == 3 and res2["final_step"] == 5
    assert ckpt.list_checkpoints(out) == [3, 5]


def test_train_main_starts_from_reference_files(micro, tmp_path):
    """A config whose ``checkpoints:`` section names the six exported files
    starts training from exactly those parameters."""
    _, _, mods, _ = micro
    ref = str(tmp_path / "ref")
    TW.export_reference_checkpoint(mods, ref, 1)
    keys = {"unet": "unet", "adapter_module": "adapter_module",
            "pose_guider": "pose_guider", "audio_linear": "audio_linear",
            "id_proj": "id_proj_model", "vasa_linear": "vasa_linear"}
    cfg = tmp_path / "train.yaml"
    cfg.write_text("solver:\n  gradient_accumulation_steps: 2\ncheckpoints:\n" + "".join(
        f"  {k}_checkpoint_path: '{ref}/{stem}-1.pth'\n" for k, stem in keys.items()))

    def same_as_exported(trainer, rec):
        if rec is None:
            for name, m in trainer.modules.items():
                for k, v in m.state_dict().items():
                    torch.testing.assert_close(v, mods[name].state_dict()[k],
                                               rtol=0, atol=0)

    res = TR.main(["--config", str(cfg), "--micro-model", "--synthetic", "1",
                   "--device", "cpu", "--output", str(tmp_path / "run")],
                  observe=same_as_exported)
    assert res["final_step"] == 1


def test_train_main_refuses_metadata_and_defaults_to_cuda():
    with pytest.raises(FileNotFoundError, match="clips.json"):
        TR.main(["--metadata", "clips.json", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            TR.main(["--micro-model", "--synthetic", "1"])
