"""PyTorch port: the single-process training commit against the JAX
package's ``make_train_step`` (``optax.MultiSteps(chain(clip_by_global_norm,
adamw), 2)``) on shared parameters and draws, fp32 on the CPU; the
sharded commit is held against this single-process one in
``test_torch_parallel.py``, so this closes the loop to the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from actalker_tpu.io import weights as W
from actalker_tpu.io.init import init_pipeline_params
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu.pipeline.pipeline import PipelineModules as JModules
from actalker_tpu.training import trainer as JT
from actalker_tpu.training.train import synthetic_batches as j_batches
from actalker_tpu_torch.io import weights as TW
from actalker_tpu_torch.io.weights import to_torch
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.training import train as TR
from actalker_tpu_torch.training import trainer as T
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)


def test_single_process_commit_matches_jax_make_train_step():
    """Two micro-steps (k = 2) of the port's ``Trainer`` on the JAX micro
    modules' parameters and the draws JAX takes from each step's key,
    against ``make_train_step`` with ``MultiSteps``: losses rel 1e-5 and
    each artifact's update rel L2 1e-4, the gradient tolerance of
    ``test_torch_train.py``. The optimizer is set so that the update is
    proportional to the mean gradient and far above the fp32 spacing of
    the parameters: learning rate 1e3, no decay, adam_eps 1 (AdamW's first
    update is otherwise near sign(g), and a 1e-3 step of a 0.02 weight
    keeps only a few bits of it)."""
    jmods = JModules.create(unet_config=JUNetConfig(scan_impl="blocked").micro(),
                            dtype=jnp.float32)
    full = init_pipeline_params(jmods, jax.random.PRNGKey(0), image_size=(64, 64),
                                latent_size=(8, 8), use_eval_shape=True, seed=0)
    params = {k: full[k] for k in TR.TRAINABLE}
    ucfg = UNetConfig().micro()
    mods = TR.build_modules(ucfg, "cpu", torch.float32)
    TW.load_unet(mods["unet"], *TW.unet_state_dicts_from_jax(params["unet"], ucfg))
    heads = {"audio_proj": W.export_audio_proj, "id_proj": W.export_id_proj,
             "vasa_proj": W.export_vasa_proj, "pose_guider": W.export_pose_guider}
    for name, export in heads.items():
        mods[name].load_state_dict(to_torch(export(params[name])), strict=True)
    kw = dict(grad_accum_steps=2, learning_rate=1e3, weight_decay=0.0,
              adam_eps=1.0, max_grad_norm=1e6, cond_dropout_prob=0.5)
    jcfg = JT.TrainConfig(**kw)
    step = jax.jit(JT.make_train_step({k: getattr(jmods, k).apply for k in TR.TRAINABLE},
                                      JT.make_optimizer(jcfg), jcfg, dtype=jnp.float32))
    trainer = T.Trainer(mods, T.TrainConfig(**kw), torch.float32)
    before = {n: W.export_unet(params[n], **W.unet_block_kwargs(ucfg)) if n == "unet"
              else heads[n](params[n]) for n in TR.TRAINABLE}
    jp, state = params, JT.make_optimizer(jcfg).init(params)
    batches = j_batches(2, 2, 8, 32, seed=4, raw_heads=True)
    for s in range(2):
        jb = next(batches)
        key = jax.random.PRNGKey(10 + s)
        jp, state, jm = step(jp, state, jb, key)
        k_sig, k_noise, k_off, k_drop = jax.random.split(key, 4)
        draws = T.LossDraws(*(torch.from_numpy(np.array(x)) for x in (
            jax.random.normal(k_sig, (2,)), jax.random.normal(k_noise, jb.latents.shape),
            jax.random.normal(k_off, (2, 1, 1, 1, 1)),
            jax.random.bernoulli(k_drop, 0.5, (2,)))))
        pb = T.TrainBatch(**{k: torch.from_numpy(np.array(getattr(jb, k)))
                             for k in T.TrainBatch._fields})
        m = trainer.step(pb, draws=draws)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert m["commit"] == (s == 1)
    for n in TR.TRAINABLE:
        after = (W.export_unet(jp[n], **W.unet_block_kwargs(ucfg)) if n == "unet"
                 else heads[n](jp[n]))
        got = mods[n].state_dict()
        du = np.concatenate([got[k].numpy().ravel() - np.ravel(before[n][k])
                             for k in after])
        dj = np.concatenate([np.ravel(after[k]) - np.ravel(before[n][k]) for k in after])
        assert np.linalg.norm(du - dj) <= 1e-4 * np.linalg.norm(dj), n
