"""The port's spans and counters (``utils/observability``) on the CPU: off by
default (the shared no-op, no ``record_function``, an empty store after a
micro UNet forward and a ``Trainer.step``); on under ``tracing()`` and under
a running ``torch.profiler`` (nesting, parents and self time, host and
tensor counters, ``user_annotation`` events in the chrome trace, a bounded
store); the spans of a micro UNet forward and of a training step; the SSM
gather's counters against a hand count; the five benchmark readers of the
spans; ``tools/profile_step.py``'s attribution of kernels to spans. No JAX:
the port's own behaviour is what is checked."""
from __future__ import annotations

import dataclasses
import json
import threading
import time

import pytest
import torch

from actalker_tpu_torch.io.init import random_init_
from actalker_tpu_torch.models import attention_blocks as AB
from actalker_tpu_torch.models import common, resnet, ssm
from actalker_tpu_torch.models.conditioning import Conditioning
from actalker_tpu_torch.models.transformer_st import TransformerSpatioTemporal
from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition
from actalker_tpu_torch.tools import profile_step
from actalker_tpu_torch.training import train as TR
from actalker_tpu_torch.training import trainer as T
from actalker_tpu_torch.utils import observability as O
from portbench import harness
from portbench.metrics import (commit_ms_train, k1_fill_infer, norm_ms_infer,
                               sampler_self_ms_infer, ssm_block_ms_infer)
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def empty_store():
    O.reset()
    yield
    O.reset()


def records():
    """(id, parent, name) of the stored spans, in the order they ended."""
    return [(s.id, s.parent, s.name) for s in O._store.spans]


@pytest.fixture(scope="module")
def micro_unet():
    with torch.device("meta"):
        unet = UNetSpatioTemporalCondition(UNetConfig().micro(), dtype=torch.float32)
    unet = random_init_(unet, seed=0, device="cpu").eval()
    b, f, hw = 1, 2, 8
    g = torch.Generator().manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    ones = torch.ones(1, 1, hw * 8, hw * 8)
    cond = Conditioning(rn(b * f, 1, 1024), rn(b * f, 32, 1024), rn(b * f, 1, 1024),
                        ones, ones)
    args = (rn(b, f, hw, hw, 8), torch.tensor(0.5), cond, rn(b, 3),
            rn(b, f, hw, hw, 32) * 0.1)
    return unet, args


@pytest.fixture(scope="module")
def micro_trainer():
    ucfg = dataclasses.replace(UNetConfig().micro(), gradient_checkpointing=True)
    mods = TR.build_modules(ucfg, "cpu", torch.float32)
    trainer = T.Trainer(mods, T.TrainConfig(grad_accum_steps=1), torch.float32)
    return trainer, TR.synthetic_batches(1, 2, 8, seed=3)


def calls_by_class(module, classes):
    """Forward hooks counting each class's calls: {class name: [n]}."""
    seen = {c.__name__: [0] for c in classes}
    hooks = []
    for m in module.modules():
        for c in classes:
            if isinstance(m, c):
                hooks.append(m.register_forward_hook(
                    lambda *a, n=seen[c.__name__]: n.__setitem__(0, n[0] + 1)))
    return seen, hooks


# ------------------------------------------------------------------ off

def test_off_records_nothing_and_opens_no_range(micro_unet, micro_trainer, monkeypatch):
    ranges = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: ranges.append(name) or real(name))
    assert not O.enabled()
    assert O.span("unet.norm") is O.span("trainer.commit") is O._OFF
    unet, args = micro_unet
    with torch.no_grad():
        unet(*args)
    trainer, batches = micro_trainer
    trainer.step(next(batches), generator=torch.Generator().manual_seed(0))
    O.count("sampler.window_steps", 3)
    O.count("ssm.k1_active", torch.ones(4, dtype=torch.bool))
    assert ranges == []
    assert O.span_table() == {"spans": {}, "counters": {}, "dropped": 0}


# ------------------------------------------------------------------- on

def test_nesting_parents_and_self_time():
    with O.tracing():
        assert O.enabled()
        with O.span("a"):
            time.sleep(0.02)
            with O.span("b"):
                time.sleep(0.03)
            with O.span("b"):
                with O.span("c"):
                    time.sleep(0.01)
    assert not O.enabled()
    recs = records()
    ids = {name: i for i, _, name in recs}      # the last of each name
    assert [n for _, _, n in recs] == ["b", "c", "b", "a"]
    assert [p for _, p, _ in recs] == [ids["a"], recs[2][0], ids["a"], None]
    t = O.span_table()["spans"]
    assert (t["a"]["n"], t["b"]["n"], t["c"]["n"]) == (1, 2, 1)
    for row in t.values():           # no card: device ms are host ms
        assert row["device_ms"] == pytest.approx(row["host_ms"])
    assert t["a"]["device_ms"] >= 60.0 and t["b"]["device_ms"] >= 40.0
    assert t["a"]["self_device_ms"] == pytest.approx(
        t["a"]["device_ms"] - t["b"]["device_ms"])
    assert t["b"]["self_device_ms"] == pytest.approx(
        t["b"]["device_ms"] - t["c"]["device_ms"])
    assert t["c"]["self_device_ms"] == pytest.approx(t["c"]["device_ms"])


def test_a_span_on_another_thread_has_no_parent():
    """Autograd's device thread in a CUDA backward opens its spans so: the
    stack of open spans is the thread's own."""
    with O.tracing():
        with O.span("outer"):
            th = threading.Thread(target=lambda: O.span("elsewhere").__enter__()
                                  .__exit__(None, None, None))
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
    parents = {n: p for _, p, n in records()}
    assert parents == {"elsewhere": None, "outer": None}


def test_threads_lose_no_update():
    """Spans and counts from more threads than cores, the interpreter
    switching threads often: every span is stored under its own thread's
    parent and no count is lost."""
    import os
    import sys

    workers, rounds = 2 * (os.cpu_count() or 4), 300
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with O.span("outer"):
                    with O.span("inner"):
                        O.count("host", 1)
                        O.count("tensor", torch.tensor(2))
        with O.tracing():
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(saved)
    t = O.span_table()
    n = workers * rounds
    assert t["counters"] == {"host": n, "tensor": 2 * n}
    assert t["spans"]["outer"]["n"] == t["spans"]["inner"]["n"] == n
    names = {i: name for i, _, name in records()}
    assert all(names[p] == "outer" for _, p, name in records() if name == "inner")
    assert all(p is None for _, p, name in records() if name == "outer")


def test_counters_host_and_tensor():
    with O.tracing():
        O.count("host", 3)
        O.count("host", 4)
        O.count("tensor", torch.tensor([True, False, True]))
        O.count("tensor", torch.tensor(5))
        O.count("both", 2)
        O.count("both", torch.ones(3, 2))
    assert O.span_table()["counters"] == {"host": 7, "tensor": 7, "both": 8}
    O.reset()
    assert O.span_table()["counters"] == {}


def test_store_is_bounded(monkeypatch):
    monkeypatch.setattr(O, "STORE_CAPACITY", 3)
    with O.tracing():
        for _ in range(5):
            with O.span("x"):
                pass
    t = O.span_table()
    assert t["spans"]["x"]["n"] == 3 and t["dropped"] == 2


def test_a_running_profiler_turns_spans_on(tmp_path):
    assert O.span("a") is O._OFF
    with O.device_trace(str(tmp_path), device="cpu") as prof:
        assert O.enabled()
        with O.span("sampler.step"):
            with O.span("unet.norm"):
                torch.ones(16, 16).sum()
        O.count("sampler.window_steps", 2)
    assert O.span("a") is O._OFF
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    assert {"sampler.step", "unet.norm"} <= {e["name"] for e in ann}
    outer = next(e for e in ann if e["name"] == "sampler.step")
    inner = next(e for e in ann if e["name"] == "unet.norm")
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    t = O.span_table()
    assert t["spans"]["unet.norm"]["n"] == 1
    assert t["counters"] == {"sampler.window_steps": 2}


# ------------------------------------------------------ the model's spans

def test_micro_unet_forward_spans(micro_unet):
    unet, args = micro_unet
    classes = (common.GroupNorm32, common.LayerNormF32, resnet.SpatioTemporalResBlock,
               TransformerSpatioTemporal, AB.Attention, AB.FeedForward,
               ssm.SS2DCondV10)
    seen, hooks = calls_by_class(unet, classes)
    try:
        with O.tracing(), torch.no_grad():
            unet(*args)
    finally:
        for h in hooks:
            h.remove()
    t = O.span_table()["spans"]
    n = {k: v[0] for k, v in seen.items()}
    control = sum(len(m.mamba_blocks) for m in unet.modules()
                  if isinstance(m, TransformerSpatioTemporal) and m.mamba_blocks is not None)
    assert control == n["SS2DCondV10"] > 0
    assert t["unet.forward"]["n"] == 1
    assert t["unet.ssm"]["n"] == control
    assert t["unet.norm"]["n"] == n["GroupNorm32"] + n["LayerNormF32"] > 0
    assert t["unet.resnet"]["n"] == n["SpatioTemporalResBlock"]
    assert t["unet.transformer"]["n"] == n["TransformerSpatioTemporal"]
    assert t["unet.attention"]["n"] == n["Attention"]
    assert t["unet.ff"]["n"] == n["FeedForward"]
    names = {i: name for i, _, name in records()}
    parents = [(name, names.get(p)) for _, p, name in records()]
    assert all(p == "unet.transformer" for name, p in parents if name == "unet.ssm")
    # each control block's out-norm is a norm span inside it
    assert sum(p == "unet.ssm" for name, p in parents if name == "unet.norm") == control
    # a leaf: nothing opens inside a norm
    assert all(p != "unet.norm" for _, p in parents)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_norm_counters_and_the_span_table(micro_unet, impl):
    """Every norm call counts ``norm.kernel`` (it launched K7) or
    ``norm.plain`` (it ran the plain code): on the CPU all are plain, under
    either lowering, one a ``unet.norm`` span; ``profile_step``'s span
    table prints the counters."""
    unet, args = micro_unet
    seen, hooks = calls_by_class(unet, (common.GroupNorm32, common.LayerNormF32))
    saved = common.norm_impl()
    common.set_norm_impl(impl)
    try:
        with O.tracing(), torch.no_grad():
            unet(*args)
    finally:
        common.set_norm_impl(saved)
        for h in hooks:
            h.remove()
    table = O.span_table()
    norms_called = seen["GroupNorm32"][0] + seen["LayerNormF32"][0]
    assert norms_called == table["spans"]["unet.norm"]["n"] > 0
    assert "norm.kernel" not in table["counters"]
    assert table["counters"]["norm.plain"] == norms_called
    lines = profile_step.span_lines(table, {})
    assert any(line.split()[:3] == ["counter", "norm.plain", str(norms_called)]
               for line in lines)
    assert any(line.split()[:2] == ["unet.norm", str(norms_called)] for line in lines)


def test_a_micro_step_runs_the_norms_the_chip_smoke_derives(micro_trainer):
    """``chip_smoke.step_norm_launches`` (a micro-step's K7 launches and
    plain norm calls on the card) counts each norm of the UNet's
    checkpointed blocks twice, its others and the heads' once: on the CPU
    every one of those calls is plain, so their sum is the micro-step's
    ``norm.plain``. The heads' one plain call on the card is vasa_proj's
    (1018 channels, not a multiple of 8)."""
    import chip_smoke

    trainer, batches = micro_trainer
    mods = trainer.modules
    want = chip_smoke.step_norm_launches(mods["unet"],
                                         [mods[h] for h in chip_smoke.HEADS])
    with O.tracing():
        trainer.step(next(batches), generator=torch.Generator().manual_seed(0))
    assert O.span_table()["counters"]["norm.plain"] == sum(want.values())
    assert want[chip_smoke.PLAIN] == 1 and want["gn_silu_conv3x3"] == 0
    blocks = chip_smoke.norm_launches(*mods["unet"].down_blocks, mods["unet"].mid_block,
                                      *mods["unet"].up_blocks)
    once = chip_smoke.norm_launches(mods["unet"], *(mods[h] for h in chip_smoke.HEADS))
    assert blocks["layer_norm"] > 0 and want == {
        n: blocks[n] + once[n] for n in chip_smoke.NORM_ENTRIES}


def test_trainer_step_spans(micro_trainer):
    trainer, batches = micro_trainer
    with O.tracing():
        trainer.step(next(batches), generator=torch.Generator().manual_seed(0))
    t = O.span_table()["spans"]
    for name in ("trainer.micro_step", "trainer.forward", "trainer.backward",
                 "trainer.optimizer", "trainer.commit"):
        assert t[name]["n"] == 1, name
    by_id = {i: (p, name) for i, p, name in records()}

    def chain(i):
        out = []
        while i is not None:
            p, name = by_id[i]
            out.append(name)
            i = p
        return out

    ends = {}
    for i, (p, name) in by_id.items():
        ends.setdefault(name, []).append(chain(i))
    assert ends["trainer.commit"] == [["trainer.commit", "trainer.optimizer",
                                       "trainer.micro_step"]]
    # block checkpointing recomputes the UNet blocks in the backward: on
    # the CPU autograd runs it on the calling thread, so the recomputed
    # spans sit under trainer.backward (on a card they have no parent)
    resnets = ends["unet.resnet"]
    fwd = [c for c in resnets if "trainer.forward" in c]
    bwd = [c for c in resnets if "trainer.backward" in c]
    assert len(fwd) == len(bwd) > 0 and len(fwd) + len(bwd) == len(resnets)
    assert t["unet.forward"]["n"] == 1


def test_sharded_commit_is_spanned():
    import torch.distributed as dist
    from tests.torch_dist_workers import free_port

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        lin = torch.nn.Linear(8, 8)
        opt = T.ShardedOptimizer(list(lin.parameters()), T.TrainConfig(grad_accum_steps=2))
        with O.tracing():
            for _ in range(2):
                lin(torch.randn(4, 8)).square().mean().backward()
                opt.step()
    finally:
        dist.destroy_process_group()
    assert O.span_table()["spans"]["trainer.commit"]["n"] == 1


@pytest.mark.parametrize("frac", [0.25, None])
def test_gather_counters_against_a_hand_count(frac):
    """One SS2D block with the expression branch's gate off (capacity 0) on
    an 8 x 8 token grid; the audio mask, at the grid's own size (so its
    resize is the identity), selects a 3 x 4 box: 12 tokens. Masked-dense
    (``frac`` None, no expression mask) scans every row of both branches."""
    b, side, d, sa = 2, 8, 32, 5
    l = side * side
    with torch.device("meta"):
        blk = ssm.SS2DCondV10(d, d_cond=16, d_state=4,
                              capacity_frac=None if frac is None else (frac, 0.0))
    blk = random_init_(blk, seed=0, device="cpu")
    g = torch.Generator().manual_seed(2)
    mask = torch.zeros(1, 1, side, side)
    mask[..., 2:5, 1:5] = 1.0
    args = (torch.randn(b, l, d, generator=g), torch.randn(b, 1, 16, generator=g),
            torch.randn(b, sa, 16, generator=g), torch.randn(b, 1, 16, generator=g),
            mask, mask if frac is not None else None)
    with O.tracing(), torch.no_grad():
        blk(*args)
    c = O.span_table()["counters"]
    tails = (1 + sa, 1 + 1)
    if frac is not None:
        caps = (16, 0)              # ceil(0.25 * 64) = 16, a multiple of 8; gate off
        active = (12 + tails[0] + tails[1]) * b
    else:
        caps = (l, l)               # every token; no expression mask: all on
        active = (12 + tails[0] + l + tails[1]) * b
    lt = max(k + t for k, t in zip(caps, tails))
    selected = (12 + (0 if frac is not None else l)) * b
    # and the block's out-norm, the plain code on the CPU
    assert c == {"ssm.k1_slots": lt * b * 2, "ssm.k1_active": active,
                 "ssm.gather_slots": sum(caps) * b, "ssm.gather_selected": selected,
                 "norm.plain": 1}
    if frac is not None:
        assert 100.0 * active / (lt * b * 2) == pytest.approx(100.0 * 40 / 88)


# ------------------------------------------------------------- the readers

def fill_store(window_steps: int, commits: int):
    with O.tracing():
        for _ in range(window_steps):
            with O.span("sampler.step"):
                time.sleep(0.002)
                with O.span("sampler.window"):
                    O.count("sampler.window_steps", 1)
                    time.sleep(0.003)
                    with O.span("unet.forward"):
                        with O.span("unet.ssm"):
                            O.count("ssm.k1_slots", 10)
                            O.count("ssm.k1_active", torch.tensor([True] * 4 + [False] * 6))
                            with O.span("unet.norm"):
                                time.sleep(0.001)
        for _ in range(commits):
            with O.span("trainer.commit"):
                time.sleep(0.001)


READERS = {"norm_ms.infer": norm_ms_infer, "ssm_block_ms.infer": ssm_block_ms_infer,
           "k1_fill.infer": k1_fill_infer, "sampler_self_ms.infer": sampler_self_ms_infer,
           "commit_ms.train": commit_ms_train}


def readings(units: int, commits: int = 0):
    r = harness.Readings()
    r.traced_units, r.commits = units, commits
    return r


def test_span_readers_on_a_filled_store():
    fill_store(3, 2)
    t = O.span_table()["spans"]
    r = readings(3, 2)
    assert norm_ms_infer.read(r) == pytest.approx(t["unet.norm"]["device_ms"] / 3)
    assert ssm_block_ms_infer.read(r) == pytest.approx(t["unet.ssm"]["device_ms"] / 3)
    assert k1_fill_infer.read(r) == pytest.approx(40.0)
    assert sampler_self_ms_infer.read(r) == pytest.approx(
        (t["sampler.window"]["self_device_ms"] + t["sampler.step"]["self_device_ms"]) / 3)
    assert sampler_self_ms_infer.read(r) >= 5.0      # the sleeps outside the UNet
    assert commit_ms_train.read(r) == pytest.approx(t["trainer.commit"]["device_ms"] / 2)
    # counted over another window than the traced one: no reading
    r = readings(4, 3)
    for name, mod in READERS.items():
        assert mod.read(r) is None, name


def test_span_readers_on_an_empty_store():
    r = readings(3, 2)
    for name, mod in READERS.items():
        assert mod.read(r) is None and harness.read_metric(name, r) is None, name


def test_profile_step_attributes_kernels_to_spans():
    """A kernel goes to the spans open at its launch (``args.correlation``
    -> the ``cuda_runtime`` event) on the launch's thread, else on the
    thread whose innermost span began last; torch's own ranges are no
    program spans."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "args": args}

    events = [
        x("user_annotation", "trainer.forward", 0, 100),
        x("user_annotation", "unet.ssm", 10, 30),
        x("user_annotation", "unet.norm", 20, 5),
        x("user_annotation", "Optimizer.step#AdamW.step", 50, 10),
        x("user_annotation", "trainer.backward", 200, 100),
        x("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 55, 1, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 150, 1, correlation=4),
        x("cuda_runtime", "cudaLaunchKernel", 250, 1, tid=9, correlation=5),
        x("kernel", "k", 22, 1000, tid=7, correlation=1),
        x("kernel", "k", 31, 2000, tid=7, correlation=2),
        x("gpu_memcpy", "m", 56, 4000, tid=7, correlation=3),
        x("kernel", "k", 151, 8000, tid=7, correlation=4),
        x("kernel", "k", 251, 16000, tid=7, correlation=5),
    ]
    got = profile_step.span_kernel_times(events)
    assert got == {"unet.norm": [1.0, 1.0], "unet.ssm": [2.0, 3.0],
                   "trainer.forward": [4.0, 7.0], "(no span)": [8.0, 8.0],
                   "trainer.backward": [16.0, 16.0]}
