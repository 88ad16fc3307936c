"""The benchmark's harness on the CPU: the manifest's names, the files each
cell resolves by name, a configuration / mix / metric added without an
edit, the imports of a run and of the reference, and the yardstick's
arithmetic against ``chip_smoke.py``'s. Card tests are marked ``cuda``."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness, roofline

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves_its_files(workload):
    cell = harness.load_cell(workload)
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                       cell.traffic["driver"] + ".py"))
    for kind in ("end_to_end", "per_layer"):
        assert cell.metrics(kind), kind
    for m in cell.metrics("per_layer"):
        path = os.path.join(ROOT, "portbench", "metrics",
                            harness.metric_module(m["name"]) + ".py")
        assert os.path.exists(path), path
        # a metric is reported where its end-to-end metric is
        e2e = {x["name"] for x in cell.metrics("end_to_end")}
        assert m["moves"] in e2e


def test_added_config_mix_and_metric_found_without_edits(tmp_path):
    """A later change adds a configuration file, a traffic file, a metric
    reader and entries; the harness finds all by name, and no file it had
    changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    b = bench()
    cfg = json.loads((root / "portbench/configs/actalker-svdxt-576.json").read_text())
    cfg["name"] = "actalker-svdxt-512"
    cfg["sampler"]["image_size"] = 512
    (root / "portbench/configs/actalker-svdxt-512.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/mode0-facebox.json").read_text())
    mix["gate"] = [1, 1]
    (root / "portbench/traffic/mode2-ones.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/window_probe_ms_infer.py").write_text(
        "def read(r):\n    return 1e3 * r.window_s\n")
    b["configs"].append({"name": "actalker-svdxt-512", "source": "x",
                         "file": "portbench/configs/actalker-svdxt-512.json",
                         "reduced": ["sampler"], "why": "x"})
    b["workloads"].append({"name": "infer512.mode2", "config": "actalker-svdxt-512",
                           "traffic": "mode2-ones", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "window_probe_ms.infer", "unit": "ms",
                           "better": "lower", "source": "host_clock", "layer": "device",
                           "moves": "window_step_s", "workloads": ["infer512.mode2"]})
    b["end_to_end"][0]["workloads"].append("infer512.mode2")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell("infer512.mode2", root=str(root))
    assert cell.config["sampler"]["image_size"] == 512
    assert cell.traffic["gate"] == [1, 1]
    assert [m["name"] for m in cell.metrics("per_layer")] == ["window_probe_ms.infer"]
    spec = harness.metric_module("window_probe_ms.infer")
    sys.path.insert(0, str(root))
    try:
        import importlib.util
        mod_spec = importlib.util.spec_from_file_location(
            spec, root / "portbench/metrics" / f"{spec}.py")
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        r = harness.Readings()
        r.window_s = 0.5
        assert mod.read(r) == 500.0
    finally:
        sys.path.remove(str(root))
    after = {p: p.read_bytes() for p in before}
    assert after == before


MICRO_RUN = r"""
import json, sys, torch
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.drivers import sampler
cfg = json.load(open({root!r} + '/portbench/configs/actalker-svdxt-576.json'))
cfg['unet'].update(block_out_channels=[32, 64], num_attention_heads=[2, 4],
                   layers_per_block=1, cross_attn_levels=1)
cfg['sampler'].update(image_size=144, n_sample_frames=2, num_inference_steps=2)
tr = json.load(open({root!r} + '/portbench/traffic/mode0-facebox.json'))
tr.update(clip_frames=2, warmup_calls=1)
b = json.load(open({root!r} + '/BENCHMARK.json'))
cell = harness.Cell({{'name': 'infer576.mode0-facebox', 'chips': 1}}, cfg, tr, b)
torch.set_num_threads(2)
rc = harness.measure(cell, sampler, torch.device('cpu'), 3, 0.01, False)
print('FORBIDDEN', json.dumps(harness.forbidden_modules()))
print('PORT', 'actalker_tpu_torch' in sys.modules)
"""


def test_micro_run_imports_no_jax():
    """A cell's process at micro size (set-up, window, check, result)
    holds no module whose top-level name is jax, jaxlib, flax or
    actalker_tpu, compared whole: actalker_tpu_torch is the port."""
    out = subprocess.run([sys.executable, "-c", MICRO_RUN.format(root=ROOT)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    result = json.loads([x for x in lines if x.startswith("{")][-1])
    assert result["correct"] is True
    assert json.loads(lines[-2].split(" ", 1)[1]) == []
    assert lines[-1] == "PORT True"


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("actalker_tpu_torch_probe", type(sys)("actalker_tpu_torch_probe"))
    try:
        assert "actalker_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["actalker_tpu_torch_probe"]


REF_IMPORTS = r"""
import sys
sys.path.insert(0, {root!r})
import portbench.reference.ops, portbench.reference.unet, portbench.reference.heads
import portbench.reference.sampler, portbench.reference.train
tops = {{m.split('.')[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'actalker_tpu', 'actalker_tpu_torch'}}))
"""


def test_reference_imports_neither_jax_nor_the_port():
    out = subprocess.run([sys.executable, "-c", REF_IMPORTS.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    import ast

    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if not f.endswith(".py") or "tests" in dirpath:
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "actalker_tpu"), \
                        (path, n)
                    if "reference" in dirpath:
                        assert n.split(".")[0] != "actalker_tpu_torch", (path, n)


# ---------------------------------------------- the yardstick vs chip_smoke

@pytest.fixture(scope="module")
def smoke_cases():
    """``chip_smoke.py``'s phase-3 cases built on the meta device: (kernel,
    label) -> bound seconds."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke

    real = chip_smoke.sfu_floor_ms
    chip_smoke.sfu_floor_ms = lambda n: 0.0
    real_randn, real_rand = torch.randn, torch.rand

    def meta(fn):
        def f(*a, generator=None, device=None, **k):
            return fn(*a, device="meta", **k)
        return f

    torch.randn, torch.rand = meta(real_randn), meta(real_rand)
    cases = {}
    try:
        gen = iter(chip_smoke.kernel_cases(torch, torch.device("meta"), None))
        while True:
            try:
                case = next(gen)
            except StopIteration:
                break
            except Exception:      # a case whose set-up needs real data
                break
            name, label, *_rest = case
            bnd = case[5] if len(case) > 5 else case[4]
            cases[(name, label)] = bnd[0] / 1e3
    finally:
        torch.randn, torch.rand = real_randn, real_rand
        chip_smoke.sfu_floor_ms = real
    return cases


def _find(cases, name, label):
    hits = [v for (n, lab), v in cases.items() if n == name and lab.startswith(label)]
    if not hits:
        pytest.skip(f"chip_smoke case {name} {label} not built on the meta device")
    return hits[0]


@pytest.mark.parametrize("dp,hw", [(640, 64), (1280, 32), (2560, 16)])
def test_k1_bound_equals_chip_smoke(smoke_cases, dp, hw):
    want = _find(smoke_cases, "ssm_scan_grouped", f"Dp={dp} L={hw * hw}+33 Bp=56")
    l = hw * hw + 33
    assert roofline.k1_call([l, l], 56, dp, -(-dp // 2 // 16)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("b,s,c,h", [(56, 4096, 320, 5), (56, 1024, 640, 10),
                                     (56, 5184, 320, 5), (56, 256, 1280, 20),
                                     (56, 64, 1280, 20)])
def test_k2_bound_equals_chip_smoke(smoke_cases, b, s, c, h):
    want = _find(smoke_cases, "mha", f"B={b} S={s} C={c} H={h}")
    assert roofline.k2_call(b, s, c, h) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("b,f,s,h", [(4, 14, 4096, 5), (4, 25, 4096, 5), (4, 14, 1024, 10),
                                     (1, 25, 4096, 5), (4, 25, 5184, 5)])
def test_k3_bound_equals_chip_smoke(smoke_cases, b, f, s, h):
    want = _find(smoke_cases, "frame_attention", f"B*F={b * f} F={f} S={s} C={64 * h} H={h}")
    assert roofline.k3_call(b, f, s, 64 * h, h) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("m,c", [(56 * 4096, 320), (56 * 1024, 640), (56 * 256, 1280)])
def test_k4_bound_equals_chip_smoke(smoke_cases, m, c):
    want = _find(smoke_cases, "geglu_mlp", f"M={m} C={c}")
    assert roofline.k4_call(m, c) == pytest.approx(want, rel=1e-12)


def test_bound_is_the_larger_of_bytes_and_operations():
    import chip_smoke

    for nbytes, ops, peak in ((3.35e9, 1e12, roofline.PEAK_BF16),
                              (1e6, 67e12, roofline.PEAK_FP32)):
        assert roofline.bound_s(nbytes, ops, peak) == pytest.approx(
            chip_smoke.bound(nbytes, ops, peak)[0] / 1e3, rel=1e-12)


def test_launches_equal_chip_smoke():
    """Launches a UNet forward and a micro-step make, derived from the
    model as ``chip_smoke.py`` derives them."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from portbench.drivers import sampler

    cfg = harness.load_cell("infer576.mode0-facebox").config
    sizes = sampler.sizes_of(cfg)
    from actalker_tpu_torch.models.unet import UNetSpatioTemporalCondition

    with torch.device("meta"):
        unet = UNetSpatioTemporalCondition(sampler.port_unet_config(sizes))
    want = chip_smoke.forward_launches(unet)
    rows = {s: [s + 33, s + 2] for s, *_ in roofline.levels(sizes, 72)}
    got = roofline.forward_bounds(sizes, 4, 25, 72, rows)
    assert {k: n for k, (n, _) in got.items()} == want
    step = roofline.micro_step_bounds(sizes, 25, 64)
    smoke = chip_smoke.micro_step_launches()
    assert {k: n for k, (n, _) in step.items()} == {k: smoke[k] for k in step}


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "infer576.mode0-facebox", "--seed", "5", "--seconds", "5"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "infer576.mode0-facebox", "--seed", "5", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_host_paced_shares_read_the_unprofiled_window():
    """``mfu`` and ``device_idle`` take the host's time from the unprofiled
    window, and only the device's busy time (per traced unit) from the
    trace, so a profiler that slows the host moves neither."""
    from portbench.metrics import _shares
    from portbench.trace import Summary

    r = harness.Readings()
    r.window_s, r.units = 32.0, 16          # 2.0 s a unit unprofiled
    r.traced_units = 4                      # traced: 12 s, 3.0 s a unit
    r.summary = Summary(12.0, {"K4 GEGLU": 1.0, "elementwise and copies": 5.9},
                        6.9, [])
    r.flops_per_unit = 1e13
    assert _shares.device_idle(r) == pytest.approx(100.0 * (1.0 - (6.9 / 4) / 2.0))
    assert _shares.mfu(r) == pytest.approx(100.0 * 1e13 * 16 / (32.0 * roofline.PEAK_BF16))
    r.summary = Summary(30.0, {"K4 GEGLU": 1.0}, 6.9, [])
    assert _shares.device_idle(r) == pytest.approx(100.0 * (1.0 - (6.9 / 4) / 2.0))
    r.bounds = {"geglu_mlp": (3, 0.1)}
    r.launches = {"geglu_mlp": 12}
    assert _shares.kernel_roofline(r) == pytest.approx(100.0 * 0.1 * 4 / 1.0)
    r.launches = {"geglu_mlp": 48}           # counted over the wrong window
    assert _shares.kernel_roofline(r) is None


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="a card is present")
def test_readings_refuse_without_a_card(capsys):
    """Without a card the port runs its plain fallbacks: the readings the
    limits are set from would be another program's."""
    from portbench import readings

    assert readings.main(["--workload", "infer576.mode0-facebox", "--seeds", "1",
                          "--program"]) == 3
    assert "needs a CUDA card" in capsys.readouterr().err
