"""The readings a cell's limits are set from, on the chip at the cell's own
size: over each seed the program's number (a sound run's), the control's
(the reference computed in fp8 in the program's place) and, for a
training cell, the faults' (planted in the reference put in the program's
place). One process for all seeds; not part of a benchmark run.

    python3 portbench/readings.py --workload infer576.mode0-facebox \
        --seeds 11 12 13 --program --control
    python3 portbench/readings.py --workload train512.synthetic \
        --seeds 11 12 13 --program --control --faults half_batch altered_update

Prints one JSON line per seed, with the card's name and power limit (and
writes them to ``--out``). Refuses to run without a CUDA card: without one
the port runs its plain fallbacks, another program than the one measured.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, weights  # noqa: E402
from portbench.drivers import sampler, trainer  # noqa: E402
from portbench.reference import ops as ref_ops  # noqa: E402


def infer_seed(cell, seed, dev, program, control):
    out = {"seed": seed}
    steps = cell.config["sampler"]["num_inference_steps"]
    c = int(np.random.default_rng(weights.seed64(seed, 5)).integers(steps))
    out["call"] = c
    st = None
    if program:
        st = sampler.setup(cell, seed, dev)
        st.calls = c
        sampler.call(st)
        prog = st.outputs[-1]
        sampler.release(st)
    else:
        st = sampler.State(cell.config, cell.traffic, seed, dev, sampler.sizes_of(cell.config),
                           sampler.make_inputs(cell.config, cell.traffic, seed, dev))
        from actalker_tpu_torch.pipeline.sampler import make_plan
        st.plan = make_plan(sampler._sampler_config(cell.config, cell.traffic),
                            cell.traffic["clip_frames"])
    ref, start, sigma, nxt = sampler.reference_output(st, c)
    if program:
        out["program"] = {"guided_v_err": sampler.v_error(prog, ref, start, sigma, nxt)}
    if control:
        ref_ops.set_precision("fp8")
        try:
            ctl = sampler.reference_output(st, c)[0]
        finally:
            ref_ops.set_precision("fp32")
        out["control"] = {"guided_v_err": sampler.v_error(ctl, ref, start, sigma, nxt)}
    return out


def train_seed(cell, seed, dev, program, control, faults):
    out = {"seed": seed}
    cfg = cell.config
    n = cell.traffic["follow_commits"] * cfg["training"]["gradient_accumulation_steps"]
    names = ("loss_err", "grad_err", "change_err")
    prog = None
    if program:
        st = trainer.setup(cell, seed, dev)
        prog = (st.losses, st.first_grad, st.change)
        trainer.release(st)
    ref = trainer.reference_run(cfg, seed, dev, n)
    if prog is not None:
        out["program"] = dict(zip(names, trainer.compare(*prog, *ref)))
        out["program_worst"] = {"grad": trainer.worst(prog[1], ref[1]),
                                "change": trainer.worst(
                                    prog[2], trainer.moved(ref[2], ref[1]))}
    runs = {}
    if control:
        ref_ops.set_precision("fp8")
        try:
            runs["control"] = trainer.reference_run(cfg, seed, dev, n)
        finally:
            ref_ops.set_precision("fp32")
    if "half_batch" in faults:      # the loss's mean over half the frames
        f = cfg["training"]["n_sample_frames"]
        runs["fault_half_batch"] = trainer.reference_run(cfg, seed, dev, n,
                                                         keep_frames=f // 2)
    if "altered_update" in faults:  # the most-moved parameter's updates x1.5
        moved = trainer.moved(ref[2], ref[1])
        leaf = max(moved, key=moved.get)
        runs["fault_altered_update"] = trainer.reference_run(
            cfg, seed, dev, n, scale_update=(leaf, 1.5))
        out["altered_leaf"] = leaf
    for k, r in runs.items():
        out[k] = dict(zip(names, trainer.compare(*r, *ref)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", nargs="*", default=(),
                   choices=("half_batch", "altered_update"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench readings: needs a CUDA card (without one the port runs "
              "its plain fallbacks, not its kernels)", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    device = {"kind": torch.cuda.get_device_name(dev),
              "power_limit": _power_limit()}
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        if cell.traffic["driver"] == "sampler":
            line = infer_seed(cell, seed, dev, args.program, args.control)
        else:
            line = train_seed(cell, seed, dev, args.program, args.control, args.faults)
        line["workload"] = args.workload
        line["device"] = device
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    return 0


def _power_limit():
    """The card's power limit as ``nvidia-smi`` gives it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


if __name__ == "__main__":
    sys.exit(main())
