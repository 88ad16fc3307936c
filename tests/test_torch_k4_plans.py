"""K4's host side on the CPU: the plan choice of ``ops/mlp.py`` and the
kernel names the traces group by.

Every ``__global__`` function of ``csrc/geglu_mlp.cu`` has to land in the
"K4 GEGLU" group of ``portbench/trace.py`` (and of its copy in
``tools/profile_step.py``), or its device time would leave K4's group and
``kernel_roofline`` would divide K4's least time by time that no longer
counts it. The plan is a function of the shapes alone, defined for every
shape the wrapper takes, and agrees with the C entries' numbering.
No JAX, no card.
"""
import itertools
import os
import re

import pytest

from actalker_tpu_torch.ops import mlp
from actalker_tpu_torch.tools import profile_step
from portbench import trace

SOURCE = os.path.join(os.path.dirname(mlp.__file__), os.pardir, "csrc", "geglu_mlp.cu")


def _source() -> str:
    with open(SOURCE) as f:
        return f.read()


def _globals():
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      _source())


def test_k4_source_has_kernels():
    assert _globals()


@pytest.mark.parametrize("args", ["true, true, true", "true, false, true",
                                  "false, false, true", "false, false, false"])
def test_k4_symbols_group_as_k4(args):
    """Each kernel's name, bare and as the profiler shows an instantiation
    (demangled, with its parameter types), is K4's in both group tables."""
    for name in _globals():
        for shown in (name, f"(anonymous namespace)::{name}<{args}>(CUtensorMap_st, "
                            f"CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
                            f"__nv_bfloat16*, int, int, int)"):
            assert trace.group_of(shown) == "K4 GEGLU", shown
            assert profile_step.group_of(shown) == "K4 GEGLU", shown


def test_k4_plan_numbers_match_the_source():
    """``PLANS`` numbers the C entries' ``Plan`` enum, and the resident
    plan's C limit is the kernel's ``kResidentK``."""
    enum = re.search(r"enum Plan \{([^}]*)\}", _source()).group(1)
    got = {re.sub(r"(?<!^)(?=[A-Z])", "_", k.strip()[1:]).lower(): int(v)
           for k, v in (e.split("=") for e in enum.split(","))}
    assert got == mlp.PLANS
    limit = re.search(r"constexpr int kResidentK = (\d+);", _source()).group(1)
    assert int(limit) == mlp.RESIDENT_C


# every shape the wrapper takes: C % 8 == 0 from 8 to 2560, I = 4C (the
# UNet) or 2C (a tp = 2 rank), any even Cout, M from 1 to the 576 px
# res-72 feed-forward's 518400 rows
CS = range(8, 2561, 8)
MS = (1, 2, 63, 64, 65, 127, 128, 129, 8100, mlp.RESIDENT_MIN_M - 1, mlp.RESIDENT_MIN_M,
      32400, 129600, 518400)
COUTS = (2, 18, 56, 200, 320, 640, 1280, 2558)


@pytest.mark.parametrize("mult", [4, 2])
def test_k4_plan_for_every_shape(mult):
    """A plan for each launch at every accepted shape, the same on every
    call, resident only where A fits (C <= 320) and TMA stores only where
    y's rows are 16-byte strided."""
    for c, m, cout in itertools.product(CS, MS, COUTS):
        first, second = mlp.plans(m, c, mult * c, cout)
        assert (first, second) == mlp.plans(m, c, mult * c, cout)
        assert first in ("in_resident", "in_stream") and first in mlp.PLANS
        assert second in ("out_tma", "out_regs") and second in mlp.PLANS
        assert (first == "in_resident") == (c <= mlp.RESIDENT_C
                                            and m >= mlp.RESIDENT_MIN_M)
        assert (second == "out_tma") == (cout % 8 == 0)


def test_k4_plans_at_the_cells_shapes():
    """The 576 px cell's feed-forwards (res-72 / -36 / -18 / the res-9 mid
    block) and the 512 px training cell's (25 frames)."""
    assert mlp.plans(518400, 320, 1280, 320) == ("in_resident", "out_tma")
    assert mlp.plans(129600, 640, 2560, 640) == ("in_stream", "out_tma")
    assert mlp.plans(32400, 1280, 5120, 1280) == ("in_stream", "out_tma")
    assert mlp.plans(8100, 1280, 5120, 1280) == ("in_stream", "out_tma")
    assert mlp.plans(25 * 4096, 320, 1280, 320) == ("in_resident", "out_tma")
