"""PyTorch port, K8's host-side plan and weight layout (``ops/resconv.py``),
on the CPU.

``conv_plan`` picks K8's tiles from (N, H, W, C, Co): every UNet and VAE
shape of the fused-norm configuration, and the card tests' edge shapes,
must get a block within the card's 227 KB of shared memory, tiles that
cover every output pixel and column once, and a halo whose slots hold
exactly the input pixels each output pixel's nine taps read (the kernel's
slot table, ``halo_source``), each pixel once. ``conv_weight`` is the
(Co, 9 * C) layout K8 reads, built once per weight tensor and rebuilt
after an in-place update (``_build.derived``, which also keeps the fp32
copies of bf16 norm affines and conv biases).
"""
import gc

import numpy as np
import pytest
import torch

from actalker_tpu_torch.ops import _build, resconv

# (H = W, C, Co) of every K8 launch of one UNet forward (ResnetBlock2D's
# two GN / SiLU / conv pairs), at the window-step's 56 images
UNET = [(64, 320, 320), (64, 960, 320), (64, 640, 320),
        (32, 320, 640), (32, 640, 640), (32, 1920, 640), (32, 1280, 640),
        (32, 960, 640),
        (16, 640, 1280), (16, 1280, 1280), (16, 2560, 1280), (16, 1920, 1280),
        (8, 1280, 1280), (8, 2560, 1280)]
# the VAE's resnets: C, Co in {128, 256, 512} at 64-512 px, 14 frames
VAE = [(hw, c, co) for hw in (64, 128, 256, 512)
       for c in (128, 256, 512) for co in (128, 256, 512)]
# the card tests' edges: one-pixel images, ragged sizes, C / Co below one
# chunk or tile, a 512-wide row in part, 8 x 8 whole images
EDGES = [(5, 1, 1, 32, 16), (2, 9, 7, 40, 24), (1, 128, 16, 128, 256),
         (3, 7, 9, 64, 40), (1, 3, 512, 128, 128), (2, 8, 8, 960, 320),
         (1, 136, 136, 64, 64), (1, 4, 137, 64, 64), (1, 1, 300, 8, 8)]
SHAPES = ([(56, hw, hw, c, co) for hw, c, co in UNET]
          + [(14, hw, hw, c, co) for hw, c, co in VAE] + EDGES)


def _tiles(m_tiles):
    """The first, last and a spread of middle M tiles (all when few)."""
    if m_tiles <= 24:
        return range(m_tiles)
    return sorted({0, 1, m_tiles // 3, m_tiles // 2, m_tiles - 2, m_tiles - 1})


@pytest.mark.parametrize("n,h,w,c,co", SHAPES,
                         ids=[f"{n}x{h}x{w}x{c}-{co}" for n, h, w, c, co in SHAPES])
def test_plan_fits_and_covers(n, h, w, c, co):
    plan = resconv.conv_plan(n, h, w, c, co)
    assert plan["smem"] <= resconv.SMEM_LIMIT
    assert 2 <= plan["stages"] <= resconv.MAX_STAGES
    assert plan["bn"] in resconv.BN_CHOICES and plan["bn"] % 8 == 0
    m = n * h * w
    # the grid's tiles cover every output pixel and column exactly once
    assert (plan["m_tiles"] - 1) * resconv.BM < m <= plan["m_tiles"] * resconv.BM
    assert (plan["n_tiles"] - 1) * plan["bn"] < co <= plan["n_tiles"] * plan["bn"]
    assert plan["chunks"] * resconv.KC >= c > (plan["chunks"] - 1) * resconv.KC
    # a Co that one of the widths tiles exactly is tiled with no padding
    if any(co % b == 0 for b in resconv.BN_CHOICES):
        assert co % plan["bn"] == 0


@pytest.mark.parametrize("n,h,w,c,co", SHAPES,
                         ids=[f"{n}x{h}x{w}x{c}-{co}" for n, h, w, c, co in SHAPES])
def test_halo_holds_every_tap_once(n, h, w, c, co):
    """For each output pixel of a tile and each tap inside its image, the
    slot the kernel reads holds that input pixel; every slot is within the
    halo, and no input pixel is staged (activated) twice in one tile."""
    plan = resconv.conv_plan(n, h, w, c, co)
    seg, slots, bm = plan["seg"], plan["slots"], resconv.BM
    assert plan["rows"] % resconv.BOX == 0 and slots <= plan["rows"] <= 3 * resconv.BOX
    m = n * h * w
    src = np.array([resconv.halo_source(s, 0, w, seg) for s in range(slots)])
    for t in _tiles(plan["m_tiles"]):
        m0 = t * bm
        held = src + m0                          # halo_source is m0 + f(s)
        inside = held[(held >= 0) & (held < m)]
        assert len(np.unique(inside)) == len(inside)
        p = np.arange(m0, min(m0 + bm, m))
        i = p - m0
        y, x = (p % (h * w)) // w, p % w
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = (y + dy >= 0) & (y + dy < h) & (x + dx >= 0) & (x + dx < w)
                slot = i + (dx + 1) + (dy + 1) * seg
                assert (slot >= 0).all() and (slot < slots).all()
                np.testing.assert_array_equal(held[slot[ok]],
                                              (p + dy * w + dx)[ok])


def test_halo_source_matches_the_formula_per_tile():
    """``halo_source`` moves with the tile start by the same offset (the
    kernel's table is m0 plus a per-slot constant)."""
    for w, seg in ((8, 8), (64, 64), (512, resconv.BOX)):
        slots = 2 * seg + resconv.BM + 2
        for s in range(0, slots, 7):
            assert (resconv.halo_source(s, 1280, w, seg)
                    == 1280 + resconv.halo_source(s, 0, w, seg))


def test_conv_weight_is_cached_and_rebuilt_after_an_update():
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(24, 16, 3, 3, generator=gen)
    want = w.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(24, 144)
    wt = resconv.conv_weight(w, torch.bfloat16)
    assert wt.dtype == torch.bfloat16 and wt.is_contiguous()
    assert torch.equal(wt, want)
    assert resconv.conv_weight(w, torch.bfloat16) is wt      # no re-layout
    w.add_(1.0)                                               # version moves
    wt2 = resconv.conv_weight(w, torch.bfloat16)
    assert wt2 is not wt
    assert torch.equal(wt2, w.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(24, 144))
    assert resconv.conv_weight(w, torch.float32).dtype == torch.float32
    key = id(w)
    assert sum(k[0] == key for k in _build._DERIVED) == 2     # bf16 and fp32
    del w
    gc.collect()
    assert not any(k[0] == key for k in _build._DERIVED)      # dies with w


def test_conv_weight_of_a_parameter_follows_optimizer_steps():
    w = torch.nn.Parameter(torch.randn(8, 8, 3, 3))
    wt = resconv.conv_weight(w, torch.bfloat16)
    opt = torch.optim.SGD([w], lr=0.5)
    w.grad = torch.ones_like(w)
    opt.step()
    wt2 = resconv.conv_weight(w, torch.bfloat16)
    assert not torch.equal(wt, wt2)
    assert torch.equal(wt2, w.detach().to(torch.bfloat16).permute(0, 2, 3, 1)
                       .reshape(8, 72))


def test_fp32_of_casts_once_per_version():
    """The fp32 copy of a bf16 parameter (a K7 gamma / beta, a K8 bias) is
    made once and rebuilt after an in-place update; an fp32 contiguous
    tensor is its own."""
    t = torch.nn.Parameter(torch.randn(64).bfloat16())
    f = _build.fp32_of(t)
    assert f.dtype == torch.float32 and torch.equal(f, t.detach().float())
    assert _build.fp32_of(t) is f
    with torch.no_grad():
        t.mul_(2)
    assert torch.equal(_build.fp32_of(t), t.detach().float())
    u = torch.randn(8)
    assert _build.fp32_of(u) is u
