"""``SS2DCondV10``'s gather path in token order (CPU, micro shapes): against
the (L, B)-ordered formulation it replaced (``tests/ssm_gather_reference``)
over the gather cases of ``test_torch_noise_capacity`` and both overflow
modes, with an ablated branch and ``no_scan``, forward and backward; a
dispatch-level check that the path creates no full-width or (L, B)-ordered
tensor; and the delta add's autograd function against autograd through
its plain version.

Tolerances: rtol 1e-4 / atol 1e-5 (``test_torch_noise_capacity``'s, fp32
both sides: the summed weight and the delta add reorder the sums).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from actalker_tpu_torch.io.init import lineage_init_
from actalker_tpu_torch.models import ssm
from actalker_tpu_torch.ops import selective_scan as ss
from tests.ssm_gather_reference import old_gather_forward
from tests.test_torch_noise_capacity import ATOL, RTOL, _GATHER_CASES, _ragged_boxes
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)


def _block(capacity, overflow="nan", d_model=64, seed=0, **flags):
    with torch.device("meta"):
        blk = ssm.SS2DCondV10(d_model, d_cond=48, capacity_frac=capacity,
                              capacity_overflow=overflow, **flags)
    return lineage_init_(blk, seed=seed, device="cpu").eval()


def _inputs(b=4, l=64, d_model=64, sa=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, l, d_model, generator=g), torch.randn(b, 1, 48, generator=g),
            torch.randn(b, sa, 48, generator=g), torch.randn(b, 1, 48, generator=g))


def _both(blk, args):
    with torch.no_grad():
        return blk(*args), old_gather_forward(blk, *args)


@pytest.mark.parametrize("case", sorted(_GATHER_CASES))
def test_gather_order_matches_the_old_formulation(case):
    """Every gather case (overlapping branches, ragged rows, an empty box, a
    gated-off branch) against the (L, B)-ordered formulation."""
    _, audio_mask, exp_mask, capacity = _GATHER_CASES[case]
    args = _inputs() + tuple(map(torch.from_numpy, (audio_mask, exp_mask)))
    new, old = _both(_block(capacity), args)
    assert torch.isfinite(new).all()
    np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("overflow", ["nan", "drop"])
def test_gather_order_overflow(overflow):
    """Ragged boxes (3 / 6 / 9 / 12 tokens) over an 8-slot budget: the rows
    whose box overflows (and only those) turn NaN under "nan"; under "drop"
    their extra tokens stay at the projection. Both as the old formulation
    does."""
    masks = _ragged_boxes(64, 4), np.zeros((1, 1, 64, 64), np.float32)
    args = _inputs() + tuple(map(torch.from_numpy, masks))
    blk = _block((0.1, 0.0), overflow=overflow)
    new, old = _both(blk, args)
    sel = ssm.downsample_ip_mask(args[4], 64)[..., 0] >= 1.0 - 1e-6
    over = sel.sum(1) > 8                           # ceil(0.1 * 64) = 7, rounded up to 8
    assert 0 < over.sum() < 4                       # some rows overflow, not all
    bad = torch.isnan(new).all(dim=(1, 2))
    if overflow == "nan":
        assert torch.equal(bad, over) and torch.equal(torch.isnan(old).all(dim=(1, 2)), over)
        new, old = new[~over], old[~over]
    assert torch.isfinite(new).all()
    np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flags", [{"use_exp": False}, {"no_scan": True}],
                         ids=["audio_only", "no_scan"])
def test_gather_order_ablations(flags):
    """An ablated expression branch (its weight leaves the summed GEMM) and
    ``no_scan`` (each branch its projection) give the old results."""
    _, audio_mask, exp_mask, capacity = _GATHER_CASES["both branches small"]
    args = _inputs() + tuple(map(torch.from_numpy, (audio_mask, exp_mask)))
    new, old = _both(_block(capacity, **flags), args)
    np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=RTOL, atol=ATOL)


class _Sizes(TorchDispatchMode):
    """Records the shape of every tensor an aten op returns, except inside
    K1's call (on the CPU its plain version makes (L, B, Dp, N) states the
    kernel keeps on chip), whose output alone is recorded."""

    def __init__(self, monkeypatch):
        super().__init__()
        self.shapes, self.paused = [], False
        real = ssm.ssm_scan_grouped

        def scan(*a):
            self.paused = True
            try:
                y = real(*a)
            finally:
                self.paused = False
            self.shapes.append(tuple(y.shape))
            return y

        monkeypatch.setattr(ssm, "ssm_scan_grouped", scan)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.shapes.append(tuple(t.shape))
        return out


def _oversized(shapes, b, l, di, nb):
    return [s for s in shapes
            if int(np.prod(s)) > b * l * di or s == (l, b, nb * di) or s[:2] == (l, b)]


def test_gather_order_makes_no_full_width_copy(monkeypatch):
    """Under a dispatch spy, no tensor the block makes (K1's operands and
    output included) holds more than B * L * d_inner elements, has the
    shape (L, B, nb * d_inner) or any (L, B, .) order: 256 tokens, 1/8 of
    them a branch's budget, 8 audio tokens. The old formulation, under the
    same spy, is caught."""
    b, l, d = 4, 256, 64
    box = np.zeros((1, 1, 64, 64), np.float32)
    box[..., 8:24, 12:28] = 1.0                      # 16 x 16 px: 4 x 4 tokens of 16 x 16
    args = _inputs(b=b, l=l, d_model=d, sa=8) + (torch.from_numpy(box),) * 2
    blk = _block((0.125, 0.125), d_model=d)
    nb, di = 2, blk.d_inner
    with torch.no_grad():
        with _Sizes(monkeypatch) as spy:
            blk(*args)
        assert spy.shapes and _oversized(spy.shapes, b, l, di, nb) == []
        with _Sizes(monkeypatch) as spy:
            old_gather_forward(blk, *args)
        assert _oversized(spy.shapes, b, l, di, nb)


def test_gather_order_gradients_match_the_old_formulation():
    """Under autograd (the delta add in place on the summed projection, the
    poison a masked fill): the gradients of x, the conditions and every
    parameter equal the (L, B)-ordered formulation's, both branches
    gathered, their boxes overlapping (tokens both select)."""
    _, audio_mask, exp_mask, capacity = _GATHER_CASES["both branches small"]
    masks = tuple(map(torch.from_numpy, (audio_mask, exp_mask)))
    blk = _block(capacity)
    cot = torch.randn(4, 64, 64, generator=torch.Generator().manual_seed(2))
    grads = []
    for fn in (blk, lambda *a: old_gather_forward(blk, *a)):
        blk.zero_grad()
        ins = [t.requires_grad_(True) for t in _inputs()]
        y = fn(*ins, *masks)
        y.backward(cot)
        grads.append([t.grad for t in ins] + [p.grad for p in blk.parameters()])
    for new, old in zip(*grads, strict=True):
        assert new is not None and old is not None
        np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("active", [0.6, 1.0], ids=["ragged", "every slot"])
def test_gather_delta_add_function_gradients(active):
    """``GatherDeltaAddFn`` (its forward the plain version on the CPU): in
    float64, gradcheck passes, and its gradients of y, s and u equal those
    of autograd through ``gather_delta_add_ref``."""
    g = torch.Generator().manual_seed(3)
    k, b, di, n = 5, 3, 8, 40
    tok = torch.randperm(n, generator=g)[:k * b].view(k, b)
    act = torch.rand(k, b, generator=g) < active
    ins = [torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)
           for shape in ((n, di), (k, b, 2 * di), (k, b, di))]

    def via(fn):
        def f(y, s, u):
            y = y.clone()
            fn(y, s, u, tok, act)
            return y
        return f

    assert torch.autograd.gradcheck(via(ss.GatherDeltaAddFn.apply), ins)
    cot = torch.randn(n, di, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(via(ss.GatherDeltaAddFn.apply)(*ins), ins, cot)
    want = torch.autograd.grad(via(ss.gather_delta_add_ref)(*ins), ins, cot)
    for a, w in zip(got, want, strict=True):
        assert torch.equal(a, w)


@pytest.mark.parametrize("capacity,flags", [
    ((0.375, 0.0), {}), ((0.375, 0.3125), {}), ((0.0, 0.3125), {}),
    ((1.0, 0.3125), {}), ((1.0, 1.0), {}), (None, {}),
    ((0.375, 0.3125), {"use_exp": False}), ((0.375, 0.3125), {"no_scan": True})],
    ids=["mode0", "both", "mode1", "one whole", "dense", "no budget", "audio_only",
         "no_scan"])
def test_chip_smoke_derives_the_delta_adds(capacity, flags, monkeypatch):
    """``chip_smoke.delta_launches`` (the card's launch count of the delta
    add, one per gathered branch with slots) against the calls with slots
    that one block forward makes, masks given."""
    import chip_smoke

    calls = []
    real = ssm.gather_delta_add

    def spy(y, s, *a):
        calls.append(s.shape[0] * s.shape[1] > 0)
        return real(y, s, *a)

    monkeypatch.setattr(ssm, "gather_delta_add", spy)
    _, audio_mask, exp_mask, _ = _GATHER_CASES["both branches small"]
    args = _inputs() + tuple(map(torch.from_numpy, (audio_mask, exp_mask)))
    blk = _block(capacity, **flags)
    with torch.no_grad():
        blk(*args)
    assert sum(calls) == chip_smoke.delta_launches(blk, capacity)
