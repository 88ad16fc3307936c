"""PyTorch port, the bf16 backwards of the GEGLU feed-forward (K4), the
frame attention (K3) and the fused GroupNorm + SiLU + 3x3 conv (K8)
against the JAX package's (CPU).

The JAX package's custom_vjp rules differentiate its XLA twins
(``_mlp_xla``, ``_frame_xla``, ``_gnconv_xla``), whose products take and
return the compute dtype. The port's autograd functions differentiate
their twins (``geglu_mlp_xla``, ``frame_attention_tokens_xla``,
``gn_silu_conv3x3_xla``), so in bf16 every matrix product and convolution
of their backwards takes bf16 operands, as the JAX package's do: checked
op by op with a ``TorchDispatchMode``.

Gradients on bf16 inputs made with numpy from a seed, against ``jax.vjp``
of the JAX function on the same inputs and cotangent. Tolerance: relative
L2 per gradient, 1e-4. Both sides round every product's output to bf16
after fp32 sums, and on the CPU both read 0 to 1.4e-7 apart (the fp32 bias
gradients' sums); a sum order that flips a rounding moves an entry by
2^-8, so 1e-4 leaves room for a few. The same backward through fp32
products (the port before its bf16 twins) reads 1.8e-3 to 4.2e-3 for the
GEGLU and frame gradients; K8's convs round alike either way on the CPU,
so its dtypes are what the product check below holds.

``_gnconv_xla``'s own vjp cannot run in bf16: its conv returns fp32
(``preferred_element_type``), and JAX refuses the transposed conv of an
fp32 cotangent with bf16 weights. So K8's oracle is the same function
written with the JAX package's ``_gn_affine`` and the conv's output in the
compute dtype before the fp32 bias, which is what the port's twin computes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from actalker_tpu.ops import mha as jmha, mlp as jmlp, resconv as jresconv
from actalker_tpu_torch.ops import mha, mlp, resconv

TOL = 1e-4
PRODUCTS = ("mm", "addmm", "bmm", "convolution", "convolution_backward")


def _rel(port, ref):
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    return float(np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30))


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> (torch bf16, jax bf16) holding the same values."""
    t = torch.from_numpy(a).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _mlp_case(rng):
    m, c = 48, 32
    x, w1, w2 = (_bf16(a) for a in (
        _rand(rng, m, c), _rand(rng, c, 8 * c, scale=c ** -0.5),
        _rand(rng, 4 * c, c, scale=(4 * c) ** -0.5)))
    b1, b2 = _rand(rng, 8 * c, scale=0.1), _rand(rng, c, scale=0.1)
    cot = _bf16(_rand(rng, m, c))
    # torch Linear layout: weights cross transposed, their gradients too
    port = ([x[0], w1[0].t().contiguous(), torch.from_numpy(b1),
             w2[0].t().contiguous(), torch.from_numpy(b2)], mlp.geglu_mlp)
    ref = ([x[1], w1[1], jnp.asarray(b1), w2[1], jnp.asarray(b2)], jmlp.geglu_mlp)
    return port, ref, cot, (False, True, False, True, False)


def _frame_case(rng):
    q, k, v, cot = (_bf16(_rand(rng, 2 * 5, 24, 128)) for _ in range(4))
    port = ([q[0], k[0], v[0]],
            lambda q, k, v: mha.frame_attention_tokens(q, k, v, 5, 2))
    ref = ([q[1], k[1], v[1]],
           lambda q, k, v: jmha.frame_attention_tokens(q, k, v, 5, 2))
    return port, ref, cot, (False,) * 3


def _jax_gnconv_bf16(x, gamma, beta, w, cb, groups=8, eps=1e-5):
    """``_gnconv_xla`` with the conv's output in x's dtype (see above)."""
    a, b = jresconv._gn_affine(x, gamma, beta, groups, eps)
    bshape = (x.shape[0], 1, 1, x.shape[-1])
    y = x.astype(jnp.float32) * a.reshape(bshape) + b.reshape(bshape)
    y = (y * jax.nn.sigmoid(y)).astype(x.dtype)
    out = jax.lax.conv_general_dilated(
        y, w.astype(x.dtype), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return (out.astype(jnp.float32) + cb).astype(x.dtype)


def _conv_case(rng):
    n, h, w, c, co = 2, 6, 6, 32, 16
    x = _bf16(_rand(rng, n, h, w, c, scale=1.5))
    wk = _bf16(_rand(rng, 3, 3, c, co, scale=0.05))
    gamma, beta = 1.0 + _rand(rng, c, scale=0.1), _rand(rng, c, scale=0.1)
    cb = _rand(rng, co, scale=0.1)
    cot = _bf16(_rand(rng, n, h, w, co))
    port = ([x[0], torch.from_numpy(gamma), torch.from_numpy(beta),
             wk[0].permute(3, 2, 0, 1).contiguous(), torch.from_numpy(cb)],
            lambda x, g, b, w, cb: resconv.gn_silu_conv3x3(x, g, b, 8, 1e-5, w, cb))
    ref = ([x[1], jnp.asarray(gamma), jnp.asarray(beta), wk[1], jnp.asarray(cb)],
           _jax_gnconv_bf16)
    return port, ref, cot, (False, False, False, "hwio", False)


CASES = {"geglu_mlp": _mlp_case, "frame_attention": _frame_case,
         "gn_silu_conv3x3": _conv_case}


def _port_grads(case, seed):
    (ins, fn), _, cot, _ = case(np.random.default_rng(seed))
    ins = [t.requires_grad_(True) for t in ins]
    out = fn(*ins)
    assert type(out.grad_fn).__name__.endswith("FnBackward")
    return out, ins, cot[0]


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_gradients_match_jax_vjp(name):
    (ins, fn), (jins, jfn), cot, layout = CASES[name](np.random.default_rng(7))
    ins = [t.requires_grad_(True) for t in ins]
    got = torch.autograd.grad(fn(*ins), ins, cot[0])
    _, vjp = jax.vjp(jfn, *jins)
    for i, (g, r, tr) in enumerate(zip(got, vjp(cot[1]), layout)):
        assert g.dtype == ins[i].dtype, (i, g.dtype)
        if tr == "hwio":
            g = g.permute(2, 3, 1, 0)
        elif tr:
            g = g.t()
        assert _rel(g, r) < TOL, (name, i, _rel(g, r))


class _Products(TorchDispatchMode):
    """Records the operand dtypes of every product op that runs."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in PRODUCTS:
            dtypes = {a.dtype for a in args
                      if isinstance(a, torch.Tensor) and a.is_floating_point()}
            self.seen.append((name, dtypes))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(CASES))
def test_backward_products_take_bf16_operands(name):
    out, ins, cot = _port_grads(CASES[name], 8)
    with _Products() as rec:
        torch.autograd.grad(out, ins, cot)
    assert rec.seen, "the backward ran no product"
    wrong = [(op, d) for op, d in rec.seen if d != {torch.bfloat16}]
    assert not wrong, wrong
