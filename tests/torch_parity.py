"""Helpers of the port's parity tests: seeded JAX parameters without a
flax ``init`` (which runs the network once, eagerly, and takes tens of
seconds for the wide ones on the CPU), the relative L2 error, and loading
an exported state dict into a port module with ``strict=True``."""
import jax
import numpy as np
import torch


def seeded_params(spec, seed: int):
    """Numpy values for a ``jax.eval_shape(model.init, ...)`` tree: conv /
    dense kernels N(0, 1 / fan_in), StyleGAN2's ``weight`` leaves N(0, 1)
    (their scale is applied in the forward), norm scales and variances
    U(0.5, 1.5), anything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf in ("var", "scale"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif leaf == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "weight":
            v = rng.standard_normal(s.shape)
        else:
            v = rng.standard_normal(s.shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, spec)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def load(net, sd):
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    return net.eval()
