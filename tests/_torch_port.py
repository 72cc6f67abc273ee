"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py): JAX
models with randomised BatchNorm, moved into the port through the weight
bridge, so both packages run the same weights on the same inputs."""
import numpy as np
import torch

import jax.numpy as jnp

from mdilss_tpu.ops.norm import BNState


def randomize_bn(params, state, rng):
    """Replace every BN scale/bias and running mean/var by random values
    (scale, var in [0.5, 1.5]; bias, mean ~ N(0, 0.1)), so eval-mode BN and
    its fold are exercised instead of the identity init."""
    def uni(a):
        return jnp.asarray(rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32))

    def nrm(a):
        return jnp.asarray(rng.normal(0.0, 0.1, np.shape(a)).astype(np.float32))

    def walk_p(t):
        if isinstance(t, dict):
            if set(t) == {"scale", "bias"}:
                return {"scale": uni(t["scale"]), "bias": nrm(t["bias"])}
            return {k: walk_p(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk_p(v) for v in t]
        return t

    def walk_s(t):
        if isinstance(t, BNState):
            return BNState(mean=nrm(t.mean), var=uni(t.var))
        if isinstance(t, dict):
            return {k: walk_s(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk_s(v) for v in t]
        return t

    return walk_p(params), walk_s(state)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
