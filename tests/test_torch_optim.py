"""The port's poly LR factor (mdilss_tpu_torch/train/optim.py
`poly_lr_factor`) against the JAX package's (mdilss_tpu/train/optim.py:118-122,
called eagerly, as its Trainer computes the logged LR columns) at every epoch
of several schedule lengths: bitwise equal (the float32 base raised to the
float32 exponent, correctly rounded to float32)."""
import pytest

from mdilss_tpu.train.optim import poly_lr_factor as jax_poly_lr_factor
from mdilss_tpu_torch.train.optim import poly_lr_factor


@pytest.mark.parametrize("num_epochs", [1, 2, 3, 5, 10, 50, 150])
def test_poly_lr_factor_equals_jax(num_epochs):
    epochs = range(1, num_epochs + 1)
    want = [float(jax_poly_lr_factor(e, num_epochs)) for e in epochs]
    got = [poly_lr_factor(e, num_epochs) for e in epochs]
    assert got == want
