"""The port's Trainer (mdilss_tpu_torch/train/loop.py) against the JAX
package's Trainer on the CPU, at the JAX trainer tests' TINY size (synthetic,
4 images, batch 2, 32x64): step 1 for 2 epochs and step 2 for one here, the
two-phase step 3 in test_torch_trainer_jax_step3.py (a file of its own, so
that the test runs beside these). The comparison is
`_torch_port.trainer_parity`; its docstring gives what is shared and the
tolerances."""
import pytest
import torch

from _torch_port import trainer_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("protocol", ["step1", "step2"])
def test_trainer_matches_jax(tmp_path, monkeypatch, protocol):
    trainer_parity(protocol, tmp_path, monkeypatch)
