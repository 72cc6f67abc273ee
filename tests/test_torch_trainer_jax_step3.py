"""The port's Trainer against the JAX package's on the two-phase step 3
(student [20, 20, 27] at task 2, train-mode teacher [20, 20]), one epoch at
the TINY size; see test_torch_trainer_jax.py and
`_torch_port.trainer_parity`."""
import torch

from _torch_port import trainer_parity

torch.set_num_threads(1)


def test_trainer_matches_jax_step3(tmp_path, monkeypatch):
    trainer_parity("step3", tmp_path, monkeypatch)
