"""The frozen arithmetic: the bounds reproduce the figures the bring-up
recorded, the model-FLOP count equals a count of the plain reference's own
ops, and a time equal to its bound reads 100%."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs, roofline
from benchmark.reference.erfnet_rap import Forward


def test_bounds_reproduce_the_recorded_figures():
    # ms at 6x512x1024 float32, against 3xTF32 and 3.35 TB/s
    assert roofline.k1_forward_bound_ms(6, 512, 1024, "float32") == pytest.approx(2.071, abs=5e-4)
    assert roofline.student_pass_bound(6, 512, 1024, "fwd", "float32") == pytest.approx(2.131, abs=5e-4)
    assert roofline.student_pass_bound(6, 512, 1024, "bwd", "float32") == pytest.approx(5.080, abs=5e-4)
    g = roofline.glue_bound(6, 512, 1024, "float32")
    assert 2 * g["fwd_bwd_ms"] == pytest.approx(7.422, abs=5e-4)
    assert 3 * g["fwd_bwd_ms"] + 2 * g["fwd_ms"] == pytest.approx(12.305, abs=5e-4)


def test_peaks():
    assert roofline.effective_peak_flops("float32") == pytest.approx(165e12)
    assert roofline.effective_peak_flops("bfloat16") == pytest.approx(989e12)


@pytest.mark.parametrize("num_classes,task", [([20], 0), ([20, 20, 27], 2)])
def test_flops_equal_the_references_own_count(num_classes, task):
    h, w, n = 64, 128, 2
    gen = torch.Generator().manual_seed(3)
    sd = inputs.state_dict(num_classes, gen, torch.device("cpu"))
    x = torch.rand(n, h, w, 3, generator=gen)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        Forward(sd, task, train=False)(x)
    want = counter.get_total_flops()
    assert roofline.pass_flops(n, h, w, num_classes[task], False) == want
    assert roofline.pass_flops(n, h, w, num_classes[task], True) == 3 * want


def test_the_published_count():
    # 60.2 GFLOP per 512x1024 image forward on a 20-class head
    assert 2 * roofline.forward_macs(512, 1024, 20) == pytest.approx(60.2e9, rel=1e-3)


@pytest.mark.parametrize("bound", [0.5, 2.071, 12.305])
def test_a_time_at_its_bound_reads_100(bound):
    assert roofline.share(bound, bound) == pytest.approx(100.0)
    assert roofline.share(bound, 2 * bound) == pytest.approx(50.0)
    assert roofline.share(bound, 0.0) is None
