"""chip_smoke.py's split of the train step's device time by family
(`ms_by_family`, read from a chrome trace of one profiled step), on a
hand-made trace: each device event is placed by the names around its launch
(its runtime call by correlation, else the torch op of its External id), a
backward op also by those around the forward op of its sequence number, what
has no launch by its own name; the port's own kernels are left out."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _trace():
    py, op, rt, k = "python_function", "cpu_op", "cuda_runtime", "kernel"
    return [
        # Adam: a kernel launched inside an op inside the optimiser's frame
        _span(py, "mdilss_tpu_torch/train/optim.py(10): adam_step", 1, 0, 100),
        _span(op, "aten::_foreach_add_", 1, 10, 20, **{"External id": 1}),
        _span(rt, "cudaLaunchKernel", 1, 15, 1, correlation=100),
        _span(k, "multi_tensor_apply_kernel", 7, 1000, 5000, correlation=100,
              **{"External id": 1}),
        # a forward op in the BN glue, and its backward on another thread
        _span(py, "mdilss_tpu_torch/ops/norm.py(5): batch_norm_train", 1, 200, 50),
        _span(op, "aten::mul", 1, 210, 10, **{"External id": 2, "Sequence number": 7}),
        _span(op, "autograd::engine::evaluate_function: MulBackward0", 2, 500, 30,
              **{"External id": 3, "Sequence number": 7}),
        _span(op, "aten::mul", 2, 505, 10, **{"External id": 4}),
        _span(rt, "cudaLaunchKernel", 2, 507, 1, correlation=101),
        _span(k, "elementwise_kernel<mul>", 7, 7000, 3000, correlation=101),
        # no runtime event: found by the op's External id
        _span(py, "mdilss_tpu_torch/losses.py(3): kld", 1, 300, 40),
        _span(op, "aten::sum", 1, 310, 10, **{"External id": 5}),
        _span(k, "reduce_kernel<sum>", 7, 11000, 2000, **{"External id": 5}),
        # a copy launched from the model
        _span(py, "mdilss_tpu_torch/models/blocks.py(9): forward", 1, 400, 20),
        _span(rt, "cudaMemcpyAsync", 1, 405, 1, correlation=103),
        _span("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 7, 14000, 500, correlation=103),
        # the port's own kernel is left out; unplaced kernels go by their name
        _span(rt, "cudaLaunchKernel", 1, 450, 1, correlation=102),
        _span(k, "void (anonymous namespace)::fwd_pair_mma_kernel<64>(float const*)", 7, 15000,
              9000, correlation=102),
        _span(k, "sm90_xmma_fprop_implicit_gemm", 7, 25000, 4000),
        _span(k, "mystery_kernel", 7, 30000, 1000),
        {"ph": "M", "name": "process_name", "tid": 0, "args": {"name": "python"}},
    ]


def test_ms_by_family_places_each_kernel_by_its_launch(smoke):
    ms, top, counts = smoke.ms_by_family(_trace())
    assert ms == pytest.approx({
        "cuDNN conv and its backward": 4.0, "Adam": 5.0, "losses over the logits": 2.0,
        "BN and dropout glue, K2/K3 operands": 3.0, "model glue (layout, pooling, concat)": 0.5,
        "unattributed": 1.0})
    assert list(ms) == [f for f in [f for f, _ in smoke.FAMILIES] + ["unattributed"] if f in ms]
    assert counts == {"device_events": 6, "launch_found": 4, "placed_by_name": 4}
    assert top["BN and dropout glue, K2/K3 operands"] == [["elementwise_kernel<mul>", 3.0]]
    assert not any("fwd_pair_mma_kernel" in name for rows in top.values() for name, _ in rows)
