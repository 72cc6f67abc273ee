"""The kernel names chip_smoke.py's profile tables look for (K1_KERNEL,
PAIR_KINDS, OWN_KERNELS) are kernels of the port's CUDA sources, read as text
with no nvcc: a renamed kernel then fails here, not as "not measured" or as a
kernel placed in the wrong family on the card. Also K3's bound split by launch
kind (`chip_smoke.k3_kind_bounds`): its FLOPs sum to the whole call's, and at
6x512x1024 in bf16 the kinds' operation bounds over one student backward are
dc 0.303, du 0.194 and wgrad 0.345 ms; K2's bound over one student forward
in bf16 is 0.453 ms."""
import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mdilss_tpu_torch" / "csrc"
BLOCK_NAMES = ("enc64_d1_rap", "enc128_d2_rap", "enc128_d4_rap", "enc128_d8_rap",
               "enc128_d16_rap", "dec64_d1", "dec16_d1")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_names(text: str) -> set[str]:
    """The names of the __global__ functions defined in a CUDA source."""
    names = set()
    for m in re.finditer(r"__global__\s+void\s+", text):
        rest = text[m.end():]
        if rest.startswith("__launch_bounds__"):
            depth = 0
            for i, ch in enumerate(rest):
                depth += {"(": 1, ")": -1}.get(ch, 0)
                if ch == ")" and depth == 0:
                    rest = rest[i + 1:]
                    break
        rest = re.sub(r"//[^\n]*", "", rest)
        names.add(re.match(r"\s*(\w+)\s*\(", rest).group(1))
    return names


@pytest.fixture(scope="module")
def kernels():
    names = set()
    for path in sorted(CSRC.glob("*.cu*")):
        names |= kernel_names(path.read_text())
    return names


def _matches(pattern: str, kernels: set[str]) -> set[str]:
    """The kernels a profiler-name pattern finds: a pattern is a substring of
    the demangled name, `(anonymous namespace)::name(...)`."""
    return {k for k in kernels if pattern in f"(anonymous namespace)::{k}("}


def test_the_sources_define_the_kernels(kernels):
    assert {"nb1d_pair_tf32_kernel", "fwd_pair_bf16_kernel", "reduce_kernel"} <= kernels
    assert len(kernels) >= 10


@pytest.mark.parametrize("table", ["K1_KERNEL", "PAIR_KINDS", "OWN_KERNELS"])
def test_every_profiled_name_is_a_kernel_of_the_sources(smoke, kernels, table):
    value = getattr(smoke, table)
    if table == "PAIR_KINDS":
        patterns = [p for kinds in value.values() for p in kinds.values()]
    elif isinstance(value, dict):
        patterns = list(value.values())
    else:
        patterns = list(value)
    assert patterns
    missing = [p for p in patterns if not _matches(p, kernels)]
    assert not missing, f"{table} names no kernel of csrc/: {missing}"


def test_each_launch_kind_names_one_kernel(smoke, kernels):
    """A kind's pattern finds exactly one kernel (the fixed-order sum is one
    kernel shared by K2 and K3), and no two kinds of one table find the same
    one, so a profile counts every launch once and in its own kind."""
    for (kind, dt), kinds in smoke.PAIR_KINDS.items():
        found = {k: _matches(p, kernels) for k, p in kinds.items()}
        assert all(len(v) == 1 for v in found.values()), (kind, dt, found)
        assert len(set.union(*found.values())) == len(found), (kind, dt, found)
    every = [p for kinds in smoke.PAIR_KINDS.values() for k, p in kinds.items() if k != "sum"]
    assert len({frozenset(_matches(p, kernels)) for p in every}) == len(every)


def test_every_kernel_of_the_sources_is_an_own_kernel(smoke, kernels):
    """ms_by_family leaves out the port's own kernels by OWN_KERNELS: every
    kernel of csrc/ must be one of them."""
    left = [k for k in kernels if not any(p in f"(anonymous namespace)::{k}("
                                          for p in smoke.OWN_KERNELS)]
    assert not left, left


@pytest.mark.parametrize("block", BLOCK_NAMES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k3_kind_bounds_sum_to_the_pair_bound(smoke, block, dt):
    name, c, d, rap, h, w, _ = next(b for b in smoke.BLOCKS if b[0] == block)
    whole = smoke.pair_bound(smoke.TRAIN_BATCH, c, h, w, rap, "bwd", dt)
    kinds = whole["kinds"]
    assert set(kinds) == set(smoke.K3_BOUND_KINDS)
    assert sum(k["flops"] for k in kinds.values()) == whole["flops"]
    for k in kinds.values():
        assert k["bound_ms"] == max(k["ops_ms"], k["bytes_ms"]) > 0
        assert k["bound_by"] == ("operations" if k["ops_ms"] >= k["bytes_ms"] else "bytes")


def test_k3_kind_bounds_over_one_student_backward(smoke):
    """Summed over the 34 pair calls (17 blocks x 2) at 6x512x1024 bf16: the
    operation bounds dc 0.303, du 0.194, wgrad 0.345 ms (989 TFLOP/s)."""
    assert smoke.TRAIN_BATCH == 6 and (smoke.HEIGHT, smoke.WIDTH) == (512, 1024)
    assert sum(b[-1] for b in smoke.BLOCKS) == 17
    ops = dict.fromkeys(smoke.K3_BOUND_KINDS, 0.0)
    for _, c, _, rap, h, w, count in smoke.BLOCKS:
        for k, v in smoke.k3_kind_bounds(smoke.TRAIN_BATCH, c, h, w, rap, "bf16").items():
            ops[k] += 2 * count * v["ops_ms"]
    assert {k: round(v, 3) for k, v in ops.items()} == {"dc": 0.303, "du": 0.194, "wgrad": 0.345}


def test_k2_bf16_bound_over_one_student_forward(smoke):
    """pair_bound summed over the 34 pair calls of one student forward at
    6x512x1024 bf16: 0.453 ms (operations 0.345, bytes 0.392), the yardstick
    phase 16 prints beside K2 bf16's device ms."""
    assert smoke.TRAIN_BATCH == 6 and (smoke.HEIGHT, smoke.WIDTH) == (512, 1024)
    got = smoke.student_pass_bound("fwd", "bf16")
    assert {k: round(v, 3) for k, v in got.items()} == {
        "bound_ms": 0.453, "ops_ms": 0.345, "bytes_ms": 0.392}
