"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
plain reference loads nothing of the port either."""
import json
import subprocess
import sys

from ._small import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "mdilss_tpu"]

LOAD_ALL = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.run, benchmark.calibrate, benchmark.faults
from benchmark import harness
for cell in json.load(open({str(ROOT / 'BENCHMARK.json')!r}))["workloads"]:
    c = harness.Cell.load({str(ROOT)!r}, cell["name"])
    c.loop_class(); c.model_module(); c.readers()
print(json.dumps(sorted(sys.modules)))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.erfnet_rap, benchmark.reference.train
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_the_harness_loads_no_jax():
    top = _loaded(LOAD_ALL)
    assert "mdilss_tpu_torch" in top  # the program under test is loaded
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded(LOAD_REFERENCE)
    assert not top & set(FORBIDDEN + ["mdilss_tpu_torch"]), top & set(FORBIDDEN + ["mdilss_tpu_torch"])


def test_forbidden_names_are_compared_whole():
    import types

    from benchmark import harness

    planted = ["jax.numpy", "jaxlib", "mdilss_tpu.ops", "mdilss_tpu_torch_probe", "jaxtyping_probe"]
    added = [n for n in planted if n not in sys.modules]
    for n in added:
        sys.modules[n] = types.ModuleType(n)
    try:
        found = set(harness.forbidden_loaded()) & set(planted)
    finally:
        for n in added:
            del sys.modules[n]
    assert found == {"jax.numpy", "jaxlib", "mdilss_tpu.ops"} & set(added)
