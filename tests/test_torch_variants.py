"""The kernel-variant tools (tools_torch/k1_variants.py, k2_variants.py,
k3_variants.py) build their variants as text substitutions of the committed
sources, and a substitution whose text is not found raises. This applies
every variant of each tool to the sources as text, with no nvcc, so a change
that moves the text a variant edits shows here rather than on the card."""
import importlib.util
from pathlib import Path

import pytest

TOOLS = Path(__file__).resolve().parents[1] / "tools_torch"


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool,expected", [
    ("k1_variants", {"as_built", "cuda_cores", "one_cta", "presplit_w", "stages4", "kc64",
                     "narrow"}),
    ("k2_variants", {"as_built", "cuda_cores", "c_split", "ring3", "ring4", "tm_smaller",
                     "one_cta", "bf16_ring2", "bf16_ring3", "bf16_w_streamed", "bf16_kc32", "bf16_walkers_132",
                     "bf16_walkers_half", "bf16_cta_per_tile", "bf16_rap_stages",
                     "bf16_params_global", "bf16_cta256_mt4", "diag_no_products",
                     "diag_no_y_stores", "diag_no_u_loads", "diag_no_pre"}),
    ("k3_variants", {"as_built", "one_level", "lo_truncated", "stages2", "stages4",
                     "bf16_kc_pair", "bf16_conv_cta256", "bf16_dc_no_halo", "bf16_wgrad_no_halo",
                     "bf16_wgrad_walkers_half", "bf16_wgrad_by_matrix"}),
])
def test_every_variant_applies_to_the_committed_sources(tool, expected):
    mod = _tool(tool)
    committed = mod.committed()
    table = mod.variants(committed)
    assert set(table) == expected
    assert table["as_built"] == {}
    for name, files in table.items():
        assert name == "as_built" or files, name
        for fname, text in files.items():
            assert fname in committed and text != committed[fname], (name, fname)
    order = getattr(mod, "ORDER", ())
    runs = [n for o in order.values() for n in o] if isinstance(order, dict) else list(order)
    assert set(runs) <= set(table), set(runs) - set(table)
