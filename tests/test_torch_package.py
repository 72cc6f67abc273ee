"""What the port's package and chip_smoke.py may import: nothing of JAX and
nothing of the JAX package (a grep over the sources and an import in a fresh
interpreter), and no PIL, sklearn or matplotlib at import time (the card's
machine is not known to have them; `decode_pair`'s fallback, `save_predictions`
and `tsne_embed` / `plot_tsne` import them when they run)."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mdilss_tpu)(\.|\s|$)", re.M)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dp, _, fs in os.walk(os.path.join(REPO, "mdilss_tpu_torch")):
        out += [os.path.join(dp, f) for f in fs if f.endswith(".py")]
    return out


def test_no_jax_import_in_the_port_sources():
    hits = []
    for path in _port_sources():
        with open(path) as f:
            hits += [f"{path}: {m.group(0).strip()}" for m in FORBIDDEN.finditer(f.read())]
    assert not hits, hits


def test_importing_the_port_loads_no_jax_and_no_pil():
    """Every module (parity, analysis.tsne, analysis.predict and serving among
    them) and chip_smoke, with PIL, sklearn and matplotlib made unimportable."""
    mods = sorted(os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
                  for p in _port_sources() if not p.endswith("chip_smoke.py"))
    code = (
        "import sys, importlib\n"
        "for m in ('PIL', 'sklearn', 'matplotlib'):\n"
        "    sys.modules[m] = None  # an import of it raises\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mdilss_tpu', 'PIL', 'sklearn', 'matplotlib') "
        "and sys.modules[m] is not None)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
