"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the measured program. Top-level names are
compared whole: ``dynamorph_tpu_torch`` begins with ``dynamorph_tpu``."""
import json
import subprocess
import sys

from bench_tiny import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "dynamorph_tpu"}


def _loaded(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            f"{code}\nimport json; print(json.dumps(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _loaded(
        "import yardstick.harness, yardstick.train, yardstick.readers\n"
        "from pathlib import Path\n"
        "from yardstick.spec import Spec\n"
        "s = Spec(Path('.'))\n"
        "[s.reader(m['name']) for m in s.bench['end_to_end'] + "
        "s.bench['per_layer']]")
    assert "dynamorph_tpu_torch" in mods and "torch" in mods
    assert not mods & JAX


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import reference.vqvae")
    assert not mods & (JAX | {"dynamorph_tpu_torch", "yardstick"})


def test_forbidden_check_compares_whole_names():
    from yardstick.train import FORBIDDEN, forbidden_modules
    assert "dynamorph_tpu" in FORBIDDEN
    sys.modules.setdefault("dynamorph_tpu_torch", sys.modules[__name__])
    assert "dynamorph_tpu" not in forbidden_modules() or \
        "dynamorph_tpu" in {m.split(".")[0] for m in sys.modules}
