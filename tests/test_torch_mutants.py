"""chip_smoke.py's mutation check, ablations and profile gates against
the kernel sources, on the CPU (no nvcc needed): every mutant's and
ablation's text occurs exactly once in the source it names under
paddle_tpu_torch/csrc/, every mutant names phases that chip_smoke
defines, and every kernel symbol the profiled steps must run is a
__global__ kernel of csrc/. A kernel redesign that
drops a mutant's text or renames a kernel fails here, not first on the
card."""
import glob
import importlib.util
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
ENTRIES = ([("mutant", m[0]) for m in SMOKE.MUTANTS] +
           [("ablation", a[0]) for a in SMOKE.ABLATIONS] +
           [("symbol", s) for s in (*SMOKE.BF16_KERNEL_SYMBOLS,
                                    *SMOKE.F32_KERNEL_SYMBOLS)])


def _kernels():
    """Names of the __global__ functions in csrc/*.cu."""
    names = set()
    for path in glob.glob(os.path.join(CSRC, "*.cu")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", f.read()))
    return names


@pytest.mark.parametrize("kind,name", ENTRIES,
                         ids=[f"{k}-{n}" for k, n in ENTRIES])
def test_mutation_check_and_gates_name_the_sources(kind, name):
    if kind == "symbol":
        assert name in _kernels(), f"{name} is no __global__ kernel of csrc/"
        return
    if kind == "ablation":
        (_, edits), = [a for a in SMOKE.ABLATIONS if a[0] == name]
        for source, old, new in edits:
            with open(os.path.join(CSRC, source)) as f:
                assert f.read().count(old) == 1, f"{name}: text not once"
            assert old != new
        return
    (_, source, old, new, phases), = [m for m in SMOKE.MUTANTS
                                      if m[0] == name]
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    assert text.count(old) == 1, f"{name}: text not once in {source}"
    assert old != new
    assert phases and all(callable(getattr(SMOKE, fn, None))
                          for fn in phases), phases
