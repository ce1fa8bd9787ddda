"""The port's CUDA sources against what calls them, read as text: a
mismatch here would first show on the card, as a cut pointer or a kernel
the profiler does not count.

For each of the four kernel libraries (``slcl_torch/csrc/<name>.cu``):
- every C function in its wrapper's ``_SIGS`` is defined ``extern "C"`` in
  the source with as many parameters as ``_SIGS`` gives ctypes;
- every ``chip_smoke.py`` ``SYMBOLS`` entry, occupancy query and profiler
  name part of the library names a function of the source;
- the source's header names the ``slcl_tpu/ops/pallas/*.py`` function it
  replaces, and that function exists.

Reads files only: no CUDA, no nvcc.
"""
import importlib
import itertools
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "slcl_torch" / "csrc"
LIBS = ("mpcl", "mpcl_pseudo", "pseudo_label", "soft_centroids")

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (imports the standard library only at top level)


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def _source_with_includes(name: str) -> str:
    """The library's .cu with the headers it includes, recursively."""
    seen, out, todo = set(), [], [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        text = (CSRC / f).read_text()
        out.append(text)
        todo += re.findall(r'#include "([\w.]+)"', text)
    return "\n".join(out)


def _extern_c_functions(src: str) -> dict:
    """{name: number of parameters} of the functions defined inside the
    source's extern "C" blocks."""
    src = _strip_comments(src)
    funcs = {}
    for block in re.finditer(r'extern "C" \{(.*?)\n\} ', src, re.S):
        for m in re.finditer(r"^(?:[\w*]+\s+)+?(\w+)\(([^)]*)\)\s*\{", block.group(1), re.M):
            params = [p for p in m.group(2).split(",") if p.strip()]
            funcs[m.group(1)] = len(params)
    return funcs


def _global_kernels(src: str) -> set:
    src = _strip_comments(src)
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                          src))


@pytest.mark.parametrize("name", LIBS)
def test_sigs_match_extern_c_definitions(name):
    wrapper = importlib.import_module(f"slcl_torch.ops.cuda.{name}")
    funcs = _extern_c_functions((CSRC / f"{name}.cu").read_text())
    assert wrapper._SIGS, name
    for fn, (_restype, argtypes) in wrapper._SIGS.items():
        assert fn in funcs, f'{fn} is not defined extern "C" in csrc/{name}.cu'
        assert funcs[fn] == len(argtypes), (
            f"{fn}: {funcs[fn]} parameters in csrc/{name}.cu, {len(argtypes)} in _SIGS")


@pytest.mark.parametrize("name", LIBS)
def test_chip_smoke_names_kernels_of_the_source(name):
    kernels = _global_kernels(_source_with_includes(name))
    wrapper = importlib.import_module(f"slcl_torch.ops.cuda.{name}")
    mine = [k for k, (src, _) in chip_smoke.SYMBOLS.items() if src == name]
    assert mine, f"no SYMBOLS entry for {name}"
    for kname in mine:
        _, sym = chip_smoke.SYMBOLS[kname]
        assert sym.split("I", 1)[0] in kernels, f"SYMBOLS[{kname!r}] = {sym!r}"
        query, args = chip_smoke.OCCUPANCY[kname]
        assert query in wrapper._SIGS, f"OCCUPANCY[{kname!r}] calls {query}"
        assert len(args) + 2 == len(wrapper._SIGS[query][1]), query
    for part in chip_smoke.PORT_KERNELS[name]:
        stem = part.rstrip("<")
        hits = {k for k in kernels if (k == stem if part.endswith("<") else k.startswith(stem))}
        assert hits, f"profiler name part {part!r} names no __global__ in {name}"
    assert set(chip_smoke.PORT_KERNELS) == set(LIBS)
    assert set(chip_smoke.SYMBOLS) == set(chip_smoke.OCCUPANCY) == set(chip_smoke.PER_STEP)


@pytest.mark.parametrize("name", LIBS)
def test_header_names_the_pallas_function_it_replaces(name):
    lines = (CSRC / f"{name}.cu").read_text().splitlines()
    header = " ".join(line[2:].strip()
                      for line in itertools.takewhile(lambda ln: ln.startswith("//"), lines))
    m = re.search(r"Replaces (slcl_tpu/ops/pallas/\w+\.py)::(\w+)", header)
    assert m, f"csrc/{name}.cu does not name the Pallas function it replaces"
    path, fn = ROOT / m.group(1), m.group(2)
    assert path.is_file(), path
    assert re.search(rf"^def {fn}\(", path.read_text(), re.M), f"{fn} not in {path.name}"
