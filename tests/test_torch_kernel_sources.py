"""The port's CUDA sources against what calls them, read as text: a
mismatch here would first show on the card, as a cut pointer or a kernel
the profiler does not count.

For each of the four kernel libraries (``slcl_torch/csrc/<name>.cu``):
- every C function in its wrapper's ``_SIGS`` is defined ``extern "C"`` in
  the source with as many parameters as ``_SIGS`` gives ctypes;
- every ``chip_smoke.py`` ``SYMBOLS`` entry, occupancy query and profiler
  name part of the library names a function of the source, and every
  ``__global__`` of the source and its includes is counted by some profiler
  name part (a final-pass kernel must not drop out of the profile's sum);
- a source that makes a bulk copy gets it from ``ring.cuh``, the entry
  points that size the forwards' partial buffers are in ``_SIGS``, and every
  persistent grid's cached size is keyed by its kernel;
- every source that gives a row a label, a mask or a margin softmax takes
  the row's cosines from ``stream_cosines``, the one cosine routine, and
  ``pseudo_label.cu`` holds no arithmetic of its own;
- every text edit of ``tools/ring_variants.py`` applies to the sources as
  they stand, and its timed kernels' symbols name kernels of their sources;
- the source's header names the ``slcl_tpu/ops/pallas/*.py`` function it
  replaces, and that function exists;
- the soft centroids' std variant is a compile-time switch: every use of
  ``kStd`` is a template parameter or argument, a constant expression or an
  ``if constexpr``, and once its ``if constexpr (kStd)`` blocks and its own
  functions and tile types (``*std*`` / ``*Std*``) are taken out no std
  arithmetic is left, so the std-free instantiations are the code they
  were; both std kernels take a persistent grid from ``ring_grid``; no sum
  there uses a float atomic;
- the soft centroids' two backwards run on one ring loop, the std-free one
  with a persistent grid from ``ring_grid`` and its tile type's shared
  memory (the first grid-stride body is gone), and every shared -> global
  bulk store is fenced for the async proxy before it and read out of its
  stage before the stage is filled again;
- the general centroid backward reads its rows through ``ring.cuh``'s bulk
  copies on a ``ring_grid`` grid at its plan's shared memory, sums no row
  with shuffles, and its plan's constants are the Python side's;
- the general (runtime-shape) family keeps the same rules: its
  ``__global__``s are launched through extern "C" entries that ``_SIGS``
  binds, named in ``chip_smoke.py`` and counted by the profiler; its
  headers name the Pallas functions they replace; its cosines come from
  the one ``stream_cosines`` (with the width and class count at run time);
  and no source holds a float atomic.

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
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke  # noqa: E402  (imports the standard library only at top level)
import ring_variants  # noqa: E402  (the same)
from slcl_torch.ops.cuda import IP  # noqa: E402


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
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+"   # one level of nesting
    return set(re.findall(rf"__global__\s+void\s+(?:{bounds})?(\w+)\(", src))


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


@pytest.mark.parametrize("name", LIBS)
def test_profiler_counts_every_global_kernel(name):
    parts = sum(chip_smoke.PORT_KERNELS.values(), ())
    for kernel in _global_kernels(_source_with_includes(name)):
        # the profiler shows "name<...>(" for a template, "name(" otherwise
        assert any(p in kernel + "<" or p in kernel + "(" for p in parts), (
            f"no chip_smoke.PORT_KERNELS part counts {kernel} (csrc/{name}.cu)")


@pytest.mark.parametrize("name", LIBS)
def test_bulk_copies_come_from_ring_header(name):
    """Every file that makes a bulk copy or touches an mbarrier includes
    ring.cuh, and only ring.cuh writes their PTX."""
    files = sorted(CSRC.glob("*.cu*"))
    assert CSRC / f"{name}.cu" in files
    for path in files:
        text = _strip_comments(path.read_text())
        if path.name == "ring.cuh":
            assert "cp.async.bulk" in text and "mbarrier.try_wait" in text
            continue
        assert "cp.async.bulk" not in text and "mbarrier." not in text, path.name
        if re.search(r"\b(bulk_copy|mbar_\w+)\(", text):
            assert '#include "ring.cuh"' in text, f"{path.name} calls the ring without ring.cuh"
    if re.search(r"\bbulk_copy\(", _source_with_includes(name)):
        assert "ring.cuh" in _source_with_includes(name)


@pytest.mark.parametrize("lib,entry", [("mpcl", "mpcl_num_partials"),
                                       ("mpcl_pseudo", "mpcl_pseudo_num_partials"),
                                       ("soft_centroids", "soft_centroids_partials_size"),
                                       ("mpcl", "mpcl_gen_num_partials"),
                                       ("mpcl_pseudo", "mpcl_pseudo_gen_num_partials"),
                                       ("soft_centroids", "soft_centroids_gen_partials_size")])
def test_partials_entry_points_are_bound(lib, entry):
    """The wrappers size the forwards' partial buffers from the ring's grid:
    the entry point is in _SIGS, returns its count through a pointer, and
    the wrapper calls it."""
    wrapper = importlib.import_module(f"slcl_torch.ops.cuda.{lib}")
    assert entry in wrapper._SIGS
    _restype, argtypes = wrapper._SIGS[entry]
    assert argtypes[-1] is IP
    assert f"lib.{entry}(" in Path(wrapper.__file__).read_text()
    assert "ring_grid<" in _source_with_includes(lib)


@pytest.mark.parametrize("name", LIBS)
def test_ring_grid_cache_is_keyed_by_the_kernel(name):
    """ring_grid caches a slot count per template instantiation: the kernel
    is a template argument, so kernels that share a signature and a tile
    type cannot share an entry (and launch each other's grid)."""
    ring = _strip_comments((CSRC / "ring.cuh").read_text())
    assert re.search(r"template <typename G, auto kKern>\s+static int ring_grid\(int M,", ring)
    src = _strip_comments(_source_with_includes(name))
    kernels = _global_kernels(src)
    for call in re.findall(r"ring_grid<(.*?)>\(M,", src.split("static int ring_grid", 1)[-1],
                           re.S):
        assert any(re.search(rf"\b{k}<", call) for k in kernels), (
            f"ring_grid<{call}> in csrc/{name}.cu names no __global__ of the source")


@pytest.mark.parametrize("path", sorted(CSRC.glob("*.cu*")), ids=lambda p: p.name)
def test_one_cosine_routine_for_every_label(path):
    """A kernel that derives a label or a mask (row_pseudo_label) or the
    margin softmax or its gradient from a row's cosines gets them from
    stream_cosines: the two-op route and the fused route then agree by
    construction. The norm and the dot products against the prototypes are
    written once, in mpcl_row.cuh."""
    text = _strip_comments(path.read_text())
    assert "row_cosines" not in path.read_text(), f"{path.name} still cites row_cosines"
    if re.search(r"\b(row_pseudo_label|margin_softmax|margin_grad)<", text):
        assert "stream_cosines<" in text, (
            f"{path.name} labels a row without stream_cosines")
    if path.name == "mpcl_row.cuh":
        assert len(re.findall(r"\bvoid stream_cosines\(", text)) == 1
        assert len(re.findall(r"rsqrtf\(ss \+ 1e-24f\)", text)) == 1
    else:
        assert "1e-24f" not in text, f"{path.name} normalises a row itself"
    if path.suffix == ".cu" and "soft_centroids" not in path.name:
        # the MPCL and pseudo-label sources are thin kernels over the tile
        # headers: no dot product, norm or argmax of their own
        for own in ("fmaf(", "rsqrtf(", "expf(", "best", "second"):
            assert own not in text, f"{path.name} holds arithmetic of its own: {own}"


def test_pseudo_label_kernel_runs_on_the_shared_tile_loop():
    text = _strip_comments((CSRC / "pseudo_label.cu").read_text())
    assert '#include "mpcl_fwd_tile.cuh"' in text
    assert "pseudo_label_tiles<T, F>(" in text and "ring_grid<" in text
    tile = _strip_comments((CSRC / "mpcl_fwd_tile.cuh").read_text())
    body = tile.split("void pseudo_label_tiles(", 1)[1]
    assert "row_pseudo_label<kC>(cosv" in body and "fwd_rows<T, F>(" in body
    # all three kernels go through the one loop, which takes the cosines
    assert len(re.findall(r"stream_cosines<T, F, F / 8>\(", tile)) == 1
    assert len(re.findall(r"fwd_rows<T, F>\(", tile)) == 2


@pytest.mark.parametrize("variant", sorted(ring_variants.VARIANTS))
def test_ring_variant_edits_apply(variant):
    kernels, edits = ring_variants.VARIANTS[variant]
    assert kernels
    texts = {}
    for f, old, new in edits:
        text = texts.get(f) or (CSRC / f).read_text()
        assert old in text, f"variant {variant}: an edit no longer applies to csrc/{f}"
        assert old != new
        texts[f] = text.replace(old, new)
    for kernel in kernels:
        lib = ring_variants.LIB_OF[kernel]
        assert lib in LIBS
        sym = ring_variants.SYMBOL_OF[kernel].split("I13", 1)[0]
        assert sym in _global_kernels(_source_with_includes(lib))


# the std variant's own functions (name holding "std") and tile types
STD_FUNCS = ("centroids_fwd_std_partial", "centroids_bwd_std", "std_block", "std_fwd_row",
             "std_store_sq", "std_bwd_coefs", "std_bwd_row", "std_fwd_grid_of",
             "std_bwd_grid_of")


def _without_std_blocks(src: str) -> str:
    """The source with every ``if constexpr (kStd) { ... }`` block, and the
    definition of every function whose name holds ``std`` and of every
    struct whose name holds ``Std``, cut out (braces matched)."""
    out, i = [], 0
    heads = re.compile(r"if constexpr \(kStd\) \{|\b\w*std\w*\([^;{]*\)\s*\{"
                       r"|struct \w*Std\w* \{")
    while True:
        m = heads.search(src, i)
        if not m:
            return "".join(out) + src[i:]
        out.append(src[i:m.start()])
        depth, j = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(src[j], 0)
            j += 1
        i = j


def test_std_variant_is_a_compile_time_switch():
    src = _strip_comments((CSRC / "soft_centroids.cu").read_text())
    kernels = src.split("extern \"C\"", 1)[0]
    for line in kernels.splitlines():
        if not re.search(r"\bkStd\b", line):
            continue
        rest = re.sub(r"bool kStd|if constexpr \(kStd\)|<[^<>;]*\bkStd\b[^<>;]*>+", "", line)
        if re.search(r"\bkStd\b", rest):
            assert "constexpr" in line or re.search(r"\[[^\]]*\bkStd\b[^\]]*\]", line), (
                f"kStd read at run time: {line.strip()}")
    rest = _without_std_blocks(kernels)
    # (the dispatch may name the std kernels, their grids and tile types)
    for name in (r"\bsq\[", r"\bgstd\[", r"\bs2\[", r"\bstdv\[", r"\bx2\b", r"\bs_aw\b",
                 r"\bstd_(block|fwd_row|store_sq|bwd_coefs|bwd_row)<"):
        assert not re.search(name, rest), f"{name} outside the std variant's code"
    # the std variant's code exists and was cut: its own functions, and the
    # final pass's class blocks (the one kStd branch left in shared code)
    for fn in STD_FUNCS:
        assert re.search(rf"\b{fn}\(", kernels) and not re.search(rf"\b{fn}\(", rest), fn
    assert kernels.count("if constexpr (kStd)") >= 1


@pytest.mark.parametrize("kernel,grid", [("centroids_fwd_std_partial", "std_fwd_grid_of"),
                                         ("centroids_bwd_std", "std_bwd_grid_of")])
def test_std_kernels_take_their_grid_from_ring_grid(kernel, grid):
    """Each std kernel runs on a persistent grid of its own: its grid
    function asks ring_grid for the kernel's slots, and the launch takes
    that grid and the tile type's dynamic shared memory."""
    src = _strip_comments((CSRC / "soft_centroids.cu").read_text())
    body = src.split(f"int {grid}(", 1)[1].split("\n}", 1)[0]
    assert re.search(rf"ring_grid<\w+<T, F, P>,\s*{kernel}<T, F, P, slcl::kC>>\(M,", body)
    # the launch follows the grid's query, before any other kernel's
    launch = src.split(f"{grid}<T, kF, kP>(M, &grid)", 1)[1].split("<<<", 1)[0]
    assert launch.rstrip().endswith(f"{kernel}<T, kF, kP, kC>"), launch
    assert "kSmem = " in launch


def test_centroid_backward_takes_its_grid_from_ring_grid():
    """The std-free backward runs on the std backward's ring loop, on a
    persistent grid of its own: its grid function asks ring_grid for the
    kernel's slots, and its launch and occupancy query take that grid and
    the tile type's dynamic shared memory. The first grid-stride body and the
    grid it sized are gone."""
    src = _strip_comments((CSRC / "soft_centroids.cu").read_text())
    body = src.split("int bwd_grid_of(", 1)[1].split("\n}", 1)[0]
    assert re.search(r"ring_grid<BwdTiles<T, F, P>,\s*centroids_bwd<T, F, P, slcl::kC>>\(M,", body)
    launch = re.split(r"\bbwd_grid_of<T, kF, kP>\(M, &grid\)", src)[1].split("<<<", 1)[0]
    assert launch.rstrip().endswith("centroids_bwd<T, kF, kP, kC>"), launch
    assert "kSmem = BwdTiles<T, kF, kP>::kSmemBytes" in launch
    assert re.search(r"occupancy\(centroids_bwd<T, kF, kP, kC>,\s*BwdTiles<T, kF, kP>::kSmemBytes",
                     src)
    for kernel, std in (("centroids_bwd", "false"), ("centroids_bwd_std", "true")):
        body = re.split(rf"\n{kernel}\(", src)[1].split("\n}", 1)[0]
        assert f"bwd_ring<T, F, P, C, {std}>(" in body, kernel
    all_src = "".join(_strip_comments(f.read_text()) for f in CSRC.glob("*.cu*"))
    assert "bwd_rows" not in all_src and "grid_for(" not in all_src


@pytest.mark.parametrize("name", LIBS)
def test_bulk_stores_are_fenced_and_read_out_before_the_next_fill(name):
    """A shared -> global bulk store follows, in its tile, the async-proxy
    fence of the threads that wrote the stage and the empty barrier that
    orders those writes before it; before the stage is filled again its
    thread waits until the store has read it, and before the block exits
    until every store has completed."""
    src = _strip_comments(_source_with_includes(name))
    stores = [m.start() for m in re.finditer(r"\bbulk_store\(", src)]
    ring = _strip_comments((CSRC / "ring.cuh").read_text())
    assert "cp.async.bulk.global.shared::cta.bulk_group" in ring
    assert "cp.async.bulk.wait_group.read" in ring and "fence.proxy.async.shared::cta" in ring
    if name == "soft_centroids":
        # the helper's definition; dfeats and dprobs of the templated
        # backward's ring and of the general one's
        assert len(stores) == 5
    for at in stores:
        if re.match(r"bulk_store\(void\* dst", src[at:]):
            continue   # the helper itself, in ring.cuh
        before = src[:at]
        tile = before[before.rindex("mbar_wait(&full"):]
        fence = tile.index("fence_proxy_async()")
        arrive = tile.index("mbar_arrive(&empty", fence)
        tile.index("mbar_wait(&empty", arrive)
        after = src[at:]
        nxt = after.index("fill(")
        assert "bulk_wait_read<" in after[:nxt], "a stage refilled before its store read it"
        assert "bulk_commit()" in after[:nxt]
        assert "bulk_wait_all()" in after, "the block may exit before its stores complete"


def test_centroid_sums_use_no_float_atomics():
    src = _strip_comments((CSRC / "soft_centroids.cu").read_text())
    assert "atomic" not in src


# ---- the general (runtime-shape) family ----
GENERAL_HEADERS = {
    "general.cuh": ("mpcl_kernel.py::mpcl_loss_fused", "mpcl_pseudo_kernel.py::mpcl_pseudo_fused",
                    "pseudo_label_kernel.py::pseudo_label_fused"),
    "centroids_gen.cuh": ("centroid_kernel.py::soft_centroids_fused",)}


@pytest.mark.parametrize("header", sorted(GENERAL_HEADERS))
def test_general_headers_name_the_pallas_functions_they_replace(header):
    lines = (CSRC / header).read_text().splitlines()
    text = " ".join(line[2:].strip()
                    for line in itertools.takewhile(lambda ln: ln.startswith("//"), lines))
    for ref in GENERAL_HEADERS[header]:
        assert f"slcl_tpu/ops/pallas/{ref}" in text, f"{header} does not name {ref}"
        path, fn = ref.split("::")
        src = (ROOT / "slcl_tpu" / "ops" / "pallas" / path).read_text()
        assert re.search(rf"^def {fn}\(", src, re.M), f"{fn} not in {path}"
    # every library that includes the header is one whose .cu names the same
    for lib in LIBS:
        if f'#include "{header}"' in (CSRC / f"{lib}.cu").read_text():
            head = (CSRC / f"{lib}.cu").read_text().split("#include", 1)[0]
            assert any(ref.split("::")[1] in head for ref in GENERAL_HEADERS[header]), lib


@pytest.mark.parametrize("name", LIBS)
def test_general_kernels_are_bound_named_and_counted(name):
    """Each general ``__global__`` of the library is named in chip_smoke.py
    and counted by one of the library's profiler name parts; each general
    extern "C" entry is bound in the wrapper's ``_SIGS``; and each general
    launch counter has its SYMBOLS entry in this library."""
    src = _source_with_includes(name)
    general = {k for k in _global_kernels(src) if "_gen" in k}
    assert general, f"no general kernel in csrc/{name}.cu"
    smoke = (ROOT / "chip_smoke.py").read_text()
    for k in general:
        assert k in smoke, f"chip_smoke.py does not name {k}"
        assert any(k.startswith(p.rstrip("<")) for p in chip_smoke.PORT_KERNELS[name]), k
    wrapper = importlib.import_module(f"slcl_torch.ops.cuda.{name}")
    entries = {fn for fn in _extern_c_functions((CSRC / f"{name}.cu").read_text())
               if "_gen" in fn}
    assert entries and entries <= set(wrapper._SIGS), entries - set(wrapper._SIGS)
    counters = {k.name for k in vars(wrapper).values()
                if type(k).__name__ == "Kernel" and k.name.endswith("_general")}
    assert counters, f"no general launch counter in ops/cuda/{name}.py"
    for kname in counters:
        assert chip_smoke.SYMBOLS[kname][0] == name, kname
        assert chip_smoke.SYMBOLS[kname][1].split("I", 1)[0] in general, kname


@pytest.mark.parametrize("path", sorted(CSRC.glob("*.cu*")), ids=lambda p: p.name)
def test_no_float_atomics_in_any_kernel(path):
    """Every sum, the general family's too, is in a fixed order: no
    atomics, so two launches give bit-identical results."""
    assert "atomic" not in _strip_comments(path.read_text()), path.name


def test_general_cosines_come_from_the_one_stream_cosines():
    """The general row loop takes each row's cosines from stream_cosines
    with the width and class count at run time (F = C = 0), once a row, and
    nothing in the general headers normalises a row or dots it with a
    prototype by itself; stream_cosines keeps one definition, whose
    compile-time form is the templated kernels'."""
    row = _strip_comments((CSRC / "mpcl_row.cuh").read_text())
    assert re.search(r"int F, int kUnroll = 1, int C = kC>\s*__device__ __forceinline__ void "
                     r"stream_cosines\(", row)
    assert "int f = F," in row and "int nc = C)" in row
    gen = _strip_comments((CSRC / "general.cuh").read_text())
    assert len(re.findall(r"\bstream_cosines<T, 0, 1, 0>\(", gen)) == 1
    assert "stream_cosines<" in gen and "row_pseudo_label<0>(" in gen
    for text in (gen, _strip_comments((CSRC / "centroids_gen.cuh").read_text())):
        assert "1e-24f" not in text and "rsqrtf(ss" not in text
        assert "s_cent[c * F + k] * " not in text



def _body(src: str, head: str) -> str:
    """The brace-matched body of the first definition that starts with
    ``head``."""
    i = src.index("{", src.index(head))
    depth, j = 1, i + 1
    while depth:
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        j += 1
    return src[i:j]


def test_general_centroid_backward_reads_its_rows_through_the_ring():
    """centroids_gen_bwd fills its stages with ring.cuh's bulk copies on
    a full barrier, takes its grid from ring_grid at its plan's rows and
    shared memory (not gen_grid), and no thread sums a row with shuffles:
    a row's partials are added through shared memory. The plan's
    constants are the ones ops/cuda/__init__.py mirrors."""
    gen = _strip_comments((CSRC / "centroids_gen.cuh").read_text())
    assert '#include "ring.cuh"' in gen and '#include "centroids_gen_plan.cuh"' in gen
    kernel = _body(gen, "centroids_gen_bwd(const T* __restrict__ feats")
    for part in ("slcl::bulk_copy(", "slcl::mbar_expect_tx(&full[stage]",
                 "slcl::mbar_wait(&full[stage], parity)", "gen_bwd_coefs<kStd>("):
        assert part in kernel, part
    assert "__shfl" not in kernel and "gen_warp_sum" not in kernel
    # each warp takes its own rows of a tile: no block-wide barrier a tile
    tiles = _body(kernel, "for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)")
    assert "__syncthreads" not in tiles and "__syncwarp();" in tiles
    rows = _body(tiles, "for (int q = 0; q < plan.npw; ++q)")
    assert "gen_load<V>(s_feat + r * F + k * V, x)" in rows
    src = _strip_comments((CSRC / "soft_centroids.cu").read_text())
    launch = _body(src, "int gen_bwd_launch(")
    assert re.search(r"slcl::ring_grid<slcl::centroids_gen_bwd<T, kS, kV, kForm>>\(\s*"
                     r"M, plan\.rows, plan\.smem, &grid\)", launch)
    assert "<<<grid, kThreads, plan.smem, st>>>" in launch and "gen_grid" not in launch
    assert "slcl::gen_bwd_plan(C, P, F, kS, sizeof(T), dprobs != nullptr)" in _body(
        src, "int gen_launch_bwd(")
    occ = _body(src, "int gen_occupancy_of(")
    assert "gen_occupancy<slcl::centroids_gen_bwd<T, kS, kV, kForm>>(" in occ
    assert "plan.smem" in occ
    ring = _strip_comments((CSRC / "ring.cuh").read_text())
    assert re.search(r"template <auto kKern>\s+static int ring_grid\(long long M, int rows, "
                     r"int smem_bytes, int\* grid\)", ring)
    plan = _strip_comments((CSRC / "centroids_gen_plan.cuh").read_text())
    from slcl_torch.ops import cuda as K
    assert f"kGenSmemLimit = 227 * 1024 - 1024;" in plan and K.SMEM_LIMIT == 227 * 1024 - 1024
    assert "kGenBwdBudget = 110 * 1024;" in plan and K.GEN_BWD_BUDGET == 110 * 1024
    assert "kGenTileBytes = 20 * 1024;" in plan and K.GEN_TILE_BYTES == 20 * 1024
    assert f"kGenRegClasses = {K.GEN_REG_CLASSES};" in plan
    assert f"kGenRegClassesStd = {K.GEN_REG_CLASSES_STD};" in plan


def test_general_centroid_forward_reads_its_rows_through_the_ring():
    """centroids_gen_fwd_partial's ring form fills its stages with ring.cuh's
    bulk copies on a full barrier, takes its grid from ring_grid at its
    plan's rows and shared memory (the partials' size from the same grid),
    sums on the tensor cores (ldmatrix and mma.sync into registers) and
    makes no read-modify-write of shared memory an element: the only
    shared-memory sums are the warps' totals, once a block. The grouped
    form (the first design) is kept for the shapes with no ring, chosen by
    the plan alone. The plan's constants are the ones ops/cuda/__init__.py
    mirrors."""
    gen = _strip_comments((CSRC / "centroids_gen.cuh").read_text())
    kernel = _body(gen, "centroids_gen_fwd_partial(const T* __restrict__ feats")
    grouped = _body(kernel, "if constexpr (kForm == kGenFwdGrouped)")
    ring = kernel[kernel.index(grouped) + len(grouped):]
    for part in ("slcl::bulk_copy(", "slcl::mbar_expect_tx(&full[stage]",
                 "slcl::mbar_wait(&full[stage], parity)", "ldsm_x4_trans(", "ldsm_x2(",
                 "mma_bf16(d, a[x]", "mma_bf16(x == 0 ? d : d2, q2[x]", "tot[i][j][e] += d[e]",
                 "bf16_terms("):
        assert part in ring, part
    tiles = _body(ring, "for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)")
    # a warp arrives on the stage's empty barrier once its product is done;
    # thread 0 refills a stage when every warp has, testing the barriers
    # without waiting on them (between its own steps and while it waits on
    # a full barrier); no barrier of the whole block a tile, the warps that
    # share rows sync among themselves
    assert tiles.index("slcl::mbar_arrive(&empty[stage])") > tiles.rindex("mma_bf16(")
    assert "slcl::mbar_test(&empty[s], epar[s])" in ring and "mbar_wait(&empty" not in ring
    assert tiles.count("poll();") == 2
    assert "__syncthreads" not in tiles and '"bar.sync %0, %1;"' in ring
    # no shared accumulator a row or an element: no fmaf, no += into an
    # array other than the register totals
    assert "fmaf(" not in tiles and "atomic" not in tiles
    assert set(re.findall(r"(\w+)\[[^\]]*\](?:\[[^\]]*\])*\s*\+=", tiles)) == {"tot"}
    assert "fmaf(" in grouped    # the first design's arithmetic, kept
    src = _strip_comments((CSRC / "soft_centroids.cu").read_text())
    grid = _body(src, "int gen_fwd_grid(")
    assert re.search(r"slcl::ring_grid<slcl::centroids_gen_fwd_partial<T, kS, kForm>>\(\s*"
                     r"M, plan\.rows, plan\.smem, grid\)", grid)
    assert "slcl::gen_grid(M, slcl::gen_cent_groups(F))" in grid
    for fn in ("int gen_launch_partial(", "int gen_partials_size("):
        body = _body(src, fn)
        assert "slcl::gen_fwd_plan(C, P, F, kS, sizeof(T))" in body
        assert "gen_fwd_grid<T, kS, kForm>(plan, M, F, &grid)" in body
    assert "<<<grid, kThreads, plan.smem, st>>>" in _body(src, "int gen_launch_partial(")
    occ = _body(src, "int gen_occupancy_of(")
    assert "gen_occupancy<slcl::centroids_gen_fwd_partial<T, kS, kForm>>(" in occ
    plan = _strip_comments((CSRC / "centroids_gen_plan.cuh").read_text())
    from slcl_torch.ops import cuda as K
    assert f"kGenFwdMT = {K.GEN_FWD_MT};" in plan and f"kGenFwdNT = {K.GEN_FWD_NT};" in plan
    assert f"kGenFwdMTWide = {K.GEN_FWD_MT_WIDE};" in plan
    # the kernel's register tile is the plan's cap (gen_fwd_mt_cap)
    assert "constexpr int kMT = kBf16 && kForm == kGenFwdRing ? kGenFwdMTWide : kGenFwdMT;" in ring
    assert "return es == 2 && !narrow ? kGenFwdMTWide : kGenFwdMT;" in plan
    assert f"kGenFwdBlocks = {K.GEN_FWD_BLOCKS};" in plan
    assert "kGenFwdBudget = 110 * 1024;" in plan and K.GEN_FWD_BUDGET == 110 * 1024
    assert f"kGenFwdMaxStages = {K.GEN_FWD_MAX_STAGES};" in plan
    assert "kGenFwdTileBytes = 20 * 1024;" in plan and K.GEN_FWD_TILE_BYTES == 20 * 1024
    launch = re.search(r"__launch_bounds__\(kThreads, (.*?)\)\ncentroids_gen_fwd_partial\(", gen,
                       re.S).group(1)
    assert " ".join(launch.split()) == (
        "kForm == kGenFwdGrouped || sizeof(T) == 4 ? 1 : (kForm == kGenFwdNarrow ? "
        "kGenFwdNarrowBlocks : kGenFwdBlocks)")
    assert f"kGenFwdNarrowBlocks = {K.GEN_FWD_NARROW_BLOCKS};" in plan
    assert "kGenFwdNarrowBudget = 72 * 1024;" in plan and K.GEN_FWD_NARROW_BUDGET == 72 * 1024
    assert "constexpr int kNT = kForm == kGenFwdNarrow ? 1 : kGenFwdNT;" in ring
