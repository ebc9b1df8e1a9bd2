"""The CUDA build's manifest (`composite_sorted.SOURCES`, `HEADERS`)
against the files in `eags_slam_torch/csrc/`: every kernel source is
built, every header a source or header includes is hashed into the build's
cache key (a header missing from HEADERS would leave a stale library in
place after it changes), and every kernel that composites or replays
rounds its alpha decisions through `twin_alpha` (the library is built with
FMA, so no other rounding matches the twins'). Reads the sources only: no
nvcc, no card."""
import re

from eags_slam_torch.ops import composite_sorted as cs

SOURCE_FILES = sorted(p.name for p in cs.CSRC.glob("*.cu"))
ALL_FILES = sorted(p.name for p in cs.CSRC.iterdir()
                   if p.suffix in (".cu", ".cuh"))
QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _includes(name: str) -> set:
    """The headers `name` reaches, directly or through a header."""
    seen, todo = set(), [name]
    while todo:
        for inc in QUOTED_INCLUDE.findall((cs.CSRC / todo.pop()).read_text()):
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return seen


def test_every_source_is_built():
    assert [n for n in SOURCE_FILES if n not in cs.SOURCES] == []


def test_every_quoted_include_is_hashed():
    missing = [(name, inc) for name in ALL_FILES
               for inc in QUOTED_INCLUDE.findall((cs.CSRC / name).read_text())
               if inc not in cs.HEADERS]
    assert missing == []


def test_every_kernel_reaches_twin_alpha():
    """Each source composites or replays (K1-K6), so each reaches
    `alpha_box.cuh`, the home of `twin_alpha`, and calls it through a
    header or itself; no source is built without FMA any more."""
    assert "twin_alpha" in (cs.CSRC / "alpha_box.cuh").read_text()
    users = {n for n in ALL_FILES if "twin_alpha(" in
             (cs.CSRC / n).read_text() and n != "alpha_box.cuh"}
    for name in cs.SOURCES:
        reach = _includes(name)
        assert "alpha_box.cuh" in reach, name
        assert users & (reach | {name}), name
    assert "-fmad=false" not in cs.NVCC_FLAGS


def test_manifest_names_files_that_exist():
    assert len(set(cs.SOURCES)) == len(cs.SOURCES) >= 6
    for name in cs.SOURCES + cs.HEADERS:
        assert (cs.CSRC / name).is_file(), name
