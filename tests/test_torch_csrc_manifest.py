"""The CUDA build's manifest (`composite_sorted.SOURCES`, `HEADERS`,
`NO_FMAD`) against the files in `eags_slam_torch/csrc/`: every kernel
source is built, every header a source or header includes is hashed into
the build's cache key (a header missing from HEADERS would leave a stale
library in place after it changes), and every source built without FMA is
one that is built. Reads the sources only: no nvcc, no card."""
import re

from eags_slam_torch.ops import composite_sorted as cs

SOURCE_FILES = sorted(p.name for p in cs.CSRC.glob("*.cu"))
ALL_FILES = sorted(p.name for p in cs.CSRC.iterdir()
                   if p.suffix in (".cu", ".cuh"))
QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def test_every_source_is_built():
    assert [n for n in SOURCE_FILES if n not in cs.SOURCES] == []


def test_every_quoted_include_is_hashed():
    missing = [(name, inc) for name in ALL_FILES
               for inc in QUOTED_INCLUDE.findall((cs.CSRC / name).read_text())
               if inc not in cs.HEADERS]
    assert missing == []


def test_no_fmad_sources_are_built():
    assert set(cs.NO_FMAD) <= set(cs.SOURCES)


def test_manifest_names_files_that_exist():
    assert len(set(cs.SOURCES)) == len(cs.SOURCES) >= 6
    for name in cs.SOURCES + cs.HEADERS:
        assert (cs.CSRC / name).is_file(), name
