"""ctypes binding of the native C++ frame loader, `native/loader.cpp` (port
of eags_slam_tpu.utils.native_loader).

A GIL-free decode pool: JPEG or PNG colour and 16-bit PNG depth, decoded by
worker threads into a bounded readahead cache (C ABI: loader_create /
loader_dims / loader_get / loader_destroy). `FileDataset.start_prefetch`
tries it before the Python preloader.

The library: the git-tracked `native/libloader.so` when it loads (it links
libjpeg.so.62, which a host may lack); else `native/loader.cpp` built with
the Makefile's flags and libraries into `build/native_loader/` (gitignored)
on first use, named by the source's hash, never into `native/`; else none,
and `try_create` returns None. `status()` says which ("tracked", "built"
or None) and why the others failed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
TRACKED = _REPO / "native" / "libloader.so"
SOURCE = _REPO / "native" / "loader.cpp"
BUILD_DIR = _REPO / "build" / "native_loader"
# native/Makefile's CXXFLAGS and LIBS.
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-ljpeg", "-lpng16", "-lz", "-lpthread")

_lock = threading.Lock()
_lib = None
_status: Dict = {}


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]
    lib.loader_dims.restype = ctypes.c_int
    lib.loader_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
    lib.loader_get.restype = ctypes.c_int
    lib.loader_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_float)]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    return lib


def build() -> Path:
    """Compile native/loader.cpp into BUILD_DIR (once per source hash);
    raises with the compiler's output when that fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libloader_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE),
                           *LIBS], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed: {proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _lib
    with _lock:
        if _status:
            return _lib
        errors = {}
        try:
            _lib, source = _bind(TRACKED), "tracked"
        except OSError as e:
            errors["tracked"] = str(e)
            try:
                _lib, source = _bind(build()), "built"
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                errors["built"] = str(e)
                _lib, source = None, None
        _status.update({"native": source, "errors": errors})
        return _lib


def status() -> Dict:
    """{"native": "tracked" | "built" | None, "errors": {attempt: message}}
    (loads the library if no call has yet)."""
    _load_lib()
    return dict(_status)


def supported(color_paths: List, depth_paths: List) -> bool:
    """The formats the pool decodes: JPEG or PNG colour, PNG depth."""
    if not color_paths or not depth_paths:
        return False
    c = str(color_paths[0]).lower()
    d = str(depth_paths[0]).lower()
    return c.endswith((".jpg", ".jpeg", ".png")) and d.endswith(".png")


class NativeLoader:
    """Prefetching decoder over (colour, depth) file lists: `get(idx)` ->
    (rgb uint8 (H, W, 3), depth float32 (H, W) = raw / depth_scale)."""

    def __init__(self, color_paths: List[str], depth_paths: List[str],
                 depth_scale: float, readahead: int = 8, n_threads: int = 2):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_status}")
        self._lib = lib
        n = len(color_paths)
        c_arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in color_paths])
        d_arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in depth_paths])
        self._h = lib.loader_create(c_arr, d_arr, n, depth_scale, readahead,
                                    n_threads)
        if not self._h:
            raise RuntimeError("loader_create failed")
        w, h = ctypes.c_int(), ctypes.c_int()
        if lib.loader_dims(self._h, ctypes.byref(w), ctypes.byref(h)) != 0:
            self.close()
            raise RuntimeError("loader_dims failed (unreadable frame 0)")
        self.width, self.height = w.value, h.value
        self.n = n

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        depth = np.empty((self.height, self.width), np.float32)
        rc = self._lib.loader_get(
            self._h, idx, rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(f"loader_get({idx}) failed rc={rc}")
        return rgb, depth

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def try_create(color_paths, depth_paths, depth_scale: float, readahead=8,
               n_threads=2) -> Optional[NativeLoader]:
    """A NativeLoader, or None when the formats are not the pool's or the
    library does not load or build."""
    if not supported(color_paths, depth_paths):
        return None
    try:
        return NativeLoader([str(p) for p in color_paths],
                            [str(p) for p in depth_paths], depth_scale,
                            readahead, n_threads)
    except Exception:
        return None
