"""ctypes binding for the native C++ helpers in ``src/native/`` (port of
lightgbm_tpu/native.py): the OpenMP text parser (`text_parser.cpp`), the
numerical bin-bound search and the full-matrix binner (`binning.cpp`) and
the batch predictor over a flattened forest (`predictor.cpp`).

The library is built from those sources at first use with the host's
``g++ -O3 -std=c++17 -fPIC -fopenmp -shared`` into
``build/torch_native/liblgbt_native-<hash>.so`` under the checkout (the
hash covers the sources and the flags, so an edited source rebuilds); it
is written under a temporary name and moved into place, so processes that
build at once never load a half-written file. Nothing is written under
``src/``. The compilers tried, in order: ``$CXX``, ``g++`` on the path,
``/usr/bin/g++``, ``c++``; a host whose compilers all lack OpenMP gets
the sources built without ``-fopenmp`` (their OpenMP pragmas are guarded,
so they run on one thread). Each caller keeps its Python route when the
library cannot be built or loaded, and this module warns once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(os.path.dirname(_PKG), "src", "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")
SOURCES = ("text_parser.cpp", "binning.cpp", "predictor.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared"]
# the flags tried: OpenMP first, then without it
FLAG_SETS = (CXX_FLAGS, [f for f in CXX_FLAGS if f != "-fopenmp"])

FMT_CSV, FMT_TSV, FMT_LIBSVM = 0, 1, 2
_FMT_NAMES = {FMT_CSV: "csv", FMT_TSV: "tsv", FMT_LIBSVM: "libsvm"}

_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None
_lib_tried = False
_lock = threading.Lock()


def library_path(flags=CXX_FLAGS) -> str:
    """Where `build` puts the library of the current sources and
    ``flags``."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"liblgbt_native-{digest.hexdigest()[:16]}.so")


def _compilers():
    out = []
    for c in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
              shutil.which("c++")):
        c = c and (shutil.which(c) or c)
        if c and os.path.isfile(c) and c not in out:
            out.append(c)
    return out


def build() -> str:
    """Compile the sources unless they are built; return the library's
    path: the first of `FLAG_SETS` that one of the compilers builds.
    Raises when none does."""
    errors = []
    for flags in FLAG_SETS:
        out = library_path(flags)
        if os.path.isfile(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        for cxx in _compilers():
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run(
                [cxx, *flags, "-o", tmp,
                 *(os.path.join(SRC_DIR, s) for s in SOURCES)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=300)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return out
            if os.path.exists(tmp):
                os.remove(tmp)
            errors.append(f"{cxx} {' '.join(flags)} (exit "
                          f"{proc.returncode}): {proc.stdout.strip()}")
    raise RuntimeError("no compiler built src/native:\n"
                       + "\n".join(errors or ["no C++ compiler found"]))


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    p64, pf64, p32, p8, pu32 = (c.POINTER(c.c_int64), c.POINTER(c.c_double),
                                c.POINTER(c.c_int32), c.POINTER(c.c_int8),
                                c.POINTER(c.c_uint32))
    lib.lgbt_scan.restype = c.c_int32
    lib.lgbt_scan.argtypes = [c.c_char_p, p64, p64, p32]
    lib.lgbt_parse.restype = c.c_int32
    lib.lgbt_parse.argtypes = [c.c_char_p, c.c_int32, c.c_int32, c.c_int64,
                               pf64, pf64]
    lib.lgbt_num_threads.restype = c.c_int32
    lib.lgbt_num_threads.argtypes = []
    lib.lgbt_find_bin_numerical.restype = c.c_int32
    lib.lgbt_find_bin_numerical.argtypes = [
        pf64, c.c_int64, c.c_int64, c.c_int32, c.c_int32, pf64]
    lib.lgbt_bin_matrix.restype = c.c_int32
    lib.lgbt_bin_matrix.argtypes = [
        c.c_void_p, c.c_int32, c.c_int64, c.c_int64, p32, c.c_int64, p32,
        p32, p32, pf64, p64, p64, p32, p64, c.c_int32, c.c_void_p]
    lib.lgbt_predict.restype = c.c_int32
    lib.lgbt_predict.argtypes = [
        pf64, c.c_int64, c.c_int64, c.c_int32, p64, p64, p32, p32, p32,
        pf64, p8, pf64, p64, p32, p64, pu32, p32, p32, c.c_int32,
        c.c_int32, c.c_int32, c.c_double, pf64]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None when it cannot be built
    or loaded (warned once)."""
    global _lib, _lib_path, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            path = build()
            lib = ctypes.CDLL(path)
            _declare(lib)
        except Exception as e:  # no compiler, no sources, a failed build
            from .utils import log
            log.warning(
                f"native helper library unavailable ({e}); text parsing, "
                "bin finding, CPU binning and CPU batch prediction take "
                "the (slower) Python route")
            return None
        _lib, _lib_path = lib, path
    return _lib


def built_path() -> Optional[str]:
    """The file the loaded library came from (None before `get_lib`
    loaded one)."""
    return _lib_path


def native_available() -> bool:
    return get_lib() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_file(path: str, label_idx: int = 0
               ) -> Optional[Tuple[np.ndarray, np.ndarray, str]]:
    """Parse a CSV / TSV / LibSVM file with the OpenMP parser: (labels
    f64 [N], features f64 [N, F], format name), or None without the
    library. The Python parser's semantics (`io/parser.py`): NA tokens
    read as NaN, absent LibSVM entries as 0.0."""
    lib = get_lib()
    if lib is None:
        return None
    rows, cols, fmt = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int32()
    rc = lib.lgbt_scan(path.encode(), ctypes.byref(rows), ctypes.byref(cols),
                       ctypes.byref(fmt))
    if rc != 0:
        raise FileNotFoundError(f"data file {path} not found")
    n = rows.value
    if fmt.value == FMT_LIBSVM:
        f, eff_label = cols.value, -1
    else:
        f = cols.value - (1 if label_idx >= 0 else 0)
        eff_label = label_idx
    f = max(f, 0)
    labels = np.zeros(n, np.float64)
    feats = np.zeros((n, f), np.float64)
    rc = lib.lgbt_parse(path.encode(), fmt.value, eff_label, f,
                        _ptr(labels, ctypes.c_double),
                        _ptr(feats, ctypes.c_double))
    if rc != 0:
        raise IOError(f"native parse of {path} failed")
    return labels, feats, _FMT_NAMES[fmt.value]


def find_bin_numerical(values: np.ndarray, total_sample_cnt: int,
                       max_bin: int, min_data_in_bin: int
                       ) -> Optional[np.ndarray]:
    """A numerical feature's ascending bin upper bounds (the last +inf)
    from its sampled nonzero values; None without the library or when the
    search degenerates."""
    lib = get_lib()
    if lib is None or max_bin < 2:
        return None
    values = np.ascontiguousarray(values, dtype=np.float64)
    out = np.empty(max_bin + 1, np.float64)
    n = lib.lgbt_find_bin_numerical(
        _ptr(values, ctypes.c_double), len(values), int(total_sample_cnt),
        int(max_bin), int(min_data_in_bin), _ptr(out, ctypes.c_double))
    if n < 0:
        return None
    return out[:n].copy()


def bin_matrix(data: np.ndarray, col_idx: np.ndarray, bin_type: np.ndarray,
               missing: np.ndarray, num_bin: np.ndarray,
               bounds: np.ndarray, bounds_off: np.ndarray,
               cats: np.ndarray, cat_bins: np.ndarray, cats_off: np.ndarray,
               out_dtype) -> Optional[np.ndarray]:
    """The bins [N, len(col_idx)] (uint8 or uint16) of an f64 or f32
    matrix's columns ``col_idx``, OpenMP over rows; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    if data.dtype == np.float64:
        dtype_code = 0
    elif data.dtype == np.float32:
        dtype_code = 1
    else:
        return None
    data = np.ascontiguousarray(data)
    n, f_total = data.shape
    out = np.empty((n, len(col_idx)), dtype=out_dtype)

    def arr(a, dt, ct):
        a = np.ascontiguousarray(a, dt)
        return a, _ptr(a, ct)

    # the arrays stay referenced until the call returns
    keep = [arr(col_idx, np.int32, ctypes.c_int32),
            arr(bin_type, np.int32, ctypes.c_int32),
            arr(missing, np.int32, ctypes.c_int32),
            arr(num_bin, np.int32, ctypes.c_int32),
            arr(bounds, np.float64, ctypes.c_double),
            arr(bounds_off, np.int64, ctypes.c_int64),
            arr(cats, np.int64, ctypes.c_int64),
            arr(cat_bins, np.int32, ctypes.c_int32),
            arr(cats_off, np.int64, ctypes.c_int64)]
    p = [k[1] for k in keep]
    rc = lib.lgbt_bin_matrix(
        data.ctypes.data_as(ctypes.c_void_p), dtype_code, n, f_total,
        p[0], len(col_idx), p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
        1 if out_dtype == np.uint16 else 0, out.ctypes.data_as(
            ctypes.c_void_p))
    if rc != 0:
        return None
    return out


def predict_forest(X: np.ndarray, flat: dict, num_class: int,
                   pred_leaf: bool = False, early_stop_freq: int = 0,
                   early_stop_margin: float = 0.0) -> Optional[np.ndarray]:
    """Raw scores ([N] for one class, [N, K] for K) or leaf indices [N, T]
    of the rows of X over a forest flattened by
    `ops.predict.flatten_forest`, OpenMP over rows; with
    ``early_stop_freq`` > 0 a row stops once its margin passes
    ``early_stop_margin`` at a multiple of that many trees (before the
    last). None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, dtype=np.float64)
    n, num_feat = X.shape
    t_count = len(flat["num_leaves"])
    if pred_leaf:
        out = np.empty((n, t_count), np.float64)
    else:
        out = np.zeros((n, num_class), np.float64)
    rc = lib.lgbt_predict(
        _ptr(X, ctypes.c_double), n, num_feat, t_count,
        _ptr(flat["node_off"], ctypes.c_int64),
        _ptr(flat["leaf_off"], ctypes.c_int64),
        _ptr(flat["left"], ctypes.c_int32),
        _ptr(flat["right"], ctypes.c_int32),
        _ptr(flat["feat"], ctypes.c_int32),
        _ptr(flat["thresh"], ctypes.c_double),
        _ptr(flat["dtype"], ctypes.c_int8),
        _ptr(flat["leaf_value"], ctypes.c_double),
        _ptr(flat["cat_bnd_off"], ctypes.c_int64),
        _ptr(flat["cat_boundaries"], ctypes.c_int32),
        _ptr(flat["cat_words_off"], ctypes.c_int64),
        _ptr(flat["cat_words"], ctypes.c_uint32),
        _ptr(flat["num_leaves"], ctypes.c_int32),
        _ptr(flat["tree_class"], ctypes.c_int32),
        num_class, 1 if pred_leaf else 0, int(early_stop_freq),
        float(early_stop_margin), _ptr(out, ctypes.c_double))
    if rc != 0:
        return None
    return out if pred_leaf or num_class > 1 else out[:, 0]
