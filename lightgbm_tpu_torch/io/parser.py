"""Text parsers: CSV / TSV / LibSVM with format auto-detection (port of
lightgbm_tpu/io/parser.py, host numpy as there).

Re-creates the reference parser layer (`src/io/parser.cpp`,
`src/io/parser.hpp`): `create_parser` sniffs a few lines to decide the
format (reference `Parser::CreateParser`, `parser.cpp:103-172`) and each
parser turns one line into ``(label, [(col, val), ...])`` sparse pairs
(reference `ParseOneLine`, `parser.hpp:30-129`).

The hot bulk path (`parse_dense`) vectorizes whole-file parsing with NumPy
instead of the reference's per-line OMP loop; a native C++ fast path can be
slotted underneath without changing callers.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NA_TOKENS = {"", "na", "nan", "null", "n/a", "none", "?"}


def _atof(tok: str) -> float:
    """Tolerant float parse (reference `Common::Atof`): NA tokens -> NaN."""
    tok = tok.strip()
    if tok.lower() in _NA_TOKENS:
        return math.nan
    try:
        return float(tok)
    except ValueError:
        return math.nan


class Parser:
    """Base parser: one line -> (label, sparse (col,val) pairs)."""

    def __init__(self, label_idx: int = 0):
        self.label_idx = label_idx

    def parse_one_line(self, line: str) -> Tuple[float, List[Tuple[int, float]]]:
        raise NotImplementedError

    def num_features(self, line: str) -> int:
        raise NotImplementedError


class _DelimitedParser(Parser):
    sep: str = "\t"

    def parse_one_line(self, line):
        toks = line.rstrip("\r\n").split(self.sep)
        label = 0.0
        pairs: List[Tuple[int, float]] = []
        col = 0
        for i, tok in enumerate(toks):
            v = _atof(tok)
            if i == self.label_idx:
                label = v
            else:
                pairs.append((col, v))
                col += 1
        return label, pairs

    def num_features(self, line):
        n = len(line.rstrip("\r\n").split(self.sep))
        return n - 1 if self.label_idx >= 0 else n


class TSVParser(_DelimitedParser):
    sep = "\t"


class CSVParser(_DelimitedParser):
    sep = ","


class SpaceParser(_DelimitedParser):
    sep = " "


class LibSVMParser(Parser):
    """``label idx:val idx:val ...``; absent indices are 0 (reference
    `parser.hpp:88-129`)."""

    def parse_one_line(self, line):
        toks = line.split()
        label = 0.0
        pairs: List[Tuple[int, float]] = []
        start = 0
        if self.label_idx >= 0 and toks and ":" not in toks[0]:
            label = _atof(toks[0])
            start = 1
        for tok in toks[start:]:
            if ":" not in tok:
                continue
            k, v = tok.split(":", 1)
            try:
                pairs.append((int(k), _atof(v)))
            except ValueError:
                continue
        return label, pairs

    def num_features(self, line):
        _, pairs = self.parse_one_line(line)
        return (max(c for c, _ in pairs) + 1) if pairs else 0


def detect_format(sample_lines: Sequence[str]) -> str:
    """Sniff the file format from a few lines (reference
    `Parser::CreateParser`, `src/io/parser.cpp:103-172`): colon pairs ->
    libsvm, else the delimiter that splits consistently across lines."""
    lines = [ln for ln in sample_lines if ln.strip()]
    if not lines:
        return "tsv"

    def is_libsvm(ln):
        toks = ln.split()
        pairs = [t for t in toks if ":" in t]
        return len(pairs) >= max(1, len(toks) - 1)

    if all(is_libsvm(ln) for ln in lines):
        return "libsvm"
    for name, sep in (("tsv", "\t"), ("csv", ","), ("space", " ")):
        counts = {len(ln.rstrip("\r\n").split(sep)) for ln in lines}
        if len(counts) == 1 and counts.pop() > 1:
            return name
    raise ValueError("Unknown data format: not CSV/TSV/LibSVM")


_PARSERS = {"tsv": TSVParser, "csv": CSVParser, "space": SpaceParser,
            "libsvm": LibSVMParser}


def create_parser(sample_lines: Sequence[str], label_idx: int = 0,
                  fmt: Optional[str] = None) -> Parser:
    fmt = fmt or detect_format(sample_lines)
    return _PARSERS[fmt](label_idx)


def parse_dense(lines: Sequence[str], parser: Parser,
                num_cols: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Bulk-parse lines into ``(labels [N], features [N, F])``.

    Delimited formats take a vectorized NumPy path; LibSVM falls back to
    the per-line parser (absent entries = 0.0, matching the reference's
    sparse semantics)."""
    lines = [ln for ln in lines if ln.strip()]
    n = len(lines)
    if n == 0:
        return np.zeros(0), np.zeros((0, num_cols or 0))
    if isinstance(parser, _DelimitedParser):
        sep = parser.sep
        first = lines[0].rstrip("\r\n").split(sep)
        ncol = len(first)
        flat = np.empty(n * ncol, dtype=np.float64)
        bad_rows = []
        try:
            for i, ln in enumerate(lines):
                toks = ln.rstrip("\r\n").split(sep)
                if len(toks) != ncol:
                    raise ValueError
                flat[i * ncol:(i + 1) * ncol] = toks
        except ValueError:
            # NA tokens or ragged rows: tolerant row-by-row path
            for i, ln in enumerate(lines):
                toks = ln.rstrip("\r\n").split(sep)
                row = [_atof(t) for t in toks[:ncol]]
                row += [math.nan] * (ncol - len(row))
                flat[i * ncol:(i + 1) * ncol] = row
            del bad_rows
        mat = flat.reshape(n, ncol)
        li = parser.label_idx
        if li >= 0 and ncol > 0:
            labels = mat[:, li].copy()
            feats = np.delete(mat, li, axis=1)
        else:
            labels = np.zeros(n)
            feats = mat
        return labels, feats
    # libsvm path
    if num_cols is None:
        num_cols = 0
        parsed = []
        for ln in lines:
            lab, pairs = parser.parse_one_line(ln)
            parsed.append((lab, pairs))
            if pairs:
                num_cols = max(num_cols, max(c for c, _ in pairs) + 1)
    else:
        parsed = [parser.parse_one_line(ln) for ln in lines]
    labels = np.zeros(n)
    feats = np.zeros((n, num_cols))
    for i, (lab, pairs) in enumerate(parsed):
        labels[i] = lab
        for c, v in pairs:
            if c < num_cols:
                feats[i, c] = v
    return labels, feats
