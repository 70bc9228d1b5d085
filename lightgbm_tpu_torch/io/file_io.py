"""Virtual file abstraction (port of lightgbm_tpu/io/file_io.py;
reference `src/io/file_io.cpp`
VirtualFileReader / VirtualFileWriter and the HDFS build flag).

The reference routes every data/model file through a VirtualFile
interface so an HDFS backend can be compiled in; here the same seam is a
SCHEME REGISTRY: paths like ``hdfs://...``, ``gs://...`` or ``s3://...``
dispatch to a registered opener, plain paths use the local filesystem.
``fsspec`` is picked up automatically when importable (it is optional;
the registry is the supported injection point):

    from lightgbm_tpu_torch.io.file_io import register_filesystem
    register_filesystem("hdfs", my_opener)   # opener(path, mode) -> file

Callers (DatasetLoader, Dataset.save_binary/load_binary, model IO) go
through :func:`open_file` / :func:`exists`, so any registered filesystem
works for datasets, sidecars, and model files alike.
"""
from __future__ import annotations

import inspect
import os
from typing import Callable, Dict

_SCHEMES: Dict[str, Callable] = {}


def register_filesystem(scheme: str, opener: Callable) -> None:
    """Register ``opener(path, mode) -> file object`` for a URI scheme."""
    _SCHEMES[scheme.lower()] = opener


def _scheme_of(path: str) -> str:
    if "://" in str(path):
        return str(path).split("://", 1)[0].lower()
    return ""


_FSSPEC_SCHEMES = ("hdfs", "gs", "s3", "gcs", "abfs", "az")


def _fsspec_open(path: str, mode: str, **kw):
    try:
        import fsspec
    except Exception:
        # NOT FileNotFoundError: a missing backend is a configuration
        # error and must not be mistaken for a missing file (exists()
        # maps only FileNotFoundError to False)
        raise RuntimeError(
            f"path {path!r} uses a remote filesystem scheme but no opener "
            f"is registered for it (register_filesystem) and fsspec is "
            f"not installed")
    return fsspec.open(path, mode, **kw).open()


def _accepts_kwargs(opener: Callable, kw: Dict):
    """True/False when `opener`'s signature (does not) take every keyword
    in `kw`; None when the signature is not introspectable."""
    try:
        sig = inspect.signature(opener)
    except (TypeError, ValueError):
        return None     # not introspectable: caller falls back on retry
    params = sig.parameters.values()
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params):
        return True
    names = {p.name for p in params
             if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                           inspect.Parameter.KEYWORD_ONLY)}
    return all(k in names for k in kw)


def open_file(path: str, mode: str = "r", **kw):
    """Open a local or registered-remote file (reference VirtualFile
    factory, file_io.cpp:21-58). Decode kwargs (errors=, encoding=)
    forward to every backend."""
    scheme = _scheme_of(path)
    if scheme in _SCHEMES:
        opener = _SCHEMES[scheme]
        # kwarg support is detected from the signature, NOT by retrying
        # on TypeError: a TypeError raised inside the opener body must
        # propagate, and silently dropping decode kwargs (errors=,
        # encoding=) on a retry would mask real opener bugs. Openers
        # whose signature is not introspectable (C extensions) keep the
        # old retry behavior — there the ambiguity is unavoidable.
        if kw:
            ok = _accepts_kwargs(opener, kw)
            if ok is False:
                return opener(path, mode)
            if ok is None:
                try:
                    return opener(path, mode, **kw)
                except TypeError:
                    return opener(path, mode)
        return opener(path, mode, **kw)
    if scheme in _FSSPEC_SCHEMES:
        return _fsspec_open(path, mode, **kw)
    return open(path, mode, **kw)


def exists(path: str) -> bool:
    """True when the path opens. Only a missing file maps to False —
    auth/network errors from remote backends PROPAGATE so operators see
    the real failure, not a fake file-not-found."""
    if _scheme_of(path) == "":
        return os.path.isfile(path)
    try:
        open_file(path, "r").close()
        return True
    except FileNotFoundError:
        return False
