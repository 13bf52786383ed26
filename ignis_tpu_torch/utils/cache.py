"""Asset cache: converted assets and acceleration tables on disk.

Counterpart of ignis_tpu/utils/cache.py, with the same key functions
(`_key`, `data_key`, `_VERSION`) and entry names.  Converted numpy tables are
stored as `.npz` (structured results as pickles) under a content hash, so a
repeated scene load skips mesh parsing, measured-BSDF conversion and the
host's BVH / packet / Baldwin-Weber table builds.  Every entry's key also
holds `code_tag()`, a hash of the package's Python sources, so that an entry
written by other loader or builder code is never read (the JAX package's
keys hold only its fixed `_VERSION`).

The directory is the port's own: `build/ignis_tpu_torch/assets/` inside the
checkout, or `IGNIS_TPU_TORCH_CACHE`; `IGNIS_TPU_TORCH_NO_CACHE=1` turns the
cache off.  Each entry is written to a name unique to the writing process
(its pid and a random suffix) and moved into place with `os.replace`, so
concurrent writers of one entry never read or clobber a half-written file.
A corrupt or unreadable entry is rebuilt.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
import secrets
from pathlib import Path

import numpy as np

_VERSION = 1
_PKG = Path(__file__).resolve().parents[1]


def enabled() -> bool:
    return not os.environ.get("IGNIS_TPU_TORCH_NO_CACHE")


def cache_dir() -> Path:
    d = os.environ.get("IGNIS_TPU_TORCH_CACHE")
    d = Path(d) if d else _PKG.parent / "build" / "ignis_tpu_torch" / "assets"
    d.mkdir(parents=True, exist_ok=True)
    return d


@functools.lru_cache(maxsize=None)
def code_tag() -> str:
    """Hash of the package's Python sources (the loaders and builders whose
    results are cached, and all they call)."""
    h = hashlib.sha256()
    for f in sorted(_PKG.rglob("*.py")):
        h.update(f"{f.relative_to(_PKG).as_posix()}:".encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _entry_extra(extra: str) -> str:
    return f"{extra}:code={code_tag()}"


def _key(path: Path, kind: str, extra: str = "") -> str:
    """Content hash of a file."""
    h = hashlib.sha256()
    h.update(f"{kind}:v{_VERSION}:{extra}:".encode())
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def data_key(arrays, kind: str, extra: str = "") -> str:
    """Content hash over in-memory arrays (shape + dtype + bytes)."""
    h = hashlib.sha256()
    h.update(f"{kind}:v{_VERSION}:{extra}:".encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _tmp_name(f: Path) -> Path:
    return f.with_name(f"{f.name}.{os.getpid()}.{secrets.token_hex(4)}.tmp")


def _load_npz(f: Path):
    try:
        with np.load(f, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError):   # missing or corrupt: rebuild
        return None


def _store(f: Path, write) -> None:
    """`write(open file)` into a private temporary name, then move it into
    place; a cache that cannot be written is skipped."""
    tmp = _tmp_name(f)
    try:
        with open(tmp, "wb") as fh:
            write(fh)
        os.replace(tmp, f)
    except OSError:
        tmp.unlink(missing_ok=True)


def _arrays_entry(f: Path, build):
    out = _load_npz(f) if f.exists() else None
    if out is None:
        out = build()
        _store(f, lambda fh: np.savez_compressed(fh, **out))
    return out


def cached_arrays_data(key_arrays, kind: str, builder, extra: str = ""):
    """`builder()` (a dict of numpy arrays), cached under a hash of the
    in-memory `key_arrays`: the BVH, packet-row and Baldwin-Weber builds,
    whose inputs are parsed geometry."""
    if not enabled():
        return builder()
    key = data_key(key_arrays, kind, _entry_extra(extra))
    return _arrays_entry(cache_dir() / f"{kind}-{key[:32]}.npz", builder)


def cached_arrays(path, kind: str, builder, extra: str = ""):
    """`builder(path)` (a dict of numpy arrays; scalars as 0-d arrays),
    cached under a hash of the file at `path`."""
    if not enabled():
        return builder(path)
    path = Path(path)
    try:
        key = _key(path, kind, _entry_extra(extra))
    except OSError:
        return builder(path)
    return _arrays_entry(cache_dir() / f"{kind}-{key[:32]}.npz",
                         lambda: builder(path))


def cached_pickle(path, kind: str, builder, extra: str = ""):
    """File-keyed cache for structured results (a tables dict beside an info
    dict): the measured-BSDF loaders.  Only this cache's own entries are
    unpickled."""
    if not enabled():
        return builder(path)
    path = Path(path)
    try:
        key = _key(path, kind, _entry_extra(extra))
    except OSError:
        return builder(path)
    f = cache_dir() / f"{kind}-{key[:32]}.pkl"
    if f.exists():
        try:
            with open(f, "rb") as fh:
                return pickle.load(fh)
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
                ValueError):
            pass
    out = builder(path)
    _store(f, lambda fh: pickle.dump(out, fh, protocol=4))
    return out
