"""Filesystem helpers shared by the snapshot writers (copy of the JAX
package's ``utils/files.py``).

One definition of the atomic-write dance (tempfile in the target dir →
write → ``os.replace``) so every writer has the same crash semantics: a
failure mid-write leaves any previous file intact, and a crash leaves no
half-written file under the target's name.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import IO, Any, Callable


def atomic_write(path: str, write_fn: Callable[[IO], None],
                 binary: bool = False) -> str:
    """Write ``path`` atomically: ``write_fn(f)`` fills a temp file in the
    same directory, then ``os.replace`` swaps it in. On any failure the
    temp file is removed and the previous ``path`` (if any) is untouched.
    Returns ``path``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path)
                               + "-")
    try:
        with os.fdopen(fd, "wb" if binary else "w") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_json(path: str, obj: Any, indent: int = 2) -> str:
    """JSON convenience over ``atomic_write``: readers either see the
    previous document or the complete new one, never a truncated parse."""
    return atomic_write(
        path, lambda f: json.dump(obj, f, indent=indent, sort_keys=True))
