"""Reader and writer of the safetensors format, in torch alone.

The card's machine has no ``safetensors`` package, so the port carries
its own. A file is:

- 8 bytes: the header's length, little-endian;
- the header: a JSON object mapping each tensor's name to its ``dtype``,
  ``shape`` and ``data_offsets`` (begin and end, relative to the data),
  with an optional ``__metadata__`` object of strings;
- the data: every tensor's bytes, row-major, little-endian.

The reader maps the file (``mmap``, a private copy-on-write mapping) and
builds tensors over the mapped bytes with ``torch.frombuffer``; bf16 and
the fp8 types are read directly. ``SafetensorsFile.get`` is a view of the
mapping and is for callers that copy at once (the HF loader copies each
layer's tensor into its slice of a stacked leaf on the device, then
``release``s its pages); ``load_file`` copies every tensor off the
mapping, so what it returns outlives a later rewrite of the file. The
writer streams one tensor at a time to the host, so a tree on the card is
written without a host copy of the whole of it.

One reader and writer serves the HF loader (``models/loader.py``) and the
port's own native format (``utils/checkpoint.py``).
"""

from __future__ import annotations

import json
import mmap
import os
import pathlib
import struct
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

from .files import atomic_write

DTYPES: Dict[str, torch.dtype] = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32,
    "I64": torch.int64, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# the format's own limit on the header (the reference reader's)
MAX_HEADER_BYTES = 100 * 1024 * 1024


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def read_header(path: str) -> Tuple[Dict[str, Any], int]:
    """``(header, data_start)``: the parsed JSON header (``__metadata__``
    included where present) and the byte offset where the data begins.
    Raises ``ValueError`` on a malformed header."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER_BYTES:
            raise ValueError(f"{path}: header of {n} bytes is too large")
        blob = f.read(n)
    if len(blob) != n:
        raise ValueError(f"{path}: header truncated ({len(blob)} of {n} "
                         "bytes)")
    try:
        header = json.loads(blob.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"{path}: header is not JSON ({e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not an object")
    return header, 8 + n


class SafetensorsFile:
    """One mapped ``.safetensors`` file. Every entry is checked against
    the file's size when it is opened, so a truncated file raises
    ``ValueError`` here, before any tensor is built."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        header, self._start = read_header(self.path)
        meta = header.pop("__metadata__", None) or {}
        if not isinstance(meta, dict):
            raise ValueError(f"{path}: __metadata__ is not an object")
        self.metadata: Dict[str, str] = meta
        size = os.path.getsize(self.path)
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int,
                                       int]] = {}
        for name, e in header.items():
            try:
                dt = DTYPES[e["dtype"]]
                shape = tuple(int(d) for d in e["shape"])
                begin, end = (int(x) for x in e["data_offsets"])
            except (KeyError, TypeError, ValueError) as err:
                raise ValueError(f"{path}: bad entry for {name!r}: {e!r} "
                                 f"({type(err).__name__}: {err})") from err
            nbytes = _numel(shape) * dt.itemsize
            if min(shape, default=0) < 0 or not 0 <= begin <= end or \
                    end - begin != nbytes:
                raise ValueError(f"{path}: entry {name!r} spans "
                                 f"[{begin}, {end}) for {nbytes} bytes")
            if self._start + end > size:
                raise ValueError(f"{path}: truncated: {name!r} ends at byte "
                                 f"{self._start + end} of {size}")
            self._entries[name] = (dt, shape, begin, end)
        self._mm: Optional[mmap.mmap] = None
        if size > self._start:
            with open(self.path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drop this object's mapping; views still alive keep it mapped
        until they go."""
        self._mm = None

    def keys(self):
        return sorted(self._entries)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._entries[name][1]

    def get(self, name: str) -> torch.Tensor:
        """A CPU tensor over the mapped bytes of ``name`` (no copy where
        its offset is aligned to its element size)."""
        dt, shape, begin, end = self._entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dt)
        off = self._start + begin
        if off % dt.itemsize:
            raw = torch.frombuffer(self._mm, dtype=torch.uint8,
                                   count=end - begin, offset=off)
            return raw.clone().view(dt).reshape(shape)
        return torch.frombuffer(self._mm, dtype=dt, count=_numel(shape),
                                offset=off).reshape(shape)

    def release(self, name: str) -> None:
        """Drop ``name``'s mapped pages from this process (they fault in
        again from the file if read later), so a loader that has copied a
        tensor off need not keep its pages. A kernel may give them back
        late: the resident set can still peak near the mapped bytes
        (``scripts/ckpt_read_rss.py`` measures it)."""
        _dt, _shape, begin, end = self._entries[name]
        if self._mm is None or end == begin or \
                not hasattr(mmap, "MADV_DONTNEED"):
            return
        page = mmap.PAGESIZE
        lo = (self._start + begin) // page * page
        hi = min(len(self._mm), -(-(self._start + end) // page) * page)
        self._mm.madvise(mmap.MADV_DONTNEED, lo, hi - lo)


def load_file(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """Every tensor of ``path`` on ``device`` (each one copied off the
    mapping, and its pages released, before the next)."""
    out: Dict[str, torch.Tensor] = {}
    with SafetensorsFile(path) as f:
        for name in f.keys():
            view = f.get(name)
            out[name] = (view.clone() if torch.device(device).type == "cpu"
                         else view.to(device))
            del view
            f.release(name)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> str:
    """Write ``tensors`` (on any device; views are fine) to ``path``,
    atomically. Tensors are laid out by element size, widest first, so
    each offset is aligned to its element size; the header is padded to 8
    bytes. Each tensor reaches the host alone, just before its bytes are
    written."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, Any] = {}
    if metadata:
        meta = dict(metadata)
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in meta.items()):
            raise ValueError("safetensors metadata must map str to str")
        header["__metadata__"] = meta
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors "
                             "name here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)

    def write(f) -> None:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                host = t.contiguous().cpu().reshape(-1).view(torch.uint8)
                f.write(memoryview(host.numpy()))
                del host

    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    return atomic_write(str(path), write, binary=True)


def iter_checkpoint(path: str) -> Iterator[pathlib.Path]:
    """The ``*.safetensors`` files of a checkpoint directory, sorted by
    name. A sharded HF directory's ``model.safetensors.index.json`` is
    not read: every shard is globbed, as the JAX loader does."""
    files = sorted(pathlib.Path(path).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    yield from files
