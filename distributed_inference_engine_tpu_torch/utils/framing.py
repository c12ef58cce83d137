"""Length-prefixed wire framing for the host RPC plane (copy of the JAX
package's ``utils/framing.py``): every message is

    | magic u16 | codec u8 | flags u8 | length u32 (big-endian) | payload |

with a JSON or msgpack payload. The port carries its own msgpack codec
(the subset the RPC plane sends: None, bool, int, float, str, bytes,
list/tuple, dict) in pure Python, so it needs no msgpack package; its
bytes are those of ``msgpack.packb(obj, use_bin_type=True)``, so a JAX
worker or client and a PyTorch one put identical frames on the wire.
"""

from __future__ import annotations

import asyncio
import json
import struct
from typing import Any, List, Optional, Tuple

MAGIC = 0xD17E
HEADER = struct.Struct(">HBBI")  # magic, codec, flags, length
HEADER_SIZE = HEADER.size

CODEC_JSON = 0
CODEC_MSGPACK = 1

DEFAULT_MAX_FRAME = 64 * 1024 * 1024


class FrameError(Exception):
    """Raised on malformed frames (bad magic, oversize, unknown codec)."""


# ------------------------------------------------------------- msgpack


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(struct.pack("B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack("b", obj))
        elif obj >= 0:
            for lim, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                   (0xFFFFFFFF, 0xCE, ">I"),
                                   (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
                if obj <= lim:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
            else:
                raise OverflowError("int too big for msgpack")
        else:
            for lim, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                   (-0x80000000, 0xD2, ">i"),
                                   (-0x8000000000000000, 0xD3, ">q")):
                if obj >= lim:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
            else:
                raise OverflowError("int too small for msgpack")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n <= 0xFF:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n <= 0xFFFF:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n <= 0xFF:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n <= 0xFFFF:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n <= 0xFFFF:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n <= 0xFFFF:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}


def _unpack(data: bytes, i: int) -> Tuple[Any, int]:
    c = data[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8F:
        return _unpack_map(data, i, c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return _unpack_array(data, i, c & 0x0F)
    if 0xA0 <= c <= 0xBF:
        n = c & 0x1F
        return data[i:i + n].decode("utf-8"), i + n
    if c == 0xC0:
        return None, i
    if c == 0xC2:
        return False, i
    if c == 0xC3:
        return True, i
    if c in _FIXED:
        fmt = _FIXED[c]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, data, i)[0], i + size
    lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H",
            0xC6: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    if c in lens:
        fmt = lens[c]
        n = struct.unpack_from(fmt, data, i)[0]
        i += struct.calcsize(fmt)
        if c in (0xD9, 0xDA, 0xDB):
            return data[i:i + n].decode("utf-8"), i + n
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(data[i:i + n]), i + n
        if c in (0xDC, 0xDD):
            return _unpack_array(data, i, n)
        return _unpack_map(data, i, n)
    raise FrameError(f"unsupported msgpack type byte 0x{c:02x}")


def _unpack_array(data: bytes, i: int, n: int) -> Tuple[Any, int]:
    out = []
    for _ in range(n):
        item, i = _unpack(data, i)
        out.append(item)
    return out, i


def _unpack_map(data: bytes, i: int, n: int) -> Tuple[Any, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(data, i)
        v, i = _unpack(data, i)
        out[k] = v
    return out, i


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the packed subset."""
    try:
        obj, end = _unpack(data, 0)
    except (IndexError, struct.error, UnicodeDecodeError) as e:
        raise FrameError(f"malformed msgpack payload: {e}") from e
    if end != len(data):
        raise FrameError("trailing bytes after msgpack payload")
    return obj


# --------------------------------------------------------------- frames


def encode_frame(obj: Any, codec: int = CODEC_MSGPACK) -> bytes:
    if codec == CODEC_MSGPACK:
        payload = packb(obj)
    else:
        codec = CODEC_JSON
        payload = json.dumps(obj).encode("utf-8")
    return HEADER.pack(MAGIC, codec, 0, len(payload)) + payload


def decode_frame(data: bytes, max_frame: int = DEFAULT_MAX_FRAME
                 ) -> Tuple[Any, int]:
    """Decode one frame from ``data`` -> (object, bytes consumed)."""
    if len(data) < HEADER_SIZE:
        raise FrameError("short header")
    magic, codec, _flags, length = HEADER.unpack_from(data)
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:04x}")
    if length > max_frame:
        raise FrameError(f"frame of {length} bytes exceeds max {max_frame}")
    if len(data) < HEADER_SIZE + length:
        raise FrameError("short payload")
    payload = data[HEADER_SIZE: HEADER_SIZE + length]
    return _decode_payload(codec, payload), HEADER_SIZE + length


def _decode_payload(codec: int, payload: bytes) -> Any:
    if codec == CODEC_JSON:
        return json.loads(payload.decode("utf-8"))
    if codec == CODEC_MSGPACK:
        return unpackb(payload)
    raise FrameError(f"unknown codec {codec}")


async def read_frame(reader: asyncio.StreamReader,
                     max_frame: int = DEFAULT_MAX_FRAME,
                     timeout: Optional[float] = None) -> Any:
    """Read exactly one framed message (whatever the TCP segmentation)."""

    async def _read() -> Any:
        header = await reader.readexactly(HEADER_SIZE)
        return await read_frame_after_header(reader, header, max_frame)

    if timeout is None:
        return await _read()
    return await asyncio.wait_for(_read(), timeout=timeout)


async def read_frame_after_header(reader: asyncio.StreamReader,
                                  header: bytes,
                                  max_frame: int = DEFAULT_MAX_FRAME) -> Any:
    """Finish reading a frame whose ``HEADER_SIZE`` bytes were already
    read (the server reads a connection's first bytes to tell a frame from
    a plain-HTTP request: ``utils/rpc.py``)."""
    magic, codec, _flags, length = HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:04x}")
    if length > max_frame:
        raise FrameError(f"frame of {length} bytes exceeds max {max_frame}")
    payload = await reader.readexactly(length)
    return _decode_payload(codec, payload)


async def write_frame(writer: asyncio.StreamWriter, obj: Any,
                      codec: int = CODEC_MSGPACK) -> None:
    writer.write(encode_frame(obj, codec))
    await writer.drain()
