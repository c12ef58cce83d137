"""Native weight checkpoints of the port: a parameter tree and its model
spec in a directory (the counterpart of the JAX package's
``utils/checkpoint.py``, in a format of the port's own).

Layout:

    <path>/spec.json                     the ModelSpec (``to_dict``)
    <path>/params/params.safetensors     every leaf, named by its path in
                                         the tree (``blocks.wq``)

The JAX package writes ``params/`` with Orbax, which imports JAX, so the
port cannot read it; it writes safetensors instead
(``utils/safetensors_io.py``). ``is_native_checkpoint`` is true only for
the port's directories. A JAX Orbax directory has ``spec.json`` and
``params/`` too; ``load_params`` refuses it with a clear error rather
than misread it.

A ``QuantizedTensor`` is stored as its payload ``<path>.q`` and scales
``<path>.s`` beside 0-d int32 tensors ``<path>.bits`` and
``<path>.pack_axis``, a marker ``<path>.__quantized_tensor__`` and, for
int4, the layout ``<path>.layout`` (``INT4_LAYOUT_SPLIT_HALF``), the
fields of the JAX sentinel dict. A node without ``bits`` is int8; an
int4 node without ``layout`` is in the older even/odd interleave and is
repacked once on restore.

The training state (``save_train_state``/``load_train_state``) comes with
training (ROADMAP.md A13).
"""

from __future__ import annotations

import json
import pathlib
import shutil
from typing import Any, Dict

import torch

from .files import atomic_write_json
from .safetensors_io import load_file, save_file

SPEC_FILE = "spec.json"
PARAMS_DIR = "params"
PARAMS_FILE = "params.safetensors"
_QUANT_MARKER = "__quantized_tensor__"


def _scalar(v: int) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32)


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of a parameter tree, ``QuantizedTensor`` nodes
    encoded as in the module docstring."""
    from ..ops.quant import INT4_LAYOUT_SPLIT_HALF, QuantizedTensor

    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, QuantizedTensor):
        out.update({prefix + "q": tree.q, prefix + "s": tree.s,
                    prefix + _QUANT_MARKER: torch.tensor(1, dtype=torch.int8),
                    prefix + "bits": _scalar(tree.bits),
                    prefix + "pack_axis": _scalar(tree.pack_axis)})
        if tree.bits == 4:
            out[prefix + "layout"] = _scalar(INT4_LAYOUT_SPLIT_HALF)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if "." in k:
                raise ValueError(f"tree key {k!r} holds a '.'")
            out.update(flatten_tree(v, prefix + k + "."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree
    else:
        raise TypeError(f"{prefix[:-1]}: cannot store a {type(tree).__name__}")
    return out


def unflatten_tree(flat: Dict[str, torch.Tensor]) -> Any:
    """The inverse of ``flatten_tree``: nested dicts, and a
    ``QuantizedTensor`` wherever the marker is (int8 without ``bits``; an
    int4 payload without ``layout`` repacked to split-half)."""
    from ..ops.quant import QuantizedTensor, repack_int4_interleaved_to_split

    root: Dict[str, Any] = {}
    for path, t in flat.items():
        *parents, leaf = path.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t

    def dec(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if _QUANT_MARKER in node:
            qt = QuantizedTensor(q=node["q"], s=node["s"],
                                 bits=int(node.get("bits", 8)),
                                 pack_axis=int(node.get("pack_axis", 0)))
            if qt.bits == 4 and "layout" not in node:
                qt = repack_int4_interleaved_to_split(qt)
            return qt
        return {k: dec(v) for k, v in node.items()}

    return dec(root)


def _params_file(path: str) -> pathlib.Path:
    return pathlib.Path(path).absolute() / PARAMS_DIR / PARAMS_FILE


def is_native_checkpoint(path: str) -> bool:
    """True when ``path`` is a directory written by ``save_params``."""
    p = pathlib.Path(path)
    return (p / SPEC_FILE).is_file() and _params_file(path).is_file()


def save_params(path: str, spec, params: Any) -> str:
    """Write ``params`` (on any device) and the spec sidecar to ``path``;
    returns the absolute path. A ``params/`` already there is replaced."""
    p = pathlib.Path(path).absolute()
    p.mkdir(parents=True, exist_ok=True)
    flat = flatten_tree(params)
    # atomic: a crash mid-save must not leave a torn spec sidecar
    atomic_write_json(str(p / SPEC_FILE), spec.to_dict())
    shutil.rmtree(p / PARAMS_DIR, ignore_errors=True)
    save_file(flat, str(_params_file(str(p))))
    return str(p)


def load_spec(path: str):
    """The ModelSpec sidecar of a checkpoint directory."""
    from ..models.base import ModelSpec

    d = json.loads((pathlib.Path(path) / SPEC_FILE).read_text())
    return ModelSpec.from_dict(d)


def load_params(path: str, device="cuda") -> Any:
    """The tree ``save_params`` wrote, on ``device`` (each tensor copied
    off the file's mapping). A JAX Orbax directory raises ``ValueError``."""
    f = _params_file(path)
    if not f.is_file():
        d = pathlib.Path(path) / PARAMS_DIR
        what = ("a JAX Orbax checkpoint (its params/ holds no "
                f"{PARAMS_FILE})" if d.is_dir() else f"missing {d}")
        raise ValueError(
            f"{path} is not a native checkpoint of the PyTorch port: {what}."
            " The port reads its own native directories and HF safetensors"
            " directories, not JAX Orbax directories")
    return unflatten_tree(load_file(str(f), device))


def tree_leaves(tree: Any, prefix: str = ""):
    """``(path, tensor)`` of every array leaf, ``QuantizedTensor`` payloads
    and scales as ``<path>.q``/``<path>.s`` (the leaves a checksum
    covers; ``bits`` and ``pack_axis`` are the node's structure)."""
    from ..ops.quant import QuantizedTensor

    if isinstance(tree, QuantizedTensor):
        yield prefix + "q", tree.q
        yield prefix + "s", tree.s
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, prefix + k + ".")
    else:
        yield prefix[:-1], tree
