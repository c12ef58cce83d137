"""Configuration of the port (copy of the JAX package's ``config.py``
subset a worker reads): ``ModelConfig``, ``EngineConfig``,
``ServerConfig`` and ``MultihostConfig`` keep their field names and
defaults, and ``load_config`` reads the same ``.json`` and ``.toml``
files into a ``Config`` (the JAX minimal TOML reader included).

The port does not carry every engine feature yet. Setting one that it
lacks raises ``NotImplementedError`` naming its ROADMAP.md item — it is
never silently ignored (``EngineConfig.check_supported``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Any, Dict, List


def build_dataclass(cls, d: Dict[str, Any]):
    """Construct ``cls`` from a dict, dropping unknown keys."""
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class ModelConfig:
    """Per-model deployment config (same fields as the JAX package's)."""

    name: str
    path: str = ""                     # checkpoint dir, or "" for random init
    version: str = "1.0"
    architecture: str = "fake"
    dtype: str = "bfloat16"
    batch_size: int = 1
    max_batch_size: int = 8
    max_seq_len: int = 2048
    quantized: bool = False
    input_schema: Dict[str, str] = field(default_factory=dict)
    output_schema: Dict[str, str] = field(default_factory=dict)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        return build_dataclass(cls, d)


@dataclass
class EngineConfig:
    """Continuous-engine knobs (field names and defaults of the JAX
    package's ``EngineConfig``)."""

    max_seq_len: int = 2048
    max_slots: int = 8
    prefill_buckets: List[int] = field(default_factory=lambda: [128, 512, 2048])
    page_size: int = 128
    num_pages: int = 512
    dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"
    decode_steps_per_call: int = 8
    use_paged_kv: bool = False
    attention_impl: str = "auto"       # "auto" | "pallas-decode": the
    # flash-decode kernel (ops/flash_decode.py) on the window scheme;
    # "pallas-decode-fw": its side-window writeback variant; "pallas":
    # the paged-attention kernel (ops/paged_attention.py) over the frozen
    # prefix, merged with the side window; "pallas-ragged": with
    # prefill_chunk, the ragged mixed step (ops/ragged_attention.py),
    # flash-decode on pure-decode steps. decode_mode="inline" (and every
    # sliding-window spec) runs the paged-attention kernel whatever this is
    decode_fused: bool = False         # norm_matmul / matmul_residual
    # kernels on the decode step (ops/fused_decode.py)
    decode_mode: str = "window"        # "window" | "inline": the per-step
    # page write (models/base.py:forward_decode_paged)
    prefix_cache: bool = True
    kv_offload: bool = False
    kv_offload_bytes: int = 1 << 30
    prefill_chunk: int = 0
    mixed_step_tokens: int = 0
    defer_admission: bool = True       # under decode pressure (>= 1/4 of
    # the slots live) an admission round's first tokens stay on the device
    # and ride the next chunk's packed read instead of a read of their own
    defer_sync: bool = False           # read chunk k's packed output after
    # queueing chunk k+1 (needs a fully backed page pool)
    stream_chunk_steps: int = 0        # while a live slot streams, decode
    # in chunks of this many steps (rounded up to a power of two)
    max_waiting: int = 0               # submits past this many waiting
    # requests raise EngineOverloadedError (0: no cap)
    queue_deadline_s: float = 0.0      # a request still queued this long
    # resolves "overloaded" at step start (0: never)
    admission_min_batch: int = 0
    admission_max_hold_s: float = 0.25
    admission_max_rows: int = 0
    timeline_capacity: int = 4096      # step-timeline ring (obs/timeline.py)
    # records per engine; 0 disables it
    spec_async: bool = False
    spec_draft_model: str = ""
    spec_max_draft: int = 4
    spec_bubble_floor_s: float = 5e-4

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for a feature the port lacks."""
        def no(what: str, item: str) -> None:
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch engine yet "
                f"(ROADMAP.md {item})")

        if self.decode_mode not in ("window", "inline"):
            raise ValueError(
                f"decode_mode {self.decode_mode!r} is not 'window'|'inline'")
        if self.kv_offload:
            no("kv_offload (host KV tier)", "A10")
        if self.attention_impl not in ("auto", "pallas", "pallas-decode",
                                       "pallas-decode-fw", "pallas-ragged"):
            raise ValueError(
                f"attention_impl {self.attention_impl!r}: the PyTorch engine "
                "runs 'auto', 'pallas', 'pallas-decode', 'pallas-decode-fw' "
                "or 'pallas-ragged'; the XLA and interpret paths are TPU "
                "choices it does not carry")


@dataclass
class ServerConfig:
    """Worker server config (same fields as the JAX package's)."""

    host: str = "127.0.0.1"
    port: int = 0
    worker_id: str = "worker-0"
    request_timeout: float = 30.0
    max_frame_bytes: int = 64 * 1024 * 1024
    # multi-model residency budget (cluster/model_manager.py): how many
    # engines one worker may hold and their total parameter bytes; over
    # either, admission evicts idle models, least recently used first
    # (0 = unbounded)
    max_resident_models: int = 0
    resident_bytes: int = 0
    # the worker's typed event ring (obs/events.py), served by ``events``
    event_ring_capacity: int = 2048


@dataclass
class MultihostConfig:
    """Multi-host bootstrap section of a config file (same fields as the
    JAX package's). The port serves one card a process: ``enabled`` raises
    in the worker CLI (ROADMAP.md A13)."""

    enabled: bool = False
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1


@dataclass
class Config:
    """A config file's sections that a worker reads: ``models``,
    ``engine``, ``server`` and ``multihost``. The JAX ``Config``'s other
    sections (``mesh``, ``batcher``, ``cache``, ``health``,
    ``autoscaler``) configure the coordinator's host plane, which the JAX
    worker ignores as well; ``load_config`` skips them."""

    models: List[ModelConfig] = field(default_factory=list)
    engine: EngineConfig = field(default_factory=EngineConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    multihost: MultihostConfig = field(default_factory=MultihostConfig)


def config_from_dict(d: Dict[str, Any]) -> Config:
    cfg = Config()
    if "models" in d:
        cfg.models = [ModelConfig.from_dict(m) for m in d["models"]]
    for section, cls in (("engine", EngineConfig), ("server", ServerConfig),
                         ("multihost", MultihostConfig)):
        if section in d:
            setattr(cfg, section, build_dataclass(cls, d[section]))
    return cfg


def _toml_scalar(raw: str):
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"'):
        return raw[1:-1]
    if raw.startswith("'") and raw.endswith("'"):
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        return [_toml_scalar(x) for x in inner.split(",")] if inner else []
    try:
        return int(raw)
    except ValueError:
        return float(raw)


def _parse_toml_minimal(text: str) -> dict:
    """TOML reader for the subset the config files use (the JAX
    package's): ``[table]``, ``[nested.table]``, ``[[array of tables]]``
    and scalar or flat-list values; used where ``tomllib`` is missing."""
    root: dict = {}
    cur = root
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[["):
            parts = line[2:].split("]]", 1)[0].strip().split(".")
            parent = root
            for k in parts[:-1]:
                parent = parent.setdefault(k, {})
            cur = {}
            parent.setdefault(parts[-1], []).append(cur)
        elif line.startswith("["):
            parts = line[1:].split("]", 1)[0].strip().split(".")
            # [models.metadata] after [[models]] nests into the last
            # element of the models array
            parent = root
            for k in parts[:-1]:
                node = parent.get(k)
                parent = node[-1] if isinstance(node, list) else \
                    parent.setdefault(k, {})
            node = parent.get(parts[-1])
            if isinstance(node, list):
                cur = node[-1]
            else:
                cur = parent.setdefault(parts[-1], {})
        else:
            key, _, raw = line.partition("=")
            raw = raw.strip()
            if not (raw.startswith('"') or raw.startswith("'")):
                raw = raw.split("#", 1)[0]       # a trailing comment
            cur[key.strip()] = _toml_scalar(raw)
    return root


def _loads_toml(text: str) -> dict:
    try:
        import tomllib
    except ImportError:
        return _parse_toml_minimal(text)
    return tomllib.loads(text)


def load_config(path: str) -> Config:
    """A ``Config`` from a ``.json`` or ``.toml`` file."""
    p = pathlib.Path(path)
    text = p.read_text()
    if p.suffix == ".json":
        data = json.loads(text)
    elif p.suffix == ".toml":
        data = _loads_toml(text)
    else:
        raise ValueError(f"unsupported config extension: {p.suffix} "
                         "(the port reads .json and .toml)")
    return config_from_dict(data or {})
