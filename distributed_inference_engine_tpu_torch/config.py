"""Configuration of the port (copy of the JAX package's ``config.py``
subset the serving path reads): ``ModelConfig``, ``EngineConfig`` and
``ServerConfig`` keep their field names and defaults.

The port does not carry every engine feature yet. Setting one that it
lacks raises ``NotImplementedError`` naming its ROADMAP.md item — it is
never silently ignored (``EngineConfig.check_supported``). One default
differs, noted at its field: ``timeline_capacity`` is off until ported.
"""

from __future__ import annotations

import dataclasses
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
    timeline_capacity: int = 0         # differs from the JAX default
    # (4096): the port records no step timeline yet (ROADMAP A6); nonzero
    # raises
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
        if "float8" in str(self.kv_dtype):
            no(f"kv_dtype={self.kv_dtype} (fp8 KV pools)", "A5f")
        if self.kv_offload:
            no("kv_offload (host KV tier)", "A10")
        if self.spec_async:
            no("spec_async (async speculation)", "A12")
        if self.timeline_capacity:
            no("timeline_capacity (step timeline)", "A6")
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
    max_resident_models: int = 0       # multi-model residency budget: not
    resident_bytes: int = 0            # ported (ROADMAP A6); nonzero raises
    event_ring_capacity: int = 2048    # the port keeps no event ring yet
