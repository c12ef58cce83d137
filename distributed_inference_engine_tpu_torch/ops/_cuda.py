"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` (all started together) for
``sm_90a``; the objects link into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, from the
sources in the checkout, into ``_build/`` beside the package (listed in
``.gitignore``); the library's name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a current one is reused. A file
lock serialises concurrent builds (a worker process and the process that
launched it).

The link names only the CUDA runtime (no ``-lcuda``). The one driver-API
call, ``cuTensorMapEncodeTiled`` for the int4 kernel's TMA tensor maps,
is fetched at run time through ``cudaGetDriverEntryPoint(ByVersion)``.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.

CUDA graphs (the engine's decode chunks and mixed steps): ``LAUNCHES``
counts in Python, where a wrapper launches its kernel (``count_launch``),
so a replayed graph would count nothing. ``capture_graph`` records the
launches of the capture's one pass through the wrappers
(``recording_launches``: on the recording thread they go to the
recording, not to ``LAUNCHES``, since a capture launches nothing), and
every ``CapturedGraph.replay`` adds that delta again: the counts read as
if the body had run eagerly. A recording holds its own thread's launches
only, so a graph captured while another thread serves (a worker staging
a model) records none of the server's. ``warm_up`` is the eager pass before a capture, on
the capture stream: it makes each kernel's first-launch host calls
(``cudaFuncSetAttribute``, the ``cuTensorMapEncodeTiled`` lookup),
cuBLAS's workspaces and the split scratch of flash-decode and paged
attention (``split_scratch``) outside any graph.
All graphs are captured on one stream a device (``capture_stream``), under
``GRAPH_LOCK``.

Host transfers of the engine: ``HostRead`` is the one read of a chunk's
packed output (the counterpart of JAX's ``copy_to_host_async`` and
``is_ready``): a non-blocking copy into pinned host memory queued right
behind the work that wrote it, with an event behind the copy, so the host
can poll for it and waits on that event only. ``upload`` and
``upload_into`` copy host data to the card through pinned memory without
a stream synchronisation (a plain ``copy_`` from pageable memory waits for
every kernel queued before it), so the host can queue a chunk while the
previous one runs.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import functools
import gc
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("flash_decode.cu", "flash_decode_fw.cu", "flash_decode_fp8.cu",
           "flash_decode_e5m2.cu", "fused_decode.cu", "int4_matmul.cu",
           "paged_attention.cu", "paged_attention_fp8.cu",
           "ragged_attention.cu", "ragged_attention_fp8.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

# dtype codes of csrc/common.cuh (FP8, e4m3, and E5M2: pools only)
F32, BF16, FP8, E5M2 = 0, 1, 2, 3
# a KV pool's fp8 dtypes: (code, the instance's launch-count suffix)
_POOL_FP8 = {torch.float8_e4m3fn: (FP8, "fp8"),
             torch.float8_e5m2: (E5M2, "e5m2")}

# launches per kernel: each wrapper adds one where it launches its kernel
# (and nowhere else), so a run can show the main path went through it
LAUNCHES: "collections.Counter[str]" = collections.Counter()
# the recording_launches block open on each thread, if any
_RECORDING = threading.local()

_lib: Optional[ctypes.CDLL] = None
last_build: Dict[str, object] = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _counter() -> "collections.Counter[str]":
    rec = getattr(_RECORDING, "counter", None)
    return LAUNCHES if rec is None else rec


def count_launch(*names: str) -> None:
    """One launch under each of ``names`` (a kernel and its instance):
    into this thread's open ``recording_launches`` block, else into
    ``LAUNCHES``."""
    _counter().update(names)


@contextlib.contextmanager
def recording_launches() -> Iterator["collections.Counter[str]"]:
    """Yield a Counter that holds the launches this thread counts inside
    the block; ``LAUNCHES`` does not see them, and other threads' launches
    go to ``LAUNCHES`` as before."""
    prev = getattr(_RECORDING, "counter", None)
    delta: "collections.Counter[str]" = collections.Counter()
    _RECORDING.counter = delta
    try:
        yield delta
    finally:
        _RECORDING.counter = prev


class CapturedGraph:
    """A captured CUDA graph (or anything with ``replay()``), the launches
    one pass of its body counts, and the body's outputs (tensors at fixed
    addresses that every replay rewrites)."""

    __slots__ = ("graph", "launches", "outputs", "capture_s", "warmup_s",
                 "__weakref__")

    def __init__(self, graph: Any, launches: Dict[str, int], outputs: Any,
                 capture_s: float = 0.0) -> None:
        self.graph = graph
        self.launches = collections.Counter(launches)
        self.outputs = outputs
        self.capture_s = capture_s
        self.warmup_s = 0.0        # the eager pass before it, if any
        _LIVE_GRAPHS.add(self)

    def replay(self) -> Any:
        """Launch the graph (never while another thread warms up or
        captures one) and count its kernels' launches; returns the
        outputs."""
        with GRAPH_LOCK:
            self.graph.replay()
        _counter().update(self.launches)
        return self.outputs


# graphs are captured one at a time per process, and a capture's warm-up
# must not interleave with another thread's replays (flash-decode's split
# scratch of the capture stream is shared by every graph: ops/flash_decode.py)
GRAPH_LOCK = threading.RLock()
# every captured graph still alive in the process (release_scratch's guard:
# a graph holds the scratch's and cuBLAS workspaces' addresses)
_LIVE_GRAPHS: "weakref.WeakSet[CapturedGraph]" = weakref.WeakSet()
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one stream of ``device`` that every graph is warmed up and
    captured on."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _CAPTURE_STREAMS[idx]


def warm_up(body: Callable[[], Any], stream: "torch.cuda.Stream") -> Any:
    """Run ``body`` eagerly on ``stream`` (ordered after the current
    stream's work, and before its later work); returns its outputs."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = body()
    cur.wait_stream(stream)
    torch.cuda.synchronize(stream.device)
    return out


def capture_graph(body: Callable[[], Any], *, pool: Any,
                  stream: "torch.cuda.Stream",
                  generators: Tuple[torch.Generator, ...] = ()
                  ) -> CapturedGraph:
    """Capture one call of ``body`` into a CUDA graph in memory ``pool``
    on ``stream`` (warmed up by the caller); each generator in
    ``generators`` is registered so every replay draws fresh numbers and
    advances it. Raises if the capture fails: there is no eager
    fallback."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    t0 = time.perf_counter()
    # capture_begin/end directly: the torch.cuda.graph context would also
    # empty the allocator's cache and collect garbage first, which costs
    # more than the capture itself in a serving process. The cyclic
    # collector is off instead while the stream captures: a collection
    # there could tear down an unreachable graph (an engine left in a
    # reference cycle), and that teardown is not permitted during a
    # capture, so it would invalidate this one
    collecting = gc.isenabled()
    gc.disable()
    try:
        with recording_launches() as delta, torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = body()
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    return CapturedGraph(graph, delta, out, time.perf_counter() - t0)


class HostRead:
    """One device tensor's copy into host memory. On a CUDA device the
    copy goes into a pinned buffer of its own (from the caching host
    allocator, which keeps the block until the copy has run), queued on
    the current stream right behind the work that wrote the tensor, with
    an event recorded behind it: ``ready()`` polls that event without a
    host synchronisation, ``numpy()`` waits on it alone. On the CPU the
    tensor is already final, so the read is always ready."""

    __slots__ = ("host", "event")

    def __init__(self, src: torch.Tensor) -> None:
        if src.device.type != "cuda":
            self.host, self.event = src, None
            return
        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        self.host.copy_(src, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(src.device))

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        """The host bytes (a copy of their own), once the copy has run."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


def _host_tensor(a, dtype: Optional[torch.dtype]) -> torch.Tensor:
    t = (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(a)))
    return t if dtype is None else t.to(dtype)


def upload(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host data ``a`` (a numpy array, or a CPU tensor) as a tensor on
    ``device``: on a CUDA device a pinned copy and a non-blocking
    host-to-device copy (no stream synchronisation); on the CPU the data
    itself."""
    t = _host_tensor(a, dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, a) -> None:
    """Copy host data ``a`` into ``dst`` in place, as ``upload`` does."""
    t = _host_tensor(a, dst.dtype)
    if dst.device.type != "cuda":
        dst.copy_(t)
        return
    dst.copy_(t.pin_memory(), non_blocking=True)



def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a current library exists; returns its
    path. ``last_build`` records the build seconds, each source's seconds
    (``source_seconds``: when its ``nvcc`` ended, all started together)
    and, with ``verbose``, each source's ``-Xptxas -v`` report (registers,
    spills, smem)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libdie_kernels_{_digest()}.so"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            last_build.update(path=str(lib_path), seconds=0.0, cached=True)
            return lib_path
        nvcc = _nvcc()
        t0 = time.perf_counter()
        extra = ["-Xptxas", "-v"] if verbose else []
        procs: List = []
        objs: List[Path] = []
        for src in SOURCES:
            obj = BUILD_DIR / (Path(src).stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *extra, "-c",
                 str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        reports, ended = {}, {}

        def wait(src, p):
            reports[src], _ = p.communicate()
            ended[src] = time.perf_counter() - t0

        waits = [threading.Thread(target=wait, args=sp) for sp in procs]
        for t in waits:
            t.start()
        for t in waits:
            t.join()
        failed = [f"{src}:\n{reports[src]}" for src, p in procs
                  if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = lib_path.with_suffix(".so.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *[str(o) for o in objs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib_path)
        last_build.update(path=str(lib_path),
                          seconds=time.perf_counter() - t0, cached=False,
                          reports=reports, source_seconds=ended)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        P, I, F, LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        handle.die_flash_decode.argtypes = [
            P, P, P, P, P, P, P, P, P, P, P,     # q .. out, ws, counters
            I, I, I, I, I, I, I, I, I,           # shapes, split
            LL, I, I, P]                         # layer base, dtypes, stream
        handle.die_flash_decode_fw.argtypes = [
            P, P, P, P, P, P, P, P, P, P, P, P,  # q .. out
            P, P,                                # ws, counters
            I, I, I, I, I, I, I, I, I,           # shapes, split
            LL, I, I, P]                         # layer base, dtypes, stream
        handle.die_ragged_attention.argtypes = [
            P, P, P, P, P, P, P, P, P,           # q .. out
            I, I, I, I, I, I, I, I, I,           # shapes, query tiles, grid
            LL, I, I, P]                         # layer base, dtypes, stream
        handle.die_norm_matmul.argtypes = [
            P, P, P, P, I, I, I, F, I, I, I, I, P]
        handle.die_matmul_residual.argtypes = [
            P, P, P, P, I, I, I, I, I, I, P]
        handle.die_int4_matmul.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I, I, P]
        handle.die_paged_attention.argtypes = [
            P, P, P, P, P, P, P, P, P, P,        # q .. l_out, ws, counters
            I, I, I, I, I, I, I, I, I,           # shapes, window, split
            I, I,                                # rows a block, route
            LL, I, I, P]                         # layer base, dtypes, stream
        for fn in (handle.die_flash_decode, handle.die_flash_decode_fw,
                   handle.die_ragged_attention, handle.die_norm_matmul,
                   handle.die_matmul_residual, handle.die_int4_matmul,
                   handle.die_paged_attention):
            fn.restype = I
        _lib = handle
    return _lib


def dtype_code(dt: torch.dtype, pool: bool = False) -> int:
    """The kernels' code of ``dt``: fp32 or bf16 for every operand, and
    e4m3 or e5m2 for a KV pool (``pool``)."""
    if dt == torch.float32:
        return F32
    if dt == torch.bfloat16:
        return BF16
    if pool and dt in _POOL_FP8:
        return _POOL_FP8[dt][0]
    raise TypeError(f"kernel takes float32 or bfloat16"
                    f"{' (or float8_e4m3fn, float8_e5m2 pools)' if pool else ''}"
                    f", not {dt}")


def pool_instance(name: str, kv_dtype: torch.dtype) -> Tuple[str, ...]:
    """The names a launch of kernel ``name`` over pools of ``kv_dtype``
    counts under: the kernel's, and ``<name>.fp8`` for its e4m3-pool
    instance or ``<name>.e5m2`` for its e5m2-pool one."""
    if kv_dtype in _POOL_FP8:
        return (name, f"{name}.{_POOL_FP8[kv_dtype][1]}")
    return (name,)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count, which the wrappers size their grids by."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# the cluster GEMVs (csrc/fused_decode.cu cluster_gemv,
# csrc/int4_matmul.cu int4_gemv_mma_kernel): the most blocks a cluster (the
# portable size) and the blocks an SM a grid aims for (4: measured faster
# than 2 for norm_matmul at N 14336 and the int4 gate|up on the H100)
MAX_CLUSTER = 8
CLUSTER_BLOCKS_PER_SM = 4


def cluster_split(k_tiles: int, blocks: int, sms: int) -> Tuple[int, int]:
    """A contraction of ``k_tiles`` stages split over the blocks of one
    thread-block cluster, for a grid of ``blocks`` blocks before the split:
    ``(ks, chunk_tiles)``, where ``ks`` (1, 2, 4 or 8) is the largest count
    that keeps the grid within ``CLUSTER_BLOCKS_PER_SM`` blocks an SM and
    gives each block at least one stage, and each block takes
    ``chunk_tiles`` stages (the last blocks' chunks may be short or
    empty)."""
    ks = 1
    while (ks * 2 <= MAX_CLUSTER and ks * 2 <= k_tiles and
           blocks * ks * 2 <= CLUSTER_BLOCKS_PER_SM * sms):
        ks *= 2
    return ks, -(-k_tiles // ks)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# (device index, stream) -> (fp32 partials, int32 arrival counters) of the
# split-KV grids of flash-decode, fw and paged attention, grown on demand;
# each kernel leaves the counters at 0. A buffer that a larger one replaces
# stays in _RETIRED: a CUDA graph captured against it still writes there.
# See split_scratch for what this asks of CUDA graphs.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_RETIRED: List[torch.Tensor] = []
# a worker has more than one thread that may launch (a serving pump, a
# model staging beside it): the lookup and the growth are one step
_SCRATCH_LOCK = threading.Lock()


def split_scratch(device: torch.device, n_partials: int, n_groups: int):
    """Workspace and zeroed counters of a split-KV grid on this device's
    current stream (kept: calls on one stream run in order, and each
    launch leaves its counters at 0; the attention kernels share them).

    The scratch is keyed by the raw stream pointer, so two launches that
    run at the same time must not share a stream's scratch. A CUDA graph
    records the pointers of the scratch of the stream it was captured on.
    The design chosen for the engine's graphs: every graph is warmed up
    and captured on the one capture stream of its device, so the warm-up
    allocates and zeroes that stream's scratch outside every graph pool
    and all graphs share it; every replay and every eager call is issued
    on the caller's current stream, one stream, so none overlaps another,
    and no eager call runs on the capture stream outside a warm-up (which
    holds ``GRAPH_LOCK``). A buffer is never freed once a graph may hold
    its address (``_RETIRED``). Threads that launch on one stream (a
    worker's pumps and its staging thread all launch on the default
    stream) run in that stream's order on the card; ``_SCRATCH_LOCK``
    keeps the table and its growth consistent on the host."""
    key = (device.index, stream_ptr(device))
    with _SCRATCH_LOCK:
        ws, cnt = _SCRATCH.get(key, (None, None))
        if ws is None or ws.numel() < n_partials:
            if ws is not None:
                _RETIRED.append(ws)
            ws = torch.empty((n_partials,), dtype=torch.float32,
                             device=device)
        if cnt is None or cnt.numel() < n_groups:
            if cnt is not None:
                _RETIRED.append(cnt)
            cnt = torch.zeros((n_groups,), dtype=torch.int32, device=device)
        _SCRATCH[key] = (ws, cnt)
    return ws, cnt


def release_scratch() -> bool:
    """Free the split scratch (current and retired) and cuBLAS's
    workspaces, so that the caching allocator can give their segments
    back: done only when no captured graph is alive, since a graph
    replays into their addresses; returns whether it was done. For a
    process that has closed every engine (a worker with no model left):
    these small buffers, kept for later models, would otherwise pin the
    allocator segments they were carved from. The next launch that needs
    them allocates them again."""
    with GRAPH_LOCK, _SCRATCH_LOCK:
        if len(_LIVE_GRAPHS):
            return False
        _SCRATCH.clear()
        _RETIRED.clear()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None and torch.cuda.is_initialized():
        clear()
    return True


def check(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_int32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        require(t.dtype == torch.int32, f"{name}: index tensors must be "
                "int32")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device/contiguity/alignment checks shared by the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        require(t.device == dev, f"{name}: tensors on different devices")
        require(t.is_contiguous(), f"{name}: tensors must be contiguous")
        require(t.data_ptr() % 16 == 0,
                f"{name}: tensor data must be 16-byte aligned")
