"""The host memory a checkpoint read to the card costs: a 4 GiB file of
random bytes read into one device tensor in 256 MiB pieces, each way in a
process of its own (``ru_maxrss`` is a process's lifetime peak):

- ``mmap``: a private mapping, ``torch.frombuffer`` over each piece,
  copied to the card (the reader of ``utils/safetensors_io.py``);
- ``mmap_dontneed``: the same, each piece's pages released after its copy
  (``madvise(MADV_DONTNEED)``, as ``SafetensorsFile.release`` does);
- ``readinto``: ``readinto`` a pageable host buffer, then copied;
- ``pinned``: the same into a pinned buffer.

Each prints the seconds and GiB/s, ``ru_maxrss`` before and after, and
the peak and final resident set from ``/proc/self/statm``.

    python scripts/ckpt_read_rss.py

Needs a card; writes its file under the checkout's ``_work/`` and
removes it.
"""

import mmap
import os
import pathlib
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
PATH = ROOT / "_work" / "ckpt_read_rss.bin"
N, PIECE = 4 << 30, 256 << 20
MODES = ("mmap", "mmap_dontneed", "readinto", "pinned")


def statm_gib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def run(mode: str) -> None:
    import torch

    torch.empty(1, device="cuda")
    base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    dst = torch.empty(N, dtype=torch.uint8, device="cuda")
    peak = 0.0
    t0 = time.perf_counter()
    if mode.startswith("mmap"):
        with open(PATH, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        for off in range(0, N, PIECE):
            t = torch.frombuffer(mm, dtype=torch.uint8, count=PIECE,
                                 offset=off)
            dst[off:off + PIECE].copy_(t)
            del t
            if mode == "mmap_dontneed":
                mm.madvise(mmap.MADV_DONTNEED, off, PIECE)
            peak = max(peak, statm_gib())
    else:
        buf = torch.empty(PIECE, dtype=torch.uint8,
                          pin_memory=(mode == "pinned"))
        with open(PATH, "rb", buffering=0) as f:
            for off in range(0, N, PIECE):
                f.readinto(memoryview(buf.numpy()))
                dst[off:off + PIECE].copy_(buf)
                peak = max(peak, statm_gib())
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"{mode}: {N / 2**30:.0f} GiB in {s:.2f} s = "
          f"{N / 2**30 / s:.2f} GiB/s; ru_maxrss {base:.2f} -> {after:.2f} "
          f"GiB; statm resident peak {peak:.2f} GiB, now {statm_gib():.2f}",
          flush=True)


def main() -> None:
    PATH.parent.mkdir(exist_ok=True)
    rs = np.random.default_rng(0)
    try:
        with open(PATH, "wb") as f:
            for _ in range(N // PIECE):
                f.write(rs.integers(0, 256, PIECE, dtype=np.uint8).tobytes())
        for mode in MODES:
            subprocess.run([sys.executable, __file__, mode], check=True)
    finally:
        PATH.unlink(missing_ok=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run(sys.argv[1])
    else:
        main()
