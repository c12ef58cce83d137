"""Time the port's attention kernels over e4m3 and e5m2 (fp8) pools
beside their bf16-pool instances, on one card, and the few kernel times
the port's first benchmark needs.

``chip_smoke.py`` times each fp8 instance at the main shapes and prints
the bf16 instance's time beside it. This script splits the ragged kernel's
main lattice (8 decode rows and two prefill chunks) into a decode-only and
a chunk-only lattice, to show which kind of item its fp8 path loses or
gains time on, adds ragged attention at Qwen2-7B's G 7, and times
flash-decode and its writeback form at B 8, B 1 (``FD_B1``, which
chip_smoke's default run leaves out), B 128 and at G 7, 12 and 16 (Hkv 4:
the 16-row instances at 12 and 16), with bf16 and fp32 q. Every row is
held to the plain version as in ``chip_smoke.py`` (its checks are reused)
and prints the bf16-pool time of the same case and q dtype from the same
run and the ratio, and the library call's time (SDPA, bf16 pools only).
Part ``int4`` times the int4 matmul at 128 rows (the bench's 128 decode
slots: the wgmma instance) on the four Llama-3-8B projections beside
cuBLAS ``mm`` on the dequantized weight.

    python scripts/fp8_times.py [--parts ragged,fd,groups,b1,b128,int4]

Needs a card. Every part by default; ``--parts ragged,fd,groups`` is the
set that two trees are compared on (each tree's copy of this script runs
against its own ``chip_smoke.py`` and package).
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# ragged lattices (ctx_len, q_len); rows 0 and 7 are inert (check_ragged
# aims their page tables at rows 1's and 6's live pages)
DECODE_ROWS = ([(0, 0)] + [(100 + 240 * i, 1) for i in range(6)] + [(0, 0)]
               + [(1540, 1), (1780, 1)])
CHUNK_ROWS = [(0, 0)] * 8 + [(0, 256), (444, 177)]
# flash-decode's single-user decode, which chip_smoke's default run leaves
# out: one 2,040-key slot alone (label, prefix lengths, n_side, fw side_idx,
# fw active; 8 side rows)
FD_B1 = [("B1", [2040], [8], [6], [1])]


PARTS = ("ragged", "fd", "groups", "b1", "b128", "int4")
# flash-decode and fw at these query-head groups (chip_smoke's
# GROUP_SHAPES: Hkv 4, Dh 128), ragged attention at G 7
FD_GROUPS = (7, 12, 16)
# the int4 matmul at the bench's 128 decode rows
INT4_M = 128


def with_fp8(check, torch, cs, **kw):
    """``check`` over bf16 pools, then over each fp8 dtype (bf16 q)."""
    return {"": check(torch, **kw), **{
        f".{suffix}": check(torch, kv, **kw)
        for kv, (suffix, _, _) in cs.KV8.items()}}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated subset of {PARTS}")
    parts = set(ap.parse_args().parts.split(","))
    if not parts <= set(PARTS):
        ap.error(f"--parts: unknown {sorted(parts - set(PARTS))}")
    import torch

    if not torch.cuda.is_available():
        print("fp8_times: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from distributed_inference_engine_tpu_torch.ops import _cuda

    _cuda.lib()
    card = cs.smi_line()
    res = {}

    def add(name, rows_by_suffix):
        for suffix, rows in rows_by_suffix.items():
            res[f"{name}{suffix}"] = rows
        torch.cuda.empty_cache()

    if "ragged" in parts:
        main_rows = list(cs.RAGGED_ROWS)
        for name, rows in (("ragged main", main_rows),
                           ("ragged decode", DECODE_ROWS),
                           ("ragged chunks", CHUNK_ROWS)):
            cs.RAGGED_ROWS = rows
            add(name, with_fp8(cs.check_ragged, torch, cs,
                               dtypes=("bfloat16",)))
        cs.RAGGED_ROWS = main_rows
        add("ragged g7", with_fp8(cs.check_ragged, torch, cs,
                                  shape=cs.GROUP_SHAPES[7],
                                  dtypes=("bfloat16",)))
    fd_checks = (("flash_decode", cs.check_flash_decode),
                 ("flash_decode_fw", cs.check_flash_decode_fw))
    for part, cases, label, dtypes in (
            ("fd", cs.FD_CASES, "", ("bfloat16", "float32")),
            ("b1", FD_B1, " b1", ("bfloat16", "float32")),
            ("b128", cs.FD_B128, " b128", ("bfloat16",))):
        if part not in parts:
            continue
        for name, check in fd_checks[:1] if part == "b128" else fd_checks:
            add(name + label, with_fp8(check, torch, cs, cases=cases,
                                       dtypes=dtypes))
    if "groups" in parts:
        for g in FD_GROUPS:
            for name, check in fd_checks:
                add(f"{name} g{g}", with_fp8(
                    check, torch, cs, cases=cs.FD_CASES[:1],
                    shape=cs.GROUP_SHAPES[g], dtypes=("bfloat16",)))
    if "int4" in parts:
        rows, shapes, edges = cs.INT4_ROWS, cs.INT4_SHAPES, cs.INT4_EDGES
        cs.INT4_ROWS, cs.INT4_EDGES = (INT4_M,), []
        cs.INT4_SHAPES = [sh for sh in shapes if sh[0] != "lm_head"]
        res["int4_matmul m128"] = cs.check_int4(torch)
        cs.INT4_ROWS, cs.INT4_SHAPES, cs.INT4_EDGES = rows, shapes, edges
    cs.note_fp8_against_bf16(res)
    bad = []
    for name, rows in res.items():
        for r in rows:
            lib = r["library_ms"]
            print(f"[fp8_times] {name:22s} {r['dtype']:8s} {r['shape']:58s}"
                  f" {'ok' if r['ok'] else 'FAIL'} {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms, library "
                  + (f"{lib:.4f} ms ({r['ms'] / lib:.3f}x)" if lib else
                     "none")
                  + f" ({r.get('note', '')}) [{card}]", flush=True)
            if not r["ok"]:
                bad.append(f"{name} {r['dtype']} {r['shape']}")
    if bad:
        print(f"fp8_times: disagree with the plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
