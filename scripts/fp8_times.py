"""Time the port's attention kernels over e4m3 and e5m2 (fp8) pools
beside their bf16-pool instances, on one card.

``chip_smoke.py`` times each fp8 instance at the main shapes and prints
the bf16 instance's time beside it. This script splits the ragged kernel's
main lattice (8 decode rows and two prefill chunks) into a decode-only and
a chunk-only lattice, to show which kind of item its fp8 path (tiles
widened in place in shared memory) loses time on, and times
flash-decode and its writeback form at B 8, B 1 (``FD_B1``, which
chip_smoke's default run leaves out) and B 128 with bf16 and fp32 q.
Every row is held to the plain version as in ``chip_smoke.py`` (its
checks are reused) and prints the bf16-pool time of the same case and q
dtype from the same run, and the ratio.

    python scripts/fp8_times.py

Needs a card.
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


def main() -> int:
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
    main_rows = list(cs.RAGGED_ROWS)
    for name, rows in (("ragged main", main_rows),
                       ("ragged decode", DECODE_ROWS),
                       ("ragged chunks", CHUNK_ROWS)):
        cs.RAGGED_ROWS = rows
        res[name] = cs.check_ragged(torch, dtypes=("bfloat16",))
        for kv, (suffix, _, _) in cs.KV8.items():
            res[f"{name}.{suffix}"] = cs.check_ragged(torch, kv,
                                                      dtypes=("bfloat16",))
    cs.RAGGED_ROWS = main_rows
    b8_b1 = cs.FD_CASES + FD_B1
    for name, check, cases, dtypes in (
            ("flash_decode", cs.check_flash_decode, b8_b1,
             ("bfloat16", "float32")),
            ("flash_decode_fw", cs.check_flash_decode_fw, b8_b1,
             ("bfloat16", "float32")),
            ("flash_decode b128", cs.check_flash_decode, cs.FD_B128,
             ("bfloat16",))):
        res[name] = check(torch, cases=cases, dtypes=dtypes)
        for kv, (suffix, _, _) in cs.KV8.items():
            res[f"{name}.{suffix}"] = check(torch, kv, cases=cases,
                                            dtypes=dtypes)
            torch.cuda.empty_cache()
    cs.note_fp8_against_bf16(res)
    bad = []
    for name, rows in res.items():
        for r in rows:
            print(f"[fp8_times] {name:22s} {r['dtype']:8s} {r['shape']:58s}"
                  f" {'ok' if r['ok'] else 'FAIL'} {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r.get('note', '')}) [{card}]")
            if not r["ok"]:
                bad.append(f"{name} {r['dtype']} {r['shape']}")
    if bad:
        print(f"fp8_times: disagree with the plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
