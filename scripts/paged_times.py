"""Time the port's paged-attention kernel on launch plans that its rule
does not pick, on one card.

``chip_smoke.py`` times each paged instance on the plan that
``ops/paged_attention.py:paged_plan`` picks (and, for bf16 q at G <= 4, on
the other route too). This script times the plans around it: the route
(tensor cores or CUDA cores), the query rows a block holds, and the split
grid's run length, at chip_smoke's B 8 decode case (lengths 0-6,000, 48
pages of 128 a slot, a 4-layer stacked pool rotated for a cold L2), so
that the rule's choices can be checked against their neighbours. Each
line is one plan: its time (median of 3 repeats of 10 launches) and its
largest error against the plain version in fp32.

    python scripts/paged_times.py                 # the default plans
    python scripts/paged_times.py --routes        # G 1, 2, 4: both routes
    python scripts/paged_times.py --plans FILE    # a JSON list of cases
    python scripts/paged_times.py --sweep         # chip_smoke's sweeps

``--sweep`` runs, through ``chip_smoke.py``'s own checks (held to the
plain versions as there), the kernel cases that its default run keeps one
representative of: paged attention at the Mistral shapes over every case
(q dtype, window 0 and 4096, one layer's pool and the stacked one) over
bf16, e4m3 and e5m2 pools; the other families' instances of the four
attention kernels at every query-head group and paged attention at Dh 256
at both windows; and paged attention's two routes at ``ROUTE_SHAPES``.
Each row prints as chip_smoke's kernel rows do (time, bound, plain
version; the fp8 rows with the bf16-pool time of the same case).

A case is ``{"shape": [H, Hkv, Dh], "window": 4096, "q": "bfloat16",
"kv": "bfloat16", "plans": [[mma, rows, chunk], ...]}``. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

T, F = True, False
# G 7 and 8 (8-row tile), 9, 12, 16 (16-row tile; 8-row sub-groups),
# Gemma-2B, G 3 and Mistral's G 4 (both routes), and Dh 256 at G 4
DEFAULT_CASES = [
    {"shape": [28, 4, 128], "plans": [[T, 8, 256], [T, 8, 512]]},
    {"shape": [32, 4, 128], "plans": [[T, 8, 256], [T, 8, 512]]},
    {"shape": [36, 4, 128], "plans": [[T, 16, 256], [T, 16, 512]]},
    {"shape": [48, 4, 128],
     "plans": [[T, 16, 256], [T, 16, 512], [T, 8, 256]]},
    {"shape": [64, 4, 128],
     "plans": [[T, 16, 256], [T, 16, 512], [T, 8, 512]]},
    {"shape": [8, 1, 256], "window": 0, "plans": [[T, 8, 256], [T, 16, 256]]},
    {"shape": [12, 4, 128],
     "plans": [[T, 8, 256], [T, 8, 512], [F, 4, 256], [F, 4, 512]]},
    {"shape": [32, 8, 128], "window": 0,
     "plans": [[T, 8, 256], [T, 8, 384], [T, 8, 512], [T, 8, 704],
               [F, 4, 704]]},
    {"shape": [32, 8, 128], "window": 0, "kv": "float8_e4m3fn",
     "plans": [[T, 8, 256], [T, 8, 384], [T, 8, 512], [T, 8, 704],
               [F, 4, 704]]},
    {"shape": [32, 8, 128], "plans": [[T, 8, 256], [T, 8, 512], [F, 4, 512]]},
    {"shape": [32, 8, 256], "plans": [[T, 8, 256], [T, 8, 512], [F, 4, 512]]},
]


def route_cases(torch, pa, sms: int):
    """bf16 q at G 1, 2 and 4 over 8 KV heads, Dh 64, 128 and 256, bf16
    and e4m3 pools, windows 0 and 4096: each route on its own grid rule
    (``paged_plan`` with ``mma`` given), the data of the route rule."""
    cases = []
    for dh in (64, 128, 256):
        for g in (1, 2, 4):
            for kv in ("bfloat16", "float8_e4m3fn"):
                for window in (0, 4096):
                    table_keys = 48 * 128
                    max_keys = min(table_keys, window) if window else \
                        table_keys
                    plans = []
                    for mma in (True, False):
                        p = pa.paged_plan(8, 8 * g, 8, dh, max_keys, sms,
                                          torch.bfloat16,
                                          getattr(torch, kv), mma=mma)
                        plans.append([p.mma, p.rows, p.chunk])
                    cases.append({"shape": [8 * g, 8, dh], "window": window,
                                  "kv": kv, "plans": plans})
    return cases


# --sweep: the groups ragged attention serves, and the group paged
# attention alone serves (Llama-3-70B's and Qwen2-72B's); paged
# attention's two routes for bf16 q at G 1 and 2 over 8 KV heads at Dh 128
# (its G 4 is chip_smoke's main rows) and G 2 and 4 at Dh 256 (Gemma-7B's
# G 1 is a Dh 256 row)
RAGGED_GROUPS = (3, 6, 7)
PAGED_ONLY_GROUPS = (8,)
ROUTE_SHAPES = ((8, 8, 128), (16, 8, 128), (16, 8, 256), (32, 8, 256))


def sweep(torch, cs, card: str) -> int:
    """``--sweep``: chip_smoke's checks over the cases its default run
    leaves out; 1 if any row disagrees with its plain version."""
    paged_sweep = tuple((d, w, st) for d in ("bfloat16", "float32")
                        for w in (0, cs.MISTRAL_WINDOW)
                        for st in (False, True))
    family_sweep = {
        name: tuple(g for g in cs.GROUP_SHAPES
                    if (g in RAGGED_GROUPS if name == "ragged_attention"
                        else name == "paged_attention"
                        or g not in PAGED_ONLY_GROUPS))
        for name in cs.FAMILY_GROUPS}
    gemma_sweep = tuple((shape, (0, cs.MISTRAL_WINDOW))
                        for shape in cs.GEMMA_SHAPES)
    res = {"paged_attention": cs.check_paged(torch, cases=paged_sweep)}
    for kv, (suffix, _, _) in cs.KV8.items():
        res[f"paged_attention.{suffix}"] = cs.check_paged(
            torch, kv, cases=paged_sweep)
        torch.cuda.empty_cache()
    res.update(cs.family_kernel_rows(torch, groups=family_sweep,
                                     gemma=gemma_sweep))
    res["paged_attention.routes"] = [
        row for shape in ROUTE_SHAPES for row in (
            cs.family_paged(torch, shape=shape, dtypes=("bfloat16",))
            + cs.family_paged(torch, cs.FP8, shape=shape,
                              dtypes=("bfloat16",)))]
    cs.note_fp8_against_bf16(res)
    bad = []
    for name, rows in res.items():
        for r in rows:
            print(f"[paged_times] {name:24s} {r['dtype']:8s} "
                  f"{r['shape']:60s} {'ok' if r['ok'] else 'FAIL'} "
                  f"{r['ms']:.4f} ms ({r.get('route', '')}), bound "
                  f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library " + (f"{r['library_ms']:.4f} ms"
                                 if r["library_ms"] is not None else "none")
                  + f" ({r.get('note', '')}) [{card}]", flush=True)
            if not r["ok"]:
                bad.append(f"{name} {r['dtype']} {r['shape']}")
    if bad:
        print(f"paged_times: disagree with the plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", help="a JSON file of cases")
    ap.add_argument("--routes", action="store_true",
                    help="both routes at G 1, 2 and 4 (route_cases)")
    ap.add_argument("--sweep", action="store_true",
                    help="chip_smoke.py's kernel sweeps (see above)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("paged_times: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.ops import \
        paged_attention as pa

    _cuda.lib()
    card = cs.smi_line()
    print(card, flush=True)
    if args.sweep:
        return sweep(torch, cs, card)
    if args.routes:
        cases = route_cases(torch, pa, _cuda.sm_count(0))
    elif args.plans:
        cases = json.loads(Path(args.plans).read_text())
    else:
        cases = DEFAULT_CASES
    g = torch.Generator(device="cuda").manual_seed(8)
    n = cs.B * cs.MP_PAGED
    layers = 4
    table = torch.randperm(n, generator=g, device="cuda").reshape(
        cs.B, cs.MP_PAGED).to(torch.int32).contiguous()
    for case in cases:
        h, hkv, dh = case["shape"]
        window = case.get("window", cs.MISTRAL_WINDOW)
        lens = torch.tensor(case.get("lens", cs.PAGED_LENS),
                            dtype=torch.int32, device="cuda")
        kv_dt = getattr(torch, case.get("kv", "bfloat16"))
        dt = getattr(torch, case.get("q", "bfloat16"))
        pool = (layers * n, cs.P, hkv * dh)
        kp = torch.randn(pool, generator=g, device="cuda").to(kv_dt)
        vp = torch.randn(pool, generator=g, device="cuda").to(kv_dt)
        q = torch.randn((cs.B, h, dh), generator=g, device="cuda").to(dt)
        max_keys = (min(cs.MP_PAGED * cs.P, window) if window
                    else cs.MP_PAGED * cs.P)
        kw = dict(n_kv_heads=hkv, window=window, with_stats=True,
                  n_pages_per_layer=n)
        ref = pa.paged_attention_xla(q.float(), kp.float(), vp.float(),
                                     table, lens, **dict(kw, layer=1))[0]
        for mma, rows, chunk in case["plans"]:
            plan = pa.PagedPlan(mma, rows, -(-(h // hkv) // rows),
                                -(-max_keys // chunk), chunk)
            got = pa.paged_attention_launch(q, kp, vp, table, lens, plan,
                                            layer=1, **kw)[0]
            err = float((got.float() - ref).abs().max())
            ms = cs.time_ms(
                torch, lambda i: pa.paged_attention_launch(
                    q, kp, vp, table, lens, plan, layer=i % layers, **kw),
                lambda i: (i,), **cs.QUICK)
            print(json.dumps(dict(
                shape=case["shape"], window=window, q=str(dt)[6:],
                kv=str(kv_dt)[6:], route="mma" if mma else "simt",
                rows=rows, n_sub=plan.n_sub, n_split=plan.n_split,
                chunk=chunk, ms=round(ms, 5), max_abs_err=round(err, 5))),
                flush=True)
        del kp, vp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
