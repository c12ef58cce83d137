"""Where the fp32 decode logits' gap between the attention kernels and
their plain versions comes from over fp8 pools, on the two paths that
store each step's K/V into the pools: the ragged mixed step (the kernel
rounds and writes the fresh K/V) and the inline paged decode (the forward
rounds and writes them, ``astype_kv``).

For each pool dtype (e4m3, e5m2) and path, Llama-3-8B in fp32 at full
width, teacher-forced as ``chip_smoke.py``'s ``kernel_vs_plain`` runs it
(the same weights, prompt and continuation):

1. ``gap``: the max logit gap, kernels against plain versions (the
   reading ``kernel_vs_plain`` holds);
2. ``per_call``: every attention call of the kernel run held against the
   plain version on the same inputs: the max output gap, over the max
   output, and (ragged) the pool bytes the two write that differ;
3. ``flips``: the K/V values the two runs round to different pool bytes:
   how many of how many, how many of them are neighbouring values of the
   pool dtype, how many have the two runs' fp32 values on either side of
   the rounding midpoint between those neighbours, the largest relative
   fp32 difference at a flipped value, and the first (step, layer) with
   one; beside it, the pool bytes that differ after the two runs;
4. ``noise``: the plain versions against themselves, each attention
   output of the second run times (1 + eps * N(0, 1)) (seeded; no kernel
   in either run): the same gap and flip count, one entry per seed.

    python scripts/fp8_logit_gap.py [--layers 32] [--seeds 3]

Needs a card (``--device cpu --size llama-tiny`` runs the same steps on
the CPU, where kernels and plain versions are one function). Prints one
line per reading and writes them all to ``chiprun_out/fp8_logit_gap.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
KERNEL_OF = {"ragged": "ragged_attention", "inline": "paged_attention"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--eps", type=float, default=2.0 ** -20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="llama3-8b")
    args = ap.parse_args()

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("fp8_logit_gap: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from distributed_inference_engine_tpu_torch.models import base as mb
    from distributed_inference_engine_tpu_torch.models import (
        spec_for_architecture)
    from distributed_inference_engine_tpu_torch.ops import attention as at
    from distributed_inference_engine_tpu_torch.ops import (
        paged_attention as pa)
    from distributed_inference_engine_tpu_torch.ops import (
        ragged_attention as ra)

    dev = torch.device(args.device)
    card = cs.smi_line() if dev.type == "cuda" else "cpu"
    plain = {"ragged": ra.ragged_attention_plain,
             "inline": pa.paged_attention_xla}
    kernel = {"ragged": mb.ragged_attention, "inline": mb.paged_attention}
    astype_kv = mb.astype_kv

    @contextlib.contextmanager
    def hooked(path, impl, rec, check=False, noise=None, eps=0.0):
        """The forward's attention call of ``path`` through ``impl``,
        and every ``astype_kv`` of the forward, recorded into ``rec``:
        each K/V value the run rounds into the pools (fp32, in order,
        with its step and layer); with ``check`` each call also held
        against the plain version on copies of the same inputs; with
        ``noise`` (a generator) each output times (1 + eps N(0, 1))."""
        name = KERNEL_OF[path]
        rec.update(vals=[], where=[], calls=[], step=0, writes=0)

        def note(x, layer):
            rec["vals"].append(x.detach().float().clone())
            rec["where"].append((rec["step"], layer))

        def unembed(*a, **k):
            rec["step"] += 1
            rec["writes"] = 0
            return old_unembed(*a, **k)

        def cast(x, dtype):
            if at.is_fp8(dtype):   # K then V, one pair a layer
                note(x, rec["writes"] // 2)
                rec["writes"] += 1
            return astype_kv(x, dtype)

        def call(q, kp, vp, table, *rest, **kw):
            layer = kw.get("layer")
            n = kw.get("n_pages_per_layer") or kp.shape[0]
            rec["pools"] = (kp, vp)
            if path == "ragged":
                q_len = int(rest[1][0])
                note(rest[2][0, :q_len], layer)
                note(rest[3][0, :q_len], layer)
            if check:
                sl = slice(layer * n, (layer + 1) * n)
                kc, vc = kp[sl].clone(), vp[sl].clone()
                pkw = dict(kw, layer=None, n_pages_per_layer=0)
                want = plain[path](q, kc, vc, table, *rest, **pkw)
            res = impl(q, kp, vp, table, *rest, **kw)
            out = res[0] if isinstance(res, tuple) else res
            if check:
                want = want[0] if isinstance(want, tuple) else want
                top = float(want.abs().max())
                bytes_ = (int((at.raw_view(kp[sl]) != at.raw_view(kc)).sum()
                              + (at.raw_view(vp[sl]) != at.raw_view(vc)).sum())
                          if path == "ragged" else 0)
                rec["calls"].append(
                    (float((out - want).abs().max()), top, bytes_))
            if noise is not None:
                out = out * (1 + eps * torch.randn(
                    out.shape, generator=noise, device=out.device,
                    dtype=out.dtype))
                res = (out,) + tuple(res[1:]) if isinstance(res,
                                                            tuple) else out
            return res

        old_unembed = mb.unembed
        old = getattr(mb, name)
        mb.unembed, mb.astype_kv = unembed, cast
        setattr(mb, name, call)
        try:
            yield
        finally:
            mb.unembed, mb.astype_kv = old_unembed, astype_kv
            setattr(mb, name, old)

    def flips(a, b, kv):
        """K/V values two runs (records ``a``, ``b``) round differently."""
        dt = getattr(torch, kv)
        total = n = nb = mid = 0
        rel, first = 0.0, None
        for xa, xb, where in zip(a["vals"], b["vals"], a["where"]):
            assert xa.shape == xb.shape, (xa.shape, xb.shape)
            ca = at.raw_view(at.astype_kv(xa, dt))
            cb = at.raw_view(at.astype_kv(xb, dt))
            total += ca.numel()
            diff = ca != cb
            k = int(diff.sum())
            if not k:
                continue
            first = first or where
            n += k
            ca, cb = ca[diff].int(), cb[diff].int()

            def rank(c):   # the value's place in the dtype's order
                return torch.where(c >= 128, -(c - 128), c)
            nb += int(((rank(ca) - rank(cb)).abs() <= 1).sum())
            va = ca.to(torch.uint8).view(dt).float()
            vb = cb.to(torch.uint8).view(dt).float()
            m = (va + vb) / 2
            fa, fb = xa[diff], xb[diff]
            mid += int(((fa - m) * (fb - m) <= 0).sum())
            rel = max(rel, float(((fa - fb).abs()
                                  / fa.abs().clamp_min(1e-30)).max()))
        ka, va_ = a["pools"]
        kb, vb_ = b["pools"]
        pool = int((at.raw_view(ka) != at.raw_view(kb)).sum()
                   + (at.raw_view(va_) != at.raw_view(vb_)).sum())
        return {"values": total, "flipped": n, "neighbours": nb,
                "across_midpoint": mid, "max_rel_fp32": rel,
                "first_step_layer": first, "pool_bytes_differ": pool}

    gen = torch.Generator(device=dev)
    spec = spec_for_architecture("llama", args.size, max_seq_len=1024)
    spec32 = spec.replace(dtype="float32", n_layers=args.layers)
    params = mb.init_params(spec32, gen.manual_seed(0))
    rs = np.random.RandomState(17)
    cont = rs.randint(1, spec32.vocab_size, size=16).tolist()
    prompt = [t % spec32.vocab_size for t in cs.mixed_prompts()[0][7]]
    if spec32.max_seq_len < len(prompt) + len(cont):
        prompt = prompt[:spec32.max_seq_len - len(cont)]

    def run(path, kv, impl, **hook):
        rec = {}
        with hooked(path, impl, rec, **hook):
            logits = cs.decode_logits(torch, spec32, params, prompt, cont,
                                      path, kv, device=dev)
        return logits, rec

    out = {"card": card, "layers": args.layers, "eps": args.eps,
           "size": args.size, "rows": []}
    for kv in cs.KV8:
        for path in KERNEL_OF:
            got, rk = run(path, kv, kernel[path], check=True)
            ref, rp = run(path, kv, plain[path])
            calls = rk["calls"]
            row = {"kv_dtype": kv, "path": path,
                   "gap": float((got - ref).abs().max()),
                   "per_call": {
                       "calls": len(calls),
                       "max_out_gap": max(c[0] for c in calls),
                       "max_rel_out_gap": max(c[0] / max(c[1], 1e-30)
                                              for c in calls),
                       "pool_bytes_differ": sum(c[2] for c in calls)},
                   "flips": flips(rk, rp, kv), "noise": []}
            for seed in range(args.seeds):
                g = torch.Generator(device=dev).manual_seed(seed)
                noisy, rn = run(path, kv, plain[path], noise=g, eps=args.eps)
                row["noise"].append(
                    {"seed": seed, "gap": float((noisy - ref).abs().max()),
                     "flipped": flips(rn, rp, kv)["flipped"]})
            out["rows"].append(row)
            cs.log(f"[fp8 gap] {args.layers} layers, {kv} pools, {path}: "
                   f"{json.dumps(row)} [{card}]")
    dst = REPO / "chiprun_out" / "fp8_logit_gap.json"
    dst.parent.mkdir(exist_ok=True)
    dst.write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
