#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py             # every phase (needs one card)
    python3 chip_smoke.py --profile   # ... plus profiles of the bf16 and
                                      # int4 mixed steps (with the ragged
                                      # kernel's ms per step) and the int4
                                      # wgmma token tiles
    python3 chip_smoke.py --full-depth  # ... with the fp32 logit checks at
                                      # every layer (32; Qwen2-7B and
                                      # Gemma-7B 28) (CUT_LAYERS: 8);
                                      # Mixtral's at 8 (4): fp32 at 32
                                      # layers would be 187 GB

The engine replays a CUDA graph for every decode chunk and mixed step (the
worker phases and every in-process engine). Each decode scheme (``serve``,
fused, fw, ``pallas``, ``inline``, int4, Mistral's inline) and the mixed
step (bf16, int4, int8) also runs through a second engine with the eager
comparison hook (``pair_run``, ``mixed_pair_line``): the graph run's greedy
tokens and launch counts must equal the eager run's; each prints both runs'
decode ms per step and device-busy share (``torch.profiler`` over one
decode chunk with 8 slots live, each failing if a kernel the one-launch
GEMVs replaced runs), the mixed steps' ms by bucket, and the graphs' count,
capture seconds and pool bytes.

Phases, each failing loudly (any failure exits non-zero):

1. ``build``: prints the card (``nvidia-smi`` name and power limit, torch's
   device name), builds the CUDA kernels from ``csrc/`` and prints the
   build time and the compiler's register/spill summary, and the
   registers and spills of the flash-decode instances, the ragged
   tensor-core instances (by head width) and the matmul_residual ones.
2. ``kernels``: holds each of the seven kernels against its plain PyTorch
   version on the card at the Llama-3-8B shapes, in bf16 and fp32, with
   the tolerance printed beside the max error, and times kernel, plain
   version and one PyTorch library call (a yardstick the port never
   calls) with CUDA events over back-to-back launches on rotating
   buffers (cold L2):
   - flash-decode and its writeback variant at the decode shapes (B=8,
     H=32, Hkv=8, Dh=128, P=128, W=8, MP=16), each row printing its split
     grid (runs x keys); the fw check with inactive slots and a slot at
     side_idx = W, the side buffers compared;
   - ragged attention at R=10 rows (8 decode rows with context 0-1000, two
     of them inert, a 256-query chunk at 0 and a 177-query chunk at 444
     straddling a page; MP=8), the written pages compared, bf16 on the
     tensor-core instance (``mma``) and fp32 on the CUDA cores (``simt``),
     each checked by its launch count;
   - the GEMV pair (D=4096, F=14336), each row naming its instance (bf16
     ``mma``, fp32 ``simt``, checked by launch count) and cluster size;
   - the packed-int4 matmul at every Llama-3-8B int4 product (fused
     q|k|v, o, fused gate|up, down in bf16; the vocab-padded head with fp32
     activations) at M = 1, 8, 10, 64, 512 and 2560 rows, and at two
     shapes off the tiles; held per output column (``check_int4``), each
     row naming the instance it ran (gemv, with its cluster plan; wgmma,
     wmma, simt); its library
     yardstick is cuBLAS on the dequantized weight, which reads 4x (bf16)
     or 8x (fp32) the packed bytes; and at Mixtral-8x7B's expert shapes
     (gate/up [K/2 2048, N 14336], down [7168, 4096]) at M 8 and 2,048
     (``int4_matmul.moe``);
   - paged attention at the Mistral decode shapes (B=8, H=32, Hkv=8,
     Dh=128, P=128, MP=48, lengths 0-6,000 with one empty slot): bf16 at
     window 4096 on the stacked pool (layer 5 of 32) with the flash stats m
     and l held too, bf16 without a window on one layer's pool, fp32 at
     window 4096 stacked (``PAGED_CASES``), and one 6,000-token slot alone
     (B=1, window 4096, stacked) (``check_paged``). Each row names
     the route its launch took (``mma``: the tensor cores, ``simt``: the
     CUDA cores; checked by the route's launch count), its rows a block
     and its split grid; a bf16 row at G <= 4 also holds and times the
     other route.
   - the e4m3-pool (fp8) and e5m2-pool instances of flash-decode, fw,
     ragged attention and paged attention at the same shapes (bf16 q on
     the tensor cores where the bf16 instance is, fp32 q on the CUDA
     cores), q's tolerance, fp32 held to 1e-5; fw's side write with a
     fresh row past the dtype's limit (464; 61,440 for e5m2) and the ragged
     writeback with fresh K/V past it byte-equal to the plain versions'
     (NaN bytes for e4m3, +-inf for e5m2); each checked by its
     ``<kernel>.fp8`` or ``<kernel>.e5m2`` launch count; no library
     yardstick (no one call takes fp8 K/V: SDPA needs an upcast); each
     fp8 row prints the bf16-pool instance's time at the same case from
     the same run and the ratio (``note_fp8_against_bf16``);
   - flash-decode at 128 slots (``FD_B128``: prefix lengths drawn
     uniformly from 0-2,040 and side counts from 0-8 with a seeded
     generator), bf16 q over bf16 and over e4m3 pools, where the pools'
     bytes dominate a layer (the TPU bench's default rung runs 128 slots)
     and the grid is one run a slot (the unsplit grid);
   - speculation's two kernel cases (A12): ragged attention at the async
     verify step's lattice (``VERIFY_ROWS``: 8 rows of 1 + 4 queries over
     contexts 0-1,000, one plain q=1 row, two inert; bf16 on ``mma``,
     fp32 on ``simt``, pools and outputs against the plain version,
     ``ragged_attention.verify``), and the int4 matmul at the speculative
     verify window's M 40 (8 slots x 5) on the four Llama-3-8B products,
     each on ``wgmma`` (``int4_matmul.verify``), beside SDPA and cuBLAS.
   The default run keeps one case of each instance and route; the sweeps
   around them run in ``scripts/paged_times.py --sweep`` (paged attention
   over every case, the families' instances at every group and head
   width, the routes at G <= 4) and ``scripts/fp8_times.py`` (flash-decode
   and fw with one 2,040-key slot alone; the fp8 instances at 128 slots).
   Attention kernels are also held per output row to max|out - ref32| /
   max|ref32| against the plain version on the same values in fp32. Each
   bound counts the valid work only (no query padding), the pools' bytes
   at their width.
3. ``fleet`` (it holds the ``serve`` phase, whose lines and checks keep
   their ``[serve]`` tag): starts the port's worker CLI with no model on
   a free localhost port and drives it through the port's
   ``WorkerClient``:
   - deploys ``serve`` over ``load_model``: the full 32-layer llama3-8b
     (random bf16 weights from seed 0, ``attention_impl=pallas-decode``,
     ``warmup=1``: the engine's warmup runs at load and captures its
     graphs), reading the worker's device memory before
     (``WorkerMemory``); the same ``load_model`` again returns at once;
   - the ``serve`` wave: 8 concurrent requests (prompts of 16-600
     tokens, two sharing a 256-token prefix, 32 new tokens each), with
     counts, lengths, finish reasons, each result's ``worker_trace``
     (received <= first token <= done), the worker's kernel launch counts
     (zeroed just before the requests) and its engine counters (read there
     too: the checks use their differences over the waves). Every worker
     phase prints its warmup's rounds, seconds and graphs, and fails if a
     graph, decode key or mixed bucket appears during its waves. Then one
     request streams through ``generate_stream``: the frames, joined, must
     equal its result and ``generate``'s greedy tokens for the same
     prompt;
   - ``stage_model`` of the ``int4`` phase's model (as
     ``llama3-8b-int4``) and at once ``swap_model`` gated on the int4
     worker's greedy tokens of the golden prompt, while ``serve`` waves
     run back to back: their tok/s against the wave before and after,
     ``stage_overlap_steps``, the stage and swap seconds;
   - the ``int4`` phase's two waves and checks through the swapped-in
     model; ``resident_models`` (both, their bytes the engines'
     ``param_bytes``); a ``profile`` of one int4 wave whose Chrome trace
     names the ragged and int4 kernels; ``metrics_text`` over RPC and
     ``GET /metrics`` (the same families); ``events`` (``model.stage``,
     ``model.swap``, a timeline a model whose ``compile`` records are its
     warm-up's graph captures);
   - ``unload_model`` of both: the worker's memory back within
     ``UNLOAD_SLACK_GIB`` of the reading before the first load
     (``WorkerMemory``: its pid's memory where ``nvidia-smi`` lists the
     pid, else the card's less this process's change in reserve; each
     reading printed beside this process's reserve and the worker's own
     allocator); a reload
     of ``serve`` and one request with the streamed request's tokens;
     then ``drain`` with two requests in flight (both finish) and a later
     ``generate`` shed with ``overloaded``/``draining``.
4. ``mixed``: the worker CLI again, once the first has shut down, with
   ``attention_impl=pallas-ragged,prefill_chunk=256,mixed_step_tokens=512``
   (same weights): 8 concurrent requests with prompts of 16-900 tokens,
   then a second wave of a prefix hit on the 520-token prompt with a
   400-token tail (it resumes chunked at 256) beside a 40-token prompt.
   Checks the results, one ragged launch per layer per mixed step (all of
   them the tensor-core instance), flash-decode on the pure-decode steps,
   and the mixed, chunked and prefix-hit admission counts.
4a. ``ckpt`` (A11): the ``mixed`` model's seed-0 bf16 tree (drawn on the
   card as the engine draws it) written at full width and depth as an HF
   Llama checkpoint, sharded as HF ships Llama-3-8B (``CKPT_SHARD_BYTES``,
   with the index and ``config.json``), under the checkout's ``_work/``
   (about 21 GB of disk with the int4 artifact; the write's and the
   free disk's figures printed). One worker CLI started with no model
   loads it over ``load_model`` three times, each served the mixed
   phase's two waves and unloaded (memory back within
   ``UNLOAD_SLACK_GIB``): ``path=<dir>`` in bf16, whose tokens must equal
   the ``mixed`` phase's; ``quantized=1,weight_bits=4,artifact=<dir2>``,
   the slow path (read, quantize, prepare, write the artifact, record the
   golden probe); the same config again, which must be an artifact cold
   start (one hit, one miss, the golden probe replayed equal, no graph
   captured during the waves) with the slow path's tokens. Prints each
   load's phases (read GB/s, quantize, artifact write and checksum
   seconds, golden probe), the worker's peak host RSS, the artifact's
   bytes, and the launches (ragged attention and flash-decode; the int4
   matmul on the int4 loads). Both directories are removed at the end
   whatever happens.
4b. ``fp8`` (A5f) and ``e5m2`` (A5f-e5m2): the worker CLI again with the
   ``mixed`` model plus ``kv_dtype=float8_e4m3fn`` (``FP8_MODEL``) over the
   mixed phase's two waves; then, in the same worker process, that model
   unloaded and ``E5M2_MODEL`` (``kv_dtype=float8_e5m2``) loaded over
   ``load_model`` and served the same waves. For each: both served, every
   ragged launch (32 per mixed step, tensor cores) and every flash-decode
   launch on its ``.fp8`` (``.e5m2``) instance, the pools' ``hbm_bytes``
   half of ``mixed``'s, served tok/s and TTFT printed beside ``mixed``'s
   (and e5m2's beside fp8's) from the same run.
5. ``fused``: rebuilds the same weights in this process, checks one served
   chain teacher-forced against ``forward_train`` (bf16: ties within the
   measured bf16 gap between the two code paths), runs the serve
   requests through in-process ``ContinuousEngine``s with
   ``decode_fused=True`` (every matmul_residual and norm_matmul launch on
   the tensor cores) and with ``attention_impl="pallas-decode-fw"`` (launch counts
   zeroed just before each) and checks a chain of each the same way (bf16
   smokes; the fw one ``CUT_LAYERS`` deep); then, in fp32 at full width,
   holds the decode
   path's logits to ``forward_train``'s within 1e-3 (flash-decode fused
   off and on, and the fw kernel), and runs the mixed phase's first wave
   through fp32 engines (fp32 pools): ``pallas-decode`` with
   ``decode_fused`` off and on, and ``pallas-ragged`` with
   ``prefill_chunk=256``, holding every chain teacher-forced to
   ``forward_train`` with a 1e-3 tie band and counting the chains equal
   to ``pallas-decode``'s. The bf16 runs are at full depth (32 layers)
   but for the ``pallas``/``inline`` smokes below, which run 8 layers of
   the full width, as do the fp32 checks (here, in ``int4`` and in
   ``mistral``; ``CUT_LAYERS``, cut for the time limit). It also
   times the bf16 mixed steps over the mixed phase's first wave. Its
   ``[host]`` lines (``phase_host``, ``CUT_LAYERS`` deep) run the serve
   prompts through the engine's host paths (bf16, ``decode_fused``,
   graphs): sync admission,
   deferred admission with the step timeline on (the default) and off,
   ``defer_sync``, ``stream_chunk_steps=2`` with a callback on every
   request, and ``defer_sync`` through the eager hook; the five
   full-chunk runs must emit equal tokens and logprobs, the
   ``defer_sync`` graph and eager runs the same launches; each prints its
   profiled decode ms per step, busy share and host gap per step, and its
   deferred admissions, firsts fetches, stream-ring counters and decode
   keys.
6. ``int4`` (run before ``fleet``, which needs its probe tokens): the
   worker CLI with the ``mixed`` model plus
   ``quantized=1,weight_bits=4`` (int4 weights born from seed 0) and the
   mixed phase's two waves. Checks the results, 32 ragged launches per
   mixed step (tensor cores), 129 ``int4_matmul`` launches per forward
   (four per layer and the LM head), the wgmma instance's launches (the
   mixed steps and the admission prefills) and no wmma one, and no fused
   decode GEMV. Then in this process, on the same weights: the served chain teacher-forced (bf16 band); a
   ``decode_fused=True`` engine launching no fused GEMV and 129 int4
   launches per forward; the int4 mixed steps' time; a bf16 int8 engine
   (``weight_bits`` 8, ``CUT_LAYERS`` deep) with its decode and mixed-step
   times; then in fp32,
   for int4 and for int8, the decode path's logits within 1e-3 of
   ``forward_train``'s and a ``pallas-ragged`` engine at 8 slots (chunk
   256) holding every chain teacher-forced at the 1e-3 band.
6a. ``static`` and ``spec_async`` (A8, A12; ``spec_worker_phases``), in
   the ``int4`` phase's worker once its waves and probe are done: the int4
   model unloaded, ``STATIC_MODEL`` (``continuous=0``: the static
   ``Engine``, no pump, the executor path) loaded over ``load_model`` and
   the mixed phase's waves sent request by request at once (32 tokens
   each; a prompt past 512 tokens keeps its tail), with no attention
   kernel launched (``cached_attention`` is plain PyTorch, as JAX's is
   XLA), 128 ``wgmma`` launches a call (its prefill) and 129 GEMV
   launches a decode step; prints tok/s, TTFT p50, the engine's prefill
   and decode seconds, ms a decode step and int4 launches by instance.
   Then it unloaded and ``SPEC_ASYNC_MODEL`` (``spec_async=1``, a
   ``layers:2`` self-draft, k 4, a bubble floor of 0) loaded and the
   waves streamed (``generate_stream``: the drafter serves streaming
   slots): fails unless verify steps and drafted tokens are above 0 and
   every ragged launch is the verify steps' and mixed steps' (32 each, on
   ``mma``); prints the accept rate, the drafter's counters, the verify
   step's ms (the step timeline) against the ``int4`` phase's plain
   decode step and tok/s beside ``int4``'s. In process (``spec``,
   ``phase_spec_inproc``, after ``int4``'s): every static and async
   chain teacher-forced at 32 layers (bf16 band); the
   ``SpeculativeEngine`` (``truncated_draft`` of 2 layers, k 4, 4 rounds
   a call) over the first wave, its chains teacher-forced and counted
   against the static worker's, its accept rate, tokens a round, ms a
   round against the static step and its ``wgmma`` launches at M 40 (128
   a round run; the head's fp32 M 40 on ``simt``); the async verify step
   graph against eager (equal tokens and launches); and in fp32 at
   ``CUT_LAYERS`` ``forward_window``'s logits within ``FP32_LOGIT_TOL``
   of ``forward_train``'s.
7. ``mistral``: the worker CLI with Mistral-7B v0.1 at full width and
   depth (``MISTRAL_MODEL``: random bf16 weights from seed 0, window
   4096, ``attention_impl=pallas``, ``prefill_chunk=512``,
   ``max_seq_len=8192``): 8 concurrent requests with prompts of 16-5,200
   tokens (two past the window, two sharing a 256-token prefix), then a
   chunked prefix hit beside a short prompt. Checks the results, the
   inline decode mode, 32 ``paged_attention`` launches per decode step and
   no flash-decode or ragged launch. Then in this process: the served
   5,200-token chain teacher-forced (bf16 band), and in fp32 the inline
   decode path's logits within 1e-3 of ``forward_train``'s over 32 tokens
   past the window. Phase ``fused`` also runs Llama-3-8B engines (8
   layers) with ``attention_impl="pallas"`` (window scheme) and
   ``decode_mode="inline"``, with their launch counts and a chain each.

8. ``fp8`` in process (``phase_fp8_inproc``), e4m3 then e5m2 pools, full
   width and ``CUT_LAYERS`` deep: the fw decode at 8 slots (serve prompts)
   and Mistral's inline decode past its window (mistral prompts), each
   graph against eager with tokens, logprobs and launches bit-equal and
   every fw / paged launch on its fp8 (e5m2) instance; then in fp32
   (``FP32_LAYERS``)
   the teacher-forced decode logits of flash-decode, fw, the ragged mixed
   step, the inline paged decode and Mistral's inline decode, each
   through the kernels and through their plain versions (the script's
   own ``plain_kernels`` switch), within 1e-3 of each other.

9. The other dense families (A9): the kernels phase also holds
   flash-decode, fw and paged attention at query-head groups 3, 5, 6, 7,
   12 and 16 (Hkv 4, Dh 128), paged attention at 8 too, ragged attention
   at 3, 6 and 7, and paged attention at head_dim 256 with Gemma-7B's
   16/16 and Gemma-2B's 8/1 heads (windows 0 and 4096), each in bf16,
   fp32 and over e4m3 pools (``family_kernel_rows``, the B 8 case, fewer
   timing repeats), in the default run at G 7 (and paged attention's
   16-row instance at G 16), Gemma-7B without a window and Gemma-2B with
   one (``FAMILY_GROUPS``, ``GEMMA_CASES``); and paged attention's two
   routes for bf16 q at G 1 and 2 (Dh 128) and G 2 and 4 (Dh 256)
   (in ``scripts/paged_times.py --sweep``). Flash-decode and fw at G 12
   and 16 run their 16-row instances (one sub-group a KV head, counted
   under ``.rows16``) over bf16, e4m3 and e5m2 pools at the main timing,
   bf16 beside SDPA (``ROWS16_GROUPS``). Then
   three models at full published width and depth through one worker
   process, each loaded once the one before it is unloaded
   (``phase_families``): ``qwen2-7b`` (28 heads over 4: G 7) with the
   ``mixed`` settings over the mixed waves (ragged and flash-decode at G
   7), ``gemma-7b`` (head_dim 256, tied 256,000-row embedding) and
   ``gpt2`` (learned positions, LayerNorm, biases) with ``serve``'s over
   the serve wave; served tok/s and TTFT p50 each. In process
   (``phase_families_inproc``): one served chain of each teacher-forced
   at full depth (bf16 band), graph against eager at ``FAMILY_LAYERS``
   (GPT-2 at 12): Qwen2-7B and Gemma-7B inline paged decode (paged
   attention at G 7 and at head_dim 256), Gemma-7B's fused decode
   (``norm_matmul`` over 1 + w), GPT-2's flash-decode; and in fp32 each
   decode path's teacher-forced logits within 1e-3 of ``forward_train``
   and of the plain kernels' forward (``plain_kernels``).

10. Mixtral-8x7B (A9), int4 at full width and depth (32 layers x 8
   experts, top 2; 93.4 GB in bf16 does not fit the card):
   ``mixtral`` (``phase_mixtral``): a worker CLI started with no model
   loads ``MIXTRAL_MODEL`` over ``load_model`` (int4 born from seed 0,
   the mixed phase's settings) and serves the mixed phase's two waves
   (token ids folded into its vocab); checks every request, 32 ragged
   launches per mixed step, 32 flash-decode launches per pure decode
   step, 833 ``int4_matmul`` launches per forward (w_qkv, wo and each
   expert's gate, up and down a layer, and the head), no capture during
   the waves, and the worker's memory back within ``UNLOAD_SLACK_GIB``
   after the unload; prints ``load_s``, the warm-up, ``param_bytes``,
   the worker's device memory, tok/s and TTFT. ``mixtral ckpt``
   (``phase_mixtral_ckpt``): a full-width 2-layer Mixtral written as an
   HF Mixtral checkpoint under ``_work/`` (6.3 GB), loaded through a
   worker with ``quantized=1,weight_bits=4`` (each layer quantized as it
   is read), its tokens equal to an in-process engine's on the same tree
   quantized by ``quantize_params``; the directory removed at the end.
   In process (``phase_mixtral_inproc``): the seed-0 int4 tree rebuilt,
   the worker's tokens again through an eager engine that records its
   expert choices, and one chain of each wave teacher-forced to
   ``forward_train`` at the bf16 band: printed as it stands (a
   random-init router's choices flip between the two paths' bf16
   roundings), held with ``forward_train``'s choices and gates pinned to
   the served path's, the pairs chosen apart counted and the nearest
   one's K-th and (K+1)-th probabilities printed;
   at 32 layers on graph replays, the mixed steps' times by bucket and
   one profiled pure-decode chunk beside the weights' bytes bound; then
   at ``MIXTRAL_LAYERS`` (4) deep, graph against eager over the
   first wave (decode chunks and mixed steps), an int8 tree's fp32
   decode chain within 1e-3, and the fp32 tree (22.5 GB) through
   flash-decode and the ragged mixed step within 1e-3 of
   ``forward_train`` and of the plain kernels.

Phases ``fused``, ``int4`` and ``mistral`` hold their in-process decode
schemes graph against eager as above; the worker phases print each worker
engine's graphs and fail if it captured none.

The last lines are the card's name and power limit, one JSON object
naming every kernel with its launches (on its own path: serve,
in-process fused, mixed, fw, int4; the fp8 and e5m2 instances: the fp8
phase's worker, the in-process fw and Mistral runs over each; the G 7
and head_dim 256
instances: the qwen2-7b worker, its in-process fw and inline runs, and
Gemma-7B's inline run; the int4 matmul at the expert shapes: the
mixtral worker; ragged attention at the verify lattice: the spec_async
worker's verify steps, 32 a step; the int4 matmul at M 40: the
in-process speculative engine's verify windows), error and times, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "distributed_inference_engine_tpu_torch"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12}      # fp32 outside the tensor cores
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}   # (atol, rtol)
# e4m3 and e5m2 KV pools (the fp8 and e5m2 instances) widen exactly: q's
# tolerance, fp32 q held to 1e-5
FP8 = "float8_e4m3fn"
E5M2 = "float8_e5m2"
FP8_TOL = {"bfloat16": TOL["bfloat16"], "float32": (1e-5, 1e-5)}
# per fp8 pool dtype: the suffix its instances count launches under, the
# tag its kernel rows carry, and a scale of fresh K/V past the dtype's
# largest value (e4m3 rounds it to NaN bytes, e5m2 to +-inf)
KV8 = {FP8: ("fp8", " e4m3 pools", 300.0),
       E5M2: ("e5m2", " e5m2 pools", 3e4)}


def inst8(name: str, kv_name) -> str:
    """The launch counter of kernel ``name``'s instance over ``kv_name``
    pools (``<name>.fp8`` stands for the bf16/fp32 pools' case, whose count
    must not move)."""
    return f"{name}.{KV8[kv_name][0] if kv_name else 'fp8'}"


def pool_tag(kv_name) -> str:
    return KV8[kv_name][1] if kv_name else ""
# flash-decode, per output row: max|out - ref| / max|ref| of that row
ROW_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}

# Llama-3-8B decode shapes on the main path
B, H, HKV, DH, P, W, MP = 8, 32, 8, 128, 128, 8, 16
D_MODEL, D_FF = 4096, 14336
# bf16 logits of two code paths (decode vs forward_train) differ by up to
# ~0.4 over a 128k vocab at random init, 32 layers; fp32 by ~1e-4
BF16_TIE_EPS = 0.3
FP32_LOGIT_TOL = 1e-3
# --full-depth only: kernels against plain versions over e5m2 pools on the
# paths that store each step's K/V into the pools (ragged, inline). The two
# forwards differ by fp32 rounding; a stored value that lies at a rounding
# boundary lands on another e5m2 value (12.5-25% apart) in one of them, and
# 32 layers carry such flips to the logits. scripts/fp8_logit_gap.py shows
# it: the kernels agree with the plain versions call by call on the same
# inputs, pool bytes included, and the plain versions against themselves,
# with a 2^-20 relative noise on each attention output, differ as much
# (PERF.md, PR 16). At CUT_LAYERS every path keeps FP32_LOGIT_TOL.
E5M2_STORE_LOGIT_TOL = 5e-3
# the fp32 checks and the llama3-8b paged-attention smokes run at full
# width but 8 of the 32 layers: cut to keep the script within its time
# limit (the other bf16 paths run every layer)
CUT_LAYERS = 8
# the fp32 logit checks' depth: CUT_LAYERS, or every layer with --full-depth
FP32_LAYERS = CUT_LAYERS
SERVE_MODEL = ("name=llama3-8b,architecture=llama,size=llama3-8b,"
               "continuous=1,attention_impl=pallas-decode,max_seq_len=1024,"
               "seed=0,warmup=1")
# the slice's path: chunked prefill in the ragged mixed step
MIXED_MODEL = (SERVE_MODEL.replace("attention_impl=pallas-decode",
                                   "attention_impl=pallas-ragged")
               + ",prefill_chunk=256,mixed_step_tokens=512")
# the same served with int4 weights, born quantized from the seed
INT4_MODEL = MIXED_MODEL + ",quantized=1,weight_bits=4"
# ... and from e4m3 KV pools (A5f): half the pool bytes
FP8_MODEL = MIXED_MODEL + ",kv_dtype=float8_e4m3fn"
# ... and from e5m2 KV pools (A5f-e5m2), under its own name, loaded over
# RPC into the fp8 phase's worker once the e4m3 model is unloaded
E5M2_MODEL = (MIXED_MODEL.replace("name=llama3-8b,", "name=llama3-8b-e5m2,")
              + ",kv_dtype=float8_e5m2")
N_LAYERS = 32
# int4 launches per forward: w_qkv, wo, w_gate_up and w_down per layer, and
# the LM head
INT4_PER_FORWARD = 4 * N_LAYERS + 1
# the static engine (A8) and async speculation (A12) on the int4 model,
# each loaded over RPC into the int4 phase's worker once the model before
# it is unloaded (no load-time warmup: the static engine captures no
# graphs, and the drafter's graphs are captured by the first streamed
# requests); the static engine clamps a prompt to the largest prefill
# bucket at or under max_seq_len (512: a longer prompt keeps its tail)
STATIC_MODEL = (INT4_MODEL.replace("name=llama3-8b,", "name=llama3-8b-static,")
                .replace("continuous=1", "continuous=0")
                .replace(",warmup=1", ""))
STATIC_PROMPT_CAP = 512
SPEC_ASYNC_MODEL = (INT4_MODEL.replace("name=llama3-8b,",
                                       "name=llama3-8b-spec,")
                    .replace(",warmup=1", "")
                    + ",spec_async=1,spec_draft_model=layers:2,"
                    "spec_max_draft=4,spec_bubble_floor_s=0")
# the in-process speculative engine: truncated self-draft of 2 layers,
# k 4, 4 rounds a call; its verify window is M = 8 slots x 5 rows
SPEC_K, SPEC_ROUNDS, SPEC_DRAFT_LAYERS = 4, 4, 2
# Llama-3-8B int4 products (name, K/2, N, activation dtype): the fused
# q|k|v, o, fused gate|up, down, and the vocab-padded head, which takes fp32
# activations (models/base.py:unembed)
INT4_SHAPES = [("w_qkv", D_MODEL // 2, 6144, "bfloat16"),
               ("wo", D_MODEL // 2, D_MODEL, "bfloat16"),
               ("w_gate_up", D_MODEL // 2, 2 * D_FF, "bfloat16"),
               ("w_down", D_FF // 2, D_MODEL, "bfloat16"),
               ("lm_head", D_MODEL // 2, 129024, "float32")]
# decode slots, the mixed step's unembed rows, the wgmma instance's
# 64-token tile (a small mixed step) and a 512-row admission prefill, the
# mixed step's lattice
INT4_ROWS = (1, 8, 10, 64, 512, 2560)
# the kernels line's int4 row: gate|up at the 8 decode rows
INT4_MAIN = 2 * len(INT4_ROWS) + 1
# --profile: the wgmma instance's token tiles, timed at these rows (small
# mixed steps, admission prefills of 200 to 900 rows, the lattice)
WGMMA_TILES = (64, 128, 256)
INT4_TILE_ROWS = (64, 200, 320, 512, 900, 2560)
# off the tiles and the vector widths: the tensor-core and GEMV instances
INT4_EDGES = [("edges", 37, 2000, 4100, "bfloat16"),
              ("edges", 5, 2000, 4100, "float32")]
# the speculative verify window's rows (8 slots x (k + 1)) on the four
# Llama-3-8B products: the wgmma instance; the kernels line's row: gate|up
INT4_VERIFY_CASES = [(name, 8 * (SPEC_K + 1), k2, n, dt)
                     for name, k2, n, dt in INT4_SHAPES[:4]]
# per output column: max|out - ref32| / max|ref32|
COL_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}

# Mistral-7B v0.1 (sliding window 4096) through the per-step paged decode
MISTRAL_MODEL = ("name=mistral-7b-v01,architecture=mistral,"
                 "size=mistral-7b-v01,continuous=1,attention_impl=pallas,"
                 "max_seq_len=8192,prefill_chunk=512,seed=0,warmup=1")
MISTRAL_VOCAB, MISTRAL_WINDOW = 32000, 4096
# paged attention at the Mistral decode shapes: 8 slots, 48 pages of 128
# per slot (6,144 keys), lengths over 0-6,000 with one empty slot, around
# the window (4,097) and with len - window on a page edge (4,224) and one
# past it (4,225); the stacked pool of 32 layers, layer 5
MP_PAGED, PAGED_LAYERS, PAGED_LAYER = 48, 32, 5
PAGED_LENS = [0, 1, 127, 1500, 4097, 4224, 4225, 6000]
# m and l of the flash stats against the plain version's in fp32
STATS_TOL = 1e-4

# The dense families beyond Llama and Mistral (A9), each at its published
# width and depth through the worker CLI with the load-time warmup:
# Qwen2-7B (28 query heads over 4 KV heads: G 7) with the mixed phase's
# settings, Gemma-7B (head_dim 256, 16 heads over 16, tied 256,000-row
# embedding) and GPT-2 (124M: learned positions, LayerNorm, biases) with
# serve's. name -> (model, architecture, size, layers, vocab)
QWEN_MODEL = MIXED_MODEL.replace("name=llama3-8b,architecture=llama,"
                                 "size=llama3-8b",
                                 "name=qwen2-7b,architecture=qwen,"
                                 "size=qwen2-7b")
GEMMA_MODEL = SERVE_MODEL.replace("name=llama3-8b,architecture=llama,"
                                  "size=llama3-8b",
                                  "name=gemma-7b,architecture=gemma,"
                                  "size=gemma-7b")
GPT2_MODEL = SERVE_MODEL.replace("name=llama3-8b,architecture=llama,"
                                 "size=llama3-8b",
                                 "name=gpt2,architecture=gpt2,size=gpt2")
FAMILIES = {"qwen2-7b": (QWEN_MODEL, "qwen", "qwen2-7b", 28, 152064),
            "gemma-7b": (GEMMA_MODEL, "gemma", "gemma-7b", 28, 256000),
            "gpt2": (GPT2_MODEL, "gpt2", "gpt2", 12, 50257)}

# The other families' attention instances (A9). Query-head groups G = H /
# Hkv at Hkv 4, Dh 128, by G: 3, 5, 6, 7 (Qwen2-7B: 28 heads over 4), 12
# and 16 for flash-decode, fw and paged attention, and 8 (Llama-3-70B's and
# Qwen2-72B's group) for paged attention; 3, 6, 7 for ragged attention;
# paged attention at Dh 256 with Gemma-7B's 16 heads over 16 and Gemma-2B's
# 8 over 1, with and without the window.
GROUP_SHAPES = {3: (12, 4, 128), 5: (20, 4, 128), 6: (24, 4, 128),
                7: (28, 4, 128), 8: (32, 4, 128), 12: (48, 4, 128),
                16: (64, 4, 128)}
GEMMA_SHAPES = ((16, 16, 256), (8, 1, 256))
# the default run's representatives of those (scripts/paged_times.py --sweep
# runs every group, head width, window and route): one case of each instance
# and route, the G 7 instances of the four kernels (Qwen2-7B's: one sub-group
# of 8 rows, one dead) and paged attention's 16-row tensor-core instance
# at G 16; at Dh 256 Gemma-7B's G 1 (bf16 q on the CUDA cores, e4m3 on the
# tensor cores) without a window and Gemma-2B's G 8 with one
FAMILY_GROUPS = {"flash_decode": (7,), "flash_decode_fw": (7,),
                 "ragged_attention": (7,), "paged_attention": (7, 16)}
GEMMA_CASES = ((GEMMA_SHAPES[0], (0,)),
               (GEMMA_SHAPES[1], (MISTRAL_WINDOW,)))
# flash-decode's and fw's 16-row instances (one sub-group a KV head at Dh
# 128 on the tensor cores): G 12 and 16 over bf16, e4m3 and e5m2 pools,
# bf16 q, at the main timing, bf16 beside SDPA
ROWS16_GROUPS = (12, 16)
# the stacked pool of the paged instance checks: 4 layers (a Gemma-7B
# layer's 384 pages are 0.4 GB in bf16)
FAMILY_PAGED_LAYERS = 4
# the families' in-process runs (graph against eager, fp32 logits) at full
# width and this depth (GPT-2 at its 12 layers): an earlier path than the
# slice's, cut for the time limit; --full-depth runs the fp32 checks at
# every layer
FAMILY_LAYERS = 4
FAMILY_FP32_LAYERS = FAMILY_LAYERS

# Mixtral-8x7B (A9) at full width and depth (32 layers, 8 experts, top 2):
# 46.7B parameters, 93.4 GB in bf16, more than the card holds; served int4
# (23.6 GB) with the mixed phase's settings, through a worker CLI started
# with no model (load_model over RPC)
MIXTRAL_MODEL = (MIXED_MODEL.replace("name=llama3-8b,architecture=llama,"
                                     "size=llama3-8b",
                                     "name=mixtral-8x7b,architecture=mixtral,"
                                     "size=mixtral-8x7b")
                 + ",quantized=1,weight_bits=4")
MIXTRAL_VOCAB, N_EXPERTS = 32000, 8
# the int4 matmul at the expert shapes (gate and up [K/2 2048, N 14336],
# down [7168, 4096]) at the decode slots (the GEMV) and a 2,048-row
# admission or mixed lattice (wgmma)
MOE_INT4_CASES = [(name, m, k2, n, "bfloat16")
                  for name, k2, n in (("expert w_gate/w_up", 2048, 14336),
                                      ("expert w_down", 7168, 4096))
                  for m in (8, 2048)]
# the in-process Mixtral checks (fp32 logits, int8, graph against eager)
# at full width and this depth; --full-depth: 8 layers (fp32 at 32 layers
# would be 187 GB)
MIXTRAL_LAYERS = FAMILY_LAYERS
MIXTRAL_FP32_LAYERS = MIXTRAL_LAYERS
# the loader check: a full-width Mixtral of 2 layers written as an HF
# checkpoint (6.3 GB in bf16) and loaded int4 through the worker
MIXTRAL_CKPT_LAYERS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


# the script's start (main sets it): every phase, and the longer parts of
# some, print when they end, as seconds since it
T0 = [0.0]


def done(phase: str) -> None:
    log(f"[time] {phase} done at {time.perf_counter() - T0[0]:.1f} s")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str, source: str, pattern: str, key) -> str:
    """ptxas's registers and spills of the kernel instances of ``source``
    whose mangled name matches ``pattern``, grouped by ``key(match)``
    (e.g. the head width read off the template arguments)."""
    inst = {}
    for block in report.split("Compiling entry function")[1:]:
        name = re.search(r"'(\S+)'", block)
        args = re.search(pattern, name.group(1) if name else "")
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if args and regs and spill:
            inst.setdefault(key(args), []).append(
                (int(regs.group(1)), int(spill.group(1))))
    parts = []
    for k, rows in sorted(inst.items()):
        spilled = [sp for _, sp in rows if sp]
        parts.append(f"{k}: {min(r for r, _ in rows)}-"
                     f"{max(r for r, _ in rows)} registers, "
                     + (f"{len(spilled)}/{len(rows)} spill (max "
                        f"{max(spilled)} B)" if spilled else "no spill"))
    return (f"{source}, {sum(map(len, inst.values()))} instances: "
            + "; ".join(parts))


# (source, mangled-name pattern, group key) of the instances whose
# registers and spills the build reports: flash-decode by head width, the
# ragged tensor-core instance by head width, matmul_residual and
# norm_matmul by dtype and token tile, the int4 GEMV by dtype, token tile
# and copy route
PTXAS_REPORTS = [
    ("flash_decode.cu", r"flash_decode_kernel\S*?Li(\d+)ELi(\d+)ELb([01])E",
     lambda m: f"Dh {int(m.group(1)):3d}"),
    ("flash_decode_fw.cu",
     r"flash_decode_kernel\S*?Li(\d+)ELi(\d+)ELb([01])E",
     lambda m: f"fw Dh {int(m.group(1)):3d}"),
    ("flash_decode_fp8.cu",
     r"flash_decode_kernelI(13__nv_bfloat16|f)\S*?Li(\d+)ELi(\d+)ELb([01])E",
     lambda m: (f"e4m3 pools, {'bf16' if m.group(1) != 'f' else 'fp32'} q,"
                f" Dh {int(m.group(2)):3d}")),
    ("flash_decode_e5m2.cu",
     r"flash_decode_kernelI(13__nv_bfloat16|f)\S*?Li(\d+)ELi(\d+)ELb([01])E",
     lambda m: (f"e5m2 pools, {'bf16' if m.group(1) != 'f' else 'fp32'} q,"
                f" Dh {int(m.group(2)):3d}")),
    ("ragged_attention.cu", r"ragged_mma_kernelILi(\d+)EE",
     lambda m: f"tensor cores, Dh {int(m.group(1)):3d}"),
    # the warp-specialised fp8 instances: their registers at launch (the
    # kernel's setmaxnreg then splits them between mma warps and producers)
    ("ragged_attention_fp8.cu",
     r"ragged_fp8_kernelILi(\d+)E13__nv_fp8_(e4m3|e5m2)",
     lambda m: (f"tensor cores, {m.group(2)} pools, at launch, "
                f"Dh {int(m.group(1)):3d}")),
    ("fused_decode.cu", r"(matmul_residual|norm_matmul)_kernelI"
     r"(13__nv_bfloat16|f)Li(\d)ELb([01])E",
     lambda m: (f"{m.group(1)} {'bf16' if m.group(2) != 'f' else 'fp32'}"
                f" x {8 * int(m.group(3))} tokens"
                f"{'' if m.group(4) == '1' else ' (4-byte copies)'}")),
    *((src, r"paged_(mma|simt)_kernelI(\S*?)Li(\d+)ELi(\d+)EE",
       lambda m: (f"paged {m.group(1)}"
                  f"{' e4m3' if 'e4m3' in m.group(2) else ''}"
                  f"{' e5m2' if 'e5m2' in m.group(2) else ''}"
                  f" Dh {int(m.group(3)):3d} x {int(m.group(4))} rows"))
      for src in ("paged_attention.cu", "paged_attention_fp8.cu")),
    ("int4_matmul.cu", r"int4_gemv_mma_kernelI(13__nv_bfloat16|f)Li(\d)E"
     r"Lb([01])ELb([01])E",
     lambda m: (f"int4 gemv {'bf16' if m.group(1) != 'f' else 'fp32'} x "
                f"{8 * int(m.group(2))} tokens"
                f"{'' if m.group(3) == '1' else ' (byte loads)'}"
                f"{'' if m.group(4) == '1' else ' (x by element)'}")),
]


# ----------------------------------------------------------------- timing


def time_ms(torch, fn, make_args, reps: int = 7, per_rep: int = 10,
            sleep_cycles: int = 40_000_000) -> float:
    """Median over ``reps`` of the mean time of ``per_rep`` back-to-back
    launches, queued behind a device sleep (~20 ms by default, far longer
    than the host takes to enqueue 10 kernel launches) so host enqueue time
    is not measured; ``make_args(i)`` rotates over input copies (cold
    L2)."""
    for i in range(3):
        fn(*make_args(i))
    torch.cuda.synchronize()
    times = []
    for r in range(reps):
        args = [make_args(r * per_rep + i) for i in range(per_rep)]
        torch.cuda._sleep(sleep_cycles)     # ~0.1 s: the host enqueues
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in args:
            fn(*a)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


# the timing of the instance checks beyond the main shapes (the query-head
# groups and head widths of the other families): fewer repetitions behind
# a ~10 ms sleep, which still covers the host's enqueue of 10 launches
QUICK = dict(reps=3, sleep_cycles=20_000_000)
QUICK_PLAIN = dict(reps=2, per_rep=2, sleep_cycles=20_000_000)
# the plain versions' many small launches take the host longer to enqueue:
# a ~0.1 s sleep
MAIN_PLAIN = dict(reps=3, per_rep=3, sleep_cycles=200_000_000)


def copies_for(nbytes: int, limit: int = 8) -> int:
    """Input copies so that one rotation exceeds the 50 MB L2 fourfold."""
    return max(2, min(limit, -(-200_000_000 // max(1, nbytes))))


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, ref):
    return float((got.float() - ref.float()).abs().max())


def within(torch, got, ref, dtype: str, tol=None) -> bool:
    atol, rtol = tol or TOL[dtype]
    return bool(((got.float() - ref.float()).abs()
                 <= atol + rtol * ref.float().abs()).all())


# ---------------------------------------------------------------- phase 2


# flash-decode cases: (label, prefix lengths, n_side, fw side_idx, fw
# active). The Llama-3-8B decode batch (scripts/fp8_times.py also times one
# 2,040-key slot alone)
FD_CASES = [
    ("B8", [0, 1, 127, 128, 300, 777, 1500, 2040], [0, 1, 3, 8, 2, 5, 8, 7],
     [0, 1, 3, W, 2, 5, 7, 6], [1, 1, 0, 1, 1, 0, 1, 1]),
]


def _b128_case(seed: int = 128):
    """The many-slot decode (the TPU bench's default rung runs 128 slots):
    128 prefix lengths drawn uniformly from 0-2,040 and side counts from
    0-8 with a seeded generator, where the K/V bytes dominate the layer."""
    import random
    rs = random.Random(seed)
    prefix = [rs.randint(0, 2040) for _ in range(128)]
    n_side = [rs.randint(0, W) for _ in range(128)]
    return ("B128", prefix, n_side, [min(n, W - 1) for n in n_side],
            [1] * 128)


FD_B128 = [_b128_case()]


def fd_inputs(torch, g, nb: int, dt, n_copies_limit: int = 4, kv_dt=None,
              shape=(H, HKV, DH)):
    """q, the stacked two-layer pools (in ``kv_dt``, q's dtype by default;
    copies for cold L2), a shuffled page table and side buffers of an
    nb-slot flash-decode call at ``shape`` (H, Hkv, Dh)."""
    h, hkv, dh = shape
    kv_dt = kv_dt or dt
    n_layers, n_per_layer = 2, nb * MP
    perm = torch.randperm(n_per_layer, generator=g, device="cuda")
    table = perm.reshape(nb, MP).to(torch.int32).contiguous()
    q = torch.randn((nb, h, dh), generator=g, device="cuda").to(dt)
    pool_shape = (n_layers * n_per_layer, P, hkv * dh)
    item = torch.finfo(kv_dt).bits // 8
    n_copies = copies_for(2 * n_per_layer * P * hkv * dh * item,
                          limit=n_copies_limit)
    kps = [torch.randn(pool_shape, generator=g, device="cuda").to(kv_dt)
           for _ in range(n_copies)]
    vps = [torch.randn(pool_shape, generator=g, device="cuda").to(kv_dt)
           for _ in range(n_copies)]
    sk = torch.randn((nb, W, hkv, dh), generator=g, device="cuda").to(dt)
    sv = torch.randn((nb, W, hkv, dh), generator=g, device="cuda").to(dt)
    return q, kps, vps, table, sk, sv, n_per_layer


def fd_sdpa_ms(torch, q, kp, vp, table, prefix, sk, sv, n_side,
               n_per_layer, timing=None):
    """Library yardstick: SDPA over the pre-gathered K/V (layer 1's pages
    and the side window) with a length mask (the gather is not timed)."""
    F = torch.nn.functional
    hkv, dh = sk.shape[2:]
    timing = timing or {}
    nb = q.shape[0]
    idx = (n_per_layer + table.long())
    kg = torch.cat([kp[idx].reshape(nb, MP * P, hkv, dh), sk], 1)
    vg = torch.cat([vp[idx].reshape(nb, MP * P, hkv, dh), sv], 1)
    kg = kg.transpose(1, 2).contiguous()
    vg = vg.transpose(1, 2).contiguous()
    pos = torch.arange(MP * P + W, device="cuda")[None, :]
    mask = ((pos < prefix[:, None]) | ((pos >= MP * P)
            & (pos - MP * P < n_side[:, None])))[:, None, None, :]
    q4 = q[:, :, None, :]
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask, enable_gqa=True), lambda i: (), **timing)


def fd_row_rel(torch, out, ref32) -> float:
    """max over (slot, head) rows of max|out - ref32| / max|ref32|: the
    rows with thousands of keys have outputs near 0.05, where the
    elementwise atol alone would be loose."""
    row_err = (out.float() - ref32).abs().amax(-1)
    row_ref = ref32.abs().amax(-1)
    live = row_ref > 0
    return float((row_err[live] / row_ref[live]).max())


def check_flash_decode(torch, kv_name=None, shape=(H, HKV, DH),
                       cases=FD_CASES, dtypes=("bfloat16", "float32"),
                       quick=False):
    """Kernel 1 at the decode shapes (``cases``: B 8 by default), held
    against the plain version: elementwise and
    per row against the plain version on the same values in fp32 (the bf16
    plain composition itself rounds three times: prefix part, window part,
    merge; the kernel once); a slot with no key gives exactly 0. With
    ``kv_name`` (e4m3) the pools are e4m3 (the fp8 instances, each checked
    by its launch count), the side window in q's dtype; no single library
    call takes e4m3 K/V (SDPA needs an upcast first), so no yardstick.
    ``shape`` (H, Hkv, Dh), ``cases``, ``dtypes`` and ``quick`` (the
    ``QUICK`` timing) serve the other families' instances."""
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.ops import flash_decode as fd

    h, hkv, dh = shape
    timing, plain_timing = (QUICK, QUICK_PLAIN) if quick else ({}, MAIN_PLAIN)
    rows = []
    g = torch.Generator(device="cuda").manual_seed(1)
    i32 = dict(dtype=torch.int32, device="cuda")
    for label, prefix_l, n_side_l, _, _ in cases:
        nb = len(prefix_l)
        prefix = torch.tensor(prefix_l, **i32)
        n_side = torch.tensor(n_side_l, **i32)
        for dtype_name in dtypes:
            dt = getattr(torch, dtype_name)
            gs, n_sub, n_split, chunk = fd.decode_plan(
                nb, h, hkv, dh, P, MP, torch.device("cuda", 0), dt,
                getattr(torch, kv_name) if kv_name else dt)
            tol = FP8_TOL[dtype_name] if kv_name else TOL[dtype_name]
            q, kps, vps, table, sk, sv, n_per_layer = fd_inputs(
                torch, g, nb, dt,
                kv_dt=getattr(torch, kv_name) if kv_name else None,
                shape=shape)
            n_copies = len(kps)
            args = (q, kps[0], vps[0], table, prefix, sk, sv, n_side)
            kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n_per_layer)
            ref = fd.flash_decode_attention_plain(*args, **kw)
            ref32 = fd.flash_decode_attention_plain(
                *(t.float() if t.is_floating_point() else t for t in args),
                **kw)
            torch.cuda.synchronize()

            def mk(i):
                j = i % n_copies
                return (q, kps[j], vps[j], table, prefix, sk, sv, n_side)

            t_p = time_ms(torch,
                          lambda *a: fd.flash_decode_attention_plain(*a, **kw),
                          mk, **plain_timing)
            t_l = None if kv_name else fd_sdpa_ms(
                torch, q, kps[0], vps[0], table, prefix, sk, sv, n_side,
                n_per_layer, timing)
            keys = int(prefix.sum()) + int(n_side.sum())
            item = torch.finfo(dt).bits // 8
            kv_item = torch.finfo(kps[0].dtype).bits // 8
            # the prefix K/V at the pools' width; side K/V, q and out at q's
            nbytes = 2 * int(prefix.sum()) * hkv * dh * kv_item + \
                (2 * int(n_side.sum()) * hkv * dh + 2 * nb * h * dh) * item \
                + (table.numel() + 2 * nb) * 4
            b_ms, b_by = bound_ms(nbytes, 4.0 * keys * h * dh, dtype_name)
            names = (inst8("flash_decode", kv_name), "flash_decode.rows16")
            before = [_cuda.LAUNCHES[k] for k in names]
            out = fd.flash_decode_attention(*args, **kw)
            torch.cuda.synchronize()
            assert [_cuda.LAUNCHES[k] for k in names] == [
                before[0] + bool(kv_name), before[1] + (gs == 16)], \
                "flash_decode: the fp8 or 16-row instance's launch count"
            err = max_err(torch, out, ref)
            row_rel = fd_row_rel(torch, out, ref32)
            ok = (within(torch, out, ref, dtype_name, tol)
                  and row_rel <= ROW_REL_TOL[dtype_name])
            assert torch.isfinite(out).all(), "flash_decode: non-finite output"
            empty = (prefix + n_side) == 0
            assert float(out[empty].abs().max() if empty.any()
                         else 0) == 0.0, "flash_decode: empty row"
            assert int((ref32.abs().amax(-1) > 0).sum()) == \
                int((~empty).sum()) * h, "flash_decode: zero rows"
            t_k = time_ms(torch,
                          lambda *a: fd.flash_decode_attention(*a, **kw), mk,
                          **timing)
            rows.append(dict(
                dtype=dtype_name, err=err, ok=ok, ms=t_k, plain_ms=t_p,
                library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                row_rel=row_rel, n_split=n_split, chunk=chunk, tol=tol,
                note=f"{n_split} runs of {chunk}"
                + (f"; {n_sub} sub-group(s) of {gs} rows a KV head"
                   if gs * n_sub != h // hkv or n_sub > 1 or gs == 16
                   else ""),
                shape=f"{label} H{h} Hkv{hkv} Dh{dh} "
                f"P{P} MP{MP} W{W} keys{keys}{pool_tag(kv_name)}"))
    return rows


def check_flash_decode_fw(torch, kv_name=None, shape=(H, HKV, DH),
                          cases=FD_CASES, dtypes=("bfloat16", "float32"),
                          quick=False):
    """The writeback variant at kernel 1's cases: some slots inactive,
    slot 3 of B 8 active at side_idx = W (the fresh row is dropped there,
    as in the plain version); output and the side buffers after the
    write, bit-equal to the plain version's. With ``kv_name`` (e4m3) the
    pools are e4m3 (the fp8 instances) and slot 1's fresh row is scaled
    past 464: the side window, in q's dtype, takes its bytes as they
    are. ``shape``, ``cases``, ``dtypes``, ``quick``: as
    ``check_flash_decode``."""
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.ops import flash_decode as fd

    h, hkv, dh = shape
    timing, plain_timing = (QUICK, QUICK_PLAIN) if quick else ({}, MAIN_PLAIN)
    rows = []
    g = torch.Generator(device="cuda").manual_seed(5)
    i32 = dict(dtype=torch.int32, device="cuda")
    for label, prefix_l, _, side_idx_l, active_l in cases:
        nb = len(prefix_l)
        prefix = torch.tensor(prefix_l, **i32)
        side_idx = torch.tensor(side_idx_l, **i32)
        active = torch.tensor(active_l, **i32)
        # side entries read, the fresh rows attended (and written)
        n_read = torch.clamp(side_idx, max=W)
        wrote = (active > 0) & (side_idx < W)
        for dtype_name in dtypes:
            dt = getattr(torch, dtype_name)
            gs, n_sub, n_split, chunk = fd.decode_plan(
                nb, h, hkv, dh, P, MP, torch.device("cuda", 0), dt,
                getattr(torch, kv_name) if kv_name else dt)
            tol = FP8_TOL[dtype_name] if kv_name else TOL[dtype_name]
            q, kps, vps, table, sk, sv, n_per_layer = fd_inputs(
                torch, g, nb, dt,
                kv_dt=getattr(torch, kv_name) if kv_name else None,
                shape=shape)
            n_copies = len(kps)
            fk = torch.randn((nb, 1, hkv, dh), generator=g,
                             device="cuda").to(dt)
            fv = torch.randn((nb, 1, hkv, dh), generator=g,
                             device="cuda").to(dt)
            if kv_name and nb > 1:
                fk[1] *= 2 * KV8[kv_name][2]
                fv[1] *= 2 * KV8[kv_name][2]
            kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n_per_layer)
            sk_p, sv_p = sk.clone(), sv.clone()
            ref, _, _ = fd.flash_decode_attention_fw_plain(
                q, kps[0], vps[0], table, prefix, sk_p, sv_p, fk, fv,
                side_idx, active, **kw)
            ref32, _, _ = fd.flash_decode_attention_fw_plain(
                q.float(), kps[0].float(), vps[0].float(), table, prefix,
                sk.float(), sv.float(), fk.float(), fv.float(), side_idx,
                active, **kw)
            torch.cuda.synchronize()
            sk_t, sv_t = sk.clone(), sv.clone()

            def mk(i):
                j = i % n_copies
                return (q, kps[j], vps[j], table, prefix, sk_t, sv_t, fk, fv,
                        side_idx, active)

            t_p = time_ms(
                torch,
                lambda *a: fd.flash_decode_attention_fw_plain(*a, **kw), mk,
                **plain_timing)
            # library yardstick: kernel 1's SDPA over the pre-gathered
            # prefix and the side window after the write
            t_l = None if kv_name else fd_sdpa_ms(
                torch, q, kps[0], vps[0], table, prefix, sk_p, sv_p,
                torch.clamp(side_idx + active, max=W), n_per_layer, timing)
            n_fresh = int(wrote.sum())
            keys = int(prefix.sum()) + int(n_read.sum()) + n_fresh
            item = torch.finfo(dt).bits // 8
            kv_item = torch.finfo(kps[0].dtype).bits // 8
            # K/V of every key read once (the prefix at the pools' width),
            # the fresh rows written once, q, out
            nbytes = 2 * int(prefix.sum()) * hkv * dh * kv_item + (
                2 * (int(n_read.sum()) + 2 * n_fresh) * hkv * dh
                + 2 * nb * h * dh) * item + (table.numel() + 3 * nb) * 4
            b_ms, b_by = bound_ms(nbytes, 4.0 * keys * h * dh, dtype_name)
            sk_k, sv_k = sk.clone(), sv.clone()
            names = (inst8("flash_decode_fw", kv_name),
                     "flash_decode_fw.rows16")
            before = [_cuda.LAUNCHES[k] for k in names]
            out, _, _ = fd.flash_decode_attention_fw(
                q, kps[0], vps[0], table, prefix, sk_k, sv_k, fk, fv,
                side_idx, active, **kw)
            torch.cuda.synchronize()
            assert [_cuda.LAUNCHES[k] for k in names] == [
                before[0] + bool(kv_name), before[1] + (gs == 16)], \
                "flash_decode_fw: the fp8 or 16-row instance's launch count"
            sides_equal = torch.equal(sk_k, sk_p) and torch.equal(sv_k, sv_p)
            assert bool(torch.equal(sk_k[~wrote], sk[~wrote])), \
                "flash_decode_fw: wrote an inactive or full-window side row"
            err = max_err(torch, out, ref)
            row_rel = fd_row_rel(torch, out, ref32)
            ok = (within(torch, out, ref, dtype_name, tol) and sides_equal
                  and row_rel <= ROW_REL_TOL[dtype_name])
            assert torch.isfinite(out).all(), "flash_decode_fw: non-finite"
            t_k = time_ms(
                torch, lambda *a: fd.flash_decode_attention_fw(*a, **kw), mk,
                **timing)
            rows.append(dict(
                dtype=dtype_name, err=err, ok=ok, ms=t_k, plain_ms=t_p,
                library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                row_rel=row_rel, n_split=n_split, chunk=chunk, tol=tol,
                note=f"{n_split} runs of {chunk}"
                f"{'; side rows byte-equal' if sides_equal else ''}"
                + (f"; {n_sub} sub-group(s) of {gs} rows a KV head"
                   if gs * n_sub != h // hkv or n_sub > 1 or gs == 16
                   else ""),
                shape=f"{label} H{h} Hkv{hkv} Dh{dh} "
                f"P{P} MP{MP} W{W} keys{keys}{pool_tag(kv_name)}"))
    return rows


# ragged rows (ctx_len, q_len): 8 decode rows, two of them inert, then a
# 256-query chunk from position 0 and a 177-query chunk at 384 + 60 that
# straddles a page
RAGGED_ROWS = [(0, 0), (1, 1), (127, 1), (128, 1), (383, 1), (640, 1),
               (1000, 1), (0, 0), (0, 256), (384 + 60, 177)]
MP_RAGGED = 8
# the async verify step's lattice (A12): 8 rows of 1 + k = 5 queries over
# contexts 0-1,000, a plain q=1 decode row, rows 0 and 7 inert
VERIFY_ROWS = [(0, 0), (0, 5), (1, 5), (127, 5), (128, 5), (383, 5),
               (640, 5), (0, 0), (900, 5), (1000, 5), (63, 1)]


def check_ragged(torch, kv_name=None, shape=(H, HKV, DH),
                 dtypes=("bfloat16", "float32"), quick=False,
                 lattice=RAGGED_ROWS):
    """Ragged attention at full width against its plain version: outputs
    (and, in bf16, each (row, query, head) vector against the plain version
    on the same values in fp32) and the pools after the writeback. bf16
    must run the tensor-core instance (``mma``), fp32 the CUDA cores. With
    ``kv_name`` (e4m3) the pools are e4m3 (the fp8 instances, bf16 still on
    the tensor cores): the fp32 reference keeps e4m3 pools, so it rounds
    the fresh K/V as the kernel does; then a second call with the fresh
    K/V scaled past 464 must leave the pools byte-equal to the plain
    version's (NaN bytes, JAX's cast). No single library call takes e4m3
    K/V, so no yardstick. ``shape``, ``dtypes``, ``quick``: as
    ``check_flash_decode``; ``lattice``: the rows (ctx_len, q_len), rows 0
    and 7 inert (``RAGGED_ROWS``, or the verify step's ``VERIFY_ROWS``)."""
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.ops import (
        ragged_attention as ra)
    from distributed_inference_engine_tpu_torch.ops.attention import raw_view

    F = torch.nn.functional
    h, hkv, dh = shape
    timing, plain_timing = (QUICK, QUICK_PLAIN) if quick else ({}, MAIN_PLAIN)
    rows = []
    g = torch.Generator(device="cuda").manual_seed(6)
    r = len(lattice)
    qmax = max(q for _, q in lattice)
    i32 = dict(dtype=torch.int32, device="cuda")
    ctx = torch.tensor([c for c, _ in lattice], **i32)
    ql = torch.tensor([q for _, q in lattice], **i32)
    n_layers, n = 2, r * MP_RAGGED + 8
    perm = torch.randperm(n, generator=g, device="cuda")[: r * MP_RAGGED]
    table = perm.reshape(r, MP_RAGGED).to(torch.int32).contiguous()
    table[0] = table[1]               # inert rows aim at live pages
    table[7] = table[6]
    valid = (torch.arange(qmax, device="cuda")[None, :] < ql[:, None])
    ctx_keys = sum(c for c, q in lattice if q)
    n_q = sum(q for _, q in lattice)
    flops = 4.0 * h * dh * sum(q * (c + (q + 1) / 2) for c, q in lattice)
    for dtype_name in dtypes:
        dt = getattr(torch, dtype_name)
        kv_dt = getattr(torch, kv_name) if kv_name else dt
        tol = FP8_TOL[dtype_name] if kv_name else TOL[dtype_name]
        item = torch.finfo(dt).bits // 8
        kv_item = torch.finfo(kv_dt).bits // 8
        q = torch.randn((r, qmax, h, dh), generator=g, device="cuda").to(dt)
        fk = torch.randn((r, qmax, hkv, dh), generator=g,
                         device="cuda").to(dt)
        fv = torch.randn((r, qmax, hkv, dh), generator=g,
                         device="cuda").to(dt)
        pool_shape = (n_layers * n, P, hkv * dh)
        n_copies = copies_for(2 * n * P * hkv * dh * kv_item, limit=4)
        kps = [torch.randn(pool_shape, generator=g, device="cuda").to(kv_dt)
               for _ in range(n_copies)]
        vps = [torch.randn(pool_shape, generator=g, device="cuda").to(kv_dt)
               for _ in range(n_copies)]
        kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
        kp_p, vp_p = kps[0].clone(), vps[0].clone()
        # fp32 reference pools: e4m3 ones stay e4m3 (the fresh K/V rounds
        # into them as in the kernel)
        kp_32, vp_32 = ((kps[0].clone(), vps[0].clone()) if kv_name
                        else (kps[0].float(), vps[0].float()))
        inst = ra.ragged_instance(dt, kv_dt)
        assert inst == ("mma" if dtype_name == "bfloat16" else "simt"), inst
        names = (f"ragged_attention.{inst}",
                 inst8("ragged_attention", kv_name))
        before = [_cuda.LAUNCHES[k] for k in names]
        out, _, _ = ra.ragged_attention(q, kps[0], vps[0], table, ctx, ql,
                                        fk, fv, **kw)
        torch.cuda.synchronize()
        assert [_cuda.LAUNCHES[k] for k in names] == [
            before[0] + 1, before[1] + bool(kv_name)], \
            f"ragged_attention: the {inst} instance did not run"
        ref, _, _ = ra.ragged_attention_plain(q, kp_p, vp_p, table, ctx, ql,
                                              fk, fv, **kw)
        torch.cuda.synchronize()
        pages_equal = (torch.equal(raw_view(kps[0]), raw_view(kp_p))
                       and torch.equal(raw_view(vps[0]), raw_view(vp_p)))
        err = max_err(torch, out, ref)
        ref32, _, _ = ra.ragged_attention_plain(
            q.float(), kp_32, vp_32, table, ctx, ql, fk.float(), fv.float(),
            **kw)
        row_err = (out.float() - ref32).abs().amax(-1)[valid]
        row_ref = ref32.abs().amax(-1)[valid]
        row_rel = float((row_err / row_ref).max())
        ok = (within(torch, out, ref, dtype_name, tol) and pages_equal
              and row_rel <= ROW_REL_TOL[dtype_name])
        assert torch.isfinite(out).all(), "ragged_attention: non-finite"
        assert float(out[~valid].abs().max()) == 0.0, \
            "ragged_attention: padding rows not zero"
        note = inst
        if kv_name:
            # the writeback past the dtype's largest value (e4m3: 464, NaN
            # bytes; e5m2: 61,440, +-inf), byte-equal to the plain
            # version's
            kp_o, vp_o = kps[0].clone(), vps[0].clone()
            kp_q, vp_q = kps[0].clone(), vps[0].clone()
            big_k, big_v = fk * KV8[kv_name][2], fv * KV8[kv_name][2]
            ra.ragged_attention(q, kp_o, vp_o, table, ctx, ql, big_k, big_v,
                                **kw)
            ra.ragged_attention_plain(q, kp_q, vp_q, table, ctx, ql, big_k,
                                      big_v, **kw)
            torch.cuda.synchronize()
            over_equal = (torch.equal(raw_view(kp_o), raw_view(kp_q))
                          and torch.equal(raw_view(vp_o), raw_view(vp_q)))
            n_over = int((~torch.isfinite(kp_o.float())).sum())
            assert n_over > 0, "ragged_attention: no overflow"
            ok = ok and over_equal
            note += (f"; pools byte-equal, and past "
                     f"{'464' if kv_name == FP8 else '61,440'} ({n_over} "
                     f"{'NaN' if kv_name == FP8 else 'inf'} bytes in K) "
                     f"{'byte-equal' if over_equal else 'DIFFER'}")
            del kp_o, vp_o, kp_q, vp_q

        def mk(i):
            j = i % n_copies
            return (q, kps[j], vps[j], table, ctx, ql, fk, fv)

        t_k = time_ms(torch, lambda *a: ra.ragged_attention(*a, **kw), mk,
                      **timing)
        t_p = time_ms(torch, lambda *a: ra.ragged_attention_plain(*a, **kw),
                      mk, **plain_timing)
        t_l = None
        if not kv_name:
            # library yardstick: SDPA with a boolean mask over the
            # pre-gathered context ++ fresh K/V (the gather is not timed;
            # padding queries see key 0, so no row is fully masked)
            s_ctx = MP_RAGGED * P
            idx = (n + table.long())
            kg = torch.cat([kps[0][idx].reshape(r, s_ctx, hkv, dh), fk], 1)
            vg = torch.cat([vps[0][idx].reshape(r, s_ctx, hkv, dh), fv], 1)
            kg = kg.transpose(1, 2).contiguous()
            vg = vg.transpose(1, 2).contiguous()
            pos = torch.arange(s_ctx + qmax, device="cuda")[None, None, :]
            qi = torch.arange(qmax, device="cuda")[None, :, None]
            mask = ((pos < ctx[:, None, None])
                    | ((pos >= s_ctx) & (pos - s_ctx <= qi)
                       & (pos - s_ctx < ql[:, None, None])))
            mask[..., 0] |= ~valid
            q4 = q.transpose(1, 2).contiguous()
            t_l = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask[:, None], enable_gqa=True),
                lambda i: (), **timing)
        # valid work only: context K/V below ctx_len (at the pools' width),
        # the fresh K/V read (q's width) and written (the pools'), the
        # valid queries and their outputs
        nbytes = (2 * ctx_keys + 2 * n_q) * hkv * dh * kv_item + (
            2 * n_q * hkv * dh + 2 * n_q * h * dh) * item + \
            (table.numel() + 2 * r) * 4
        b_ms, b_by = bound_ms(nbytes, flops, dtype_name)
        tq = ra.ragged_plan(r, qmax, h, hkv, inst, 132)[0]
        if (tq * (h // hkv)) % ra.ROWS_PER_BLOCK[inst]:
            note += (f"; {tq} queries a tile, {tq * (h // hkv)} of "
                     f"{ra.ROWS_PER_BLOCK[inst]} rows live")
        rows.append(dict(dtype=dtype_name, err=err, ok=ok, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                         bound_by=b_by, row_rel=row_rel, note=note, tol=tol,
                         shape=f"R{r} Qmax{qmax} H{h} Hkv{hkv} Dh{dh} P{P} "
                         f"MP{MP_RAGGED} q{n_q} ctx{ctx_keys}"
                         f"{pool_tag(kv_name)}"))
    return rows


# check_paged's cases (q dtype, window, stacked pool) at the Mistral
# shapes: the Mistral path's call (bf16, window 4096, the stacked pool with
# the stats), one layer's pool without a window, fp32 q (the CUDA cores);
# scripts/paged_times.py --sweep runs every pair of them
PAGED_CASES = (("bfloat16", MISTRAL_WINDOW, True), ("bfloat16", 0, False),
               ("float32", MISTRAL_WINDOW, True))


def check_paged(torch, kv_name=None, shape=(H, HKV, DH), quick=False,
                layers=PAGED_LAYERS, cases=PAGED_CASES):
    """Paged attention at the Mistral decode shapes against its plain
    version: ``cases`` (q dtype, window, stacked: one layer's pool or the
    stacked pool, layer 5 of 32, with the flash stats), then with bf16 q
    the 6,000-token slot alone (B=1, window 4096, stacked). Held per
    output row to max|out - ref32| / max|ref32| (ref32: the plain version
    on the same values widened to fp32) and elementwise to the dtype's
    tolerance; m and l to ``STATS_TOL`` of the fp32 plain stats. Timed on
    the stacked pool, rotating over its 32 layers (cold L2); the library
    yardstick is SDPA over the pre-gathered pages with the window mask.
    With ``kv_name`` (e4m3) the pools are e4m3 (the fp8 instance, checked
    by its launch count; no yardstick: SDPA needs an upcast first).
    ``quick`` (the other families' instances at ``shape``): the pool of
    ``layers`` layers, the ``QUICK`` timing, no lone slot."""
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.ops import paged_attention \
        as pa

    F = torch.nn.functional
    h, hkv, dh = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timing, plain_timing = (QUICK, QUICK_PLAIN) if quick else ({}, MAIN_PLAIN)
    at = min(PAGED_LAYER, layers - 1)        # the stacked pool's layer
    rows = []
    g = torch.Generator(device="cuda").manual_seed(8)
    n = B * MP_PAGED
    i32 = dict(dtype=torch.int32, device="cuda")
    table_all = torch.randperm(n, generator=g, device="cuda").reshape(
        B, MP_PAGED).to(torch.int32).contiguous()
    pos = torch.arange(MP_PAGED * P, device="cuda")[None, :]

    def one(dtype_name, q, kp, vp, table, lens_list, window, stacked):
        item = torch.finfo(q.dtype).bits // 8
        kv_item = torch.finfo(kp.dtype).bits // 8
        tol = FP8_TOL[dtype_name] if kv_name else TOL[dtype_name]
        b = len(lens_list)
        lens = torch.tensor(lens_list, **i32)
        lo = at * n
        one_pool = (kp[lo:lo + n], vp[lo:lo + n])
        pools = (kp, vp) if stacked else one_pool
        kw = dict(n_kv_heads=hkv, window=window, with_stats=stacked)
        if stacked:
            kw.update(layer=at, n_pages_per_layer=n)
        max_keys = min(MP_PAGED * P, window) if window else MP_PAGED * P
        plan = pa.paged_plan(b, h, hkv, dh, max_keys, sms, q.dtype,
                             kp.dtype)
        route = "mma" if plan.mma else "simt"
        counter = inst8("paged_attention", kv_name)
        before = (_cuda.LAUNCHES[counter],
                  _cuda.LAUNCHES[f"paged_attention.{route}"])
        got = pa.paged_attention(q, *pools, table, lens, **kw)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[counter] == before[0] + bool(
            kv_name), "paged_attention: the fp8 instance's launch count"
        assert _cuda.LAUNCHES[f"paged_attention.{route}"] == before[1] + 1, \
            f"paged_attention: the {route} route's launch count"
        ref = pa.paged_attention_xla(q, *pools, table, lens, **kw)
        ref32 = pa.paged_attention_xla(
            q.float(), *(t.float() for t in one_pool), table, lens,
            **dict(kw, with_stats=True, layer=None, n_pages_per_layer=0))
        ref_out = ref[0] if stacked else ref
        empty = [i for i, x in enumerate(lens_list) if x == 0]

        def held(got):
            """(max_abs_err, row_rel, stats_rel, ok) of one launch's
            result against the plain version's."""
            out = got[0] if stacked else got
            err = max_err(torch, out, ref_out)
            row_err = (out.float() - ref32[0]).abs().amax(-1)
            row_ref = ref32[0].abs().amax(-1)
            live = row_ref > 0
            row_rel = float((row_err[live] / row_ref[live]).max())
            ok = (within(torch, out, ref_out, dtype_name, tol)
                  and row_rel <= ROW_REL_TOL[dtype_name])
            assert torch.isfinite(out).all(), "paged_attention: non-finite"
            for i in empty:
                assert float(out[i].abs().max()) == 0.0, \
                    "paged_attention: empty slot not zero"
            assert int(live.sum()) == (b - len(empty)) * h, \
                "paged_attention: rows"
            stats_rel = None
            if stacked:
                _, m, l = got
                _, m32, l32 = ref32
                has = l32 > 0
                stats_rel = max(
                    float(((m - m32).abs()[has] / m32.abs()[has]
                           .clamp_min(1.0)).max()),
                    float(((l - l32).abs() / l32.clamp_min(1.0)).max()))
                ok = ok and stats_rel <= STATS_TOL and all(
                    float(l[i].abs().max()) == 0.0
                    and bool((m[i] == -1e30).all()) for i in empty)
            return err, row_rel, stats_rel, ok

        err, row_rel, stats_rel, ok = held(got)
        if window:
            keys = sum(min(x, window) for x in lens_list)
            vis = (pos < lens[:, None]) & (pos >= lens[:, None] - window)
        else:
            keys = sum(lens_list)
            vis = pos < lens[:, None]

        def call(fn, i):
            # the stacked pool rotates over its layers (cold L2)
            kwi = dict(kw, layer=i % layers) if stacked else kw
            return fn(q, *pools, table, lens, **kwi)

        t_k = time_ms(torch, lambda i: call(pa.paged_attention, i),
                      lambda i: (i,), **timing)
        # bf16 q at G <= 4: the other route too, held the same and timed
        # at the quick timing
        alt = None
        if q.dtype == torch.bfloat16 and h // hkv <= 4:
            other = pa.paged_plan(b, h, hkv, dh, max_keys, sms, q.dtype,
                                  kp.dtype, mma=not plan.mma)

            def launch_other(*a, **k):
                return pa.paged_attention_launch(*a[:5], other, *a[5:], **k)

            a_err, _, _, a_ok = held(
                launch_other(q, *pools, table, lens, **kw))
            ok = ok and a_ok
            err = max(err, a_err)
            alt = ("mma" if other.mma else "simt",
                   time_ms(torch, lambda i: call(launch_other, i),
                           lambda i: (i,), **QUICK))
        t_p = time_ms(torch, lambda i: call(pa.paged_attention_xla, i),
                      lambda i: (i,), **plain_timing)
        t_l = None
        if not kv_name:
            idx = lo + table.long()
            kg = kp[idx].reshape(b, MP_PAGED * P, hkv, dh).transpose(
                1, 2).contiguous()
            vg = vp[idx].reshape(b, MP_PAGED * P, hkv, dh).transpose(
                1, 2).contiguous()
            q4 = q[:, :, None, :]
            mask = vis[:, None, None, :]
            t_l = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask, enable_gqa=True), lambda i: (),
                **timing)
            del kg, vg
        # the live window's K/V read once (at the pools' width), q and out
        # (and the stats), the table and lengths
        nbytes = 2 * keys * hkv * dh * kv_item + 2 * b * h * dh * item + \
            (table.numel() + b) * 4 + (8 * b * h if stacked else 0)
        b_ms, b_by = bound_ms(nbytes, 4.0 * keys * h * dh, dtype_name)
        row = dict(dtype=dtype_name, err=err, ok=ok, ms=t_k, plain_ms=t_p,
                   library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                   row_rel=row_rel, window=window, stacked=stacked, tol=tol,
                   route=f"{route}, {plan.rows} rows"
                   f"{f' x {plan.n_sub}' if plan.n_sub > 1 else ''}, "
                   f"{plan.n_split} runs of {plan.chunk}",
                   shape=f"B{b} H{h} Hkv{hkv} Dh{dh} P{P} MP{MP_PAGED} "
                   f"win{window} "
                   f"{f'L{at}/{layers}+stats' if stacked else 'layer'} "
                   f"keys{keys}{pool_tag(kv_name)}")
        if alt:
            row["note"] = f"the {alt[0]} route {alt[1]:.4f} ms"
        if stats_rel is not None:
            row["stats_rel"] = stats_rel
        return row

    long_row = None
    for dtype_name in dict.fromkeys(d for d, _, _ in cases):
        dt = getattr(torch, dtype_name)
        pool_shape = (layers * n, P, hkv * dh)
        if kv_name:
            kv_dt = getattr(torch, kv_name)
            kp = torch.randn(pool_shape, generator=g, device="cuda").to(kv_dt)
            vp = torch.randn(pool_shape, generator=g, device="cuda").to(kv_dt)
        else:
            kp = torch.randn(pool_shape, generator=g, device="cuda", dtype=dt)
            vp = torch.randn(pool_shape, generator=g, device="cuda", dtype=dt)
        q = torch.randn((B, h, dh), generator=g, device="cuda", dtype=dt)
        for case_dtype, window, stacked in cases:
            if case_dtype == dtype_name:
                rows.append(one(dtype_name, q, kp, vp, table_all,
                                PAGED_LENS, window, stacked))
        if dtype_name == "bfloat16" and not quick:
            b1 = PAGED_LENS.index(max(PAGED_LENS))
            long_row = one(dtype_name, q[b1:b1 + 1].contiguous(), kp, vp,
                           table_all[b1:b1 + 1].contiguous(),
                           [PAGED_LENS[b1]], MISTRAL_WINDOW, True)
        del kp, vp
        torch.cuda.empty_cache()
    if long_row is not None:
        rows.append(long_row)
    return rows


# the kernels line's paged row: the Mistral path's call (bf16, stacked
# pool, window 4096), PAGED_CASES' first
PAGED_MAIN = 0


def check_gemv(torch, which: str):
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.ops import fused_decode as fdec

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    shapes = ([(D_MODEL, n) for n in (1024, 4096, D_FF)]
              if which == "norm_matmul" else
              [(k, D_MODEL) for k in (D_MODEL, D_FF)])
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        item = torch.finfo(dt).bits // 8
        for d, n in shapes:
            x = torch.randn((B, d), generator=g, device="cuda").to(dt)
            gain = (1.0 + 0.1 * torch.randn((d,), generator=g,
                                            device="cuda")).to(dt)
            res = torch.randn((B, n), generator=g, device="cuda").to(dt)
            n_copies = copies_for(d * n * item)
            ws = [(0.02 * torch.randn((d, n), generator=g,
                                      device="cuda")).to(dt)
                  for _ in range(n_copies)]
            if which == "norm_matmul":
                def kern(w):
                    return fdec.norm_matmul(x, gain, w, eps=1e-5)

                def plain(w):
                    return fdec.norm_matmul_plain(x, gain, w, eps=1e-5)

                def lib(w):
                    return torch.matmul(
                        F.rms_norm(x, (d,), gain, eps=1e-5), w)
                nbytes = (B * d + d + d * n + B * n) * item
            else:
                def kern(w):
                    return fdec.matmul_residual(x, w, res)

                def plain(w):
                    return fdec.matmul_residual_plain(x, w, res)

                def lib(w):
                    return torch.addmm(res, x, w)
                nbytes = (B * d + d * n + 2 * B * n) * item
            # bf16 on the tensor cores, fp32 on the CUDA cores, in one
            # launch (a cluster of `ks` blocks along K)
            inst = fdec.gemv_instance(dt)
            plan = fdec.gemv_plan(B, d, n, dt, _cuda.sm_count(0))
            note = dict(note=f"{inst}, clusters of {plan['ks']}, "
                        f"{plan['blocks']} blocks")
            before = _cuda.LAUNCHES[f"{which}.{inst}"]
            out = kern(ws[0])
            torch.cuda.synchronize()
            assert _cuda.LAUNCHES[f"{which}.{inst}"] == before + 1, \
                f"{which}: {inst} did not run"
            ref = plain(ws[0])
            torch.cuda.synchronize()
            err = max_err(torch, out, ref)
            ok = within(torch, out, ref, dtype_name)
            assert torch.isfinite(out).all(), f"{which}: non-finite output"

            def mk(i):
                return (ws[i % n_copies],)

            t_k = time_ms(torch, kern, mk)
            t_p = time_ms(torch, plain, mk)
            t_l = time_ms(torch, lib, mk)
            b_ms, b_by = bound_ms(nbytes, 2.0 * B * d * n, dtype_name)
            rows.append(dict(dtype=dtype_name, err=err, ok=ok, ms=t_k,
                             plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                             bound_by=b_by, shape=f"B{B} D{d} N{n}", **note))
    return rows


def check_int4(torch, cases=None):
    """The packed-int4 matmul at every Llama-3-8B shape and the rows the
    path gives it, and at two ragged shapes (or at ``cases``: (name, M,
    K/2, N, dtype)). Held per output column to
    max|out - ref32| / max|ref32| (ref32: the plain version on the same
    inputs widened to fp32) at 8 rows and more; at every row count to the
    same bound relative to the column's largest sum |x w| s, since a
    column of one or a few rows can sum thousands of random terms to near
    0, where the fp32 summation order alone moves the relative error.
    Library yardstick: cuBLAS ``torch.mm`` on the weight dequantized to
    x's dtype, which reads 4x (bf16) or 8x (fp32) the packed bytes."""
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.ops import int4_matmul as i4

    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    cases = cases or [(name, m, k2, n, dt) for name, k2, n, dt in INT4_SHAPES
                      for m in INT4_ROWS] + INT4_EDGES
    for name, m, k2, n, dtype_name in cases:
        dt = getattr(torch, dtype_name)
        item = torch.finfo(dt).bits // 8
        x = torch.randn((m, 2 * k2), generator=g, device="cuda").to(dt)
        n_copies = copies_for(k2 * n, limit=4)
        packs = [torch.randint(-128, 128, (k2, n), generator=g,
                               device="cuda", dtype=torch.int8)
                 for _ in range(n_copies)]
        scale = 0.002 + 0.01 * torch.rand((n,), generator=g, device="cuda")
        inst = i4.int4_instance(m, k2, n, dt, True)
        if inst == "gemv":
            # one launch: clusters of ks blocks along the packed rows
            pl = i4.int4_gemv_plan(m, k2, n, _cuda.sm_count(0))
            inst_note = (f"gemv, clusters of {pl['ks']}, {pl['blocks']} "
                         f"blocks")
        else:
            inst_note = inst
        before = _cuda.LAUNCHES[f"int4_matmul.{inst}"]
        out = i4.int4_matmul(x, packs[0], scale)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[f"int4_matmul.{inst}"] == before + 1, inst
        ref = i4.int4_matmul_plain(x, packs[0], scale)
        ref32 = i4.int4_matmul_plain(x.float(), packs[0], scale)
        err = max_err(torch, out, ref)
        col_err = (out.float() - ref32).abs().amax(0)
        col_rel = float((col_err / ref32.abs().amax(0).clamp_min(1e-30))
                        .max())
        lo, hi = i4.unpack_int4(packs[0])
        xa = x.float().abs()
        mag = (xa[:, :k2] @ lo.abs().float()
               + xa[:, k2:] @ hi.abs().float()) * scale
        col_rel_mag = float((col_err / mag.amax(0).clamp_min(1e-30)).max())
        tol = COL_REL_TOL[dtype_name]
        ok = (bool(torch.isfinite(out).all()) and col_rel_mag <= tol
              and (m < 8 or col_rel <= tol))
        del ref, ref32, mag, xa
        w_deq = [(torch.cat(i4.unpack_int4(p), 0).to(dt) * scale.to(dt))
                 for p in packs[: copies_for(2 * k2 * n * item, limit=2)]]
        del lo, hi

        def mk(i):
            return (x, packs[i % n_copies], scale)

        big = m * k2 * n > 1e11                  # tens of ms per call
        reps = dict(reps=3, per_rep=3) if big else {}
        t_k = time_ms(torch, i4.int4_matmul, mk, **reps)
        t_p = time_ms(torch, i4.int4_matmul_plain, mk, reps=3, per_rep=3)
        t_l = time_ms(torch, lambda w: torch.mm(x, w),
                      lambda i: (w_deq[i % len(w_deq)],), **reps)
        del w_deq, packs
        nbytes = k2 * n + m * 2 * k2 * item + m * n * item + 4 * n
        flops = 2.0 * m * 2 * k2 * n
        if inst == "gemv" and dtype_name == "float32":
            # the GEMV runs an fp32 x as three bf16 terms on the tensor cores
            b_ms, b_by = bound_ms(nbytes, 3 * flops, "bfloat16")
        else:
            b_ms, b_by = bound_ms(nbytes, flops, dtype_name)
        rows.append(dict(dtype=dtype_name, err=err, ok=ok, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                         bound_by=b_by, col_rel=col_rel,
                         col_rel_mag=col_rel_mag,
                         shape=f"{name} M{m} K/2={k2} N{n} {inst}",
                         note=inst_note))
    torch.cuda.empty_cache()
    return rows


def profile_int4_tiles(torch, card: str) -> None:
    """``--profile``: the wgmma instance at each of its token tiles (the
    wrapper's ``wgmma_tile`` replaced here only) beside the tile that rule
    picks and cuBLAS on the dequantized weight, at the bf16 Llama-3-8B
    shapes and ``INT4_TILE_ROWS``; every tile held per column to
    ``COL_REL_TOL``."""
    from distributed_inference_engine_tpu_torch.ops import int4_matmul as i4

    g = torch.Generator(device="cuda").manual_seed(4)
    rule = i4.wgmma_tile
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for name, k2, n, dtype_name in INT4_SHAPES:
            if dtype_name != "bfloat16":
                continue
            packs = [torch.randint(-128, 128, (k2, n), generator=g,
                                   device="cuda", dtype=torch.int8)
                     for _ in range(copies_for(k2 * n, limit=4))]
            scale = 0.002 + 0.01 * torch.rand((n,), generator=g, device="cuda")
            w = torch.cat(i4.unpack_int4(packs[0]), 0).bfloat16() * \
                scale.bfloat16()
            for m in INT4_TILE_ROWS:
                x = torch.randn((m, 2 * k2), generator=g,
                                device="cuda").bfloat16()
                ref32 = i4.int4_matmul_plain(x.float(), packs[0], scale)
                times = []
                for tile in WGMMA_TILES:
                    i4.wgmma_tile = lambda *a, t=tile: t
                    out = i4.int4_matmul(x, packs[0], scale)
                    col_rel = float(((out.float() - ref32).abs().amax(0)
                                     / ref32.abs().amax(0).clamp_min(1e-30))
                                    .max())
                    assert col_rel <= COL_REL_TOL["bfloat16"], \
                        (name, m, tile, col_rel)
                    times.append(time_ms(torch, i4.int4_matmul, lambda i: (
                        x, packs[i % len(packs)], scale)))
                i4.wgmma_tile = rule
                t_l = time_ms(torch, lambda: torch.mm(x, w), lambda i: ())
                log(f"[profile] int4 tiles: {name} M{m} N{n}: " + ", ".join(
                    f"{t} tokens {ms:.4f}" for t, ms in zip(WGMMA_TILES, times))
                    + f" ms; the rule picks {rule(m, n, sms)}; cuBLAS "
                    f"{t_l:.4f} ms [{card}]")
            del packs, w
    finally:
        i4.wgmma_tile = rule
    torch.cuda.empty_cache()


def family_paged(torch, kv_name=None, shape=(H, HKV, DH),
                 dtypes=("bfloat16", "float32"), quick=True,
                 windows=(MISTRAL_WINDOW,)):
    """``check_paged`` on another family's instance at ``shape``: the
    stacked pool of ``FAMILY_PAGED_LAYERS`` layers, each of ``dtypes`` at
    each of ``windows``, at the quick timing."""
    return check_paged(torch, kv_name, shape=shape, quick=quick,
                       layers=FAMILY_PAGED_LAYERS,
                       cases=tuple((d, w, True) for d in dtypes
                                   for w in windows))


def family_kernel_rows(torch, groups=FAMILY_GROUPS, gemma=GEMMA_CASES):
    """The other families' attention instances against their plain
    versions: each kernel at the query-head groups ``groups`` gives it
    (``GROUP_SHAPES``), paged attention at Dh 256 (``gemma``: (shape,
    windows) pairs), the B8 case, bf16 and fp32 and e4m3 pools (bf16 q),
    at the quick timing; flash-decode and fw at ``ROWS16_GROUPS`` (their
    16-row instances) over bf16, e4m3 and e5m2 pools at the main timing;
    rows by ``<kernel>.g<G>``, ``<kernel>.rows16.g<G>`` and
    ``paged_attention.dh256`` (scripts/paged_times.py --sweep passes every
    group and window)."""
    results = {}
    b8 = FD_CASES[:1]
    checks = {"flash_decode": (check_flash_decode, dict(cases=b8)),
              "flash_decode_fw": (check_flash_decode_fw, dict(cases=b8)),
              "paged_attention": (family_paged, {}),
              "ragged_attention": (check_ragged, {})}
    for name, gs in groups.items():
        check, kw = checks[name]
        for g in gs:
            shape = GROUP_SHAPES[g]
            results[f"{name}.g{g}"] = (
                check(torch, shape=shape, quick=True, **kw)
                + check(torch, FP8, shape=shape, dtypes=("bfloat16",),
                        quick=True, **kw))
            torch.cuda.empty_cache()
    for name in ("flash_decode", "flash_decode_fw"):
        check, kw = checks[name]
        for g in ROWS16_GROUPS:
            results[f"{name}.rows16.g{g}"] = [
                row for kv in (None, FP8, E5M2) for row in check(
                    torch, kv, shape=GROUP_SHAPES[g], dtypes=("bfloat16",),
                    **kw)]
            torch.cuda.empty_cache()
    results["paged_attention.dh256"] = [
        row for shape, windows in gemma for row in (
            family_paged(torch, shape=shape, windows=windows)
            + family_paged(torch, FP8, shape=shape, dtypes=("bfloat16",),
                           windows=windows))]
    torch.cuda.empty_cache()
    return results


def note_fp8_against_bf16(results) -> None:
    """Beside each e4m3- or e5m2-pool row, the bf16-pool instance's time at
    the same case and q dtype from the same run (the ``.fp8`` and ``.e5m2``
    lists' twins are in the list without the suffix, the families' in
    their own list), and the ratio."""
    for name, rows in results.items():
        base = rows
        for suffix, _, _ in KV8.values():
            if f".{suffix}" in name:
                base = results.get(name.replace(f".{suffix}", ""), [])
        for r in rows:
            tag = [t for _, t, _ in KV8.values() if t in r["shape"]]
            if not tag:
                continue
            shape = r["shape"].replace(tag[0], "")
            twin = [b for b in base if b["shape"] == shape
                    and b["dtype"] == r["dtype"]]
            if twin:
                t = twin[0]["ms"]
                r["bf16_ms"] = t
                r["note"] = (r.get("note", "") + f"; bf16 pools {t:.4f} ms,"
                             f" {tag[0].split()[0]}/bf16 "
                             f"{r['ms'] / t:.3f}").lstrip("; ")


def phase_kernels(torch, card: str):
    results = {
        "flash_decode": check_flash_decode(torch),
        "norm_matmul": check_gemv(torch, "norm_matmul"),
        "matmul_residual": check_gemv(torch, "matmul_residual"),
        "ragged_attention": check_ragged(torch),
        "flash_decode_fw": check_flash_decode_fw(torch),
        "int4_matmul": check_int4(torch),
        "paged_attention": check_paged(torch),
        # the e4m3-pool instances (A5f) at the same shapes
        "flash_decode.fp8": check_flash_decode(torch, FP8),
        "flash_decode_fw.fp8": check_flash_decode_fw(torch, FP8),
        "ragged_attention.fp8": check_ragged(torch, FP8),
        "paged_attention.fp8": check_paged(torch, FP8),
        # the e5m2-pool instances (A5f-e5m2) at the same shapes
        "flash_decode.e5m2": check_flash_decode(torch, E5M2),
        "flash_decode_fw.e5m2": check_flash_decode_fw(torch, E5M2),
        "ragged_attention.e5m2": check_ragged(torch, E5M2),
        "paged_attention.e5m2": check_paged(torch, E5M2),
        # Mixtral-8x7B's expert products (A9)
        "int4_matmul.moe": check_int4(torch, MOE_INT4_CASES),
        # the async verify step's lattice and the speculative verify
        # window's rows (A12)
        "ragged_attention.verify": check_ragged(torch, lattice=VERIFY_ROWS),
        "int4_matmul.verify": check_int4(torch, INT4_VERIFY_CASES),
    }
    # 128 slots: the regime where the pools' bytes dominate a layer
    results["flash_decode.b128"] = check_flash_decode(
        torch, cases=FD_B128, dtypes=("bfloat16",))
    torch.cuda.empty_cache()
    results["flash_decode.fp8.b128"] = check_flash_decode(
        torch, FP8, cases=FD_B128, dtypes=("bfloat16",))
    torch.cuda.empty_cache()
    results.update(family_kernel_rows(torch))
    note_fp8_against_bf16(results)
    bad = []
    for name, rows in results.items():
        for r in rows:
            atol, rtol = r.get("tol", TOL[r["dtype"]])
            held = f"(tol atol={atol} rtol={rtol})"
            rel = (f" row max_rel_err={r['row_rel']:.3e} (tol "
                   f"{ROW_REL_TOL[r['dtype']]})" if "row_rel" in r else "")
            if "stats_rel" in r:
                rel += (f" m,l max_rel_err={r['stats_rel']:.3e} (tol "
                        f"{STATS_TOL})")
            if "col_rel" in r:
                held = "(not held: the column errors are)"
                rel = (f" column max_rel_err={r['col_rel']:.3e} of max|ref| "
                       f"(held from 8 rows), {r['col_rel_mag']:.3e} of max "
                       f"sum|x w| s (tol {COL_REL_TOL[r['dtype']]})")
            log(f"[kernels] {name:16s} {r['dtype']:8s} {r['shape']:34s} "
                f"max_abs_err={r['err']:.3e} {held}"
                f"{rel} {'ok' if r['ok'] else 'FAIL'} | kernel "
                f"{r['ms']:.4f} ms"
                f"{' (' + r['route'] + ')' if 'route' in r else ''}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, library "
                + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                   else "none (no one call takes fp8 K/V)")
                + f"{' (' + r['note'] + ')' if 'note' in r else ''} [{card}]")
            if not r["ok"]:
                bad.append(f"{name} {r['dtype']} {r['shape']}")
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    log(f"kernels: {list(results)}")
    return results


# ------------------------------------------------------------- phases 3/4


def serve_prompts(seed: int = 7):
    import numpy as np

    rs = np.random.RandomState(seed)
    vocab = 128256
    shared = rs.randint(1, vocab, size=256).tolist()
    prompts = [rs.randint(1, vocab, size=n).tolist()
               for n in (16, 40, 100, 200, 350, 600)]
    prompts += [shared + rs.randint(1, vocab, size=20).tolist(),
                shared + rs.randint(1, vocab, size=50).tolist()]
    return prompts


def check_results(results, prompts, label: str, vocab: int = 128256
                  ) -> None:
    assert len(results) == len(prompts), f"{label}: {len(results)} results"
    for i, r in enumerate(results):
        assert len(r.tokens) == 32, f"{label}: request {i} has " \
            f"{len(r.tokens)} tokens"
        assert r.finish_reason == "length", \
            f"{label}: request {i} finished {r.finish_reason!r}"
        assert all(0 <= t < vocab for t in r.tokens), f"{label}: token id"


def mixed_prompts(seed: int = 11):
    """Wave 1: 8 prompts of 16-900 tokens (the four over 256 prefill in
    chunks). Wave 2: the first 256 tokens of the 520-token prompt plus a
    400-token tail (a prefix hit resuming chunked at 256), and a 40-token
    prompt that decodes while it prefills."""
    import numpy as np

    rs = np.random.RandomState(seed)
    vocab = 128256
    wave1 = [rs.randint(1, vocab, size=n).tolist()
             for n in (16, 40, 100, 200, 300, 520, 700, 900)]
    wave2 = [wave1[5][:256] + rs.randint(1, vocab, size=400).tolist(),
             rs.randint(1, vocab, size=40).tolist()]
    return wave1, wave2


def start_worker(model):
    """The worker CLI on a free port, preloading ``model`` (None: none)."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.cli.worker", "--worker-id", "smoke",
         "--host", "127.0.0.1", "--port", "0",
         *(["--model", model] if model else []), "--log-level", "WARNING"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 500
    lines = []
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                break
            continue
        lines.append(line.rstrip())
        log(f"[worker] {line.rstrip()}")
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        if m:
            # keep draining the pipe so the worker never blocks on a write
            threading.Thread(target=lambda: [
                log(f"[worker] {x.rstrip()}") for x in proc.stdout],
                daemon=True).start()
            return proc, m.group(1), int(m.group(2)), lines
    proc.kill()
    raise RuntimeError("worker did not come up:\n" + "\n".join(lines))


# engine counters the worker phases read as differences over their waves
# (the load-time warmup ran the same engine first)
WAVE_COUNTERS = ("decode_steps", "mixed_steps", "mixed_prefill_tokens",
                 "prefill_calls", "chunked_admissions",
                 "prefix_hit_admissions", "engine_steps",
                 "deferred_admissions", "total_requests")


def wave_delta(before, after):
    """``after``'s engine metrics with ``WAVE_COUNTERS`` and the decode
    chunk's seconds and count as differences from ``before``."""
    eng = dict(after)
    for k in WAVE_COUNTERS:
        eng[k] = after[k] - before[k]
    eng["decode_chunk"] = {
        k: after["decode_chunk"][k] - before["decode_chunk"][k]
        for k in ("sum_s", "count")}
    return eng


def check_worker_trace(r, label: str) -> None:
    """A result's ``worker_trace``: this worker's offsets, ordered."""
    wt = r.metadata.get("worker_trace")
    assert wt and wt["worker_id"] == "smoke", (label, r.metadata)
    o = wt["offsets"]
    assert 0.0 == o["received"] <= o["first_token"] <= o["done"], (label, o)


async def serve_waves(client, waves, name: str, stream_prompt=None,
                      batched: bool = False):
    """Each wave's requests concurrently through the port's
    ``WorkerClient`` to model ``name``, a wave after the previous one
    returned: one ``generate`` each, or with ``batched`` one ``generate``
    carrying the whole wave, which the worker's pump admits at once (the
    same admission rounds in every run, so runs on equal weights emit
    equal tokens: the ``[ckpt]`` phase compares them). The worker's
    kernel launch counts are zeroed just before the first wave and read
    just after the last, its engine metrics read at both points (the
    load-time warmup ran before). ``stream_prompt``: then one request
    through ``generate_stream`` and the same prompt through ``generate``.
    Fails if a CUDA graph is captured after the warmup, or a result lacks
    its ordered ``worker_trace``."""
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)

    await client.kernel_counts(reset=True)       # main path starts here
    before = (await client.metrics())["models"][name]
    results, wall = [], 0.0
    for w, prompts in enumerate(waves):
        reqs = [GenerationRequest(prompt=p, max_new_tokens=32,
                                  request_id=f"w{w}_{i}")
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        if batched:
            outs = [await client.generate(name, reqs)]
        else:
            outs = await asyncio.gather(*[client.generate(name, [r])
                                          for r in reqs])
        wall += time.perf_counter() - t0
        results.append([r for o in outs for r in o])
    launches = await client.kernel_counts()      # ... and ends here
    for r in (r for rs in results for r in rs):
        check_worker_trace(r, name)
    after = (await client.metrics())["models"][name]
    for k in ("cuda_graphs", "decode_programs", "mixed_programs"):
        assert after[k] == before[k], (
            f"{name}: {k} grew during the waves: {before[k]} after "
            f"the warmup, {after[k]} after the waves")
    assert before["cuda_graphs"] >= 1, before["cuda_graphs"]
    stream = None
    if stream_prompt is not None:
        frames = []
        res = await client.generate_stream(name, GenerationRequest(
            prompt=stream_prompt, max_new_tokens=32,
            request_id="stream"), frames.append)
        plain = (await client.generate(name, [GenerationRequest(
            prompt=stream_prompt, max_new_tokens=32,
            request_id="plain")]))[0]
        joined = [t for f in frames for t in f]
        assert joined == res.tokens, "stream frames != its result"
        assert res.tokens == plain.tokens and len(plain.tokens) == 32, \
            "streamed tokens != generate's"
        last = (await client.metrics())["models"][name]
        assert last["cuda_graphs"] == before["cuda_graphs"], last
        check_worker_trace(res, f"{name} stream")
        stream = dict(frames=len(frames), tokens=len(joined),
                      ttft=res.ttft_s, result=res.tokens)
    return dict(results=results, wall=wall, launches=launches,
                eng=wave_delta(before, after), warm=before, stream=stream)


async def drive_worker(host, port, waves, name: str, stream_prompt=None,
                       probe_prompt=None, then=(), batched: bool = False,
                       after=None):
    """``serve_waves`` (``batched``: a wave one RPC) on the worker CLI
    preloaded with model ``name``,
    then (``probe_prompt``) that prompt's 8 greedy tokens; then for each
    model of ``then`` in turn (a model string, or a (model, waves) pair),
    the model before it unloaded, the model loaded over ``load_model``
    (its load-time warm-up included) and the same waves (or its own)
    served (their outputs in ``out["then"]``); then ``after(client,
    last)`` (``last``: the resident model's name; its result in
    ``out["after"]``); then the worker's shutdown."""
    from distributed_inference_engine_tpu_torch.cli.worker import (
        parse_model_arg)
    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerClient)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)

    client = WorkerClient(host, port, timeout=900.0)
    try:
        pong = await client.ping()
        assert pong["models"] == [name], pong
        out = await serve_waves(client, waves, name, stream_prompt,
                                batched=batched)
        if probe_prompt is not None:
            (r,) = await client.generate(name, [GenerationRequest(
                prompt=list(probe_prompt), max_new_tokens=8,
                request_id="probe")])
            out["probe"] = list(r.tokens)
        out["then"] = []
        last = name
        for model in then:
            model, its_waves = (model if isinstance(model, tuple)
                                else (model, waves))
            cfg = parse_model_arg(model)
            assert await client.unload_model(last) is True, last
            receipt = await client.load_model(cfg, timeout=900.0)
            last = cfg.name
            nxt = await serve_waves(client, its_waves, last)
            rounds, secs = (await client.metrics())["model_warmup"][last]
            nxt["warmed"] = (f"warmed model {last}: {rounds} rounds in "
                             f"{secs:.2f}s (load_s {receipt['load_s']:.2f})")
            out["then"].append(nxt)
        if after is not None:
            out["after"] = await after(client, last)
        await client.shutdown()
    finally:
        await client.close()
    return out


def free_this_process(torch) -> None:
    """Give this process's cached device memory back before a worker
    starts."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[worker] starting with {free / 2**30:.1f} of {total / 2**30:.1f} "
        f"GiB free; this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def run_worker(model: str, waves, stream_prompt=None, probe_prompt=None,
               then=(), batched: bool = False, after=None):
    """Start the worker CLI with ``model`` (metadata ``warmup=1``: its
    engine runs the serving programs at load), drive ``waves`` through it
    (and through each model of ``then`` in turn, loaded over RPC into the
    same process, and ``after``: ``drive_worker``), and wait for it to
    exit; also returns
    the warmup's line. This process's cached device memory is freed
    first."""
    import torch

    free_this_process(torch)
    name = re.search(r"name=([^,]+)", model).group(1)
    proc, host, port, lines = start_worker(model)
    try:
        out = asyncio.run(drive_worker(host, port, waves, name,
                                       stream_prompt, probe_prompt, then,
                                       batched, after))
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    warmed = [x for x in lines if x.startswith("warmed model")]
    assert warmed, f"{name}: no load-time warmup line"
    out["warmed"] = warmed[0]
    return out


def decode_ms_per_step(eng, launches, n_layers: int = N_LAYERS) -> float:
    """Decode chunk wall per decode step of an engine whose every chunk
    is pure decode (flash-decode launches once per layer per step)."""
    steps = launches.get("flash_decode", 0) // n_layers
    return 1e3 * eng["decode_chunk"]["sum_s"] / max(1, steps)


def graphs_line(out) -> str:
    """A worker engine's load-time warmup and the CUDA graphs it captured
    (``run_worker`` holds the waves to capturing none)."""
    eng = out["warm"]
    assert eng["cuda_graphs"] >= 1, eng["cuda_graphs"]
    warm = sum(w for w, _ in eng["graph_capture_s"].values())
    cap = sum(c for _, c in eng["graph_capture_s"].values())
    return (f"load-time {out['warmed']}: {eng['cuda_graphs']} CUDA graphs "
            f"({eng['decode_programs']} decode keys, "
            f"{eng['mixed_programs']} mixed buckets; "
            f"{', '.join(_key_short(k) for k in eng['graph_capture_s'])}),"
            f" warm-up {warm:.2f} s + capture {cap:.2f} s; none captured "
            f"during the waves")


def _key_short(key: str) -> str:
    return " ".join(x for x in key.split() if not x.endswith("=0"))


def served_line(results, wall: float) -> str:
    gen = sum(len(r.tokens) for r in results)
    ttfts = sorted(r.ttft_s for r in results)
    return (f"{len(results)} requests, {gen} tokens in {wall:.3f} s = "
            f"{gen / wall:.1f} tok/s; TTFT p50 {ttfts[len(ttfts) // 2]:.3f} s"
            f" max {ttfts[-1]:.3f} s")


def report_serve(out, prompts, card: str):
    """The ``serve`` checks and lines over ``serve_waves``'s output."""
    results, wall, launches, eng = (out["results"][0], out["wall"],
                                    out["launches"], out["eng"])
    check_results(results, prompts, "serve")
    assert launches.get("flash_decode", 0) > 0, \
        f"serve: flash_decode never launched: {launches}"
    assert launches["flash_decode"] == N_LAYERS * eng["decode_steps"], \
        (launches, eng["decode_steps"])
    log(f"[serve] {graphs_line(out)} [{card}]")
    log(f"[serve] {served_line(results, wall)}; prefix-hit admissions "
        f"{eng['prefix_hit_admissions']}; deferred admissions "
        f"{eng['deferred_admissions']}; decode "
        f"{decode_ms_per_step(eng, launches):.2f} ms/step; launches "
        f"{launches} [{card}]")
    st = out["stream"]
    log(f"[serve] generate_stream: {st['tokens']} tokens in {st['frames']} "
        f"frames, joined equal to its result and to generate's greedy "
        f"tokens for the same prompt; TTFT {st['ttft']:.3f} s [{card}]")
    return results, launches


# the fleet phase's second model: INT4_MODEL's weights under their own name
INT4_FLEET_NAME = "llama3-8b-int4"
# a worker's device memory after unloading everything, against before the
# first load
UNLOAD_SLACK_GIB = 2.0


def _smi_apps():
    """``nvidia-smi``'s device memory of each listed process, GiB by pid."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True, timeout=30).stdout
    rows = [x.split(",") for x in out.strip().splitlines() if "," in x]
    return {int(p): float(m) / 1024 for p, m in rows if p.strip().isdigit()}


def _smi_card() -> float:
    """The card's used memory, GiB."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True, timeout=30).stdout
    return float(out.strip().splitlines()[0]) / 1024


class WorkerMemory:
    """A worker's device memory in GiB, for the unload checks: its pid's
    ``used_memory`` where ``nvidia-smi`` lists that pid, else (another
    PID namespace) the card's used memory less this process's change in
    reserved memory since the reader was made: the card's reading holds
    this process too, whose CUDA context stays put. Each reading notes
    this process's ``torch.cuda.memory_reserved()`` and the worker's own
    caching allocator (``metrics()["device_memory"]``) beside it, so an
    excess can be told apart (``note``)."""

    def __init__(self, torch, pid: int, client) -> None:
        self.torch, self.pid, self.client = torch, pid, client
        self.own0 = torch.cuda.memory_reserved()
        self.by_pid = pid in _smi_apps()
        self.source = (f"pid {pid}" if self.by_pid else
                       "the card less this process's change in reserve")
        self.note = ""

    async def read(self) -> float:
        own = self.torch.cuda.memory_reserved()
        dev = (await self.client.metrics()).get("device_memory", {})
        gib = (_smi_apps()[self.pid] if self.by_pid
               else _smi_card() - (own - self.own0) / 2**30)
        self.note = (
            f"this process reserves {own / 2**30:.2f} GiB "
            f"({(own - self.own0) / 2**30:+.2f}); the worker's allocator "
            f"{dev.get('allocated_bytes', 0) / 2**30:.2f} GiB allocated, "
            f"{dev.get('reserved_bytes', 0) / 2**30:.2f} reserved")
        return gib


def families(text: str) -> set:
    """Metric family names with a sample in an OpenMetrics exposition."""
    names = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            names.add(("decl", line.split()[2]))
        elif line and not line.startswith("#"):
            names.add(("sample", line.split("{", 1)[0].split(" ", 1)[0]))
    decl = {n for k, n in names if k == "decl"}
    out = set()
    for k, n in names:
        if k != "sample":
            continue
        for sfx in ("_total", "_bucket", "_count", "_sum", ""):
            if n.endswith(sfx) and n[: len(n) - len(sfx)] in decl:
                out.add(n[: len(n) - len(sfx)])
                break
    return out


async def http_get(host: str, port: int, path: str):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    chunks = []
    while True:
        b = await asyncio.wait_for(reader.read(1 << 20), timeout=60)
        if not b:
            break
        chunks.append(b)
    writer.close()
    head, _, body = b"".join(chunks).partition(b"\r\n\r\n")
    return head.decode("latin-1"), body.decode()


def traced_kernels(path: str):
    """A Chrome trace's kernel events by name, and the counts of the
    ragged tensor-core, int4 and flash-decode kernels among them; fails
    unless the ragged and an int4 kernel are there."""
    with open(path) as f:
        trace = json.load(f)
    kernels = collections.Counter(
        e.get("name", "") for e in trace.get("traceEvents", [])
        if e.get("cat") == "kernel")
    named = {k: sum(n for name, n in kernels.items() if k in name)
             for k in ("ragged_mma_kernel", "int4_wgmma_kernel",
                       "int4_gemv_mma_kernel", "flash_decode_kernel")}
    assert named["ragged_mma_kernel"] > 0 and \
        named["int4_wgmma_kernel"] + named["int4_gemv_mma_kernel"] > 0, \
        (named, kernels.most_common(12))
    return kernels, named


def _tok_s(results, wall: float) -> float:
    return sum(len(r.tokens) for r in results) / wall


async def drive_fleet(host, port, pid: int, prompts, probe, card: str):
    """The ``fleet`` phase's steps on a worker started with no model (see
    ``phase_fleet``)."""
    import torch

    from distributed_inference_engine_tpu_torch.cli.worker import (
        parse_model_arg)
    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerClient)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)
    from distributed_inference_engine_tpu_torch.utils.rpc import RPCError

    serve_cfg = parse_model_arg(SERVE_MODEL)
    int4_cfg = parse_model_arg(INT4_MODEL)
    int4_cfg.name = INT4_FLEET_NAME
    serve, int4 = serve_cfg.name, int4_cfg.name
    client = WorkerClient(host, port, timeout=900.0)
    res: dict = {}

    async def wave(name, ps, tag, max_new=32):
        t0 = time.perf_counter()
        outs = await asyncio.gather(*[client.generate(name, [
            GenerationRequest(prompt=p, max_new_tokens=max_new,
                              request_id=f"{tag}_{i}")])
            for i, p in enumerate(ps)])
        wall = time.perf_counter() - t0
        return [o[0] for o in outs], wall

    try:
        pong = await client.ping()
        assert pong["models"] == [] and pong["draining"] is False, pong
        mem = WorkerMemory(torch, pid, client)
        mem0 = await mem.read()
        note0 = mem.note
        # 1. deploy serve over load_model; the same config again: at once
        t0 = time.perf_counter()
        receipt = await client.load_model(serve_cfg, timeout=900.0)
        load_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = await client.load_model(serve_cfg)
        again_s = time.perf_counter() - t0
        assert again == receipt and again_s < 1.0, (again, again_s)
        mem_serve = await mem.read()
        m = await client.metrics()
        rounds, secs = m["model_warmup"][serve]
        log(f"[fleet] load_model {serve}: load_s {receipt['load_s']:.2f} "
            f"(RPC wall {load_wall:.2f} s; warm-up {rounds} rounds in "
            f"{secs:.2f} s); the same config again returned in "
            f"{again_s * 1e3:.1f} ms with the same receipt; worker memory "
            f"({mem.source}) {mem0:.2f} GiB before ({note0}), "
            f"{mem_serve:.2f} GiB after ({mem.note}) [{card}]")
        # 2. the serve phase's wave and stream, in this worker
        mono_serve = (await client.ping())["mono"]
        out = await serve_waves(client, [prompts], serve,
                                stream_prompt=prompts[0])
        out["warmed"] = (f"warmed model {serve}: {rounds} rounds in "
                         f"{secs:.2f}s")
        res["serve"] = out
        res["serve_results"], res["serve_launches"] = report_serve(
            out, prompts, card)
        base_tok_s = _tok_s(out["results"][0], out["wall"])
        # 3-4. stage int4 while serve waves run, then swap it in, gated on
        # the int4 worker's probe tokens
        staged = await client.stage_model(int4_cfg)
        assert staged == {"staging": int4, "already_resident": False}, \
            staged
        t_stage = time.perf_counter()
        swap = asyncio.ensure_future(client.swap_model(int4, probe=probe,
                                                       timeout=900.0))
        during = []
        while not swap.done():
            ps = serve_prompts(100 + len(during))
            rs, wall = await wave(serve, ps, f"stage{len(during)}")
            check_results(rs, ps, f"serve wave {len(during)} while staging")
            during.append(_tok_s(rs, wall))
        swap_receipt = await swap
        staged_s = time.perf_counter() - t_stage
        ps = serve_prompts(99)
        rs, wall = await wave(serve, ps, "after")
        check_results(rs, ps, "serve wave after the swap")
        after_tok_s = _tok_s(rs, wall)
        assert swap_receipt["swapped"] == int4 and \
            not swap_receipt["already_resident"], swap_receipt
        assert swap_receipt["evicted"] == [], swap_receipt
        assert swap_receipt["overlap_steps"] > 0, swap_receipt
        m = await client.metrics()
        assert m["stage_overlap_steps"] == swap_receipt["overlap_steps"]
        during_sorted = sorted(during)
        log(f"[fleet] serve tok/s: {base_tok_s:.1f} before staging; "
            f"{len(during)} waves while {int4} staged and swapped in "
            f"({staged_s:.1f} s): min {during_sorted[0]:.1f}, median "
            f"{during_sorted[len(during) // 2]:.1f}, max "
            f"{during_sorted[-1]:.1f} ({', '.join(f'{x:.1f}' for x in during)}"
            f"); {after_tok_s:.1f} after [{card}]")
        log(f"[fleet] swap_model {int4}: probe of {len(probe)} tokens "
            f"accepted; stage_s {swap_receipt['stage_s']:.2f}, swap_s "
            f"{swap_receipt['swap_s']:.2f}, stage_overlap_steps "
            f"{swap_receipt['overlap_steps']}, evicted none; warm-up "
            f"{m['model_warmup'][int4][0]} rounds in "
            f"{m['model_warmup'][int4][1]:.2f} s [{card}]")
        # the int4 phase's waves through the swapped-in model
        wave1, wave2 = mixed_prompts()
        mono_int4 = (await client.ping())["mono"]
        iout = await serve_waves(client, [wave1, wave2], int4)
        iout["warmed"] = (f"warmed model {int4}: "
                          f"{m['model_warmup'][int4][0]} rounds in "
                          f"{m['model_warmup'][int4][1]:.2f}s")
        report_int4_run(iout, wave1, wave2, card, "fleet int4")
        # 5. residency
        resident = await client.resident_models()
        m = await client.metrics()
        pbytes = {n: m["models"][n]["param_bytes"] for n in (serve, int4)}
        assert resident["resident"] == sorted((serve, int4)), resident
        assert resident["staged"] == [], resident
        assert resident["resident_bytes"] == sum(pbytes.values()), \
            (resident, pbytes)
        mem_both = await mem.read()
        log(f"[fleet] resident_models: {resident['resident']}, "
            f"resident_bytes {resident['resident_bytes']} = param_bytes "
            f"{pbytes}; worker memory {mem_both:.2f} GiB ({mem.note}) "
            f"[{card}]")
        # 6. profile one int4 wave of fresh prompts (the waves above left
        # theirs in the prefix cache: they would skip the mixed steps)
        trace_dir = tempfile.mkdtemp(prefix="fleet-trace-")
        fresh = mixed_prompts(12)[0]
        await client.profile("start", trace_dir=trace_dir)
        rs, wall = await wave(int4, fresh, "prof")
        check_results(rs, fresh, "profiled int4 wave")
        t0 = time.perf_counter()
        stop = await client.profile("stop")
        stop_s = time.perf_counter() - t0
        kernels, named = traced_kernels(stop["trace_file"])
        window = stop["timelines"].get(int4, [])
        log(f"[fleet] profile: one int4 wave ({_tok_s(rs, wall):.1f} tok/s "
            f"under the profiler); Chrome trace "
            f"{os.path.getsize(stop['trace_file']) / 2**20:.1f} MiB, "
            f"{sum(kernels.values())} kernel events, by name {named}; "
            f"{len(window)} step-timeline records of {int4} in the window; "
            f"stop took {stop_s:.2f} s [{card}]")
        shutil.rmtree(trace_dir, ignore_errors=True)
        # 7. metrics_text over RPC and plain GET /metrics
        await client.metrics_text()      # its self-timing shows next time
        text = await client.metrics_text()
        head, body = await http_get(host, port, "/metrics")
        assert head.startswith("HTTP/1.1 200") and \
            "openmetrics-text" in head, head
        assert text.rstrip().endswith("# EOF") and \
            body.rstrip().endswith("# EOF")
        fam_rpc, fam_http = families(text), families(body)
        assert fam_rpc == fam_http and len(fam_rpc) > 40, \
            (fam_rpc ^ fam_http, len(fam_rpc))
        log(f"[fleet] metrics_text and GET /metrics: {len(fam_rpc)} "
            f"families with samples, the same names [{card}]")
        # 8. events: the ring and one timeline a model, whose compile
        # marks are the load-time warm-ups' captures
        ev = await client.events()
        types = [e["type"] for e in ev["ring"]["events"]]
        assert "model.stage" in types and "model.swap" in types, types
        assert set(ev["timelines"]) == {serve, int4}, set(ev["timelines"])
        m = await client.metrics()
        for name, mono in ((serve, mono_serve), (int4, mono_int4)):
            recs = ev["timelines"][name]
            comp = [r for r in recs if r["args"].get("compile")]
            graphs = m["models"][name]["cuda_graphs"]
            assert len(comp) == graphs, (name, len(comp), graphs)
            assert all(r["t"] < mono for r in comp), name
            log(f"[fleet] events: {name}'s timeline holds {len(recs)} "
                f"records, {len(comp)} marked compile = its {graphs} "
                f"CUDA graphs, all from the load-time warm-up [{card}]")
        log(f"[fleet] events: ring of {len(types)} "
            f"({dict(collections.Counter(types))}), dropped "
            f"{ev['ring']['dropped']} [{card}]")
        # 10. unload both; memory back; reload serve and serve again (before
        # the drain, which leaves the worker refusing new work)
        assert await client.unload_model(int4) is True
        assert await client.unload_model(serve) is True
        assert await client.unload_model(serve) is False
        assert (await client.ping())["models"] == []
        mem_unloaded = await mem.read()
        note_unloaded = mem.note
        log(f"[fleet] unloaded both: worker memory {mem_unloaded:.2f} GiB "
            f"({note_unloaded}) [{card}]")
        assert mem_unloaded - mem0 <= UNLOAD_SLACK_GIB, \
            (mem0, note0, mem_unloaded, note_unloaded)
        t0 = time.perf_counter()
        receipt2 = await client.load_model(serve_cfg, timeout=900.0)
        reload_wall = time.perf_counter() - t0
        mem_reload = await mem.read()
        (one,) = await client.generate(serve, [GenerationRequest(
            prompt=prompts[0], max_new_tokens=32, request_id="reload")])
        assert one.tokens == out["stream"]["result"], \
            "the reloaded model's greedy tokens differ"
        log(f"[fleet] unload_model both: worker memory {mem_unloaded:.2f} "
            f"GiB ({mem_unloaded - mem0:+.2f} against {mem0:.2f} before the "
            f"first load; both loaded {mem_both:.2f}); reload load_s "
            f"{receipt2['load_s']:.2f} (wall {reload_wall:.2f} s), memory "
            f"{mem_reload:.2f} GiB; its greedy tokens equal the first "
            f"load's [{card}]")
        # 9. drain with two requests in flight
        busy = [asyncio.ensure_future(client.generate(serve, [
            GenerationRequest(prompt=prompts[i], max_new_tokens=32,
                              request_id=f"drain{i}")])) for i in (1, 2)]
        for _ in range(1000):
            m = await client.metrics()
            if m["pumps"][serve]["in_flight"]:
                break
            await asyncio.sleep(0.01)
        t0 = time.perf_counter()
        summary = await client.drain(timeout_s=300.0)
        drain_s = time.perf_counter() - t0
        finished = [(await f)[0] for f in busy]
        check_results(finished, [prompts[1], prompts[2]], "drained")
        assert summary["drained"] and summary["in_flight"] == 0, summary
        try:
            await client.generate(serve, [GenerationRequest(
                prompt=prompts[3], max_new_tokens=4)])
            raise AssertionError("a generate after the drain was served")
        except RPCError as e:
            assert (e.kind, e.detail) == ("overloaded", "draining"), e
        assert (await client.ping())["draining"] is True
        log(f"[fleet] drain: the 2 requests in flight finished (32 tokens "
            f"each), drained in {drain_s:.2f} s; a later generate got the "
            f"overloaded/draining shed [{card}]")
        await client.shutdown()
    finally:
        await client.close()
    return res


def phase_fleet(torch, card: str, probe):
    """The worker CLI started with no model and driven through the port's
    ``WorkerClient``: deploy ``serve`` over ``load_model`` (and again: at
    once); the ``serve`` phase's wave and stream; stage the ``int4`` model
    while ``serve`` waves run, swap it in gated on ``probe`` (the int4
    worker's greedy tokens of the golden prompt); the ``int4`` waves;
    ``resident_models``; a ``profile`` of one int4 wave naming the ragged
    and int4 kernels; ``metrics_text`` over RPC and ``GET /metrics``;
    ``events``; unload both (memory back within ``UNLOAD_SLACK_GIB``),
    reload ``serve`` and serve; ``drain`` with two requests in flight."""
    prompts = serve_prompts()
    free_this_process(torch)
    proc, host, port, _lines = start_worker(None)
    try:
        res = asyncio.run(drive_fleet(host, port, proc.pid, prompts, probe,
                                      card))
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return prompts, res["serve_results"], res["serve_launches"]


def phase_mixed(torch, card: str):
    """The slice's path: chunked prefill in the ragged mixed step, through
    the worker CLI at full width."""
    wave1, wave2 = mixed_prompts()
    # a wave one RPC: the [ckpt] phase's bf16 load must emit these tokens
    out = run_worker(MIXED_MODEL, [wave1, wave2], batched=True)
    results, wall, launches, eng = (out["results"], out["wall"],
                                    out["launches"], out["eng"])
    check_results(results[0], wave1, "mixed wave 1")
    check_results(results[1], wave2, "mixed wave 2")
    for k in ("ragged_attention", "flash_decode"):
        assert launches.get(k, 0) > 0, f"mixed: {k} never launched: " \
            f"{launches}"
    assert eng["mixed_steps"] > 0 and eng["chunked_admissions"] > 0, eng
    assert eng["prefix_hit_admissions"] >= 1, eng
    # one ragged launch per layer per mixed step, all on the tensor cores
    assert launches["ragged_attention"] == 32 * eng["mixed_steps"], \
        (launches, eng["mixed_steps"])
    assert launches.get("ragged_attention.mma") == \
        launches["ragged_attention"], launches
    log(f"[mixed] {graphs_line(out)} [{card}]")
    log(f"[mixed] {served_line(results[0] + results[1], wall)}; mixed steps "
        f"{eng['mixed_steps']} carrying {eng['mixed_prefill_tokens']} "
        f"prefill tokens; chunked admissions {eng['chunked_admissions']}; "
        f"prefix-hit admissions {eng['prefix_hit_admissions']}; deferred "
        f"admissions {eng['deferred_admissions']}; engine steps "
        f"{eng['engine_steps']}; pools {eng['kv']['hbm_bytes'] / 2**30:.2f}"
        f" GiB; launches {launches} [{card}]")
    return wave1, launches, out


# the [ckpt] phase's checkpoint: MIXED_MODEL's seed-0 bf16 tree at full
# width and depth in HF Llama naming, sharded as HF ships Llama-3-8B
# (files of at most 5 GB, an index, config.json); written, with the int4
# serving artifact, under the checkout's _work/ and removed at the end
CKPT_SHARD_BYTES = 5 * 10**9
# HF Llama naming of the block weights (nn.Linear stores [out, in])
HF_LLAMA_BLOCKS = (("ln1_scale", "input_layernorm"),
                   ("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                   ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                   ("ln2_scale", "post_attention_layernorm"),
                   ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                   ("w_down", "mlp.down_proj"))


# HF Mixtral naming of the MoE weights: the router, and each expert's w1
# (gate), w2 (down) and w3 (up)
HF_MIXTRAL_EXPERTS = (("w_gate", "w1"), ("w_down", "w2"), ("w_up", "w3"))


def hf_llama_tensors(params, spec):
    """``(HF name, tensor)`` of a Llama tree in HF's order (a Mixtral
    tree's MLP in its ``block_sparse_moe`` naming): each weight a
    transposed view (no copy) of the port's ``[in, out]`` slice."""
    yield "model.embed_tokens.weight", params["tok_emb"]
    blocks = params["blocks"]
    for layer in range(spec.n_layers):
        pre = f"model.layers.{layer}."
        for ours, theirs in HF_LLAMA_BLOCKS:
            if spec.n_experts and theirs.startswith("mlp."):
                continue
            t = blocks[ours][layer]
            yield f"{pre}{theirs}.weight", t.t() if t.dim() == 2 else t
        if spec.n_experts:
            yield (f"{pre}block_sparse_moe.gate.weight",
                   blocks["w_router"][layer].t())
            for e in range(spec.n_experts):
                for ours, theirs in HF_MIXTRAL_EXPERTS:
                    yield (f"{pre}block_sparse_moe.experts.{e}.{theirs}."
                           "weight", blocks[ours][layer][e].t())
    yield "model.norm.weight", params["lnf_scale"]
    yield "lm_head.weight", params["lm_head"].t()


def write_hf_checkpoint(torch, path: Path, spec, seed: int = 0):
    """The engine's seed-``seed`` tree of ``spec`` (``init_params`` on the
    card, as the engine draws it) written to ``path`` in HF Llama naming
    (Mixtral's for a spec with experts), sharded at ``CKPT_SHARD_BYTES``,
    with ``model.safetensors.index.json`` and ``config.json``; each tensor
    reaches the host alone. Returns the files, bytes and seconds."""
    from distributed_inference_engine_tpu_torch.models.base import (
        init_params)
    from distributed_inference_engine_tpu_torch.utils.safetensors_io import (
        save_file)

    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(
        seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shards, cur, size = [], [], 0
    for name, t in hf_llama_tensors(params, spec):
        nbytes = t.numel() * t.element_size()
        if cur and size + nbytes > CKPT_SHARD_BYTES:
            shards.append(cur)
            cur, size = [], 0
        cur.append((name, t))
        size += nbytes
    shards.append(cur)
    weight_map, total = {}, 0
    t0 = time.perf_counter()
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(dict(shard), str(path / fname), metadata={"format": "pt"})
        for name, t in shard:
            weight_map[name] = fname
            total += t.numel() * t.element_size()
    write_s = time.perf_counter() - t0
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
    family = ({"architectures": ["MixtralForCausalLM"],
               "model_type": "mixtral",
               "num_local_experts": spec.n_experts,
               "num_experts_per_tok": spec.experts_per_token}
              if spec.n_experts else
              {"architectures": ["LlamaForCausalLM"], "model_type": "llama"})
    (path / "config.json").write_text(json.dumps({
        **family,
        "vocab_size": spec.vocab_size, "hidden_size": spec.d_model,
        "num_hidden_layers": spec.n_layers,
        "num_attention_heads": spec.n_heads,
        "num_key_value_heads": spec.n_kv_heads,
        "intermediate_size": spec.d_ff,
        "max_position_embeddings": spec.max_seq_len,
        "rope_theta": spec.rope_theta, "rms_norm_eps": spec.norm_eps,
        "tie_word_embeddings": spec.tie_embeddings, "hidden_act": "silu",
        "torch_dtype": "bfloat16"}, indent=2))
    n_files = len(shards)
    del params, shards, cur
    return dict(files=n_files, bytes=total, init_s=init_s, write_s=write_s)


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


async def drive_ckpt(torch, host, port, pid: int, ck: Path, art: Path,
                     waves, card: str):
    """The ``[ckpt]`` phase's three loads on one worker started with no
    model, each served ``waves`` and then unloaded (the worker's memory
    back within ``UNLOAD_SLACK_GIB`` of the reading before the first):
    the checkpoint in bf16; the same with int4 weights and ``artifact=``
    (the slow path: read, quantize, prepare, write the artifact, record
    the golden probe); the same config again (the artifact cold start)."""
    from distributed_inference_engine_tpu_torch.cli.worker import (
        parse_model_arg)
    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerClient)

    bf16 = parse_model_arg(MIXED_MODEL + f",path={ck}")
    int4 = parse_model_arg(MIXED_MODEL + f",path={ck},quantized=1,"
                           f"weight_bits=4,artifact={art}")
    client = WorkerClient(host, port, timeout=900.0)
    runs = []
    try:
        mem = WorkerMemory(torch, pid, client)
        mem0 = await mem.read()
        log(f"[ckpt] worker memory ({mem.source}) {mem0:.2f} GiB before "
            f"the first load ({mem.note}) [{card}]")
        for label, cfg in (("bf16", bf16), ("int4 slow path", int4),
                           ("int4 cold start", int4)):
            t0 = time.perf_counter()
            receipt = await client.load_model(cfg, timeout=900.0)
            wall = time.perf_counter() - t0
            m = await client.metrics()
            rounds, secs = m["model_warmup"][cfg.name]
            run = dict(label=label, receipt=receipt, load_wall=wall,
                       warmed=(f"warmed model {cfg.name}: {rounds} rounds "
                               f"in {secs:.2f}s"),
                       load=m["models"][cfg.name]["load"],
                       hits=m["artifact_hits"], misses=m["artifact_misses"],
                       rss=m["peak_rss_bytes"] / 2**30,
                       mem_loaded=await mem.read(),
                       note_loaded=mem.note)
            run.update(await serve_waves(client, waves, cfg.name,
                                         batched=True))
            assert await client.unload_model(cfg.name) is True
            run["mem_unloaded"] = await mem.read()
            run["note_unloaded"] = mem.note
            runs.append(run)
            assert run["mem_unloaded"] - mem0 <= UNLOAD_SLACK_GIB, \
                (label, mem0, run["mem_unloaded"], mem.note)
        await client.shutdown()
    finally:
        await client.close()
    return runs


def _tokens(out):
    return [[r.tokens for r in wave] for wave in out["results"]]


def report_ckpt_run(run, card: str) -> None:
    """A ``[ckpt]`` load's lines: the load's phases (seconds, bytes), the
    worker's resident set and device memory, the waves and launches."""
    info, results = run["load"], run["results"][0] + run["results"][1]
    phases = ", ".join(f"{k} {v:.2f}" for k, v in info.items()
                       if k.endswith("_s"))
    read = (f"; read {info['bytes_read'] / 1e9:.2f} GB in "
            f"{info['read_s']:.2f} s = "
            f"{info['bytes_read'] / 1e9 / info['read_s']:.2f} GB/s (warm "
            "page cache: written just before; the layers copied, "
            "transposed and cast on the card)"
            if "bytes_read" in info else "")
    log(f"[ckpt] {run['label']}: load_s {run['receipt']['load_s']:.2f} "
        f"(RPC wall {run['load_wall']:.2f} s, the warm-up included); "
        f"source {info['source']}, phases "
        f"(s): {phases}{read}; artifact hits {run['hits']}, misses "
        f"{run['misses']}; worker peak host RSS {run['rss']:.2f} GiB "
        f"(the process's so far); worker memory {run['mem_loaded']:.2f} "
        f"GiB loaded ({run['note_loaded']}), {run['mem_unloaded']:.2f} "
        f"after unloading ({run['note_unloaded']}) [{card}]")
    log(f"[ckpt] {run['label']}: {graphs_line(run)}; "
        f"{served_line(results, run['wall'])}; launches "
        f"{run['launches']} [{card}]")


def phase_ckpt(torch, card: str, mixed):
    """A11 at full width and depth on the card: write the seed-0
    llama3-8b bf16 tree (``mixed``'s weights) as an HF checkpoint, then
    through one worker load it in bf16 (its tokens must equal ``mixed``'s
    on the same waves), with int4 weights and ``artifact=`` (the slow
    path writes the artifact), and again (an artifact cold start: one
    artifact hit, the golden probe replayed, no capture during the waves,
    the slow path's tokens). Both directories are removed at the end,
    whatever happens. Returns the bf16 and int4 runs' launches."""
    from distributed_inference_engine_tpu_torch.cli.worker import (
        parse_model_arg)
    from distributed_inference_engine_tpu_torch.engine.artifact import (
        has_artifact)
    from distributed_inference_engine_tpu_torch.models import (
        spec_for_architecture)

    mixed_cfg = parse_model_arg(MIXED_MODEL)
    wave1, wave2 = mixed_prompts()
    parent = REPO / "_work"
    parent.mkdir(exist_ok=True)
    free0 = shutil.disk_usage(parent).free
    ck = Path(tempfile.mkdtemp(prefix="ckpt-hf-", dir=parent))
    art_root = Path(tempfile.mkdtemp(prefix="ckpt-art-", dir=parent))
    art = art_root / "llama3-8b"
    try:
        # the family's published spec (config.json's widths and positions)
        spec = spec_for_architecture(mixed_cfg.architecture,
                                     mixed_cfg.metadata["size"])
        w = write_hf_checkpoint(torch, ck, spec)
        free1 = shutil.disk_usage(parent).free
        log(f"[ckpt] wrote {w['files']} files, {w['bytes'] / 1e9:.2f} GB "
            f"in HF Llama naming in {w['write_s']:.2f} s = "
            f"{w['bytes'] / 1e9 / w['write_s']:.2f} GB/s (each tensor "
            f"copied off the card and written; the tree drawn in "
            f"{w['init_s']:.2f} s); free disk {free0 / 1e9:.2f} GB before, "
            f"{free1 / 1e9:.2f} after [{card}]")
        free_this_process(torch)
        proc, host, port, _lines = start_worker(None)
        try:
            runs = asyncio.run(drive_ckpt(
                torch, host, port, proc.pid, ck, art, [wave1, wave2], card))
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        bf16, slow, cold = runs
        for run in runs:
            check_results(run["results"][0], wave1, f"ckpt {run['label']}")
            check_results(run["results"][1], wave2, f"ckpt {run['label']}")
        assert bf16["load"]["source"] == "hf", bf16["load"]
        assert _tokens(bf16) == _tokens(mixed), \
            "the checkpoint's bf16 tokens differ from the mixed phase's"
        assert (slow["load"]["source"], slow["misses"], slow["hits"]) == \
            ("hf", 1, 0), slow["load"]
        assert "artifact_save_s" in slow["load"] and has_artifact(str(art))
        assert (cold["load"]["source"], cold["hits"], cold["misses"]) == \
            ("artifact", 1, 1), cold["load"]
        assert "golden_probe_s" in cold["load"], cold["load"]
        assert _tokens(cold) == _tokens(slow), \
            "the artifact cold start's tokens differ from the slow path's"
        for run in runs:
            launches = run["launches"]
            assert launches.get("ragged_attention", 0) == N_LAYERS * run[
                "eng"]["mixed_steps"] > 0, (run["label"], launches)
            assert launches.get("flash_decode", 0) > 0, launches
            assert (launches.get("int4_matmul", 0) > 0) == \
                (run is not bf16), (run["label"], launches)
        manifest = json.loads((art / "manifest.json").read_text())
        abytes = _dir_bytes(art)
        for run in runs:
            report_ckpt_run(run, card)
        log(f"[ckpt] artifact: {abytes / 1e9:.3f} GB ({abytes} bytes; quant "
            f"{manifest['quant']}; batch buckets "
            f"{manifest['buckets']['batch']}); checksum "
            f"{slow['load']['artifact_checksum_s']:.2f} s at save, "
            f"{cold['load']['artifact_checksum_s']:.2f} s at the cold start "
            f"(sha256 over the tree read back from the card); golden probe "
            f"{manifest['golden']['tokens']} replayed equal in "
            f"{cold['load']['golden_probe_s']:.2f} s; cold start load_s "
            f"{cold['receipt']['load_s']:.2f} against the slow path's "
            f"{slow['receipt']['load_s']:.2f} [{card}]")
        log(f"[ckpt] bf16 from the checkpoint: tokens equal the mixed "
            f"phase's on both waves; int4 cold start: tokens equal the slow "
            f"path's, no graph captured during its waves [{card}]")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(art_root, ignore_errors=True)
        log(f"[ckpt] removed {ck.name} and {art_root.name}: free disk "
            f"{shutil.disk_usage(parent).free / 1e9:.2f} GB [{card}]")
    assert not ck.exists() and not art_root.exists()
    return bf16["launches"], slow["launches"]


def phase_fp8(torch, card: str, mixed):
    """A5f and A5f-e5m2: the mixed phase's model and waves from e4m3 KV
    pools (``kv_dtype=float8_e4m3fn``), then, in the same worker process
    (the e4m3 model unloaded, ``load_model`` over RPC), from e5m2 pools
    (``E5M2_MODEL``), at full width and depth with the load-time warmup.
    For each: both waves served; every ragged launch on its fp8 (or e5m2)
    instance (32 per mixed step, on the tensor cores) and every
    flash-decode launch too; the pools' ``hbm_bytes`` half of ``mixed``'s;
    served tok/s and TTFT beside ``mixed``'s from this run. Returns the
    launch counts by pool dtype."""
    wave1, wave2 = mixed_prompts()
    first = run_worker(FP8_MODEL, [wave1, wave2], then=[E5M2_MODEL])
    mixed_res = mixed["results"][0] + mixed["results"][1]
    half = mixed["eng"]["kv"]["hbm_bytes"]
    launched, served = {}, {}
    for kv, out in zip((FP8, E5M2), [first] + first["then"]):
        suffix = KV8[kv][0]
        results, wall, launches, eng = (out["results"], out["wall"],
                                        out["launches"], out["eng"])
        check_results(results[0], wave1, f"{suffix} wave 1")
        check_results(results[1], wave2, f"{suffix} wave 2")
        assert eng["mixed_steps"] > 0 and eng["chunked_admissions"] > 0, eng
        assert eng["prefix_hit_admissions"] >= 1, eng
        for k in ("ragged_attention", "flash_decode"):
            assert launches.get(k, 0) > 0 and launches.get(
                f"{k}.{suffix}") == launches[k], \
                f"{suffix}: {k} not on its {suffix} instance: {launches}"
        assert launches["ragged_attention"] == N_LAYERS * eng[
            "mixed_steps"], (launches, eng["mixed_steps"])
        assert launches.get("ragged_attention.mma") == \
            launches["ragged_attention"], launches
        assert 2 * eng["kv"]["hbm_bytes"] == half, (eng["kv"], half)
        every = results[0] + results[1]
        served[suffix] = (_tok_s(every, wall),
                          _p50([r.ttft_s for r in every]))
        log(f"[{suffix}] {graphs_line(out)} [{card}]")
        log(f"[{suffix}] {served_line(every, wall)}; mixed steps "
            f"{eng['mixed_steps']} carrying {eng['mixed_prefill_tokens']} "
            f"prefill tokens; chunked admissions "
            f"{eng['chunked_admissions']}; prefix-hit admissions "
            f"{eng['prefix_hit_admissions']}; pools "
            f"{eng['kv']['hbm_bytes'] / 2**30:.2f} GiB (mixed "
            f"{half / 2**30:.2f}); launches {launches} [{card}]")
        launched[kv] = launches
    log(f"[e5m2] beside mixed and fp8 (same run): served "
        f"{served['e5m2'][0]:.1f} tok/s against mixed's "
        f"{_tok_s(mixed_res, mixed['wall']):.1f} and fp8's "
        f"{served['fp8'][0]:.1f}; TTFT p50 {served['e5m2'][1]:.3f} s "
        f"against {_p50([r.ttft_s for r in mixed_res]):.3f} s and "
        f"{served['fp8'][1]:.3f} s [{card}]")
    return launched


def _p50(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def decode_logit_gap(torch, spec, params, prompt, cont, fused: bool,
                     attn_impl: str = "pallas-decode"):
    """Max |logit| gap between the decode path (pages written by
    ``forward_prefill_into_pages``, then one ``forward_decode_window`` step
    per token of ``cont``, teacher-forced, through the CUDA kernels of
    ``attn_impl``) and ``forward_train`` over the whole sequence — one
    number per step."""
    import numpy as np
    from distributed_inference_engine_tpu_torch.models import base as mb

    seq = list(prompt) + list(cont)
    n0, steps = len(prompt), len(cont)
    with torch.no_grad():
        ref = mb.forward_train(spec, params, torch.tensor(
            [seq], device="cuda"), np.array([len(seq)], np.int32))[0]
        fusedw = spec.n_kv_heads * spec.head_dim
        n_pages = -(-len(seq) // P)
        kp = torch.zeros((spec.n_layers, n_pages, P, fusedw),
                         dtype=spec.torch_dtype, device="cuda")
        vp = torch.zeros_like(kp)
        table = np.arange(n_pages, dtype=np.int32)[None]
        h, _, _ = mb.forward_prefill_into_pages(
            spec, params, torch.tensor([prompt], device="cuda"),
            np.array([n0], np.int32), kp, vp, table)
        gaps = [float((mb.unembed(spec, params, h[0, -1:])[0]
                       - ref[n0 - 1]).abs().max())]
        side = torch.zeros((2, spec.n_layers, 1, steps, spec.n_kv_heads,
                            spec.head_dim), dtype=spec.torch_dtype,
                           device="cuda")
        i32 = dict(dtype=torch.int32, device="cuda")
        start = torch.tensor([n0], **i32)
        tab = torch.tensor(table, device="cuda")
        active = torch.tensor([True], device="cuda")
        for s in range(steps):
            x, _, _ = mb.forward_decode_window(
                spec, params, torch.tensor([seq[n0 + s]], **i32),
                torch.tensor([n0 + s], **i32), start, kp, vp, tab, side[0],
                side[1], active, attn_impl=attn_impl, fused=fused)
            gaps.append(float((mb.unembed(spec, params, x)[0]
                               - ref[n0 + s]).abs().max()))
    return gaps


def phase_fused(torch, card: str, prompts, results, mixed_wave,
                profile_it: bool):
    from distributed_inference_engine_tpu_torch.config import EngineConfig
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)
    from distributed_inference_engine_tpu_torch.models import (
        spec_for_architecture)
    from distributed_inference_engine_tpu_torch.models.base import init_params
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    spec = spec_for_architecture("llama", "llama3-8b", max_seq_len=1024)
    # the worker drew its weights the same way (seed 0 on this card)
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0))
    # bf16 is a smoke, checked with a tie band as wide as the bf16 gap
    # between two code paths (decode vs forward_train, printed below);
    # the fp32 checks below hold the kernels tightly
    eps = BF16_TIE_EPS
    gaps = decode_logit_gap(torch, spec, params, prompts[5],
                            results[5].tokens[:8], fused=False)
    log(f"[fused] bf16 decode-vs-forward_train max|logit gap| per step "
        f"{[round(g, 4) for g in gaps]}; tie band eps={eps} [{card}]")
    m, t = assert_greedy_parity(spec, params, prompts[5], results[5].tokens,
                                eps=eps, label="served chain")
    log(f"[fused] served chain teacher-forced: {m} strict, {t} ties")
    # the serve configuration in this process: graph replays against the
    # eager hook (the worker above replayed graphs)
    out_s, _, _, _ = pair_run(torch, spec, params, prompts, "serve", card,
                              profile_share=("flash_decode_kernel",),
                              attention_impl="pallas-decode")
    log(f"[fused] serve chains in process equal to the worker's: "
        f"{sum(a.tokens == b.tokens for a, b in zip(out_s, results))}/"
        f"{len(out_s)}")
    out, launches, eng, wall = pair_run(
        torch, spec, params, prompts, "fused", card,
        profile_share=("flash_decode_kernel", "matmul_residual_kernel",
                       "norm_matmul_kernel"),
        decode_fused=True, attention_impl="pallas-decode")
    for k in ("flash_decode", "norm_matmul", "matmul_residual"):
        assert launches.get(k, 0) > 0, f"fused: {k} never launched"
    steps = launches["flash_decode"] // spec.n_layers
    assert launches["flash_decode"] == steps * spec.n_layers
    assert launches["norm_matmul"] == 5 * launches["flash_decode"], launches
    assert launches["matmul_residual"] == 2 * launches["flash_decode"], \
        launches
    assert launches.get("matmul_residual.mma") == \
        launches["matmul_residual"], launches
    assert launches.get("norm_matmul.mma") == launches["norm_matmul"], \
        launches
    m, t = assert_greedy_parity(spec, params, prompts[5], out[5].tokens,
                                eps=eps, label="fused chain")
    same = sum(a.tokens == b.tokens for a, b in zip(out, results))
    gen = sum(len(r.tokens) for r in out)
    log(f"[fused] {len(out)} requests, {gen} tokens in {wall:.3f} s = "
        f"{gen / wall:.1f} tok/s; {steps} decode steps; launches "
        f"{launches}; teacher-forced {m} strict, {t} ties; chains equal to "
        f"the served ones: {same}/{len(out)} [{card}]")

    # the paged-attention kernel's two routes on Llama-3-8B: the window
    # scheme with attention_impl="pallas" (the kernel over the frozen
    # prefix with stats, merged with the side window) and the per-step
    # paged decode (decode_mode="inline"); bf16 smokes at the tie band
    done("fused: serve and fused pairs")
    spec_p = spec.replace(n_layers=CUT_LAYERS)
    params_p = init_params(spec_p,
                           torch.Generator(device="cuda").manual_seed(0))
    # the fw decode configuration, CUT_LAYERS deep: a bf16 engine through
    # the writeback kernel (a smoke, teacher-forced at the bf16 tie band)
    out_fw, fw_launch, _, wall = pair_run(
        torch, spec_p, params_p, prompts, "fw", card,
        profile_share=("flash_decode_kernel",),
        attention_impl="pallas-decode-fw")
    assert fw_launch.get("flash_decode_fw", 0) > 0, fw_launch
    assert fw_launch.get("flash_decode", 0) == 0, fw_launch
    m, t = assert_greedy_parity(spec_p, params_p, prompts[5],
                                out_fw[5].tokens, eps=eps, label="fw chain")
    log(f"[fused] fw engine ({CUT_LAYERS} layers): {len(out_fw)} requests in"
        f" {wall:.3f} s = {sum(len(r.tokens) for r in out_fw) / wall:.1f} "
        f"tok/s; launches {fw_launch}; teacher-forced {m} strict, {t} ties "
        f"[{card}]")
    for label, extra in (("pallas", dict(attention_impl="pallas")),
                         ("inline", dict(decode_mode="inline"))):
        out_p, launch_p, eng, wall = pair_run(
            torch, spec_p, params_p, prompts, f"paged {label}", card,
            **extra)
        steps = eng["decode_steps"]
        assert eng["decode_mode"] == ("inline" if label == "inline"
                                      else "window"), eng["decode_mode"]
        assert steps > 0 and launch_p.get("paged_attention", 0) == \
            CUT_LAYERS * steps, (launch_p, steps)
        for k in ("flash_decode", "flash_decode_fw", "ragged_attention"):
            assert not launch_p.get(k), f"paged {label}: {k} launched"
        m, t = assert_greedy_parity(spec_p, params_p, prompts[5],
                                    out_p[5].tokens, eps=eps,
                                    label=f"paged {label} chain")
        log(f"[fused] llama3-8b attention_impl/decode_mode {label}: "
            f"{len(out_p)} requests in {wall:.3f} s = "
            f"{sum(len(r.tokens) for r in out_p) / wall:.1f} tok/s; decode "
            f"{1e3 * eng['decode_chunk']['sum_s'] / steps:.2f} ms/step over "
            f"{steps} steps ({CUT_LAYERS} layers); launches {launch_p}; "
            f"teacher-forced {m} strict, {t} ties [{card}]")
    done("fused: fw, paged pallas and inline pairs")
    # the host paths at CUT_LAYERS deep: the host's work a step does not
    # grow with the depth, the device's does
    phase_host(torch, card, spec_p, params_p, prompts)
    del params_p
    torch.cuda.empty_cache()
    done("fused: host")
    log(f"[fused] {mixed_pair_line(torch, spec, params, mixed_wave, card, 'bf16')}"
        f" [{card}]")
    if profile_it:
        profile_mixed(torch, spec, params, mixed_wave, card)
    del params
    torch.cuda.empty_cache()
    done("fused: bf16 mixed steps")

    # fp32 at full width (CUT_LAYERS deep): the decode path through all
    # three kernels must match forward_train to fp32 rounding, at one slot
    # (logits) and at the engine's 8 live slots (every chain,
    # teacher-forced)
    t_fp32 = time.perf_counter()
    spec32 = spec.replace(dtype="float32", n_layers=FP32_LAYERS)
    params = init_params(spec32, torch.Generator(device="cuda").manual_seed(0))
    cont = out[5].tokens[:8]
    for impl, fused in (("pallas-decode", False), ("pallas-decode", True),
                        ("pallas-decode-fw", False)):
        gaps = decode_logit_gap(torch, spec32, params, prompts[5], cont,
                                fused=fused, attn_impl=impl)
        log(f"[fused] fp32 decode-vs-forward_train max|logit gap| "
            f"({impl}, fused={fused}) {max(gaps):.3e} over {len(gaps)} steps "
            f"(limit {FP32_LOGIT_TOL}) [{card}]")
        assert max(gaps) <= FP32_LOGIT_TOL, gaps
    # fp32 engines over the mixed phase's first wave (prompts of 16-900):
    # the decode path fused off and on, and the chunked ragged mixed step,
    # every chain held teacher-forced to forward_train
    chains = {}
    for label, extra in (("pallas-decode", dict()),
                         ("pallas-decode fused", dict(decode_fused=True)),
                         ("pallas-ragged chunk 256", dict(
                             attention_impl="pallas-ragged",
                             prefill_chunk=256))):
        # 8 slots x 8 pages of 128 cover max_seq_len 1024
        cfg32 = EngineConfig(**dict(dict(
            max_slots=8, max_seq_len=1024, num_pages=64, kv_dtype="float32",
            attention_impl="pallas-decode"), **extra))
        engine = ContinuousEngine(spec32, params=params, config=cfg32,
                                  device="cuda")
        res32 = engine.generate([
            GenerationRequest(prompt=p, max_new_tokens=32,
                              request_id=f"{label}_{i}")
            for i, p in enumerate(mixed_wave)])
        em = engine.get_metrics()
        del engine
        check_results(res32, mixed_wave, f"fp32 engine {label}")
        if "ragged" in label:
            assert em["mixed_steps"] > 0, em
        m = t = 0
        for i, (p, r) in enumerate(zip(mixed_wave, res32)):
            mi, ti = assert_greedy_parity(
                spec32, params, p, r.tokens, eps=FP32_LOGIT_TOL,
                label=f"fp32 engine {label} slot {i}")
            m, t = m + mi, t + ti
        chains[label] = [r.tokens for r in res32]
        log(f"[fused] fp32 engine ({label}), 8 slots: every chain "
            f"teacher-forced to forward_train, {m} strict, {t} ties "
            f"(band {FP32_LOGIT_TOL}); mixed steps {em['mixed_steps']} "
            f"[{card}]")
    base = chains["pallas-decode"]
    for label in ("pallas-decode fused", "pallas-ragged chunk 256"):
        same = sum(a == b for a, b in zip(base, chains[label]))
        log(f"[fused] fp32 chains equal to pallas-decode's: {label} "
            f"{same}/{len(mixed_wave)}")
    del params
    torch.cuda.empty_cache()
    log(f"[fused] the fp32 checks took {time.perf_counter() - t_fp32:.1f} s")
    return launches, fw_launch


# the [host] phase: llama3-8b bf16, decode_fused, graphs on, one wave
# through each of the engine's host paths (the last through the eager
# comparison hook)
HOST_CONFIGS = [
    ("sync admission", dict(defer_admission=False), False),
    ("deferred admission", dict(), False),
    # the step timeline is on by default (4096 records): its cost, read
    # against the same path with it off
    ("deferred admission, timeline off", dict(timeline_capacity=0), False),
    ("defer_sync", dict(defer_sync=True), False),
    ("stream_chunk_steps=2", dict(stream_chunk_steps=2), True),
    ("defer_sync eager", dict(defer_sync=True), False),
]


def host_wave(torch, engine, prompts, label: str, stream: bool):
    """``prompts`` (32 new tokens each) through ``engine``: two, one
    step, then the rest (admitted under decode pressure), stepping with a
    stream-ring poll between steps as the pump does; a stream callback on
    every request when ``stream``. Returns (results in order, frames,
    wall s)."""
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)

    frames = {}
    reqs = [GenerationRequest(prompt=p, max_new_tokens=32,
                              request_id=f"{label}{i}")
            for i, p in enumerate(prompts)]
    out = {}
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        if i == 2:
            engine.step()
        if stream:
            frames[r.request_id] = []
            engine.submit(r, on_tokens=frames[r.request_id].extend)
        else:
            engine.submit(r)
    while engine.n_live or engine.n_waiting:
        engine.step()
        engine.poll_stream()
        out.update({r.request_id: r for r in engine.drain_finished()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [out[r.request_id] for r in reqs], frames, wall


def profile_host(torch, engine, prompts, card: str, label: str,
                 stream: bool, min_steps: int = 16):
    """torch.profiler over at least ``min_steps`` pure-decode steps of
    ``engine`` with ``prompts`` all live (stream callbacks on when
    ``stream``), a first chunk unprofiled; returns (ms per decode step,
    device-busy %, host gap ms per step = (wall - device) / steps)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)

    for i, p in enumerate(prompts):
        engine.submit(GenerationRequest(prompt=p, max_new_tokens=256,
                                        request_id=f"hprof{i}"),
                      on_tokens=(lambda toks: None) if stream else None)
    while engine.n_waiting or engine.get_metrics()["prefilling_slots"]:
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    before = engine.get_metrics()["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.get_metrics()["decode_steps"] - before < min_steps:
            engine.step()
            engine.poll_stream()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = engine.get_metrics()["decode_steps"] - before
    engine.abort_all()
    ms, busy = report_profile(prof, wall, steps, f"host {label}", card)
    return ms, busy, ms * (1 - busy / 100)


def phase_host(torch, card: str, spec, params, prompts):
    """The engine's host paths at full width (llama3-8b bf16,
    ``CUT_LAYERS`` deep, ``decode_fused``, ``pallas-decode``, graphs on):
    one wave of the serve
    prompts through sync admission, the default deferred admission (with
    the step timeline on, the default, and off), ``defer_sync``, ``stream_chunk_steps=2`` with a callback on every
    request, and ``defer_sync`` through the eager hook. The five at the
    full chunk emit equal greedy tokens and logprobs bit for bit (the same
    device work, read at other times); the streamed one decodes in chunks
    of 2, a different split of flash-decode's keys between the pages and
    the side window, so where its tokens differ its chains are held
    teacher-forced at the bf16 tie band. The ``defer_sync`` graph run and
    its eager run count the same launches. Prints for each the decode ms
    per step, the device-busy share and the host gap per step (profiled),
    the deferred admissions, firsts fetches, stream-ring counters and the
    decode keys captured."""
    from distributed_inference_engine_tpu_torch.config import EngineConfig
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    t_phase = time.perf_counter()
    runs = {}
    for label, cfg, stream in HOST_CONFIGS:
        engine = ContinuousEngine(spec, params=params, config=EngineConfig(
            max_slots=8, max_seq_len=1024, attention_impl="pallas-decode",
            decode_fused=True, **cfg), device="cuda")
        engine._eager = label.endswith("eager")
        _cuda.reset_launch_counts()                  # this path starts here
        out, frames, wall = host_wave(torch, engine, prompts, "host", stream)
        launches = _cuda.launch_counts()             # ... and ends here
        check_results(out, prompts, f"host {label}")
        for r in out:
            if stream:
                assert frames[r.request_id] == r.tokens, \
                    f"host {label}: stream != result"
        m = engine.get_metrics()
        assert launches["flash_decode"] == spec.n_layers * m[
            "decode_steps"], (label, launches, m["decode_steps"])
        prof = profile_host(torch, engine, prompts, card, label, stream)
        runs[label] = dict(out=out, launches=launches, m=m, wall=wall,
                           prof=prof)
        gen = sum(len(r.tokens) for r in out)
        keys = [k for k in m["graph_capture_s"] if k.startswith("decode")]
        log(f"[host] {label}: {gen} tokens in {wall:.3f} s = "
            f"{gen / wall:.1f} tok/s; decode {prof[0]:.2f} ms/step, "
            f"{prof[1]:.1f}% busy, host gap {prof[2]:.2f} ms/step; "
            f"deferred admissions {m['deferred_admissions']}, firsts "
            f"fetches {m['firsts_fetches']}, stream ring pushes "
            f"{m['stream_ring_pushes']} polls {m['stream_ring_polls']} "
            f"ready {m['stream_ring_ready_polls']} depth "
            f"{m['stream_ring_depth']}, clamped chunks "
            f"{m['stream_clamped_chunks']}; decode keys captured "
            f"{[_key_short(k) for k in keys]}; "
            f"{sum(launches.values())} launches [{card}]")
        del engine
        torch.cuda.empty_cache()
    # the late round's batched admissions defer (a prefix hit among them
    # reads its first token through the suffix path)
    base = runs["deferred admission"]
    assert base["m"]["deferred_admissions"] > 0, base["m"]
    assert runs["sync admission"]["m"]["deferred_admissions"] == 0
    for label, cfg, _ in HOST_CONFIGS[2:]:
        assert runs[label]["m"]["deferred_admissions"] == \
            base["m"]["deferred_admissions"], label
    for label, _, stream in HOST_CONFIGS:
        r = runs[label]
        if stream:
            continue
        for a, b in zip(r["out"], base["out"]):
            assert a.tokens == b.tokens, f"host {label}: tokens differ"
            assert a.logprobs == b.logprobs, f"host {label}: logprobs"
    assert runs["defer_sync"]["launches"] == \
        runs["defer_sync eager"]["launches"], "defer_sync graph != eager"
    assert runs["defer_sync"]["m"]["stream_ring_pushes"] > 0
    sc = runs["stream_chunk_steps=2"]
    assert sc["m"]["stream_clamped_chunks"] > 0
    same = sum(a.tokens == b.tokens for a, b in zip(sc["out"], base["out"]))
    for p, a, b in zip(prompts, sc["out"], base["out"]):
        if a.tokens != b.tokens:
            assert_greedy_parity(spec, params, p, a.tokens,
                                 eps=BF16_TIE_EPS, label="host streamed")
    log(f"[host] sync admission, deferred admission (timeline on and off), "
        f"defer_sync and "
        f"defer_sync eager: greedy tokens and logprobs bit-equal; "
        f"defer_sync graph and eager launches equal; stream_chunk_steps=2: "
        f"{same}/{len(prompts)} chains bit-equal to the full chunk's"
        + ("" if same == len(prompts) else
           ", the rest teacher-forced within the bf16 tie band")
        + f"; the phase took {time.perf_counter() - t_phase:.1f} s [{card}]")


def mixed_step_times(torch, spec, params, prompts, eager: bool = False):
    """The wall of each mixed step of a ``mixed``-configuration engine
    while ``prompts`` prefill, with its bucket (prefill rows, chunk width),
    the first step (with the batched admission prefill) left out; a step
    ends in its one blocking host read, so its wall is its time. Returns
    ([(bucket, ms, whether the step captured a graph)], the chains'
    tokens, the engine's metrics, its graph pool's bytes)."""
    from distributed_inference_engine_tpu_torch.config import EngineConfig
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)

    engine = ContinuousEngine(spec, params=params, config=EngineConfig(
        max_slots=8, max_seq_len=1024, attention_impl="pallas-ragged",
        prefill_chunk=256, mixed_step_tokens=512), device="cuda")
    engine._eager = eager
    buckets = []
    run_chunk = engine._mixed_chunk

    def spy(inputs, qb, *rest):
        buckets.append((inputs.shape[0], qb))
        return run_chunk(inputs, qb, *rest)

    engine._mixed_chunk = spy
    for i, p in enumerate(prompts):
        engine.submit(GenerationRequest(prompt=p, max_new_tokens=32,
                                        request_id=f"tm{i}"))
    times = []
    while True:
        before = engine.get_metrics()["mixed_steps"]
        n_graphs = len(engine._graphs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        if engine.get_metrics()["mixed_steps"] == before:
            break
        times.append((buckets[-1], 1e3 * (time.perf_counter() - t0),
                      len(engine._graphs) > n_graphs))
    out = engine.run_until_idle()
    metrics = engine.get_metrics()
    pool = graph_pool_bytes(torch, engine._graph_pool)
    del engine
    assert len(times) >= 2, times
    return (times[1:], sorted((r.request_id, r.tokens) for r in out),
            metrics, pool)


def mistral_prompts():
    """Wave 1: 8 prompts of 16-5,200 tokens, two past the 4,096-token
    window (4,500 and 5,200) and two sharing a 256-token prefix; those
    over 512 tokens prefill in 512-token chunks. Wave 2: the first 2,048
    tokens of the 4,500-token prompt plus a 700-token tail (a prefix hit
    that resumes chunked) beside a 40-token prompt."""
    import numpy as np

    rs = np.random.RandomState(13)
    v = MISTRAL_VOCAB
    shared = rs.randint(1, v, size=256).tolist()
    wave1 = [rs.randint(1, v, size=n).tolist()
             for n in (16, 100, 700, 1500, 4500, 5200)]
    wave1 += [shared + rs.randint(1, v, size=20).tolist(),
              shared + rs.randint(1, v, size=300).tolist()]
    wave2 = [wave1[4][:2048] + rs.randint(1, v, size=700).tolist(),
             rs.randint(1, v, size=40).tolist()]
    return wave1, wave2


def phase_mistral(torch, card: str):
    """The slice's path: Mistral-7B v0.1 at full width and depth through
    the worker CLI. Sliding-window specs decode inline: every decode step
    lands each layer's K/V in its page and runs the paged-attention kernel
    once per layer (32 launches per step); no flash-decode and no ragged
    launch."""
    wave1, wave2 = mistral_prompts()
    out = run_worker(MISTRAL_MODEL, [wave1, wave2])
    results, wall, launches, eng = (out["results"], out["wall"],
                                    out["launches"], out["eng"])
    check_results(results[0], wave1, "mistral wave 1", MISTRAL_VOCAB)
    check_results(results[1], wave2, "mistral wave 2", MISTRAL_VOCAB)
    assert eng["decode_mode"] == "inline", eng["decode_mode"]
    steps = eng["decode_steps"]
    assert steps > 0 and launches.get("paged_attention", 0) == \
        N_LAYERS * steps, (launches, steps)
    # bf16 q at G 4: every launch on the tensor-core route
    assert launches.get("paged_attention.mma") == N_LAYERS * steps, launches
    for k in ("flash_decode", "flash_decode_fw", "ragged_attention"):
        assert not launches.get(k), f"mistral: {k} launched: {launches}"
    assert eng["chunked_admissions"] >= 5, eng["chunked_admissions"]
    assert eng["prefix_hit_admissions"] >= 1, eng["prefix_hit_admissions"]
    log(f"[mistral] {graphs_line(out)} [{card}]")
    log(f"[mistral] {served_line(results[0] + results[1], wall)}; decode "
        f"{1e3 * eng['decode_chunk']['sum_s'] / steps:.2f} ms/step over "
        f"{steps} steps; chunked admissions {eng['chunked_admissions']}; "
        f"prefix-hit admissions {eng['prefix_hit_admissions']}; prefill "
        f"calls {eng['prefill_calls']}; pools "
        f"{eng['kv']['hbm_bytes'] / 1e9:.2f} GB ({eng['kv']['num_pages']} "
        f"pages of {eng['kv']['page_size']}); "
        f"launches {launches} [{card}]")
    return wave1, results[0], launches


def paged_logit_gap(torch, spec, params, prompt, cont):
    """Max |logit| gap between the inline decode path (pages written by
    ``forward_prefill_into_pages``, then one ``forward_decode_paged`` step
    per token of ``cont``, teacher-forced, through the paged-attention
    kernel) and ``forward_train`` over the whole sequence, per step."""
    import numpy as np
    from distributed_inference_engine_tpu_torch.models import base as mb

    seq = list(prompt) + list(cont)
    n0 = len(prompt)
    with torch.no_grad():
        ref = mb.forward_train(spec, params, torch.tensor(
            [seq], device="cuda"), np.array([len(seq)], np.int32))[0]
        fusedw = spec.n_kv_heads * spec.head_dim
        n_pages = -(-len(seq) // P)
        kp = torch.zeros((spec.n_layers, n_pages, P, fusedw),
                         dtype=spec.torch_dtype, device="cuda")
        vp = torch.zeros_like(kp)
        table = np.arange(n_pages, dtype=np.int32)[None]
        h, _, _ = mb.forward_prefill_into_pages(
            spec, params, torch.tensor([prompt], device="cuda"),
            np.array([n0], np.int32), kp, vp, table)
        gaps = [float((mb.unembed(spec, params, h[0, -1:])[0]
                       - ref[n0 - 1]).abs().max())]
        del h
        i32 = dict(dtype=torch.int32, device="cuda")
        tab = torch.tensor(table, device="cuda")
        for s in range(len(cont)):
            x, _, _ = mb.forward_decode_paged(
                spec, params, torch.tensor([seq[n0 + s]], **i32),
                torch.tensor([n0 + s], **i32), kp, vp, tab)
            gaps.append(float((mb.unembed(spec, params, x)[0]
                               - ref[n0 + s]).abs().max()))
    return gaps


def phase_mistral_inproc(torch, card: str, wave1, served):
    """The Mistral weights of phase ``mistral`` rebuilt in this process
    (same seed and card, so the same draws): the served 5,200-token chain
    teacher-forced to ``forward_train`` at the bf16 tie band; then in fp32
    at full width and ``CUT_LAYERS`` deep, the inline decode path's logits
    within 1e-3 of
    ``forward_train``'s over the 32 served tokens continuing the
    4,500-token prompt (the window skips pages 0-2 and cuts page 3)."""
    from distributed_inference_engine_tpu_torch.models import (
        spec_for_architecture)
    from distributed_inference_engine_tpu_torch.models.base import init_params
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    spec = spec_for_architecture("mistral", "mistral-7b-v01",
                                 max_seq_len=8192)
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0))
    m, t = assert_greedy_parity(spec, params, wave1[5], served[5].tokens,
                                eps=BF16_TIE_EPS,
                                label="mistral served chain")
    log(f"[mistral] served chain (5,200-token prompt) teacher-forced to "
        f"forward_train: {m} strict, {t} ties (band {BF16_TIE_EPS}) "
        f"[{card}]")
    # the inline decode, graphs against eager, with 8 live slots over
    # contexts up to 5,200 (ms per step and busy share)
    out, launches, eng, _ = pair_run(
        torch, spec, params, wave1, "mistral", card,
        profile_share=("paged_mma_kernel", "paged_simt_kernel"),
        attention_impl="pallas", max_seq_len=8192, prefill_chunk=512)
    assert eng["decode_mode"] == "inline" and launches.get(
        "paged_attention") == N_LAYERS * eng["decode_steps"], \
        (launches, eng["decode_steps"])
    log(f"[mistral] in-process graph chains equal to the served ones: "
        f"{sum(a.tokens == b.tokens for a, b in zip(out, served))}/"
        f"{len(out)}")
    del params
    torch.cuda.empty_cache()

    spec32 = spec.replace(dtype="float32", n_layers=FP32_LAYERS)
    params = init_params(spec32, torch.Generator(device="cuda").manual_seed(0))
    _cuda.reset_launch_counts()
    gaps = paged_logit_gap(torch, spec32, params, wave1[4],
                           served[4].tokens)
    launches = _cuda.launch_counts()
    assert launches.get("paged_attention") == FP32_LAYERS * len(
        served[4].tokens), launches
    log(f"[mistral] fp32 inline decode-vs-forward_train max|logit gap| "
        f"{max(gaps):.3e} over {len(gaps)} steps past the window (prompt "
        f"{len(wave1[4])}, limit {FP32_LOGIT_TOL}); launches {launches} "
        f"[{card}]")
    assert max(gaps) <= FP32_LOGIT_TOL, gaps
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------- A5f in process


@contextlib.contextmanager
def plain_kernels():
    """Test-only switch of this script: every attention kernel the forward
    calls (``models/base.py``'s names) replaced by its plain version
    inside the block, restored after. The package has no such knob."""
    from distributed_inference_engine_tpu_torch.models import base as mb
    from distributed_inference_engine_tpu_torch.ops import flash_decode as fd
    from distributed_inference_engine_tpu_torch.ops import (
        paged_attention as pa)
    from distributed_inference_engine_tpu_torch.ops import (
        ragged_attention as ra)

    swaps = {"flash_decode_attention": fd.flash_decode_attention_plain,
             "flash_decode_attention_fw": fd.flash_decode_attention_fw_plain,
             "paged_attention": pa.paged_attention_xla,
             "ragged_attention": ra.ragged_attention_plain}
    old = {k: getattr(mb, k) for k in swaps}
    for k, v in swaps.items():
        setattr(mb, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mb, k, v)


def decode_logits(torch, spec, params, prompt, cont, path: str,
                  kv_dtype: str = FP8, device: str = "cuda"):
    """fp32 logits [len(cont) + 1, V] of one decode path over pools of
    ``kv_dtype`` (e4m3 by default, or e5m2; else the spec's dtype),
    teacher-forced: the prompt prefilled into the pages
    (``forward_prefill_into_pages``, which attends to its fresh keys
    unrounded: the same bytes land whatever the attention kernels), then
    one step per token of ``cont`` through ``forward_decode_window``
    (``path`` its ``attn_impl``) or the inline ``forward_decode_paged``
    (``inline``); for ``ragged`` the first half of ``cont`` as one chunk
    row of ``forward_mixed_step`` (every position's hidden state), the
    rest as its decode rows. On ``device``: the card unless the caller
    asks for the CPU."""
    import numpy as np
    from distributed_inference_engine_tpu_torch.models import base as mb

    seq = list(prompt) + list(cont)
    n0, steps = len(prompt), len(cont)
    L, fusedw = spec.n_layers, spec.n_kv_heads * spec.head_dim
    n_pages = -(-len(seq) // P)
    i32 = dict(dtype=torch.int32, device=device)
    kv = getattr(torch, kv_dtype) if kv_dtype in KV8 else spec.torch_dtype
    with torch.no_grad():
        # zero bytes viewed in the pool dtype (no fp8 fill kernel)
        kp = torch.zeros((L, n_pages, P, fusedw * kv.itemsize),
                         dtype=torch.uint8, device=device).view(kv)
        vp = torch.zeros_like(kp)
        table = np.arange(n_pages, dtype=np.int32)[None]
        tab = torch.tensor(table, device=device)
        h, _, _ = mb.forward_prefill_into_pages(
            spec, params, torch.tensor([prompt], device=device),
            np.array([n0], np.int32), kp, vp, table)
        logits = [mb.unembed(spec, params, h[0, -1:])[0]]
        side = torch.zeros((2, L, 1, steps, spec.n_kv_heads, spec.head_dim),
                           dtype=spec.torch_dtype, device=device)
        start = torch.tensor([n0], **i32)
        active = torch.tensor([True], device=device)
        first = 0
        if path == "ragged":
            first = steps // 2
            h, _, _ = mb.forward_mixed_step(
                spec, params, torch.tensor([cont[:first]], **i32),
                np.array([n0], np.int32), np.array([first], np.int32), kp,
                vp, tab, return_hidden_all=True)
            logits += list(mb.unembed(spec, params, h[0]))
        for s in range(first, steps):
            tok = torch.tensor([seq[n0 + s]], **i32)
            pos = torch.tensor([n0 + s], **i32)
            if path == "inline":
                x, _, _ = mb.forward_decode_paged(spec, params, tok, pos, kp,
                                                  vp, tab)
            elif path == "ragged":
                x, _, _ = mb.forward_mixed_step(
                    spec, params, tok[:, None], pos, torch.ones_like(pos),
                    kp, vp, tab)
            else:
                x, _, _ = mb.forward_decode_window(
                    spec, params, tok, pos, start, kp, vp, tab, side[0],
                    side[1], active, attn_impl=path)
            logits.append(mb.unembed(spec, params, x)[0])
    return torch.stack(logits)


def kernel_vs_plain(torch, card: str, spec32, params, prompt, cont, paths,
                    tag: str, kv_dtype: str = FP8):
    """Each decode path over ``kv_dtype`` pools (e4m3 or e5m2, or the spec's
    fp32) in fp32, through the kernels and through their plain versions
    (``plain_kernels``): the logits within ``FP32_LOGIT_TOL`` of each
    other (``E5M2_STORE_LOGIT_TOL`` at full depth over e5m2 pools on the
    ragged and inline paths), the plain run launching no kernel, the
    kernel run launching each path's kernel (its fp8 or e5m2 instance over
    fp8 pools); the gap to the unrounded ``forward_train`` printed beside
    (over fp8 pools the rounding itself, not held; over fp32 pools held to
    ``FP32_LOGIT_TOL``). Returns the kernel runs' launch counts by path."""
    import numpy as np
    from distributed_inference_engine_tpu_torch.models import base as mb
    from distributed_inference_engine_tpu_torch.ops import _cuda

    seq = list(prompt) + list(cont)
    with torch.no_grad():
        ref = mb.forward_train(spec32, params, torch.tensor(
            [seq], device="cuda"), np.array([len(seq)], np.int32))[0]
    ref = ref[len(prompt) - 1:]
    fp8 = kv_dtype in KV8
    want = {"pallas-decode": "flash_decode",
            "pallas-decode-fw": "flash_decode_fw",
            "inline": "paged_attention",
            "ragged": "ragged_attention"}
    by_path = {}
    for path in paths:
        _cuda.reset_launch_counts()
        got = decode_logits(torch, spec32, params, prompt, cont, path,
                            kv_dtype)
        launches = by_path[path] = _cuda.launch_counts()
        assert launches.get(inst8(want[path], kv_dtype) if fp8
                            else want[path], 0) > 0, (path, launches)
        with plain_kernels():
            _cuda.reset_launch_counts()
            plain = decode_logits(torch, spec32, params, prompt, cont, path,
                                  kv_dtype)
            assert not _cuda.launch_counts(), _cuda.launch_counts()
        gap = float((got - plain).abs().max())
        drift = float((got - ref).abs().max())
        tol = (E5M2_STORE_LOGIT_TOL if kv_dtype == E5M2
               and path in ("ragged", "inline")
               and spec32.n_layers > CUT_LAYERS else FP32_LOGIT_TOL)
        pools = KV8[kv_dtype][1].split()[0] if fp8 else "fp32"
        log(f"[{KV8[kv_dtype][0] if fp8 else 'families'}] fp32 {tag} {path}, "
            f"{pools} pools, {spec32.n_layers} layers:"
            f" kernels-vs-plain max|logit gap| {gap:.3e} over {len(got)} "
            f"steps (limit {tol}); vs "
            + (f"the unrounded forward_train {drift:.3e} (the {pools} "
               f"rounding, not held)" if fp8 else
               f"forward_train {drift:.3e} (limit {FP32_LOGIT_TOL})")
            + f"; launches {launches} [{card}]")
        assert gap <= tol, (tag, path, gap)
        assert fp8 or drift <= FP32_LOGIT_TOL, (tag, path, drift)
    return by_path


def phase_fp8_inproc(torch, card: str):
    """A5f in this process, at full width and ``CUT_LAYERS`` deep, over
    e4m3 and then e5m2 pools (each model's weights built once for both):
    the fw decode (``pallas-decode-fw``) at 8 slots over the serve
    prompts and Mistral's inline decode past its window over the mistral
    prompts, graph replays against the eager hook (tokens, logprobs and
    launches bit-equal); then in fp32 (``FP32_LAYERS`` deep) the decode
    paths' teacher-forced logits through the kernels against the same
    forward through their plain versions: flash-decode, fw, the ragged
    mixed step and the inline paged decode (Llama-3-8B), and Mistral's
    inline decode past the window. Returns, by pool dtype, the fw and
    Mistral runs' launch counts (the fp8 and e5m2 instances' paths)."""
    import numpy as np
    from distributed_inference_engine_tpu_torch.models import (
        spec_for_architecture)
    from distributed_inference_engine_tpu_torch.models.base import init_params

    gen = torch.Generator(device="cuda")
    launched = {kv: {} for kv in KV8}
    spec = spec_for_architecture("llama", "llama3-8b", max_seq_len=1024
                                 ).replace(n_layers=CUT_LAYERS)
    params = init_params(spec, gen.manual_seed(0))
    prompts = serve_prompts()
    for kv, (suffix, _, _) in KV8.items():
        _, fw_launch, eng, _ = pair_run(
            torch, spec, params, prompts, f"fw {suffix}", card, exact=True,
            attention_impl="pallas-decode-fw", kv_dtype=kv)
        assert fw_launch.get(f"flash_decode_fw.{suffix}") == \
            fw_launch.get("flash_decode_fw") == \
            CUT_LAYERS * eng["decode_steps"] > 0, \
            (fw_launch, eng["decode_steps"])
        launched[kv]["fw"] = fw_launch
    del params
    torch.cuda.empty_cache()

    mspec = spec_for_architecture("mistral", "mistral-7b-v01",
                                  max_seq_len=8192).replace(
        n_layers=CUT_LAYERS)
    params = init_params(mspec, gen.manual_seed(0))
    m_wave, _ = mistral_prompts()
    for kv, (suffix, _, _) in KV8.items():
        _, m_launch, eng, _ = pair_run(
            torch, mspec, params, m_wave, f"mistral {suffix}", card,
            exact=True, attention_impl="pallas", max_seq_len=8192,
            prefill_chunk=512, kv_dtype=kv)
        assert eng["decode_mode"] == "inline" and \
            m_launch.get(f"paged_attention.{suffix}") == \
            m_launch.get("paged_attention") == \
            CUT_LAYERS * eng["decode_steps"] > 0, \
            (m_launch, eng["decode_steps"])
        launched[kv]["mistral"] = m_launch
    del params
    torch.cuda.empty_cache()

    rs = np.random.RandomState(17)
    spec32 = spec.replace(dtype="float32", n_layers=FP32_LAYERS)
    params = init_params(spec32, gen.manual_seed(0))
    cont = rs.randint(1, spec32.vocab_size, size=16).tolist()
    for kv in KV8:
        kernel_vs_plain(
            torch, card, spec32, params, mixed_prompts()[0][7], cont,
            ("pallas-decode", "pallas-decode-fw", "ragged", "inline"),
            "llama3-8b", kv_dtype=kv)
    del params
    torch.cuda.empty_cache()
    mspec32 = mspec.replace(dtype="float32", n_layers=FP32_LAYERS)
    params = init_params(mspec32, gen.manual_seed(0))
    cont = rs.randint(1, MISTRAL_VOCAB, size=16).tolist()
    for kv in KV8:
        kernel_vs_plain(torch, card, mspec32, params, m_wave[4], cont,
                        ("inline",), "mistral-7b past the window",
                        kv_dtype=kv)
    del params
    torch.cuda.empty_cache()
    return launched


# ------------------------------------------------------ A9 the families


def family_waves(name: str):
    """The prompts a family's worker serves: Qwen2-7B the mixed phase's
    two waves, Gemma-7B and GPT-2 the serve wave (every prompt and its 32
    new tokens inside GPT-2's 1,024 positions), token ids folded into the
    family's vocab."""
    vocab = FAMILIES[name][4]
    waves = list(mixed_prompts()) if name == "qwen2-7b" else [
        serve_prompts()]
    return [[[t % vocab for t in p] for p in wave] for wave in waves]


def phase_families(torch, card: str):
    """The three families through one worker CLI process (``run_worker``:
    each after the one before it is unloaded), each checked by
    ``check_family``; returns ``check_family``'s results by name."""
    models = {name: (FAMILIES[name][0], family_waves(name))
              for name in FAMILIES}
    first, *rest = FAMILIES
    out = run_worker(*models[first], then=[models[n] for n in rest])
    return {name: check_family(card, name, o)
            for name, o in zip(FAMILIES, [out] + out["then"])}


def check_family(card: str, name: str, out):
    """One family at full published width and depth through the worker
    CLI (random bf16 weights from seed 0, ``warmup=1``; ``out``:
    ``serve_waves``' output): its waves served
    (none captures a graph), every result 32 tokens in the vocab. Qwen2-7B
    (mixed settings): one ragged launch per layer per mixed step, all on
    the tensor cores, at G 7 (one sub-group of 8 rows, one dead), and
    flash-decode at G 7 on the pure-decode steps. Gemma-7B and GPT-2
    (serve's settings): one flash-decode launch per layer per decode step
    (Gemma at head_dim 256; GPT-2 on the unfused chain), no other
    attention kernel. Prints the served tok/s and TTFT p50."""
    _model, _arch, _size, layers, vocab = FAMILIES[name]
    waves = family_waves(name)
    results, wall, launches, eng = (out["results"], out["wall"],
                                    out["launches"], out["eng"])
    for i, (res, prompts) in enumerate(zip(results, waves)):
        check_results(res, prompts, f"{name} wave {i + 1}", vocab)
    steps = eng["decode_steps"]
    if name == "qwen2-7b":
        assert eng["mixed_steps"] > 0 and eng["chunked_admissions"] > 0, eng
        assert launches.get("ragged_attention") == layers * eng[
            "mixed_steps"] == launches.get("ragged_attention.mma"), \
            (launches, eng["mixed_steps"])
        assert launches.get("flash_decode", 0) > 0, launches
        paths = (f"ragged (G 7) {launches['ragged_attention']} launches "
                 f"over {eng['mixed_steps']} mixed steps carrying "
                 f"{eng['mixed_prefill_tokens']} prefill tokens, "
                 f"flash-decode (G 7) {launches['flash_decode']}")
    else:
        assert steps > 0 and launches.get("flash_decode") == \
            layers * steps, (launches, steps)
        for k in ("ragged_attention", "paged_attention", "flash_decode_fw",
                  "norm_matmul", "matmul_residual"):
            assert not launches.get(k), f"{name}: {k} launched: {launches}"
        paths = (f"flash-decode {launches['flash_decode']} launches over "
                 f"{steps} decode steps")
    assert eng["prefix_hit_admissions"] >= 1, eng["prefix_hit_admissions"]
    every = [r for rs in results for r in rs]
    log(f"[{name}] {graphs_line(out)} [{card}]")
    log(f"[{name}] {served_line(every, wall)}; {paths}; prefix-hit "
        f"admissions {eng['prefix_hit_admissions']}; pools "
        f"{eng['kv']['hbm_bytes'] / 2**30:.2f} GiB "
        f"({eng['kv']['num_pages']} pages of {eng['kv']['page_size']}); "
        f"launches {launches} [{card}]")
    return dict(waves=waves, results=results, launches=launches,
                tok_s=_tok_s(every, wall),
                ttft_p50=_p50([r.ttft_s for r in every]))


def phase_families_inproc(torch, card: str, served):
    """Each family rebuilt in this process (same seed and card, so the
    same draws as its worker): one served chain teacher-forced to
    ``forward_train`` at the bf16 tie band, at full depth. Then at full
    width and ``FAMILY_LAYERS`` deep (GPT-2 at its 12 layers), graph replays
    against the eager hook, tokens, launches and logprobs equal (the
    logprobs bit for bit): Qwen2-7B and Gemma-7B through the inline paged
    decode (``attention_impl=pallas``, ``decode_mode=inline``: paged
    attention at G 7 and at head_dim 256), Gemma-7B's fused decode
    (``norm_matmul`` over 1 + w, flash-decode at head_dim 256), GPT-2's
    flash-decode. Then in fp32 (``FAMILY_FP32_LAYERS``
    deep; GPT-2 at 12) each decode path's teacher-forced logits through
    the kernels within 1e-3 of ``forward_train``'s and of the same
    forward through their plain versions. Returns the launch counts of
    the paths that carry the G 7 fw, G 7 paged and head_dim 256 paged
    instances."""
    import numpy as np
    from distributed_inference_engine_tpu_torch.models import (
        spec_for_architecture)
    from distributed_inference_engine_tpu_torch.models.base import init_params
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    gen = torch.Generator(device="cuda")
    rs = np.random.RandomState(19)
    paths = {}
    for name, (_m, arch, size, layers, vocab) in FAMILIES.items():
        spec = spec_for_architecture(arch, size, max_seq_len=1024)
        waves, results = served[name]["waves"], served[name]["results"]
        params = init_params(spec, gen.manual_seed(0))
        i = max(range(len(waves[0])), key=lambda j: len(waves[0][j]))
        m, t = assert_greedy_parity(spec, params, waves[0][i],
                                    results[0][i].tokens, eps=BF16_TIE_EPS,
                                    label=f"{name} served chain")
        log(f"[{name}] served chain ({len(waves[0][i])}-token prompt, "
            f"{layers} layers) teacher-forced to forward_train: {m} strict,"
            f" {t} ties (band {BF16_TIE_EPS}) [{card}]")
        del params
        torch.cuda.empty_cache()

        cut = layers if name == "gpt2" else FAMILY_LAYERS
        spec_c = spec.replace(n_layers=cut)
        params = init_params(spec_c, gen.manual_seed(0))
        prompts = serve_prompts()
        prompts = [[t % vocab for t in p] for p in prompts]
        runs = {"gpt2": [("", {})],
                "gemma-7b": [(" inline", dict(attention_impl="pallas",
                                               decode_mode="inline")),
                             (" fused", dict(decode_fused=True))],
                "qwen2-7b": [(" inline", dict(attention_impl="pallas",
                                               decode_mode="inline"))]}[name]
        for tag, cfg in runs:
            _, launches, eng, _ = pair_run(torch, spec_c, params, prompts,
                                           f"{name}{tag}", card, exact=True,
                                           **cfg)
            steps = eng["decode_steps"]
            if tag == " inline":
                assert eng["decode_mode"] == "inline" and launches.get(
                    "paged_attention") == cut * steps > 0, (launches, steps)
                # Qwen2-7B's G 7 on the tensor cores, Gemma-7B's G 1 on
                # the CUDA cores (paged_plan's rule)
                route = "mma" if name == "qwen2-7b" else "simt"
                assert launches.get(f"paged_attention.{route}") == \
                    cut * steps, (route, launches)
                paths[f"{name} inline"] = launches
            else:
                assert launches.get("flash_decode") == cut * steps > 0, \
                    (launches, steps)
            if tag == " fused":
                assert launches.get("norm_matmul", 0) > 0 and launches.get(
                    "matmul_residual", 0) > 0, launches
            elif name == "gpt2":
                assert not launches.get("norm_matmul") and not \
                    launches.get("matmul_residual"), launches
        del params
        torch.cuda.empty_cache()

        spec32 = spec.replace(dtype="float32",
                              n_layers=layers if name == "gpt2"
                              else min(FAMILY_FP32_LAYERS, layers))
        params = init_params(spec32, gen.manual_seed(0))
        prompt = max(prompts, key=len)
        by_path = kernel_vs_plain(
            torch, card, spec32, params, prompt,
            rs.randint(1, vocab, size=16).tolist(),
            ("pallas-decode", "pallas-decode-fw", "inline")
            + (("ragged",) if name == "qwen2-7b" else ()), name,
            kv_dtype="float32")
        if name == "qwen2-7b":
            paths["qwen2-7b fw"] = by_path["pallas-decode-fw"]
        del params
        torch.cuda.empty_cache()
    return paths


# ------------------------------------------------------------- Mixtral (A9)


def mixtral_waves():
    """The mixed phase's two waves, token ids folded into Mixtral's
    vocab."""
    return [[[t % MIXTRAL_VOCAB for t in p] for p in wave]
            for wave in mixed_prompts()]


async def drive_load(torch, host, port, pid: int, model: str, waves,
                     card: str):
    """On a worker started with no model: ``model`` loaded over
    ``load_model`` (its load-time warm-up included), ``waves`` served
    (each wave one RPC: ``serve_waves``), the model unloaded (the worker's
    memory back within ``UNLOAD_SLACK_GIB`` of the reading before the
    load) and the worker shut down. Returns ``serve_waves``' output with
    the load's receipt, wall, warm-up, phases, the engine's
    ``param_bytes`` and the memory readings."""
    from distributed_inference_engine_tpu_torch.cli.worker import (
        parse_model_arg)
    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerClient)

    cfg = parse_model_arg(model)
    client = WorkerClient(host, port, timeout=900.0)
    try:
        mem = WorkerMemory(torch, pid, client)
        run = dict(mem0=await mem.read())
        run["note0"] = mem.note
        t0 = time.perf_counter()
        run["receipt"] = await client.load_model(cfg, timeout=900.0)
        run["load_wall"] = time.perf_counter() - t0
        m = await client.metrics()
        rounds, secs = m["model_warmup"][cfg.name]
        run.update(warmed=(f"warmed model {cfg.name}: {rounds} rounds in "
                           f"{secs:.2f}s"), warmup_s=secs,
                   load=m["models"][cfg.name]["load"],
                   param_bytes=m["models"][cfg.name]["param_bytes"],
                   mem_loaded=await mem.read(), note_loaded=mem.note)
        run.update(await serve_waves(client, waves, cfg.name, batched=True))
        assert await client.unload_model(cfg.name) is True
        run["mem_unloaded"] = await mem.read()
        run["note_unloaded"] = mem.note
        assert run["mem_unloaded"] - run["mem0"] <= UNLOAD_SLACK_GIB, \
            (cfg.name, run["mem0"], run["mem_unloaded"], mem.note)
        await client.shutdown()
    finally:
        await client.close()
    return run


def load_run(torch, model: str, waves, card: str):
    """``drive_load`` on a fresh worker CLI started with no model."""
    free_this_process(torch)
    proc, host, port, _lines = start_worker(None)
    try:
        run = asyncio.run(drive_load(torch, host, port, proc.pid, model,
                                     waves, card))
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return run


def check_mixtral_run(run, waves, label: str, n_layers: int = N_LAYERS):
    """A Mixtral worker run's checks: every request finished (32 tokens in
    the vocab), one ragged launch per layer per mixed step (all on the
    tensor cores), one flash-decode launch per layer per pure decode step,
    ``n_layers * (2 + 3 * 8) + 1`` int4 launches per forward (admission
    prefills, decode steps and mixed steps), none on the wmma instance,
    no fused decode GEMV. Returns the forwards by kind."""
    results, launches, eng = run["results"], run["launches"], run["eng"]
    for i, (res, prompts) in enumerate(zip(results, waves)):
        check_results(res, prompts, f"{label} wave {i + 1}", MIXTRAL_VOCAB)
    assert eng["mixed_steps"] > 0 and eng["chunked_admissions"] > 0, eng
    assert eng["prefix_hit_admissions"] >= 1, eng
    assert launches.get("ragged_attention") == n_layers * eng[
        "mixed_steps"] == launches.get("ragged_attention.mma"), \
        (launches, eng["mixed_steps"])
    decode_steps = launches.get("flash_decode", 0) // n_layers
    assert decode_steps > 0 and \
        launches["flash_decode"] == n_layers * decode_steps, launches
    forwards = eng["prefill_calls"] + decode_steps + eng["mixed_steps"]
    # w_qkv, wo and each expert's gate, up and down per layer (the 4-D
    # expert payloads are not fused), and the head: 833 at 32 layers
    per_forward = n_layers * (2 + 3 * N_EXPERTS) + 1
    assert launches.get("int4_matmul") == per_forward * forwards, \
        (label, launches, eng["prefill_calls"], decode_steps,
         eng["mixed_steps"])
    inst = {k.split(".", 1)[1]: v for k, v in launches.items()
            if k.startswith("int4_matmul.")}
    assert sum(inst.values()) == launches["int4_matmul"] and \
        not inst.get("wmma"), inst
    for k in ("norm_matmul", "matmul_residual"):
        assert not launches.get(k), f"{label}: {k} launched: {launches}"
    return dict(prefills=eng["prefill_calls"], decode=decode_steps,
                mixed=eng["mixed_steps"], per_forward=per_forward)


def phase_mixtral(torch, card: str):
    """A9 at full width and depth: ``MIXTRAL_MODEL`` (Mixtral-8x7B, 32
    layers x 8 experts, int4 born from seed 0) loaded over ``load_model``
    into a worker CLI started with no model, and the mixed phase's two
    waves served (``check_mixtral_run``: 833 int4 launches per forward);
    unloading brings the worker's memory back. Prints the load's seconds,
    the warm-up's, the weights' bytes, the worker's device memory, tok/s
    and TTFT p50/max. Returns the waves and the run."""
    waves = mixtral_waves()
    run = load_run(torch, MIXTRAL_MODEL, waves, card)
    fw = check_mixtral_run(run, waves, "mixtral")
    results, wall, launches, eng = (run["results"], run["wall"],
                                    run["launches"], run["eng"])
    load = run["load"]
    phases = ", ".join(f"{k} {v:.2f}" for k, v in load.items()
                       if k.endswith("_s"))
    log(f"[mixtral] load_s {run['receipt']['load_s']:.2f} (RPC wall "
        f"{run['load_wall']:.2f} s; phases (s): {phases}; warm-up "
        f"{run['warmup_s']:.2f} s); weights {run['param_bytes'] / 1e9:.3f} "
        f"GB ({run['param_bytes']} bytes; predicted ~23.6); worker memory "
        f"({run['note0']}) {run['mem0']:.2f} GiB before the load, "
        f"{run['mem_loaded']:.2f} loaded ({run['note_loaded']}), "
        f"{run['mem_unloaded']:.2f} after unloading "
        f"({run['note_unloaded']}); pools "
        f"{eng['kv']['hbm_bytes'] / 2**30:.2f} GiB [{card}]")
    log(f"[mixtral] {graphs_line(run)} [{card}]")
    every = results[0] + results[1]
    log(f"[mixtral] {served_line(every, wall)}; mixed steps "
        f"{eng['mixed_steps']} carrying {eng['mixed_prefill_tokens']} "
        f"prefill tokens; chunked admissions {eng['chunked_admissions']}; "
        f"prefix-hit admissions {eng['prefix_hit_admissions']}; forwards: "
        f"{fw['prefills']} admission prefills, {fw['decode']} decode steps, "
        f"{fw['mixed']} mixed steps, {fw['per_forward']} int4 launches "
        f"each; launches {launches} [{card}]")
    return waves, run


class RouteRecorder:
    """The expert choices of an engine run, by sequence position: while
    ``recording()`` is on, the engine's forwards (admission prefill, mixed
    step, window decode; the names ``engine/continuous.py`` calls) note
    which rows carry which (page-table row's first page, position, token),
    and ``ops/moe.py:route`` records each such row's experts at each layer,
    keyed ``(wave, first page, position)``, with their gates. An engine run
    through its eager hook calls the Python forwards every step, so the
    records are the served path's own choices (graph replays equal the
    eager bodies bit for bit). ``pinned(seq, wave)`` then makes
    ``forward_train`` over ``seq`` route each position as that run did,
    with its gates: each MoE layer then combines the same experts with the
    same weights in both paths, as a dense MLP does, and what is left
    between them is the bf16 rounding the tie band was set for. It counts
    the choices that differ from ``forward_train``'s own and the nearest
    of those (its K-th and (K+1)-th probabilities). A prefix hit's first
    pages are found in the wave that wrote them."""

    def __init__(self, torch, n_layers: int, device="cuda") -> None:
        self.torch, self.n_layers, self.device = torch, n_layers, device
        self.records = {}
        self.wave = 0
        self.rows = None
        self.layer = 0

    def _rows(self, fn, args, kwargs):
        """[(row, first page, position, token)] of one forward's live
        rows, on the host."""
        import inspect

        import numpy as np
        from distributed_inference_engine_tpu_torch.models import base as mb

        a = inspect.signature(getattr(mb, fn)).bind(*args, **kwargs).arguments

        def host(x):
            return (x.detach().cpu().numpy() if hasattr(x, "detach")
                    else np.asarray(x))

        toks, table = host(a["tokens"]), host(a["page_table"])
        out = []
        if fn == "forward_prefill_into_pages":
            lens = host(a["seq_lens"])
            t = toks.shape[1]
            for b in range(toks.shape[0]):
                out += [(b * t + i, int(table[b, 0]), i, int(toks[b, i]))
                        for i in range(int(lens[b]))]
        elif fn == "forward_mixed_step":
            ctx, ql = host(a["ctx_lens"]), host(a["q_lens"])
            qm = toks.shape[1]
            for r in range(toks.shape[0]):
                out += [(r * qm + i, int(table[r, 0]), int(ctx[r]) + i,
                         int(toks[r, i])) for i in range(int(ql[r]))]
        else:                                     # forward_decode_window
            lens, act = host(a["lengths"]), host(a["active"])
            out = [(b, int(table[b, 0]), int(lens[b]), int(toks[b]))
                   for b in range(toks.shape[0]) if act[b]]
        return out

    @contextlib.contextmanager
    def recording(self):
        from distributed_inference_engine_tpu_torch.engine import continuous
        from distributed_inference_engine_tpu_torch.ops import moe

        names = ("forward_prefill_into_pages", "forward_mixed_step",
                 "forward_decode_window")
        old = {n: getattr(continuous, n) for n in names}
        real_route = moe.route

        def wrap(fn):
            def call(*args, **kwargs):
                self.rows, self.layer = self._rows(fn, args, kwargs), 0
                return old[fn](*args, **kwargs)
            return call

        def route(w, xf, k):
            probs, gate, idx = real_route(w, xf, k)
            experts, gates = idx.cpu().numpy(), gate.cpu().numpy()
            for row, page, pos, tok in self.rows:
                rec = self.records.setdefault(
                    (self.wave, page, pos),
                    {"token": tok, "idx": [None] * self.n_layers})
                rec["idx"][self.layer] = (
                    tuple(int(e) for e in experts[row]),
                    tuple(float(g) for g in gates[row]))
            self.layer += 1
            return probs, gate, idx

        def no_suffix(*args, **kwargs):
            raise AssertionError("the ragged engine ran a suffix prefill")

        for n in names:
            setattr(continuous, n, wrap(n))
        continuous.forward_prefill_suffix, suffix = no_suffix, \
            continuous.forward_prefill_suffix
        moe.route = route
        try:
            yield self
        finally:
            for n, f in old.items():
                setattr(continuous, n, f)
            continuous.forward_prefill_suffix = suffix
            moe.route = real_route

    def choices(self, seq, wave: int):
        """Position -> experts by layer for ``seq`` as wave ``wave`` (or,
        for a cached prefix, the wave before it) routed it: the first page
        whose records match ``seq``'s tokens most."""
        hits = collections.Counter(
            page for (w, page, pos), rec in self.records.items()
            if w == wave and pos < len(seq) and rec["token"] == seq[pos])
        page = hits.most_common(1)[0][0]
        out = {}
        for pos in range(len(seq)):
            for w in range(wave, -1, -1):
                rec = self.records.get((w, page, pos))
                if rec is not None and rec["token"] == seq[pos]:
                    out[pos] = rec["idx"]
                    break
        return out

    @contextlib.contextmanager
    def pinned(self, seq, wave: int):
        torch = self.torch
        from distributed_inference_engine_tpu_torch.ops import moe

        chosen = self.choices(seq, wave)
        # per layer: the recorded positions, their experts and gates
        pins = []
        for li in range(self.n_layers):
            at = [(pos, e[li]) for pos, e in chosen.items()
                  if e[li] is not None]
            pins.append((
                torch.tensor([p for p, _ in at], device=self.device),
                torch.tensor([e for _, (e, _) in at], device=self.device),
                torch.tensor([g for _, (_, g) in at], device=self.device)))
        real_route = moe.route
        stats = dict(pinned=sum(len(p[0]) for p in pins), differ=0,
                     nearest=None)
        layer = [0]

        def route(w, xf, k):
            probs, gate, own = real_route(w, xf, k)
            idx, gate = own.clone(), gate.clone()
            li, layer[0] = layer[0], layer[0] + 1
            pos, experts, gates = pins[li]
            if len(pos):
                idx[pos], gate[pos] = experts, gates
            diff = (idx.sort(-1).values != own.sort(-1).values).any(-1)
            if bool(diff.any()):
                top = torch.sort(probs[diff], -1, descending=True).values
                gaps = top[:, k - 1] - top[:, k]
                j = int(torch.argmin(gaps))
                near = (float(gaps[j]), float(top[j, k - 1]),
                        float(top[j, k]))
                stats["differ"] += int(diff.sum())
                if stats["nearest"] is None or near[0] < stats["nearest"][0]:
                    stats["nearest"] = near
            return probs, gate, idx

        moe.route = route
        try:
            yield stats
        finally:
            moe.route = real_route


def served_chain_parity(torch, recorder, spec, params, prompt, tokens,
                        wave: int, label: str, card: str):
    """A served chain teacher-forced to ``forward_train`` at the bf16 tie
    band, first as it stands (printed, not held: the two paths' bf16
    roundings flip experts whose K-th and (K+1)-th probabilities nearly
    tie, and a flip moves that token's MLP output), then with
    ``forward_train``'s expert choices and gates pinned to the served
    path's (``RouteRecorder``), which must hold. Prints how many (layer,
    position) choices the two paths made apart and the nearest of them
    (``forward_train``'s K-th and (K+1)-th probabilities there)."""
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    def held(**kw):
        try:
            m, t = assert_greedy_parity(spec, params, prompt, tokens,
                                        eps=BF16_TIE_EPS, label=label)
            return True, f"{m} strict, {t} ties"
        except AssertionError as e:
            return False, f"outside the band: {e}"

    seq = list(prompt) + list(tokens)
    _, own = held()
    with recorder.pinned(seq, wave) as st:
        ok, pinned = held()
    near = ("" if st["nearest"] is None else
            f"; the nearest: K-th {st['nearest'][1]:.6e}, (K+1)-th "
            f"{st['nearest'][2]:.6e} (gap {st['nearest'][0]:.3e})")
    log(f"[mixtral] {label} ({len(prompt)}-token prompt, {spec.n_layers} "
        f"layers) teacher-forced to forward_train (band {BF16_TIE_EPS}): "
        f"as it stands {own}; with its expert choices and gates pinned to "
        f"the served path's ({st['pinned']} of {len(seq) * spec.n_layers} "
        f"(layer, position) pairs): {pinned}; the two paths chose apart at "
        f"{st['differ']} pairs{near} [{card}]")
    assert ok, f"{label}, experts pinned: {pinned}"


def phase_mixtral_inproc(torch, card: str, waves, served):
    """Mixtral-8x7B in this process after its worker shut down: the same
    seed-0 int4 tree rebuilt (same seed and card, so the same draws), the
    longest chain of each wave teacher-forced to ``forward_train`` at the
    bf16 tie band (32 layers); on graph replays at 32 layers, the mixed
    steps' times by bucket and one profiled pure-decode chunk (ms a step,
    device-busy share, the int4 GEMV's share) beside the weights' bytes
    bound. Then at full width and ``MIXTRAL_LAYERS`` deep: int4 graph
    replays against the eager hook over the first wave
    (decode chunks and mixed steps; tokens, logprobs and launches equal);
    an int8 tree's decode chain in fp32 within 1e-3 of ``forward_train``;
    and the fp32 tree (not quantized; ``MIXTRAL_FP32_LAYERS`` deep) through
    flash-decode and the ragged mixed step, its teacher-forced logits
    within 1e-3 of ``forward_train``'s and of the plain kernels'. Returns
    the graph run's launches."""
    from distributed_inference_engine_tpu_torch.cli.worker import (
        parse_model_arg)
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)
    from distributed_inference_engine_tpu_torch.models import (
        engine_config, spec_for_architecture)
    from distributed_inference_engine_tpu_torch.models.base import (
        init_params, random_quantized_params)
    from distributed_inference_engine_tpu_torch.ops.quant import (
        param_bytes, prepare_params)

    spec = spec_for_architecture("mixtral", "mixtral-8x7b",
                                 max_seq_len=1024)
    gen = torch.Generator(device="cuda")

    def born(spec, bits):
        return prepare_params(random_quantized_params(
            spec, gen.manual_seed(0), bits=bits))

    params = born(spec, 4)
    log(f"[mixtral] rebuilt in process: {param_bytes(params) / 1e9:.3f} GB "
        f"of int4 weights [{card}]")
    # the served path again, in this process through the eager hook with
    # the worker's config (each wave one batch, as the worker admitted
    # it): the worker's tokens, its expert choices recorded
    recorder = RouteRecorder(torch, spec.n_layers)
    engine = ContinuousEngine(spec, params=params, config=engine_config(
        parse_model_arg(MIXTRAL_MODEL)), device="cuda")
    engine._eager = True
    t0 = time.perf_counter()
    with recorder.recording():
        for w, (prompts, results) in enumerate(zip(waves,
                                                   served["results"])):
            recorder.wave = w
            out = engine.generate([GenerationRequest(
                prompt=p, max_new_tokens=32, request_id=f"w{w}_{i}")
                for i, p in enumerate(prompts)])
            assert [r.tokens for r in out] == [r.tokens for r in results], \
                f"wave {w + 1}: the eager engine's tokens differ from the " \
                "worker's"
    del engine
    torch.cuda.empty_cache()
    log(f"[mixtral] the eager engine (this process, 32 layers) emitted the "
        f"worker's tokens on both waves in {time.perf_counter() - t0:.1f} "
        f"s; {len(recorder.records)} (wave, page, position) routes "
        f"recorded [{card}]")
    for w, (prompts, results) in enumerate(zip(waves, served["results"])):
        i = max(range(len(prompts)), key=lambda j: len(prompts[j]))
        served_chain_parity(torch, recorder, spec, params, prompts[i],
                            results[i].tokens, w,
                            f"served chain, wave {w + 1}", card)
    del recorder
    # the served configuration's steps at 32 layers, on graph replays: the
    # mixed steps by bucket, and one profiled pure-decode chunk (the
    # worker's decode-chunk wall would also hold the admission prefills
    # queued before a chunk)
    log(f"[mixtral] {mixed_pair_line(torch, spec, params, waves[0], card, 'int4 (32 layers)', ('graph',))}"
        f" [{card}]")
    engine = ContinuousEngine(spec, params=params, config=engine_config(
        parse_model_arg(MIXTRAL_MODEL)), device="cuda")
    ms, busy = profile_decode(torch, engine, waves[0], card,
                              label="mixtral decode, graph",
                              share_of=("int4_gemv", "flash_decode_kernel"))
    del engine
    log(f"[mixtral] decode at 32 layers x 8 experts, 8 slots: {ms:.2f} "
        f"ms/step, device busy {busy:.1f}%; bound "
        f"{param_bytes(params) / HBM_BYTES_PER_S * 1e3:.2f} ms (the "
        f"weights' bytes at 3.35 TB/s) [{card}]")
    del params
    torch.cuda.empty_cache()

    cut = spec.replace(n_layers=MIXTRAL_LAYERS)
    params = born(cut, 4)
    _, launches, eng, _ = pair_run(
        torch, cut, params, waves[0], "mixtral int4", card, exact=True,
        attention_impl="pallas-ragged", prefill_chunk=256,
        mixed_step_tokens=512)
    assert eng["mixed_steps"] > 0 and launches.get("ragged_attention") == \
        MIXTRAL_LAYERS * eng["mixed_steps"], (launches, eng["mixed_steps"])
    decode_steps = launches.get("flash_decode", 0) // MIXTRAL_LAYERS
    assert decode_steps > 0, launches
    assert launches.get("int4_matmul") == (
        MIXTRAL_LAYERS * (2 + 3 * N_EXPERTS) + 1) * (
        eng["prefill_calls"] + decode_steps + eng["mixed_steps"]), \
        (launches, eng["prefill_calls"], eng["mixed_steps"])
    del params
    torch.cuda.empty_cache()

    spec32 = spec.replace(dtype="float32", n_layers=MIXTRAL_FP32_LAYERS)
    prompt, cont = waves[0][5], served["results"][0][5].tokens[:8]
    params = born(spec32, 8)
    gaps = decode_logit_gap(torch, spec32, params, prompt, cont,
                            fused=False)
    log(f"[mixtral] int8 fp32 decode chain ({MIXTRAL_FP32_LAYERS} layers): "
        f"decode-vs-forward_train max|logit gap| {max(gaps):.3e} over "
        f"{len(gaps)} steps (limit {FP32_LOGIT_TOL}); weights "
        f"{param_bytes(params) / 1e9:.2f} GB [{card}]")
    assert max(gaps) <= FP32_LOGIT_TOL, gaps
    del params
    torch.cuda.empty_cache()

    params = init_params(spec32, gen.manual_seed(0))
    log(f"[mixtral] fp32 tree ({MIXTRAL_FP32_LAYERS} layers, full width): "
        f"{param_bytes(params) / 1e9:.2f} GB [{card}]")
    kernel_vs_plain(torch, card, spec32, params, prompt,
                    served["results"][0][5].tokens[:16],
                    ("pallas-decode", "ragged"), "mixtral-8x7b",
                    kv_dtype="float32")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_mixtral_ckpt(torch, card: str, waves):
    """The Mixtral loader on the card: a full-width Mixtral of
    ``MIXTRAL_CKPT_LAYERS`` layers (seed-0 bf16 tree, drawn on the card as
    the engine draws it) written as an HF Mixtral checkpoint under the
    checkout's ``_work/``, loaded through a worker CLI with
    ``quantized=1,weight_bits=4`` (each layer quantized as it is read)
    and served the two waves; its tokens must equal an in-process engine's
    on the same tree quantized by ``quantize_params``. The directory is
    removed at the end, whatever happens."""
    from distributed_inference_engine_tpu_torch.cli.worker import (
        parse_model_arg)
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)
    from distributed_inference_engine_tpu_torch.models import (
        engine_config, spec_for_architecture)
    from distributed_inference_engine_tpu_torch.models.base import (
        init_params)
    from distributed_inference_engine_tpu_torch.ops.quant import (
        quantize_params)

    spec = spec_for_architecture("mixtral", "mixtral-8x7b",
                                 max_seq_len=1024).replace(
        n_layers=MIXTRAL_CKPT_LAYERS)
    parent = REPO / "_work"
    parent.mkdir(exist_ok=True)
    ck = Path(tempfile.mkdtemp(prefix="ckpt-mixtral-", dir=parent))
    try:
        w = write_hf_checkpoint(torch, ck, spec)
        log(f"[mixtral ckpt] wrote {w['files']} files, {w['bytes'] / 1e9:.2f}"
            f" GB in HF Mixtral naming ({spec.n_layers} layers at full "
            f"width) in {w['write_s']:.2f} s [{card}]")
        model = (MIXTRAL_MODEL.replace("name=mixtral-8x7b,",
                                       "name=mixtral-ckpt,")
                 + f",path={ck}")
        run = load_run(torch, model, waves, card)
        fw = check_mixtral_run(run, waves, "mixtral ckpt",
                               n_layers=spec.n_layers)
        assert run["load"]["source"] == "hf", run["load"]
        got = [[r.tokens for r in wave] for wave in run["results"]]
        engine = ContinuousEngine(
            spec, params=quantize_params(spec, init_params(
                spec, torch.Generator(device="cuda").manual_seed(0)),
                bits=4),
            config=engine_config(parse_model_arg(model)), device="cuda")
        want = [[r.tokens for r in engine.generate([GenerationRequest(
            prompt=p, max_new_tokens=32, request_id=f"w{w}_{i}")
            for i, p in enumerate(wave)])] for w, wave in enumerate(waves)]
        del engine
        torch.cuda.empty_cache()
        assert got == want, "the loaded int4 Mixtral's tokens differ from " \
            "the tree quantized in process"
        load = run["load"]
        log(f"[mixtral ckpt] loaded int4 through the worker: load_s "
            f"{run['receipt']['load_s']:.2f} (read and quantize "
            f"{load['read_s']:.2f} s of {load['bytes_read'] / 1e9:.2f} GB, "
            f"the head {load['quantize_s']:.2f} s); weights "
            f"{run['param_bytes'] / 1e9:.3f} GB; "
            f"{served_line(run['results'][0] + run['results'][1], run['wall'])}"
            f"; {fw['per_forward']} int4 launches a forward; tokens equal "
            f"the in-process engine's on the tree quantized by "
            f"quantize_params [{card}]")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    assert not ck.exists()


def phase_int4(torch, card: str):
    """The slice's path: the worker CLI serving the mixed phase's two waves
    with int4 weights (born int4 from seed 0, q|k|v and gate|up fused at
    engine init). Every projection and the LM head launch the int4 kernel
    (129 launches per forward); no fused decode GEMV runs. Then the
    golden prompt's 8 greedy tokens: the probe the ``fleet`` phase's swap
    of the same model is gated on."""
    from distributed_inference_engine_tpu_torch.engine.artifact import (
        GOLDEN_PROMPT)

    wave1, wave2 = mixed_prompts()
    out = run_worker(INT4_MODEL, [wave1, wave2], probe_prompt=GOLDEN_PROMPT,
                     after=lambda client, last: spec_worker_phases(
                         client, last, [wave1, wave2]))
    launches = report_int4_run(out, wave1, wave2, card, "int4")
    log(f"[int4] probe: {len(GOLDEN_PROMPT)}-token golden prompt -> "
        f"{out['probe']} [{card}]")
    spec = out["after"]
    spec["static"]["launches_by_path"] = report_static(
        spec["static"], [wave1, wave2], card)
    spec["spec_async"]["launches_by_path"] = report_spec_async(
        spec["spec_async"], [wave1, wave2], card, out,
        spec["int4_decode_ms"])
    return wave1, out["results"][0], launches, out["probe"], spec


def report_int4_run(out, wave1, wave2, card: str, label: str):
    """The ``int4`` checks and lines over ``serve_waves``'s output."""
    results, wall, launches, eng = (out["results"], out["wall"],
                                    out["launches"], out["eng"])
    check_results(results[0], wave1, "int4 wave 1")
    check_results(results[1], wave2, "int4 wave 2")
    for k in ("int4_matmul", "ragged_attention", "flash_decode"):
        assert launches.get(k, 0) > 0, f"int4: {k} never launched: " \
            f"{launches}"
    for k in ("norm_matmul", "matmul_residual"):
        assert launches.get(k, 0) == 0, f"int4: {k} launched: {launches}"
    assert eng["mixed_steps"] > 0 and eng["chunked_admissions"] > 0, eng
    assert eng["prefix_hit_admissions"] >= 1, eng
    assert launches["ragged_attention"] == N_LAYERS * eng["mixed_steps"], \
        (launches, eng["mixed_steps"])
    assert launches.get("ragged_attention.mma") == \
        launches["ragged_attention"], launches
    # forwards: the batched admission prefills, the pure-decode steps (one
    # flash-decode per layer) and the mixed steps; the one prefix hit
    # resumes chunked in the mixed step, so no suffix prefill runs
    decode_steps = launches["flash_decode"] // N_LAYERS
    assert launches["flash_decode"] == N_LAYERS * decode_steps, launches
    forwards = eng["prefill_calls"] + decode_steps + eng["mixed_steps"]
    assert launches["int4_matmul"] == INT4_PER_FORWARD * forwards, \
        (launches, eng["prefill_calls"], decode_steps, eng["mixed_steps"])
    # by instance: every projection of a mixed step (hundreds of lattice
    # rows) and of an admission prefill takes the wgmma instance; decode
    # (8 rows) and the head take the GEMV; no Llama-3-8B shape needs wmma
    inst = {k.split(".", 1)[1]: v for k, v in launches.items()
            if k.startswith("int4_matmul.")}
    assert sum(inst.values()) == launches["int4_matmul"], launches
    per_step = (INT4_PER_FORWARD - 1) * eng["mixed_steps"]
    assert inst.get("wgmma", 0) > per_step and not inst.get("wmma"), \
        (inst, eng["mixed_steps"], eng["prefill_calls"])
    log(f"[{label}] {graphs_line(out)} [{card}]")
    log(f"[{label}] {served_line(results[0] + results[1], wall)}; mixed "
        f"steps {eng['mixed_steps']} carrying {eng['mixed_prefill_tokens']} "
        f"prefill tokens; chunked admissions {eng['chunked_admissions']}; "
        f"prefix-hit admissions {eng['prefix_hit_admissions']}; forwards "
        f"{forwards} ({eng['prefill_calls']} admission prefills, "
        f"{decode_steps} decode steps, {eng['mixed_steps']} mixed steps); "
        f"launches {launches} [{card}]")
    return launches


# ------------------------------------------- static engine and speculation


async def spec_worker_phases(client, last: str, waves):
    """Phases ``static`` (A8) and ``spec_async`` (A12) in the int4 phase's
    worker: ``last`` unloaded, then ``STATIC_MODEL`` loaded over
    ``load_model`` and ``waves`` sent request by request at once (each its
    own ``generate``: the executor path, one batch a call), then it
    unloaded and ``SPEC_ASYNC_MODEL`` loaded and the waves streamed
    (``generate_stream``: the drafter serves streaming slots), each with
    the worker's launch counts zeroed just before and read just after, its
    engine metrics (and the spec model's step timeline) read after."""
    from distributed_inference_engine_tpu_torch.cli.worker import (
        parse_model_arg)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)

    # the int4 model's plain decode step (its timeline), beside which the
    # verify step is printed
    out = {"int4_decode_ms": _timeline_ms(
        (await client.events())["timelines"][last], "decode")}
    for label, model in (("static", STATIC_MODEL),
                         ("spec_async", SPEC_ASYNC_MODEL)):
        assert await client.unload_model(last) is True, last
        cfg = parse_model_arg(model)
        receipt = await client.load_model(cfg, timeout=900.0)
        last = cfg.name
        before = (await client.metrics())["models"][last]
        await client.kernel_counts(reset=True)    # this path starts here
        results, wall = [], 0.0
        for w, prompts in enumerate(waves):
            reqs = [GenerationRequest(prompt=p, max_new_tokens=32,
                                      request_id=f"{label}{w}_{i}")
                    for i, p in enumerate(prompts)]
            t0 = time.perf_counter()
            if label == "static":
                outs = [o[0] for o in await asyncio.gather(*[
                    client.generate(last, [r]) for r in reqs])]
            else:
                outs = await asyncio.gather(*[
                    client.generate_stream(last, r, lambda t: None)
                    for r in reqs])
            wall += time.perf_counter() - t0
            results.append(outs)
        launches = await client.kernel_counts()   # ... and ends here
        after = (await client.metrics())["models"][last]
        timeline = (await client.events())["timelines"].get(last, [])
        out[label] = dict(results=results, wall=wall, launches=launches,
                          before=before, eng=after, timeline=timeline,
                          load_s=receipt["load_s"], name=last)
    assert await client.unload_model(last) is True, last
    return out


def _int4_by_instance(launches):
    return {k.split(".", 1)[1]: v for k, v in launches.items()
            if k.startswith("int4_matmul.")}


def report_static(run, waves, card: str):
    """Phase ``static``: every request's 32 tokens (a prompt past
    ``STATIC_PROMPT_CAP`` keeps its tail), no attention kernel (the static
    engine attends through ``cached_attention``, plain PyTorch as the JAX
    engine's XLA), and its int4 launches by instance: each call's prefill
    projections on wgmma (128 a call, at the prompt's bucket rows), the
    decode steps' and every head's on the GEMV (129 a decode step, one
    head a prefill). Prints tok/s, TTFT p50, the engine's prefill and
    decode seconds and ms per decode step. Returns the path's launches."""
    results, launches, eng = run["results"], run["launches"], run["eng"]
    for w, (rs, ps) in enumerate(zip(results, waves)):
        check_results(rs, ps, f"static wave {w + 1}")
    for k in ("ragged_attention", "flash_decode", "paged_attention"):
        assert not launches.get(k), f"static: {k} launched: {launches}"
    calls = sum(len(w) for w in waves)
    inst = _int4_by_instance(launches)
    assert sum(inst.values()) == launches["int4_matmul"], launches
    assert inst.get("wgmma") == (INT4_PER_FORWARD - 1) * calls, inst
    steps, rem = divmod(inst["gemv"] - calls, INT4_PER_FORWARD)
    assert rem == 0 and steps > 0, (inst, calls)
    d_prefill = {k: eng["prefill"][k] - run["before"]["prefill"][k]
                 for k in ("sum_s", "count")}
    d_decode = {k: eng["decode"][k] - run["before"]["decode"][k]
                for k in ("sum_s", "count")}
    assert d_prefill["count"] == d_decode["count"] == calls, eng
    flat = [r for rs in results for r in rs]
    log(f"[static] {run['name']} (continuous=0) over load_model in "
        f"{run['load_s']:.2f} s: {served_line(flat, run['wall'])}; engine "
        f"prefill {d_prefill['sum_s']:.3f} s over {calls} calls, decode "
        f"{d_decode['sum_s']:.3f} s over {steps} decode steps = "
        f"{1e3 * d_decode['sum_s'] / steps:.2f} ms/step (eager, 1 row a "
        f"call: the executor runs one generate at a time); int4 launches "
        f"by instance {inst} [{card}]")
    run["ms_per_step"] = 1e3 * d_decode["sum_s"] / steps
    return {"int4_matmul": launches["int4_matmul"]}


def _timeline_ms(events, kind: str):
    """Mean ms per step of an engine's ``kind`` records (a decode record
    holds ``n_steps`` steps), leaving out each key's first dispatch (its
    graph's capture)."""
    xs = [1e3 * e["dur"] / e["args"].get("n_steps", 1) for e in events
          if e["name"] == kind and not e["args"].get("compile")]
    return (sum(xs) / len(xs), len(xs)) if xs else (float("nan"), 0)


def report_spec_async(run, waves, card: str, int4_out, int4_decode_ms):
    """Phase ``spec_async``: every request's 32 tokens, the verify step
    run (``spec_async_verify_steps``) with drafted tokens, the ragged
    kernel at the verify lattice (one launch a layer a verify step, on the
    tensor cores), and the drafter's counters; prints the accept rate,
    verify steps, ms per verify step against a plain decode step (the
    step timeline; the int4 model's decode chunks for the plain step,
    ``int4_decode_ms``) and tok/s beside the ``int4`` phase's. Returns the
    verify path's launches."""
    results, launches, eng, before = (run["results"], run["launches"],
                                      run["eng"], run["before"])
    for w, (rs, ps) in enumerate(zip(results, waves)):
        check_results(rs, ps, f"spec_async wave {w + 1}")
    d = {k: eng[k] - before[k] for k in (
        "spec_async_verify_steps", "spec_async_drafted_tokens",
        "spec_async_accepted_tokens", "spec_async_wasted_tokens",
        "spec_async_draft_rounds", "spec_async_propose_rounds",
        "spec_async_catchup_tokens", "mixed_steps", "decode_steps")}
    assert d["spec_async_verify_steps"] > 0, d
    assert d["spec_async_drafted_tokens"] > 0, d
    verify_ragged = N_LAYERS * d["spec_async_verify_steps"]
    assert launches.get("ragged_attention", 0) == verify_ragged +         N_LAYERS * d["mixed_steps"], (launches, d)
    assert launches.get("ragged_attention.mma") ==         launches["ragged_attention"], launches
    t_ver, n_ver = _timeline_ms(run["timeline"], "verify")
    # a plain decode step: the int4 phase's (the same model, no drafter;
    # here every step with a live stream verifies)
    t_dec, n_dec = int4_decode_ms
    flat = [r for rs in results for r in rs]
    int4_flat = [r for rs in int4_out["results"] for r in rs]
    acc = (d["spec_async_accepted_tokens"] / d["spec_async_drafted_tokens"])
    log(f"[spec_async] {run['name']} over load_model in {run['load_s']:.2f}"
        f" s, waves streamed: {served_line(flat, run['wall'])}; the int4 "
        f"phase's {served_line(int4_flat, int4_out['wall'])}; accept rate "
        f"{acc:.3f} ({d['spec_async_accepted_tokens']} of "
        f"{d['spec_async_drafted_tokens']} drafted, "
        f"{d['spec_async_wasted_tokens']} wasted, "
        f"{d['spec_async_catchup_tokens']} caught up); verify steps "
        f"{d['spec_async_verify_steps']}, draft rounds "
        f"{d['spec_async_draft_rounds']} ({d['spec_async_propose_rounds']} "
        f"proposing), mixed steps {d['mixed_steps']}; verify step "
        f"{t_ver:.2f} ms ({n_ver} records) against the int4 phase's plain "
        f"decode step {t_dec:.2f} ms ({n_dec} chunks; each key's capture "
        f"left out); int4 launches by instance "
        f"{_int4_by_instance(launches)}; launches {launches} [{card}]")
    return {"ragged_attention": verify_ragged}


def phase_spec_inproc(torch, card: str, waves, spec_runs):
    """Phase ``spec`` (A12) in this process on the int4 weights of phase
    ``int4`` (same seed and card): the static and async workers' chains
    teacher-forced to ``forward_train`` (bf16 band); the
    ``SpeculativeEngine`` at 32 layers with ``truncated_draft(..., 2)``, k
    4, 4 rounds a call over the first wave, its chains teacher-forced and
    against the static worker's on the same prompts, with its accept rate,
    tokens a round, ms a round against the static engine's ms a decode
    step and its wgmma launches at M 40; the async verify step graph
    against eager (equal tokens and launches); then in fp32 at
    ``CUT_LAYERS`` ``forward_window``'s logits within ``FP32_LOGIT_TOL`` of
    ``forward_train``'s. Returns the verify window's int4 launches."""
    from distributed_inference_engine_tpu_torch.config import EngineConfig
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.engine.engine import (
        prefill_cache)
    from distributed_inference_engine_tpu_torch.engine.speculative import (
        SpeculativeEngine, truncated_draft)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)
    from distributed_inference_engine_tpu_torch.models import (
        spec_for_architecture)
    from distributed_inference_engine_tpu_torch.models.base import (
        forward_prefill, forward_train, forward_window, init_params,
        random_quantized_params)
    from distributed_inference_engine_tpu_torch.ops import _cuda
    from distributed_inference_engine_tpu_torch.ops.quant import (
        prepare_params)
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    spec = spec_for_architecture("llama", "llama3-8b", max_seq_len=1024)
    params = prepare_params(random_quantized_params(
        spec, torch.Generator(device="cuda").manual_seed(0), bits=4))
    static = [r for rs in spec_runs["static"]["results"] for r in rs]
    served = [r for rs in spec_runs["spec_async"]["results"] for r in rs]
    prompts = [p for w in waves for p in w]
    for label, rs, cap in (("static", static, STATIC_PROMPT_CAP),
                           ("spec_async", served, None)):
        m = t = 0
        for i, (p, r) in enumerate(zip(prompts, rs)):
            mi, ti = assert_greedy_parity(
                spec, params, p[-cap:] if cap else p, r.tokens,
                eps=BF16_TIE_EPS, label=f"{label} chain {i}")
            m, t = m + mi, t + ti
        log(f"[{label}] every served chain teacher-forced ({len(rs)}): "
            f"{m} strict, {t} ties (band {BF16_TIE_EPS}) [{card}]")

    # the speculative engine over the first wave (one batch of 8)
    cfg = EngineConfig(max_slots=8, max_seq_len=1024)
    d_spec, d_params = truncated_draft(spec, params, SPEC_DRAFT_LAYERS)
    se = SpeculativeEngine(spec, d_spec, params=params,
                           draft_params=d_params, config=cfg,
                           speculate_k=SPEC_K, rounds_per_call=SPEC_ROUNDS,
                           device="cuda")
    reqs = [GenerationRequest(prompt=p, max_new_tokens=32,
                              request_id=f"spec{i}")
            for i, p in enumerate(waves[0])]
    se.generate(reqs[:1])                     # first-use costs, untimed
    live0 = se.get_metrics()["rounds"]
    with _cuda.recording_launches() as launches:   # this path starts here
        t0 = time.perf_counter()
        out = se.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(launches)                      # ... and ends here
    check_results(out, waves[0], "spec")
    m = se.get_metrics()
    inst = _int4_by_instance(launches)
    # the prefill's projections (target 32 layers and draft 2, at the
    # prompts' bucket rows) and every verify window's (M 40) take wgmma;
    # the draft's steps (M 8) and every head but the verify's (fp32, M
    # 40: the CUDA-core instance) the GEMV
    prefill_wgmma = 4 * (N_LAYERS + SPEC_DRAFT_LAYERS)
    verify_wgmma = inst.get("wgmma", 0) - prefill_wgmma
    # every call runs its rounds, rows frozen or not (a live round has a
    # row emitting)
    rounds_run, rem = divmod(verify_wgmma, 4 * N_LAYERS)
    assert rem == 0 and rounds_run % SPEC_ROUNDS == 0 and \
        rounds_run >= m["rounds"] - live0 > 0, (inst, m)
    assert inst.get("simt") == rounds_run, inst
    ms_round = 1e3 * out[0].decode_s / rounds_run
    m_tf = t_tf = same = 0
    for i, (p, r) in enumerate(zip(waves[0], out)):
        mi, ti = assert_greedy_parity(
            spec, params, p[-STATIC_PROMPT_CAP:], r.tokens, eps=BF16_TIE_EPS,
            label=f"spec chain {i}")
        m_tf, t_tf = m_tf + mi, t_tf + ti
        same += r.tokens == static[i].tokens
    log(f"[spec] SpeculativeEngine (truncated_draft {SPEC_DRAFT_LAYERS} "
        f"layers, k {SPEC_K}, {SPEC_ROUNDS} rounds a call), 8 requests in "
        f"{wall:.3f} s = {sum(len(r.tokens) for r in out) / wall:.1f} tok/s;"
        f" accept rate {m['draft_acceptance_rate']:.3f}, "
        f"{m['tokens_per_round']:.2f} tokens a live round; "
        f"{rounds_run} rounds run at {ms_round:.2f} ms a round against "
        f"{spec_runs['static']['ms_per_step']:.2f} ms a static decode step "
        f"(worker, 1 row); wgmma launches at M {8 * (SPEC_K + 1)}: "
        f"{verify_wgmma}; chains teacher-forced {m_tf} strict, {t_tf} ties,"
        f" {same}/8 equal to the static worker's; launches {launches} "
        f"[{card}]")
    del se, d_params

    # the async verify step, graph against eager, over the first wave; then
    # the same engine without the drafter (graphs): its plain decode step
    runs = []
    for eager, spec_async in ((True, True), (False, True), (False, False)):
        eng = ContinuousEngine(spec, params=params, device="cuda",
                               config=EngineConfig(
                                   max_slots=8, max_seq_len=1024,
                                   num_pages=64,
                                   attention_impl="pallas-ragged",
                                   prefill_chunk=256, mixed_step_tokens=512,
                                   spec_async=spec_async,
                                   spec_draft_model="layers:2",
                                   spec_bubble_floor_s=0.0))
        eng._eager = eager
        with _cuda.recording_launches() as la:
            for i, p in enumerate(waves[0]):
                eng.submit(GenerationRequest(prompt=p, max_new_tokens=32,
                                             request_id=f"v{i}"),
                           on_tokens=lambda t: None)
            res = eng.run_until_idle()
            torch.cuda.synchronize()
        runs.append((sorted((r.request_id, r.tokens) for r in res),
                     dict(la), eng.get_metrics(),
                     _timeline_ms(eng.timeline.events(), "verify")[0],
                     _timeline_ms(eng.timeline.events(), "decode")[0]))
        del eng
    (te, le, me, ve, _), (tg, lg, mg, vg, _), (tp, _, mp, _, dp) = runs
    assert tg == te, "spec_async: graph tokens != eager"
    assert lg == le, ("spec_async: graph launches != eager", lg, le)
    assert mg["spec_async_verify_steps"] == me["spec_async_verify_steps"] \
        > 0, (mg, me)
    same = sum(a == b for a, b in zip(tg, tp))
    log(f"[spec_async] in process, graph against eager: equal tokens and "
        f"launches; verify steps {mg['spec_async_verify_steps']}, accept "
        f"rate {mg['spec_async_accept_rate']:.3f}, graphs "
        f"{mg['cuda_graphs']}; verify step {vg:.2f} ms graph, {ve:.2f} ms "
        f"eager, against a plain decode step of the same engine without "
        f"the drafter {dp:.2f} ms ({mp['decode_steps']} steps; {same}/8 "
        f"chains equal to its) [{card}]")
    del params
    torch.cuda.empty_cache()

    # fp32 at full width, CUT_LAYERS deep: forward_window over a 5-token
    # window after a 520-token prompt against forward_train
    spec32 = spec.replace(dtype="float32", n_layers=CUT_LAYERS)
    params = init_params(spec32, torch.Generator(device="cuda").manual_seed(0))
    prompt = waves[0][5]
    window = static[5].tokens[:SPEC_K + 1]
    n = len(prompt)
    i32 = dict(dtype=torch.int32, device="cuda")
    _, ks, vs = forward_prefill(spec32, params, torch.tensor([prompt], **i32),
                                [n])
    ck = prefill_cache(ks, n + 8, torch.float32)
    cv = prefill_cache(vs, n + 8, torch.float32)
    del ks, vs
    got, _, _ = forward_window(spec32, params, torch.tensor([window], **i32),
                               torch.tensor([len(window)], **i32),
                               torch.tensor([n], **i32), ck, cv)
    # window position i: the distribution after window token i (at n + i)
    ref = forward_train(spec32, params, torch.tensor([prompt + window],
                                                     **i32),
                        [n + len(window)])[:, n: n + len(window)]
    gap = float((got - ref).abs().max())
    log(f"[spec] fp32 forward_window ({CUT_LAYERS} layers) against "
        f"forward_train max|logit gap| {gap:.3e} over {len(window)} "
        f"positions (limit {FP32_LOGIT_TOL}) [{card}]")
    assert gap <= FP32_LOGIT_TOL, gap
    del params, ck, cv
    torch.cuda.empty_cache()
    return {"int4_matmul": verify_wgmma}


def engine_run(torch, spec, params, prompts, label: str, **cfg):
    """``prompts`` (32 new tokens each) through an in-process engine at 8
    slots, launch counts zeroed just before; returns (results, launches,
    metrics, wall s)."""
    from distributed_inference_engine_tpu_torch.config import EngineConfig
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)
    from distributed_inference_engine_tpu_torch.ops import _cuda

    engine = ContinuousEngine(spec, params=params, config=EngineConfig(
        **dict(dict(max_slots=8, max_seq_len=1024), **cfg)), device="cuda")
    _cuda.reset_launch_counts()                      # this path starts here
    t0 = time.perf_counter()
    out = engine.generate([GenerationRequest(
        prompt=p, max_new_tokens=32, request_id=f"{label}{i}")
        for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _cuda.launch_counts()                 # ... and ends here
    metrics = engine.get_metrics()
    del engine
    check_results(out, prompts, label)
    return out, launches, metrics, wall


def phase_int4_inproc(torch, card: str, wave1, served, profile_it: bool):
    """The int4 weights of phase ``int4`` rebuilt in this process (same
    seed and card, so the same draws): the served chain teacher-forced to
    ``forward_train``; ``decode_fused=True`` launching no fused GEMV; the
    mixed steps' time; a bf16 int8 engine's times (``CUT_LAYERS`` deep);
    then fp32 at full
    width, int4 and int8 (``fp32_chains``). ``profile_it``: also the int4
    decode and mixed-step profiles."""
    from distributed_inference_engine_tpu_torch.models import (
        spec_for_architecture)
    from distributed_inference_engine_tpu_torch.models.base import (
        random_quantized_params)
    from distributed_inference_engine_tpu_torch.ops.quant import (
        param_bytes, prepare_params)
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    spec = spec_for_architecture("llama", "llama3-8b", max_seq_len=1024)

    def born(spec, bits):
        return prepare_params(random_quantized_params(
            spec, torch.Generator(device="cuda").manual_seed(0), bits=bits))

    params = born(spec, 4)
    gaps = decode_logit_gap(torch, spec, params, wave1[5],
                            served[5].tokens[:8], fused=False)
    log(f"[int4] bf16 decode-vs-forward_train max|logit gap| per step "
        f"{[round(g, 4) for g in gaps]}; tie band eps={BF16_TIE_EPS}; "
        f"weights {param_bytes(params) / 1e9:.2f} GB [{card}]")
    m, t = assert_greedy_parity(spec, params, wave1[5], served[5].tokens,
                                eps=BF16_TIE_EPS, label="int4 served chain")
    log(f"[int4] served chain teacher-forced: {m} strict, {t} ties")

    out, launches, eng, wall = engine_run(
        torch, spec, params, wave1, "int4 fused", decode_fused=True,
        attention_impl="pallas-decode")
    for k in ("norm_matmul", "matmul_residual"):
        assert launches.get(k, 0) == 0, f"int4 fused: {k} launched"
    decode_steps = launches.get("flash_decode", 0) // N_LAYERS
    assert decode_steps > 0, launches
    forwards = eng["prefill_calls"] + decode_steps
    assert launches["int4_matmul"] == INT4_PER_FORWARD * forwards, \
        (launches, eng["prefill_calls"])
    m, t = assert_greedy_parity(spec, params, wave1[5], out[5].tokens,
                                eps=BF16_TIE_EPS, label="int4 fused chain")
    log(f"[int4] decode_fused=True engine: {len(out)} requests in "
        f"{wall:.3f} s = {sum(len(r.tokens) for r in out) / wall:.1f} tok/s;"
        f" decode {decode_ms_per_step(eng, launches):.2f} ms/step; launches "
        f"{launches}; teacher-forced {m} strict, {t} ties [{card}]")
    # the int4 decode scheme, graphs against eager, with the int4 GEMV's
    # ms per decode step (129 launches a step)
    out, launches, eng, wall = pair_run(
        torch, spec, params, wave1, "int4", card,
        profile_share=("int4_gemv", "flash_decode_kernel"),
        attention_impl="pallas-decode")
    assert launches["int4_matmul"] == INT4_PER_FORWARD * (
        eng["prefill_calls"] + launches["flash_decode"] // N_LAYERS), \
        (launches, eng["prefill_calls"])
    log(f"[int4] {mixed_pair_line(torch, spec, params, wave1, card, 'int4')}"
        f" [{card}]")
    if profile_it:
        profile_mixed(torch, spec, params, wave1, card, label="int4 mixed")
    del params
    torch.cuda.empty_cache()

    # int8: the payload widened to bf16 per call, no kernel of its own, at
    # CUT_LAYERS deep (an earlier path, cut for the time limit). Its
    # bf16 chains are timed, not held: two bf16 code paths differ by ~0.4
    # in a logit here (printed), more than the 0.3 tie band, so the int8
    # chains are held in fp32 below
    spec8 = spec.replace(n_layers=CUT_LAYERS)
    params = born(spec8, 8)
    gaps = decode_logit_gap(torch, spec8, params, wave1[5],
                            served[5].tokens[:8], fused=False)
    out, launches, eng, wall = engine_run(
        torch, spec8, params, wave1, "int8", attention_impl="pallas-decode")
    assert not launches.get("int4_matmul"), launches
    log(f"[int8] bf16 engine ({CUT_LAYERS} layers): {len(out)} requests in "
        f"{wall:.3f} s = {sum(len(r.tokens) for r in out) / wall:.1f} "
        f"tok/s; decode "
        f"{decode_ms_per_step(eng, launches, CUT_LAYERS):.2f} ms/step; "
        f"weights {param_bytes(params) / 1e9:.2f} GB; launches {launches}; "
        f"bf16 decode-vs-forward_train max|logit gap| per step "
        f"{[round(g, 4) for g in gaps]} [{card}]")
    log(f"[int8] {mixed_pair_line(torch, spec8, params, wave1, card, 'int8', ('graph',))}"
        f" [{card}]")
    del params
    torch.cuda.empty_cache()

    # fp32 at full width (CUT_LAYERS deep): int4 through the kernel's
    # fp32 instances (GEMV, CUDA-core tiles), and int8, on the decode path
    # and through an engine's chunked mixed step
    spec32 = spec.replace(dtype="float32", n_layers=FP32_LAYERS)
    for bits in (4, 8):
        params = born(spec32, bits)
        launches = fp32_chains(torch, card, spec32, params, wave1,
                               served[5].tokens[:8], f"int{bits}")
        assert bool(launches.get("int4_matmul")) == (bits == 4), launches
        del params
        torch.cuda.empty_cache()


def fp32_chains(torch, card: str, spec32, params, prompts, cont, label: str):
    """fp32 at full width: the decode path's logits within 1e-3 of
    ``forward_train``'s over ``prompts[5]`` + ``cont``, then ``prompts``
    through an fp32 ``pallas-ragged`` engine (chunk 256) at 8 slots, every
    chain held teacher-forced to ``forward_train`` at the 1e-3 band."""
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    gaps = decode_logit_gap(torch, spec32, params, prompts[5], cont,
                            fused=False)
    log(f"[{label}] fp32 decode-vs-forward_train max|logit gap| "
        f"{max(gaps):.3e} over {len(gaps)} steps (limit {FP32_LOGIT_TOL}) "
        f"[{card}]")
    assert max(gaps) <= FP32_LOGIT_TOL, gaps
    out, launches, eng, wall = engine_run(
        torch, spec32, params, prompts, f"{label} fp32", num_pages=64,
        kv_dtype="float32", attention_impl="pallas-ragged",
        prefill_chunk=256)
    assert eng["mixed_steps"] > 0, eng
    assert launches.get("ragged_attention.simt") == \
        launches.get("ragged_attention"), launches
    m = t = 0
    for i, (p, r) in enumerate(zip(prompts, out)):
        mi, ti = assert_greedy_parity(spec32, params, p, r.tokens,
                                      eps=FP32_LOGIT_TOL,
                                      label=f"{label} fp32 engine slot {i}")
        m, t = m + mi, t + ti
    log(f"[{label}] fp32 engine (pallas-ragged chunk 256), 8 slots, in "
        f"{wall:.3f} s: every chain teacher-forced to forward_train, {m} "
        f"strict, {t} ties (band {FP32_LOGIT_TOL}); mixed steps "
        f"{eng['mixed_steps']}; launches {launches} [{card}]")
    return launches


# kernels that the one-launch kernels replaced (norm_matmul's prologue, GEMV
# and split-K reduce; the int4 GEMV and its reduce; paged attention's
# second, merging launch): no profile may see one
RETIRED_KERNELS = ("rms_inv_kernel", "::gemv_kernel<", "splitk_reduce_kernel",
                   "int4_gemv_kernel<", "paged_merge_kernel")


def report_profile(prof, wall: float, steps: int, label: str,
                   card: str, share_of=()) -> None:
    """Wall per step, the device-busy share and the device time by kernel
    of a ``torch.profiler`` window over ``steps`` steps; for each name in
    ``share_of``, also the device time per step and the share of device
    time of the kernels whose name holds it. Fails if one of
    ``RETIRED_KERNELS`` ran."""
    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total

    # kernel-level entries only (op entries would count their kernels twice)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    log(f"[profile] {label}: {steps} steps in {wall * 1e3:.1f} ms = "
        f"{wall * 1e3 / steps:.2f} ms/step; device busy {busy * 1e3:.1f} ms "
        f"= {100 * busy / wall:.1f}% of wall [{card}]")
    assert busy > 0, f"{label}: the profiler saw no device time"
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        log(f"[profile] {label}: {dev_us(e) / 1e3 / steps:9.3f} ms/step "
            f"{100 * dev_us(e) / 1e6 / busy:5.1f}% of device  "
            f"x{e.count / steps:<6.1f}/step {e.key[:90]}")
    for name in share_of:
        mine = [e for e in events if name in e.key]
        t = sum(dev_us(e) for e in mine) / 1e6
        log(f"[profile] {label}: {name} {t * 1e3 / steps:.3f} ms/step = "
            f"{100 * t / busy:.1f}% of device time, "
            f"x{sum(e.count for e in mine) / steps:.1f}/step [{card}]")
    retired = {name: sum(dev_us(e) for e in events if name in e.key)
               / 1e3 / steps for name in RETIRED_KERNELS}
    assert not any(retired.values()), \
        f"{label}: retired kernels ran: {retired}"
    return wall * 1e3 / steps, 100 * busy / wall


def profile_decode(torch, engine, prompts, card: str, label: str = "decode",
                   share_of=("flash_decode_kernel", "matmul_residual_kernel",
                             "norm_matmul_kernel")):
    """torch.profiler over one pure-decode chunk (8 steps: an eager chunk's
    trace takes the profiler seconds to reduce) of ``engine`` with
    ``prompts`` all prefilled and
    decoding (8 slots live), the admissions, the prefills and a first
    decode chunk (and so a graph engine's captures) unprofiled; returns
    (ms per decode step, device-busy %)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)

    for i, p in enumerate(prompts):
        engine.submit(GenerationRequest(prompt=p, max_new_tokens=256,
                                        request_id=f"prof{i}"))
    while True:                      # admissions and chunked prefills
        engine.step()
        m = engine.get_metrics()
        if not (m["prefilling_slots"] or m["waiting"]):
            break
    assert m["live_slots"] == len(prompts), m["live_slots"]
    engine.step()                    # a first pure-decode chunk
    torch.cuda.synchronize()
    before = engine.get_metrics()["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = engine.get_metrics()["decode_steps"] - before
    engine.abort_all()
    return report_profile(prof, wall, steps, label, card, share_of=share_of)


# --------------------------------------------------- graphs against eager


def graph_pool_bytes(torch, pool) -> int:
    """Bytes of the device memory segments of a graph memory pool
    (``torch.cuda.graph_pool_handle()``; 0 for None)."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def pair_run(torch, spec, params, prompts, label: str, card: str,
             profile_share=None, exact=False, **cfg):
    """``prompts`` (32 new tokens each, greedy) through two in-process
    engines of one configuration (8 slots, ``max_seq_len`` 1024 unless
    ``cfg`` says otherwise): one replaying CUDA graphs (the default), one
    through the engine's eager comparison hook. Holds the graph run's
    tokens equal to the eager run's and its launch counts equal too
    (each zeroed just before its run), printing the largest gap between
    the chosen tokens' logprobs where they are not bit-equal; prints the
    graphs' count, capture seconds and pool bytes. ``profile_share`` (kernel
    names, or ``()``): also each engine's decode ms per step and
    device-busy share over a profiled chunk. ``exact``: the logprobs
    must be bit-equal too. Returns the graph run's (results, launches,
    metrics, wall s)."""
    from distributed_inference_engine_tpu_torch.config import EngineConfig
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)
    from distributed_inference_engine_tpu_torch.ops import _cuda

    runs = {}
    for mode in ("eager", "graph"):
        engine = ContinuousEngine(spec, params=params, config=EngineConfig(
            **dict(dict(max_slots=8, max_seq_len=1024), **cfg)),
            device="cuda")
        engine._eager = mode == "eager"
        _cuda.reset_launch_counts()                  # this path starts here
        t0 = time.perf_counter()
        out = engine.generate([GenerationRequest(
            prompt=p, max_new_tokens=32, request_id=f"{label}{i}")
            for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _cuda.launch_counts()             # ... and ends here
        metrics = engine.get_metrics()
        check_results(out, prompts, f"{label} {mode}",
                      vocab=spec.vocab_size)
        pool = graph_pool_bytes(torch, engine._graph_pool)
        prof = None
        if profile_share is not None:
            prof = profile_decode(torch, engine, prompts, card,
                                  label=f"{label} decode, {mode}",
                                  share_of=profile_share)
        runs[mode] = dict(out=out, launches=launches, metrics=metrics,
                          wall=wall, pool=pool, prof=prof)
        del engine
        torch.cuda.empty_cache()
        done(f"pair {label} {mode}")
    e, g = runs["eager"], runs["graph"]
    for i, (a, b) in enumerate(zip(e["out"], g["out"])):
        assert a.tokens == b.tokens, (
            f"{label}: request {i} graph tokens differ from eager at "
            f"{next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)}")
    gap = max(abs(x - y) for a, b in zip(e["out"], g["out"])
              for x, y in zip(a.logprobs, b.logprobs))
    assert not exact or gap == 0, f"{label}: logprobs differ by {gap}"
    assert g["launches"] == e["launches"], (label, g["launches"],
                                            e["launches"])
    gm = g["metrics"]
    assert gm["cuda_graphs"] >= 1 and e["metrics"]["cuda_graphs"] == 0, gm
    gen = sum(len(r.tokens) for r in g["out"])
    caps = ", ".join(f"{k}: warm-up {w:.3f} s + capture {c:.3f} s"
                     for k, (w, c) in gm["graph_capture_s"].items())
    log(f"[graphs] {label}: graph tokens equal to eager ("
        f"{'bit-equal logprobs' if gap == 0 else f'largest logprob gap {gap:.3e}'}"
        f"); launches equal ({sum(g['launches'].values())}); {gen} tokens "
        f"in {g['wall']:.3f} s graph = {gen / g['wall']:.1f} tok/s, eager "
        f"{e['wall']:.3f} s = {gen / e['wall']:.1f} tok/s [{card}]")
    log(f"[graphs] {label}: {gm['cuda_graphs']} graphs ({gm['decode_programs']}"
        f" decode keys, {gm['mixed_programs']} mixed buckets): {caps}; "
        f"graph pool {g['pool'] / 2**20:.1f} MiB; warm-up launches "
        f"{gm['graph_warmup_launches']} [{card}]")
    if profile_share is not None:
        log(f"[graphs] {label}: decode {e['prof'][0]:.2f} ms/step "
            f"{e['prof'][1]:.1f}% busy eager -> {g['prof'][0]:.2f} ms/step "
            f"{g['prof'][1]:.1f}% busy graph [{card}]")
    return g["out"], g["launches"], gm, g["wall"]


def mixed_pair_line(torch, spec, params, prompts, card: str, label: str,
                    modes=("eager", "graph")) -> str:
    """``mixed_step_times`` through an eager engine and a graph one: the
    mean ms of a mixed step by bucket (prefill rows, chunk width), a step
    that captured its graph apart; the two runs' tokens equal."""
    parts = []
    tokens = {}
    for mode in modes:
        times, toks, m, pool = mixed_step_times(torch, spec, params, prompts,
                                                eager=mode == "eager")
        tokens[mode] = toks
        by = {}
        for key, ms, captured in times:
            by.setdefault(key, ([], []))[captured].append(ms)
        desc = []
        for key, (ran, caught) in sorted(by.items()):
            desc.append(f"{key[0]}x{key[1]}: "
                        + (f"{statistics.mean(ran):.1f} ms x{len(ran)}"
                           if ran else "no replay")
                        + (f" (with its capture {caught[0]:.1f})"
                           if caught else ""))
        if mode == "graph":
            assert m["cuda_graphs"] >= 1, m
            desc.append(f"{m['cuda_graphs']} graphs: " + ", ".join(
                f"{k}: warm-up {w:.3f} s + capture {c:.3f} s"
                for k, (w, c) in m["graph_capture_s"].items())
                + f"; pool {pool / 2**20:.1f} MiB")
        parts.append(f"{mode} " + "; ".join(desc))
    if len(tokens) == 2:
        assert tokens["eager"] == tokens["graph"], f"{label}: mixed tokens"
    return (f"{label} mixed steps by bucket (rows x width), admission step "
            f"apart: " + " | ".join(parts)
            + ("; tokens equal" if len(tokens) == 2 else ""))


def profile_mixed(torch, spec, params, prompts, card: str,
                  label: str = "mixed") -> None:
    """``--profile``: torch.profiler over up to three mixed steps of a
    bf16 ``pallas-ragged`` engine on ``params`` (bf16 or int4 weights; the
    mixed phase's configuration) while
    the long prompts of ``prompts`` prefill, the first mixed step (with
    the admission) unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_inference_engine_tpu_torch.config import EngineConfig
    from distributed_inference_engine_tpu_torch.engine.continuous import (
        ContinuousEngine)
    from distributed_inference_engine_tpu_torch.engine.types import (
        GenerationRequest)

    cfg = EngineConfig(max_slots=8, max_seq_len=1024,
                       attention_impl="pallas-ragged", prefill_chunk=256,
                       mixed_step_tokens=512)
    engine = ContinuousEngine(spec, params=params, config=cfg, device="cuda")
    for i, p in enumerate(prompts):
        engine.submit(GenerationRequest(prompt=p, max_new_tokens=32,
                                        request_id=f"pmix{i}"))
    engine.step()
    torch.cuda.synchronize()
    before = engine.get_metrics()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            if not engine.get_metrics()["prefilling_slots"]:
                break
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = engine.get_metrics()
    engine.run_until_idle()
    steps = after["mixed_steps"] - before["mixed_steps"]
    assert steps > 0 and steps == after["engine_steps"] - \
        before["engine_steps"], (before, after)
    tokens = after["mixed_prefill_tokens"] - before["mixed_prefill_tokens"]
    log(f"[profile] {label}: {tokens} prefill tokens over {steps} mixed "
        f"steps")
    report_profile(prof, wall, steps, label, card,
                   share_of=(("int4_wgmma_kernel",) if "int4" in label else ())
                   + ("ragged_mma_kernel",))
    del engine


# ------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the bf16 and int4 mixed steps and "
                    "time the int4 wgmma token tiles")
    ap.add_argument("--full-depth", action="store_true",
                    help=f"run the fp32 logit checks at every layer "
                    f"({N_LAYERS}; Qwen2-7B and Gemma-7B 28) instead of "
                    f"{CUT_LAYERS}")
    args = ap.parse_args()
    global FP32_LAYERS, FAMILY_FP32_LAYERS, MIXTRAL_FP32_LAYERS
    if args.full_depth:
        FP32_LAYERS = FAMILY_FP32_LAYERS = N_LAYERS
        MIXTRAL_FP32_LAYERS = CUT_LAYERS

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    from distributed_inference_engine_tpu_torch.ops import _cuda

    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | device {kind} x{torch.cuda.device_count()}")
    t0 = T0[0] = time.perf_counter()
    _cuda.build(verbose=True)
    rep = dict(_cuda.last_build)
    _cuda.lib()
    (_cuda.BUILD_DIR / "ptxas_report.txt").write_text(
        "\n".join(rep.get("reports", {}).values()))
    regs = [int(x) for txt in rep.get("reports", {}).values()
            for x in re.findall(r"Used (\d+) registers", txt)]
    spills = [int(x) for txt in rep.get("reports", {}).values()
              for x in re.findall(r"(\d+) bytes spill stores", txt)]
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(cached={rep.get('cached')}); registers max "
        f"{max(regs) if regs else 'n/a'}, spill stores max "
        f"{max(spills) if spills else 'n/a'}; each source's nvcc ended at "
        + ", ".join(f"{src} {sec:.1f} s" for src, sec in sorted(
            rep.get("source_seconds", {}).items(), key=lambda x: x[1])))
    for source, pattern, key in PTXAS_REPORTS:
        report = rep.get("reports", {}).get(source)
        if report:
            log(f"[build] {ptxas_summary(report, source, pattern, key)}")

    done("build")
    kern = phase_kernels(torch, card)
    torch.cuda.empty_cache()
    if args.profile:
        profile_int4_tiles(torch, card)
    done("kernels")
    # the worker phases first: each worker process has the card to itself
    # but for this process's kernel-phase leftovers (freed here)
    mixed_wave, mixed_launch, mixed_out = phase_mixed(torch, card)
    done("mixed")
    phase_ckpt(torch, card, mixed_out)
    done("ckpt")
    fp8_launch = phase_fp8(torch, card, mixed_out)
    del mixed_out
    done("fp8 and e5m2 worker")
    int4_wave, int4_served, int4_launch, probe, spec_runs = phase_int4(
        torch, card)
    done("int4, static and spec_async worker")
    prompts, results, serve_launch = phase_fleet(torch, card, probe)
    done("fleet (serve)")
    m_wave, m_served, mistral_launch = phase_mistral(torch, card)
    done("mistral worker")
    fam_served = phase_families(torch, card)
    done("qwen2-7b, gemma-7b and gpt2 worker")
    mx_waves, mixtral_run = phase_mixtral(torch, card)
    mixtral_launch = mixtral_run["launches"]
    done("mixtral worker")
    phase_mixtral_ckpt(torch, card, mx_waves)
    done("mixtral checkpoint")
    fused_launch, fw_launch = phase_fused(torch, card, prompts, results,
                                          mixed_wave, args.profile)
    done("fused and host")
    phase_int4_inproc(torch, card, int4_wave, int4_served, args.profile)
    torch.cuda.empty_cache()
    done("int4 in process")
    spec_launch = phase_spec_inproc(torch, card, list(mixed_prompts()),
                                    spec_runs)
    done("spec in process")
    phase_mistral_inproc(torch, card, m_wave, m_served)
    done("mistral in process")
    fp8_inproc = phase_fp8_inproc(torch, card)
    done("fp8 and e5m2 in process")
    fam_paths = phase_families_inproc(torch, card, fam_served)
    done("families in process")
    phase_mixtral_inproc(torch, card, mx_waves, mixtral_run)
    del mixtral_run
    done("mixtral in process")
    qwen_launch = fam_served["qwen2-7b"]["launches"]

    jax_ops = "distributed_inference_engine_tpu/ops/"
    # kernel: (source, TPU kernel it replaces, launches on its path); the
    # int4 matmul at the Mixtral expert shapes: the mixtral worker; the
    # fp8 and e5m2 instances' paths: the fp8 phase's worker (ragged,
    # flash-decode; e4m3, then e5m2), the in-process fw and Mistral runs
    # over each; the other families' instances (their
    # launches under the kernel's own count on their path): the qwen2-7b
    # worker (G 7 ragged and flash-decode), its in-process fp32 fw decode
    # and inline paged decode, and gemma-7b's inline paged decode (Dh 256)
    sources = {
        "flash_decode": ("csrc/flash_decode.cuh",
                         jax_ops + "flash_decode.py:246", serve_launch),
        "norm_matmul": ("csrc/fused_decode.cu",
                        jax_ops + "fused_decode.py:120", fused_launch),
        "matmul_residual": ("csrc/fused_decode.cu",
                            jax_ops + "fused_decode.py:165", fused_launch),
        "ragged_attention": ("csrc/ragged_attention.cuh",
                             jax_ops + "ragged_attention.py:181",
                             mixed_launch),
        "flash_decode_fw": ("csrc/flash_decode.cuh",
                            jax_ops + "flash_decode.py:314", fw_launch),
        "int4_matmul": ("csrc/int4_matmul.cu",
                        jax_ops + "int4_matmul.py:240", int4_launch),
        "paged_attention": ("csrc/paged_attention.cuh",
                            jax_ops + "paged_attention.py:112",
                            mistral_launch),
        "flash_decode.fp8": ("csrc/flash_decode_fp8.cu",
                             jax_ops + "flash_decode.py:246",
                             fp8_launch[FP8]),
        "flash_decode_fw.fp8": ("csrc/flash_decode_fp8.cu",
                                jax_ops + "flash_decode.py:314",
                                fp8_inproc[FP8]["fw"]),
        "ragged_attention.fp8": ("csrc/ragged_attention_fp8.cu",
                                 jax_ops + "ragged_attention.py:181",
                                 fp8_launch[FP8]),
        "paged_attention.fp8": ("csrc/paged_attention_fp8.cu",
                                jax_ops + "paged_attention.py:112",
                                fp8_inproc[FP8]["mistral"]),
        "flash_decode.e5m2": ("csrc/flash_decode_e5m2.cu",
                              jax_ops + "flash_decode.py:246",
                              fp8_launch[E5M2]),
        "flash_decode_fw.e5m2": ("csrc/flash_decode_e5m2.cu",
                                 jax_ops + "flash_decode.py:314",
                                 fp8_inproc[E5M2]["fw"]),
        "ragged_attention.e5m2": ("csrc/ragged_attention_fp8.cu",
                                  jax_ops + "ragged_attention.py:181",
                                  fp8_launch[E5M2]),
        "paged_attention.e5m2": ("csrc/paged_attention_fp8.cu",
                                 jax_ops + "paged_attention.py:112",
                                 fp8_inproc[E5M2]["mistral"]),
        "flash_decode.g7": ("csrc/flash_decode.cuh",
                            jax_ops + "flash_decode.py:246", qwen_launch),
        "flash_decode_fw.g7": ("csrc/flash_decode.cuh",
                               jax_ops + "flash_decode.py:314",
                               fam_paths["qwen2-7b fw"]),
        "ragged_attention.g7": ("csrc/ragged_attention.cuh",
                                jax_ops + "ragged_attention.py:181",
                                qwen_launch),
        "paged_attention.g7": ("csrc/paged_attention.cuh",
                               jax_ops + "paged_attention.py:112",
                               fam_paths["qwen2-7b inline"]),
        "paged_attention.dh256": ("csrc/paged_attention.cuh",
                                  jax_ops + "paged_attention.py:112",
                                  fam_paths["gemma-7b inline"]),
        "int4_matmul.moe": ("csrc/int4_matmul.cu",
                            jax_ops + "int4_matmul.py:240",
                            mixtral_launch),
        # the async verify step's ragged launches in the spec_async worker
        # (one a layer a verify step), and the speculative engine's wgmma
        # launches at the verify window's M 40 (A12)
        "ragged_attention.verify": (
            "csrc/ragged_attention.cuh", jax_ops + "ragged_attention.py:181",
            spec_runs["spec_async"]["launches_by_path"]),
        "int4_matmul.verify": ("csrc/int4_matmul.cu",
                               jax_ops + "int4_matmul.py:240", spec_launch)}
    # representative main-path shape per kernel: bf16, and for the GEMVs
    # the d_ff projections (gate/up for norm_matmul, down for residual,
    # gate|up at the 8 decode rows for int4); paged attention as Mistral
    # calls it (stacked pool, window 4096)
    pick = {"flash_decode": 0, "norm_matmul": 2, "matmul_residual": 1,
            "ragged_attention": 0, "flash_decode_fw": 0,
            "int4_matmul": INT4_MAIN, "paged_attention": PAGED_MAIN,
            "flash_decode.fp8": 0, "flash_decode_fw.fp8": 0,
            "ragged_attention.fp8": 0, "paged_attention.fp8": PAGED_MAIN,
            "flash_decode.e5m2": 0, "flash_decode_fw.e5m2": 0,
            "ragged_attention.e5m2": 0, "paged_attention.e5m2": PAGED_MAIN,
            "flash_decode.g7": 0, "flash_decode_fw.g7": 0,
            "ragged_attention.g7": 0, "paged_attention.g7": 0,
            "paged_attention.dh256": 0, "int4_matmul.moe": 0,
            "ragged_attention.verify": 0, "int4_matmul.verify": 2}
    kernels = []
    for name, (src, replaces, path_launches) in sources.items():
        rows = kern[name]
        r = rows[pick[name]]
        # an instance of another family counts under its kernel's name
        counter = name.split(".")[0] if name.endswith(
            (".g7", ".dh256", ".moe", ".verify")) else name
        launches = path_launches.get(counter, 0)
        assert launches > 0, f"{name}: never launched on its path"
        kernels.append({
            "name": name, "route": "cuda", "source": f"{PKG}/{src}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(x["err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "dtype": r["dtype"], **{"kv_dtype": kv for kv, (suffix, _, _)
                                    in KV8.items()
                                    if name.endswith(f".{suffix}")}})
    for name, fam in fam_served.items():
        log(f"[{name}] served {fam['tok_s']:.1f} tok/s, TTFT p50 "
            f"{fam['ttft_p50']:.3f} s [{card}]")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
