"""Chip smoke test of the torch port on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --kernels-only   # phases 1-3, no result line
    python3 chip_smoke.py --train-only     # phases 1-3 and 8, no result line
    python3 chip_smoke.py --moe-only       # phases 1-3 and 9, no result line
    python3 chip_smoke.py --recurrent-only # phases 1-3 and 10, no result line
    python3 chip_smoke.py --multimodal-only # phases 1-3 and 11, no result line
    python3 chip_smoke.py --tp-only        # phases 1-3 and 12, no result line
    python3 chip_smoke.py --roofline-only  # phases 1-3 and 13, no result line
    python3 chip_smoke.py --matrix-only    # phases 1-3 and 14, no result line
    python3 chip_smoke.py --train-families-only  # phases 1-3 and 15, likewise
    python3 chip_smoke.py --bench-only     # phases 1-3 and 16, no result line
    python3 chip_smoke.py --prefix-only    # phases 1-3 and 17, no result line

Phases, one line each; any failure raises and the script exits non-zero
without printing a result:

  1. device   -- the card's name and power limit (nvidia-smi) and torch's
                 name for it;
  2. build    -- nvcc builds the Hopper kernels (the five ports and the
                 fixed-order batched matmul) from
                 src/repro_torch/kernels/csrc/ (sm_90a) at first use, one
                 process per source, all started together;
  3. kernels  -- the wgmma probe first (``[wgmma_probe] equal=...``:
                 wgmma's k16 step bitwise mma.sync's, over 2^27 outputs,
                 kernels/wgmma_probe.py), and no spill in the wgmma
                 mainloop (wg_gemm.cuh: matmul above 96 rows, the batched
                 kernel's training tiles); then each kernel against its
                 plain PyTorch version at the
                 full-width deepseek-7b shapes of the serving paths,
                 of phase 8's train step and of phase 9's models (bf16,
                 plus one f32 case each), with its time, the plain
                 version's, a one-call PyTorch yardstick's where there is
                 one, and the card's bound for the same work; then the
                 determinism checks: two launches on the same inputs give
                 the same bits, and a probe row gives the same bits alone
                 and inside batches of 4, 64 and 512 rows (matmul,
                 rmsnorm, norm_matmul, swiglu), and for matmul in 16-bit
                 inside 96 to 4,224 rows, across the wgmma route's
                 threshold (at mixtral's wo too); the batched matmul (no
                 TPU kernel: the emitter's route for every other
                 floating contraction) at the paged decode's attention,
                 a 64-row prefill chunk's, deepseek-v3's expert FFN and
                 phase 8's backward products, with a probe (batch entry,
                 row) bitwise equal in batches of 1, 3, 4 and 32 at M of
                 1 to 64 (and in 16-bit at 65 to 4,224, the wgmma
                 mainloop, dX's B as (N, K) and dW's A as (K, M)), and
                 zero-padded K bitwise equal; one f32 order:
                 f32 matmul == the batched kernel, f32 swiglu == matmul of
                 its h and f32 norm_matmul == matmul of its normalised
                 rows, bitwise; swiglu called on two
                 inputs in turn gives each its own bits; for flash attention
                 two launches, a probe (slot, head) alone and inside 4
                 slots, and decode at position p against row p of the
                 dense prefill, for p in 0, 63, 64, 127 (and under a
                 sliding window, at mixtral's and recurrentgemma's heads,
                 for p on both sides of the window's edge); then the same
                 inside CUDA graphs: swiglu and norm_matmul (whose second
                 launch is the first one's programmatic dependent) on two
                 inputs in turn, and flash's prefill and decode rows,
                 replayed, give the eager bits; and the emitter's CumSum
                 (4 x 102400 f32, 20 runs) and ScatterAdd (10^5 updates
                 onto one row, 2 runs) give the same bits every run;
                 and the emitter's LinearRecurrence (torch ops, no
                 kernel of its own) at phase 10's prefill shapes, f32,
                 forward and reversed, within 1e-4 of the sequential
                 interpreter, bitwise across runs and for a row alone
                 and in a batch, with its time and bound;
  4. main     -- ServeEngine(mode="paged") at O2 with the kernels on
                 full-width deepseek-7b (30 layers, d_model 4096, vocab
                 102400, f32 params drawn on the card from a seed):
                 6 greedy requests, two sharing a 32-token prefix, run to
                 drain, once eagerly (static_jit=False) and once with the
                 dispatch captured as CUDA graphs (the default): the same
                 tokens bit for bit; the five kernels of this path (its
                 chunked prefill holds no Attention op; its attention
                 compositions take the batched kernel) must have
                 launched, and a replay's profile (the decode chunk and
                 a prefill chunk) must show each of them by name as often
                 as its counter says;
  5. flash    -- the same model and weights through
                 ServeEngine(mode="donated"): 4 greedy requests of 128
                 prompt tokens and 16 new ones, one dense prefill and one
                 fused 15-step chunk, so flash attention launches once per
                 layer and step (480 times); then the paged engine with a
                 dense prefill (prefill_chunk=0) on 2 requests, whose
                 prefills launch it too.  Each eagerly, then three times
                 captured (first calls, capture, replays): the same
                 tokens, and a replay's profile of the donated chunk and
                 of a dense prefill as in phase 4.  All five ported
                 kernels must launch (the donated path holds no other
                 contraction; the paged one also the batched kernel);
     sampled  -- 4 keyed requests at temperature 0.8 over the whole
                 vocabulary through the captured paged graphs, twice:
                 the same tokens;
  6. parity   -- reduced deepseek-7b with the same numpy weights and
                 prompts through the port on the card (kernels) and on the
                 CPU (plain versions): paged at d_head 64, and lockstep,
                 donated, continuous and paged with a dense prefill at
                 d_head 128 (flash attention on the card); f32 greedy
                 tokens must be identical;
  7. http     -- phase 4's engine shape and weights behind the HTTP front
                 door (ServeHTTPServer on 127.0.0.1, an ephemeral port,
                 wait queue 8), warmed by two direct runs so its graphs
                 are captured, then driven by loadgen from the main
                 thread: phase 4's six prompts and two more as 8
                 concurrent greedy streams on 4 slots, and a ninth client
                 that hangs up after 4 tokens (the client.disconnect_after_n
                 fault site).  Every stream must equal the direct engine's
                 tokens bit for bit; the disconnect is counted and
                 cancelled, the drain is clean (drain_ok, no page in use);
                 the five paged-path kernels launched; and the line
                 reports TTFT, inter-token gaps and sustained tok/s from
                 /v1/metrics beside the card's name and power limit.

  8. train    -- training (runs last, after phase 7's weights are
                 freed): deepseek-7b at full width with the depth cut to
                 4 layers (AdamW's f32 p, m and v of 30 layers exceed one
                 card), batch 4 x seq 512 of SyntheticLM (seed 0), f32
                 parameters, bf16 compute, the IR train step (autodiff +
                 AdamW) at O2 with the kernels, p, m and v donated.  Six
                 steps (eager first call, capture, four replays): losses
                 finite, all six kernels launched on every step (the
                 forward and the backward scan's recompute; the
                 batched kernel takes the backward's transposed
                 products) and none
                 refused, the state written back into the same tensors;
                 a replay's profile shows each kernel at its counted
                 launches.  The same six steps eagerly from the same
                 state: the same losses bit for bit.  The step without
                 the kernels (O1): the first loss within 3e-2 of scale.
                 A fresh backend over the same cache dir: the step from
                 disk (pipeline skipped), the first loss's bits.  Then
                 at phase 6's d_head-128 width in f32: five steps on the
                 card against the CPU (loss and state within 1e-4 of
                 scale), a checkpoint after step 3 restored into fresh
                 card tensors gives steps 4-5 bit for bit, the card's
                 checkpoint restores on the CPU bit for bit, an
                 autotune sweep of the prefill graph writes a valid
                 record that a fresh backend re-resolves with no sweep,
                 and five steps each with two microbatches and under
                 the WSD and constant schedules: captured == eager bit
                 for bit, card == CPU within the f32 state limits.
                 The lines report step ms (eager, capture, median
                 replay), tok/s, model TFLOP/s (6 x non-embedding
                 parameters x tokens per step) and its share of 989,
                 peak GB, launches per step, and compile seconds cold
                 against the disk hit.
  9. moe      -- the mixture-of-experts families (runs after phase 8,
                 whose graphs it frees) through ServeEngine(mode=
                 "lockstep") at O2 with the kernels, bf16 compute,
                 weights drawn on the card from seed 0, depth cut to 2
                 layers: mixtral-8x22b (f32 parameters) with 4 greedy
                 requests of 128 prompt tokens and 16 new ones, eager
                 and then captured, then one request of 4,224 tokens
                 and 8 new ones across its 4096-token window;
                 deepseek-v3-671b (bf16 parameters, one dense and one
                 MoE layer) with 4 requests of 64 tokens and 16 new
                 ones, eager and then captured.  Every request
                 completes, captured == eager bit for bit, each path's
                 kernels launched (mixtral: matmul, norm_matmul, rmsnorm,
                 flash; deepseek-v3: all five), flash exactly once a
                 layer and attention call it takes, nothing refused but
                 deepseek-v3's absorbed decode attention (576 wide, past
                 the kernel's 256), refused once a layer and step; a
                 replay's profile of each decode graph shows each kernel
                 at its counted launches.  Then both families at d_head
                 128 in f32 (flash on the card) with the builder's numpy
                 weights: the card's greedy tokens equal the CPU's.
 10. recurrent -- the recurrent families (runs after phase 9, whose
                 graphs it frees) through ServeEngine(mode="lockstep")
                 at O2 with the kernels, bf16 compute, f32 parameters
                 drawn on the card from seed 0: recurrentgemma-9b at
                 full width with the depth cut to 8 (two (rec, rec,
                 attn) groups and the two-rec tail) and xlstm-350m at
                 full width and depth, each with 4 greedy requests of
                 128 prompt tokens and 16 new ones, eager and then
                 captured (bit for bit), and recurrentgemma with one
                 request of 2,176 tokens and 8 new ones past its
                 2048-token window.  Each run launches exactly the
                 kernels serve.smoke_kernels names (recurrentgemma: all
                 five; xlstm: matmul, norm_matmul, rmsnorm) and refuses
                 none; flash launches once per attention layer and call;
                 a replay's profile of each decode graph shows each
                 kernel at its counted launches; every distinct shape
                 the runs gave a kernel is held against its plain
                 version; then both at a reduced f32 width (rg at d_head
                 128, flash on the card) with the builder's numpy
                 weights: the card's greedy tokens equal the CPU's.

 11. multimodal -- the multimodal families (runs after phase 10, whose
                 graphs it frees) through ServeEngine(mode="lockstep")
                 at O2 with the kernels, bf16 compute, f32 parameters
                 drawn on the card from seed 0: whisper-medium at full
                 width and depth (24 + 24 layers), 4 greedy requests of
                 64 prompt tokens and 16 new ones over 4 x 1500 stubbed
                 frames; llama-3.2-vision-11b at full width, at full
                 depth when the builder's census reckons its peak under
                 70 GB (else 20 layers), 4 requests of 128 tokens and 16
                 new ones over 1601 stubbed image tokens.  Each eagerly
                 and then captured (bit for bit); exactly the kernels
                 serve.smoke_kernels names launch (whisper: matmul and
                 flash; vlm: all five), none refused; flash once per
                 Attention op and call; a replay's profile of each
                 decode graph; every launched shape held against its
                 plain version; then both at a reduced f32 width whose
                 attention takes flash (whisper d_head 64, vlm 128,
                 gates open): the card's greedy tokens equal the CPU's.

 12. tp       -- tensor-parallel paged serving (runs after phase 11, whose
                 graphs it frees): deepseek-7b at full width, as deep as
                 the census reckons two shards' peak under 70 GB
                 (_reckon_tp_peak_gb), f32 parameters drawn on the card
                 from seed 0, bf16 compute, phase 4's engine shape and six
                 requests, two shards on the one card (an explicit mesh,
                 make_mesh((2,), ("model",), devices=["cuda", "cuda"])).
                 At O2 with the kernels (the main path) and at O1 with
                 the kernels (the sharded products at local width): tp=1
                 and tp=2, each eagerly and captured, give the same
                 tokens bit for bit; every pool drains (pages_in_use 0,
                 verify() clean, ref_allocs == ref_frees);
                 kv_bytes_per_device * 2 == pool.total_bytes; the path's
                 kernels launch (O2 the four paged ones, O1 matmul and
                 rmsnorm), a replay's profile shows each at its counted
                 launches, nothing refused; the partitioned chunk and
                 64-row prefill graphs' stats equal the reference pass's
                 on the same graphs (scripts/check_torch_parity.py
                 --kind tp, run beside the phase in a process of its
                 own); a cancel mid-prefill over a shared prefix moves
                 the pool at tp=2 as at tp=1.  [tp] lines: decode tok/s,
                 host and wall ms of a dispatch, steady decode tok/s,
                 peak GB; [tp_profile]: a captured dispatch's device ms
                 split into the kernels, cat (the AllGathers and the
                 outputs' joins) and copy (the inputs' splits, the bf16
                 converts, the pools' write-back), and the splits and
                 joins alone by CUDA events; every launched shape held
                 against its plain version ([tp_shapes]).
 13. roofline -- the IR cost model's roofline (launch/roofline.py, the
                 H100 data-sheet constants) read against the card (runs
                 last): phase 4's engine again, its decode chunk's
                 compute, memory and collective terms against the
                 median of 7 CUDA-event replays of the captured
                 dispatch (its launches equal phase 4's), the memory
                 plan against one eager dispatch's peak; phase 8's
                 train step the same way, its MFU equal to phase 8's to
                 1% (run alone, to its own host-timed replays'); phase
                 12's O2 chunk graph at tp=2, its collective census
                 (the AllGather nodes equal the pass's stats) beside
                 phase 12's measured dispatch and cat ms.  Every term
                 finite; a fraction max(t_*) / measured above 1.05
                 fails, naming the top ops of the cost.  [roofline]
                 lines.
 14. matrix   -- the serving matrix (runs last, after phase 13's graphs
                 are freed): scripts/torch_serving_matrix.py's eight
                 legs (donated, continuous, paged, the shared-prefix
                 pair with sharing off and on, paged at tp=2 with both
                 shards on the card, the HTTP front door fed by four
                 tagged concurrent clients then drained, and the chaos
                 probe in a process of its own, reduced) through the
                 serve CLI's own path and report, on deepseek-7b at full
                 width, as deep as phase 12's reckoning allows two
                 shards (one f32 weight draw from seed 0 for every leg),
                 at O2 with the kernels, first in f32, then the seven
                 engine legs in bf16.  In f32 the unchanged
                 scripts/check_serving_matrix.py must pass the eight
                 reports (greedy parity across the legs, no page
                 leaked, paged under continuous in KV bytes, COW on the
                 shared pair, tp=2's halved KV bytes, a clean drain,
                 every chaos scenario).  In bf16 the paged-form legs
                 (paged, paged tp=2 and the front door; the shared pair)
                 must agree token for token per request
                 ([matrix_bf16_paged_parity]: their contractions take the
                 fixed-order kernels); donated and continuous prefill
                 through flash, a form that rounds apart from the IR
                 compositions, so the checker may fail them on greedy
                 parity alone; every split it reports is found and
                 measured: a prefill of the prompt and the agreed
                 tokens in bf16 and in f32 gives each leg's pick in
                 bf16 units below the top logit ([matrix_tie] lines; a
                 split within one unit is counted a tie).  In
                 both runs each engine leg launched the kernels
                 serve.smoke_kernels names for it (flash in the donated
                 and continuous legs), none refused, all six across
                 the legs, and every launched shape is held against its
                 plain version.  [matrix] lines: each leg's tok/s, TTFT
                 p50/p95, KV bytes per active token, peak GB, seconds;
                 [matrix_prefill] lines: the prompt prefill (4 x 32 and
                 1 x 32 rows) in each compute type, its wall ms and its
                 profiled device ms by kernel.
 15. train_families -- the six non-dense families train on the card (runs
                 last, each family's graphs and state freed before the
                 next): mixtral-8x22b, deepseek-v3-671b, recurrentgemma-9b,
                 xlstm-350m, whisper-medium and llama-3.2-vision-11b at
                 published widths, each as deep as the train builder's
                 census reckons its peak under 70 GB
                 (_reckon_train_peak_gb: p, g, m, v, the bf16 casts, the
                 experts' f32 copies, the logits and their gradient, the
                 frames or images) and the emitted plan's walk agrees
                 (_plan_peak_gb); deepseek-v3 its dense prefix and MTP
                 head (one MoE layer's state exceeds a card).  Batch 4 x
                 512 of SyntheticLM (whisper 4 x 448, its decoder's
                 context), frames and images from the trainer's
                 step_data, f32 parameters drawn on the card, bf16
                 compute, the IR train step at O2 with the kernels, p, m
                 and v donated.  Four steps (eager, capture, two
                 replays): losses finite, every kernel serve.smoke_kernels
                 names launched on every step and none refused, the state
                 written back into the same tensors; a replay's profile
                 shows each kernel at its counted launches; the same four
                 steps eagerly give the same losses bit for bit; every
                 launched shape is held against its plain version; whisper
                 checkpointed after two steps and restored into fresh card
                 tensors gives steps 3-4 bit for bit; and each family at a
                 reduced f32 width (phases 9-11's, flash on the card) five
                 steps on the card against the CPU, loss, moments and
                 update norm within 1e-4, the update's direction within
                 1e-2 (the CPU tests' bound for the port against JAX:
                 AdamW turns a gradient element within rounding of zero
                 into an update of +-lr).  [train_family] lines: depth
                 and why, parameters,
                 reckoned and measured peak GB, step ms (eager, capture,
                 median replay), tok/s, model TFLOP/s and its share of
                 989, launches per step, the card.
 16. bench    -- the benchmark harness (runs last, after phase 15's
                 graphs are freed): a dry-run cell (xlstm-350m
                 decode_32k) for the scaling section, then
                 scripts/torch_bench_to_json.py's snapshot of all 18
                 sections of scripts/torch_bench.py on deepseek-7b at
                 published widths, 4 layers, O2 with the kernels
                 (results/bench_torch.json, its CSV beside it), and its
                 --check: every parity row 1, every section's kernel
                 rows launched and none refused but the kernels
                 section's one refusal probe, all six kernels
                 launched, every launched shape held against its plain
                 version.  [bench] lines: each section's seconds and
                 launches; [bench_bf16_forms]: the cross-form parity
                 comparisons in bf16, recorded beside their f32 gates.
 17. prefix   -- one request's greedy tokens across graph shapes (runs
                 last): scripts/torch_prefix_shapes.py's legs (E16's
                 32-token prompt, page 4, 8 new tokens) on deepseek-7b at
                 published widths, 4 layers, O2 with the kernels,
                 eagerly, in bf16 and in f32: three slots, then one slot
                 at prefill chunks 16, 5, 8 and 32 must give the same
                 tokens and bit-identical first-decode-step logits; the
                 dense leg (chunk 0, another form) is printed, not held.
                 While the legs run, torch.einsum is wrapped and no call
                 on CUDA float operands may reach it (the integer one-hot
                 picks' f64 products are counted apart).  [prefix_shapes]
                 lines per leg, launches per kernel.

In phases 4, 5, 7, 8, 9, 10, 11, 12, 14, 15, 16 and 17 no kernel may have been refused
at full width, but phase 9's counted deepseek-v3 decode attention.
Phase 6 and phase 8's reduced width count their refusals but do not gate
them: the reduced vocabulary (257) is no whole number of 16-byte
vectors, so the matmul kernel refuses the unembed there, as the
reference's fallback rule says, and the batched kernel takes it.  Then one JSON line with
every kernel's numbers, the card's name and power limit, and the result
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense tensor core / f32 CUDA core
# a kernel's max |kernel - plain| over the scale max(max |plain|, 1):
# 16-bit, two units in the last place at the scale (a kernel whose f32
# sum differs from the plain version's only in order rounds at most one
# unit apart); f32, 1e-4
TOL = {torch.bfloat16: 2 * 2.0 ** -7, torch.float16: 2 * 2.0 ** -10,
       torch.float32: 1e-4}
D, F, V, SLOTS, CHUNK, DH, HEADS = 4096, 11008, 102400, 4, 64, 128, 32
DENSE = 512   # rows of the donated dense prefill (4 prompts x 128)
MX_PROMPT, MX_LONG, V3_PROMPT = 128, 4224, 64
V3_ROWS = SLOTS * V3_PROMPT   # deepseek-v3's prefill rows (4 x 64)
# phase 10: 4 x 128 prompt tokens and 16 new ones for both recurrent
# families; rg's long request, past its 2048-token window
REC_PROMPT, REC_NEW, RG_LONG, RG_LONG_NEW = 128, 16, 2176, 8
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:20",
    "norm_matmul": "src/repro/kernels/norm_matmul.py:21",
    "swiglu": "src/repro/kernels/swiglu.py:22",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:18",
    "flash_attention": "src/repro/kernels/flash_attention.py:41",
    # no TPU kernel: the reference's XLA lax.dot_general; repairs Queue 3
    "batched_matmul": "none (src/repro/transformers/jax_backend.py:254, "
                      "XLA's lax.dot_general; repairs ROADMAP Queue 3)",
}
# the kernels each serving path must launch: the paged path's chunked
# prefill and decode attend through IR compositions, whose contractions
# take the batched kernel; the donated path holds an Attention op at
# d_head 128 and no other contraction
PAGED_KERNELS = ("matmul", "norm_matmul", "swiglu", "rmsnorm",
                 "batched_matmul")
PORTED_KERNELS = ("matmul", "norm_matmul", "swiglu", "rmsnorm",
                  "flash_attention")
ALL_KERNELS = PORTED_KERNELS + ("batched_matmul",)
# what phases 8 and 12 measured, for phase 13 to read its meter against
READINGS: dict = {}
# the wgmma mainloop of matmul, norm_matmul's product and swiglu's two
# launches (above ops.WG_MIN_ROWS rows) and of the batched kernel's
# training tiles, and its device kernels' tags
WG_SOURCE = "src/repro_torch/kernels/csrc/wg_gemm.cuh"
WG_TAGS = {"matmul": ("matmul_wg",), "batched_matmul": ("bmm_wg",),
           "norm_matmul": ("norm_matmul_wg",),
           "swiglu": ("swiglu_gate_up_wg", "swiglu_down_wg")}
# (kernel, case label) -> "wgmma" for the cases the plans send there
ROUTE_OF: dict = {}
# (kernel, case label) -> matmul's launches on the same product(s), for
# norm_matmul's and swiglu's wgmma cases (``matmul_route_ms``)
MATMUL_ROUTE: dict = {}
# flash's wgmma prefill and its split mma.sync launch are in its own source
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH16_FUNCS = ("flash_wg_kernel", "flash_tc_kernel", "flash_combine_kernel")


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- 1. device -----------------------------------------------------------------
def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", smi=repr(smi), torch=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    return smi


# -- 2. build --------------------------------------------------------------------
def _spills(log: str) -> list:
    """The kernels that ptxas -v reports spilling, each with its line."""
    spills, entry = [], ""
    for ln in log.splitlines():   # ptxas -v: entry name, then its spills
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln and not ln.strip().startswith("0 bytes"):
            spills.append(f"{entry[:160]}: {ln.strip()}")
    return spills


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.lib()
    secs = time.perf_counter() - t0
    log = "\n".join(_build.build_log)
    spills = _spills(log)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.BUILD_DIR, "ptxas.log"), "w") as f:
        f.write(log)
    say("build", seconds=f"{secs:.2f}", sources=len(_build.sources()),
        library=os.path.basename(lib._name), spilling_kernels=len(spills),
        spills=json.dumps(spills))


# -- 3. kernels ------------------------------------------------------------------
def _events_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events and each preceded by a write of ``flush`` (larger than the
    50 MB L2), so the weights come from device memory as they do on the
    serving path, where each layer's weights are new.  The write keeps
    the card busy (~0.15 ms) while the host enqueues the launch, so the
    events time the device's work, not the wrapper's Python."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _bound(nbytes: int, flops: int, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rand(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _case_makers(gen, cases: list):
    """One builder per kernel; each draws a case's inputs from ``gen`` and
    appends ``(kernel, label, kernel_fn, plain_fn, library_fn, bytes,
    flops, dtype)`` to ``cases``.  Bytes count each input read once and
    the output written once (for attention, the K/V rows the mask lets
    some query see); flops count what the case's inputs need."""
    from repro_torch.kernels import matmul as km, norm_matmul as kn
    from repro_torch.kernels import rmsnorm as kr, swiglu as ks
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import batched_matmul as kb
    from repro_torch.kernels import ops, ref
    import torch.nn.functional as Fn
    bf, f32 = torch.bfloat16, torch.float32

    def mm(label, M, K, N, dt):
        a = _rand((M, K), dt, gen)
        b = _rand((K, N), dt, gen, K ** -0.5)
        s = a.element_size()
        if ops.matmul_plan(M, K, N, dt).route == "wgmma":
            ROUTE_OF["matmul", label] = "wgmma"
        cases.append(("matmul", label, lambda: km.matmul(a, b),
                      lambda: ref.matmul_ref(a, b), lambda: torch.matmul(a, b),
                      (M * K + K * N + M * N) * s, 2 * M * K * N, dt))

    def nm(label, M, N, g_dt, K=D, dt=bf, eps=1e-6):
        x = _rand((M, K), dt, gen)
        g = (1 + 0.1 * _rand((K,), f32, gen)).to(g_dt)
        w = _rand((K, N), dt, gen, K ** -0.5)
        if ops.norm_matmul_plan(M, K, N, dt, g_dt).route == "wgmma":
            ROUTE_OF["norm_matmul", label] = "wgmma"
            MATMUL_ROUTE["norm_matmul", label] = lambda: km.matmul(x, w)
        cases.append(("norm_matmul", label,
                      lambda: kn.norm_matmul(x, g, w, eps),
                      lambda: ref.norm_matmul_ref(x, g, w, eps), None,
                      (M * K + K * N + M * N) * x.element_size()
                      + K * g.element_size(),
                      2 * M * K * N + 4 * M * K, dt))

    def sw(label, M, dt, d=D, f=F):
        x = _rand((M, d), dt, gen)
        wg = _rand((d, f), dt, gen, d ** -0.5)
        wu = _rand((d, f), dt, gen, d ** -0.5)
        wd = _rand((f, d), dt, gen, f ** -0.5)
        s = x.element_size()
        if ops.swiglu_plan(M, d, f, d, dt).route == "wgmma":
            ROUTE_OF["swiglu", label] = "wgmma"
            h = _rand((M, f), dt, gen)
            MATMUL_ROUTE["swiglu", label] = lambda: (
                km.matmul(x, wg), km.matmul(x, wu), km.matmul(h, wd))
        cases.append(("swiglu", label, lambda: ks.swiglu(x, wg, wu, wd),
                      lambda: ref.swiglu_ref(x, wg, wu, wd), None,
                      (M * d + 3 * d * f + M * d) * s,
                      6 * M * d * f + 4 * M * f, dt))

    def rn(label, M, w_dt, d=D, dt=bf, eps=1e-6):
        x = _rand((M, d), dt, gen)
        w = (1 + 0.1 * _rand((d,), f32, gen)).to(w_dt)
        lib = (lambda: Fn.rms_norm(x, (d,), w, eps)) if w_dt == dt else None
        cases.append(("rmsnorm", label, lambda: kr.rmsnorm(x, w, eps),
                      lambda: ref.rmsnorm_ref(x, w, eps), lib,
                      2 * M * d * x.element_size() + d * w.element_size(),
                      4 * M * d, dt))

    def fa(label, B, Hq, Hkv, Sq, Skv, off, dt, dk=DH, dv=DH, window=None,
           causal=True, scale=None):
        q = _rand((B, Hq, Sq, dk), dt, gen)
        k = _rand((B, Hkv, Skv, dk), dt, gen)
        v = _rand((B, Hkv, Skv, dv), dt, gen)
        o = None if off is None else torch.tensor(off, dtype=torch.int32,
                                                  device="cuda")
        # the mask on absolute positions: what this case lets through
        vis = ref.attention_mask(Sq, Skv, causal=causal, window=window,
                                 q_offset=off, device="cuda")
        pairs = int(vis.sum())
        rows = int(vis.any(0).sum())   # K/V rows some query sees
        s = q.element_size()
        if ops.flash_plan(q.shape, k.shape, v.shape, dt).route == "wgmma":
            ROUTE_OF["flash_attention", label] = "wgmma"
        # the one-call yardstick: SDPA over repeated kv heads (repeated
        # here, outside the timed call), is_causal where top-left
        # alignment is the mask, else the boolean mask
        kr_, vr_ = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
        if off is None and window is None and causal:
            lib = lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                q, kr_, vr_, is_causal=True, scale=scale)
        else:
            lib = lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                q, kr_, vr_, attn_mask=vis, scale=scale)
        cases.append(("flash_attention", label,
                      lambda: kf.flash_attention(q, k, v, causal=causal,
                                                 window=window, scale=scale,
                                                 q_offset=o),
                      lambda: ref.flash_attention_ref(
                          q, k, v, causal=causal, window=window,
                          scale=scale, q_offset=o),
                      lib, (B * Hq * Sq * (dk + dv)
                            + B * Hkv * rows * (dk + dv)) * s,
                      2 * B * Hq * pairs * (dk + dv), dt))

    def bm(label, batch, M, N, K, dt, a_t=False, b_t=False, out=f32):
        # A as (K, M) and B as (N, K) where transposed: strided views, as
        # the emitter hands them over; the yardstick is torch.bmm on the
        # same operands (f32 with TF32 off, or the 16-bit type's cuBLAS
        # GEMM, which rounds its output to that type)
        a = _rand((batch, K, M), dt, gen).transpose(1, 2) if a_t else \
            _rand((batch, M, K), dt, gen)
        b = (_rand((batch, N, K), dt, gen, K ** -0.5).transpose(1, 2)
             if b_t else _rand((batch, K, N), dt, gen, K ** -0.5))
        s = a.element_size()
        if ops.batched_matmul_plan(batch, M, N, K, dt, a_t, b_t).kernel == \
                "wg_gemm_kernel":
            ROUTE_OF["batched_matmul", label] = "wgmma"
        cases.append(("batched_matmul", label,
                      lambda: kb.batched_matmul(a, b, out),
                      lambda: ref.batched_matmul_ref(a, b, out),
                      lambda: torch.bmm(a, b),
                      batch * (M * K + K * N) * s
                      + batch * M * N * torch.empty((), dtype=out)
                      .element_size(),
                      2 * batch * M * N * K, dt))

    return mm, nm, sw, rn, fa, bm


def kernel_cases(gen):
    """The cases (:func:`_case_makers`) at the shapes the serving paths
    and phase 8's train step give each kernel: decode (4 slots) first --
    the case the result line reports -- then prefill (a 64-row chunk, or
    a dense prefill for attention), the f32 case, the train step's 2048
    rows, and phase 9's full-width shapes (phase 9 also holds every
    shape its runs launch, :func:`_launched_cases`)."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    mm, nm, sw, rn, fa, bm = _case_makers(gen, cases)
    # the fixed-order batched kernel: the paged decode's q.k^T (4 slots x
    # 32 kv heads, one query row, over 256 keys of the cache read as (N,
    # K)) first -- the case the result line reports -- then its p.V, a
    # 64-row prefill chunk's scores (f32) and p.V (bf16, p rounded to the
    # cache's type), deepseek-v3's expert FFN at decode (256 experts x 8
    # rows) and phase 8's backward products (dX against a transposed
    # weight, dW from a transposed activation, attention's f32 scores)
    bm("paged decode q.k^T (128x1x128)@(128x128x256)", SLOTS * HEADS, 1,
       256, DH, f32, b_t=True)
    bm("paged decode p.V (128x1x256)@(128x256x128)", SLOTS * HEADS, 1, DH,
       256, f32)
    bm(f"prefill chunk q.k^T (32x{CHUNK}x128)@(32x128x256)", HEADS, CHUNK,
       256, DH, f32, b_t=True)
    bm(f"prefill chunk p.V (32x{CHUNK}x256)@(32x256x128) bf16", HEADS,
       CHUNK, DH, 256, bf, out=bf)
    bm("sampler pick (4x1x102400)@(4x102400x1) f32", SLOTS, 1, 1, V, f32)
    # the paged write's one-hot product: phase 4's pool of 1 + 4 x 16
    # pages of 16 rows, the slots' mask read as (K, M), their new rows
    P = 1 + SLOTS * (MAIN_ENGINE["max_len"] // MAIN_ENGINE["page_size"])
    bm(f"paged write one-hot (1x{P * MAIN_ENGINE['page_size']}x{SLOTS})@"
       f"(1x{SLOTS}x{D}) bf16, A as (K, M)", 1,
       P * MAIN_ENGINE["page_size"], D, SLOTS, bf, a_t=True, out=bf)
    mm("decode wo (4x4096)@(4096x4096)", SLOTS, D, D, bf)
    mm("prefill wo (64x4096)@(4096x4096)", CHUNK, D, D, bf)
    mm("prefill unembed (1x4096)@(4096x102400)", 1, D, V, bf)
    mm("dense prefill (512x4096)@(4096x4096)", DENSE, D, D, bf)
    # the wgmma route's fewest rows (ops.WG_MIN_ROWS + 1)
    mm("prefill (97x4096)@(4096x4096), the wgmma route's fewest rows", 97,
       D, D, bf)
    mm("f32 (4x4096)@(4096x4096)", SLOTS, D, D, f32)
    # the f32 route's arrangements: register tiles at a prefill's rows (a
    # 32-token prompt, 4 x 16 and 4 x 32: phase 14's f32 prefill), the
    # chunk lanes over the unembed's 102400 columns
    for m in F32_PREFILL_ROWS:
        mm(f"f32 prefill ({m}x4096)@(4096x4096)", m, D, D, f32)
    mm("f32 prefill unembed (1x4096)@(4096x102400)", 1, D, V, f32)
    nm("decode qkv (4x4096)(4096x4096)", SLOTS, D, bf)
    nm("decode final+unembed (4x4096)(4096x102400) g f32", SLOTS, V, f32)
    nm("prefill qkv (64x4096)(4096x4096)", CHUNK, D, bf)
    nm("dense prefill qkv (512x4096)(4096x4096)", DENSE, D, bf)
    # the f32 routes of norm_matmul and swiglu (matmul's f32 launch after
    # a row kernel, or after the paired gate/up kernel) at decode and at
    # phase 14's f32 prefill rows
    nm("f32 decode qkv (4x4096)(4096x4096)", SLOTS, D, f32, dt=f32)
    for m in F32_PREFILL_ROWS:
        nm(f"f32 prefill qkv ({m}x4096)(4096x4096)", m, D, f32, dt=f32)
    sw("decode (4x4096) F=11008", SLOTS, bf)
    sw("prefill (64x4096) F=11008", CHUNK, bf)
    sw("dense prefill (512x4096) F=11008", DENSE, bf)
    sw("f32 decode (4x4096) F=11008", SLOTS, f32)
    for m in F32_PREFILL_ROWS:
        sw(f"f32 prefill ({m}x4096) F=11008", m, f32)
    rn("decode pre-MLP (4x4096)", SLOTS, bf)
    rn("prefill final (64x4096) w f32", CHUNK, f32)
    rn("dense prefill (512x4096)", DENSE, bf)
    fa("decode (4x32x1) over 256 keys at pos 255", SLOTS, HEADS, HEADS, 1,
       256, 255, bf)
    fa("decode (4x32x1) over 256 keys at pos 63", SLOTS, HEADS, HEADS, 1,
       256, 63, bf)
    fa("dense prefill (4x32x128) causal", SLOTS, HEADS, HEADS, 128, 128,
       None, bf)
    fa("paged-dense prefill (1x32x100) causal", 1, HEADS, HEADS, 100, 100,
       None, bf)
    fa("f32 decode (4x32x1) at pos 255", SLOTS, HEADS, HEADS, 1, 256, 255,
       f32)
    # the f32 route (CUDA cores): phase 14's three launched shapes (the
    # decode step over a 64-row cache, the prompt prefills of 1 and 4
    # slots), phase 16's reduced-width prefill, and the families' shapes:
    # qwen1.5-110b's GQA decode, a 128-token prefill, whisper's
    # cross-attention (Dk 64, 1500 frames, no mask), MLA's Dk 192 / Dv 128
    # prefill (deepseek-v3's heads) and recurrentgemma's windowed MQA
    # decode (Dk 256, past its 2048-token window)
    fa("f32 decode (4x32x1) over 64 keys at pos 63 (phase 14)", SLOTS,
       HEADS, HEADS, 1, 64, 63, f32)
    fa("f32 prompt prefill (1x32x32) causal (phase 14)", 1, HEADS, HEADS, 32,
       32, None, f32)
    fa("f32 prompt prefill (4x32x32) causal (phase 14)", SLOTS, HEADS, HEADS,
       32, 32, None, f32)
    fa("f32 GQA decode Hq 64 Hkv 8 (qwen1.5-110b) at pos 255", SLOTS, 64, 8,
       1, 256, 255, f32)
    fa("f32 prefill (4x32x128) causal", SLOTS, HEADS, HEADS, 128, 128, None,
       f32)
    fa("f32 prefill (1x2x256) causal (phase 16)", 1, 2, 2, 256, 256, None,
       f32)
    fa("f32 cross-attention (4x16x64) Dk 64 over 1500 keys, no mask "
       "(whisper-medium)", SLOTS, 16, 16, 64, 1500, None, f32, dk=64, dv=64,
       causal=False)
    fa("f32 MLA prefill (4x128x64) Dk 192 Dv 128 causal (deepseek-v3)",
       SLOTS, 128, 128, 64, 64, None, f32, dk=192, dv=128)
    fa(f"f32 windowed decode (1x16x1) MQA 16:1 Dk 256 at pos "
       f"{RG_LONG + RG_LONG_NEW - 1} window 2048 (recurrentgemma-9b)", 1, 16,
       1, 1, RG_LONG + RG_LONG_NEW, RG_LONG + RG_LONG_NEW - 1, f32, dk=256,
       dv=256, window=2048)
    fa("GQA decode Hq 64 Hkv 8 (qwen1.5-110b) at pos 255", SLOTS, 64, 8, 1,
       256, 255, bf)
    # more (slot, kv head) pairs than SMs: 512 decode blocks (and the f32
    # route's 512 slots' heads)
    fa("decode (16x32x1) over 256 keys at pos 255", 16, HEADS, HEADS, 1, 256,
       255, bf)
    fa("f32 decode (16x32x1) over 256 keys at pos 255", 16, HEADS, HEADS, 1,
       256, 255, f32)
    # phase 8's train step: 4 x 512 tokens, forward and recompute
    T = TRAIN_BATCH * TRAIN_SEQ
    mm(f"train q/k/v/o ({T}x4096)@(4096x4096)", T, D, D, bf)
    nm(f"train ({T}x4096)(4096x4096)", T, D, bf)
    nm(f"train ({T}x4096)(4096x11008)", T, F, bf)
    nm(f"train final+unembed ({T}x4096)(4096x102400) g f32", T, V, f32)
    sw(f"train ({T}x4096) F=11008", T, bf)
    bm(f"train dX ({T}x4096)@(4096x4096)^T", 1, T, D, D, bf, b_t=True,
       out=bf)
    bm(f"train dW ({T}x4096)^T@({T}x11008)", 1, D, F, T, bf, a_t=True,
       out=bf)
    bm(f"train attention scores ({TRAIN_BATCH * HEADS}x{TRAIN_SEQ}x128)@"
       f"(..x128x{TRAIN_SEQ}) f32", TRAIN_BATCH * HEADS, TRAIN_SEQ,
       TRAIN_SEQ, DH, f32, b_t=True)
    # phase 15's xlstm: the sLSTM scan's backward, ~12,000 a step
    bm("xlstm sLSTM backward (4x4x1024)@(4x1024x256) f32", 4, 4, 256, 1024,
       f32)
    rn(f"train ({T}x4096)", T, bf)
    fa(f"train ({TRAIN_BATCH}x32x{TRAIN_SEQ}) causal", TRAIN_BATCH, HEADS,
       HEADS, TRAIN_SEQ, TRAIN_SEQ, None, bf)
    # phase 9's full-width shapes, from the two configs
    from repro_torch.configs import get_config
    mx, v3 = get_config("mixtral-8x22b"), get_config("deepseek-v3-671b")
    mm(f"moe router f32 ({SLOTS}x{mx.d_model})@({mx.d_model}x"
       f"{mx.n_experts}) (mixtral)", SLOTS, mx.d_model, mx.n_experts, f32)
    mm(f"moe router f32 ({MX_LONG}x{mx.d_model})@({mx.d_model}x"
       f"{mx.n_experts}) (mixtral's long prefill)", MX_LONG, mx.d_model,
       mx.n_experts, f32)
    # mixtral's wo at its 4,224-token prefill (phase 9) and rg's
    # 2,176-token product (phase 10): the compute-bound 16-bit shapes
    mm(f"mixtral wo ({MX_LONG}x{mx.d_model})@({mx.d_model}x{mx.d_model}) "
       f"(mixtral's long prefill)", MX_LONG, mx.d_model, mx.d_model, bf)
    mm(f"rg ({RG_LONG}x4096)@(4096x4096) (recurrentgemma-9b's long "
       f"prefill)", RG_LONG, D, D, bf)
    kv_a = v3.kv_lora + v3.d_rope
    mm(f"moe wkv_a ({V3_ROWS}x{v3.d_model})@({v3.d_model}x{kv_a}) "
       f"(deepseek-v3)", V3_ROWS, v3.d_model, kv_a, bf)
    nq = v3.n_heads * (v3.d_nope + v3.d_rope)
    nm(f"moe wq_b ({V3_ROWS}x{v3.q_lora})({v3.q_lora}x{nq}) (deepseek-v3)",
       V3_ROWS, nq, bf, K=v3.q_lora)
    bm(f"moe expert FFN up ({v3.n_experts}x8x{v3.d_model})@(..x"
       f"{v3.d_model}x{v3.expert_d_ff}) (deepseek-v3)", v3.n_experts, 8,
       v3.expert_d_ff, v3.d_model, bf, out=bf)
    bm(f"moe expert FFN down ({v3.n_experts}x8x{v3.expert_d_ff})@(..x"
       f"{v3.expert_d_ff}x{v3.d_model}) (deepseek-v3)", v3.n_experts, 8,
       v3.d_model, v3.expert_d_ff, bf, out=bf)
    for f, what in ((v3.d_ff, "dense MLP"), (v3.expert_d_ff,
                                             "shared expert")):
        for m in (SLOTS, V3_ROWS):
            sw(f"moe {what} ({m}x{v3.d_model}) F={f} (deepseek-v3)", m, bf,
               d=v3.d_model, f=f)
    dk = v3.d_nope + v3.d_rope
    fa(f"moe MLA prefill ({SLOTS}x{v3.n_heads}x{V3_PROMPT}) Dk {dk} Dv "
       f"{v3.d_v} causal (deepseek-v3)", SLOTS, v3.n_heads, v3.n_heads,
       V3_PROMPT, V3_PROMPT, None, bf, dk=dk, dv=v3.d_v)
    fa(f"moe prefill (1x{mx.n_heads}x{MX_LONG}) GQA {mx.n_heads}:"
       f"{mx.n_kv_heads} window {mx.window} (mixtral)", 1, mx.n_heads,
       mx.n_kv_heads, MX_LONG, MX_LONG, None, bf, window=mx.window)
    fa(f"moe decode (1x{mx.n_heads}x1) at pos {MX_LONG - 1} GQA "
       f"{mx.n_heads}:{mx.n_kv_heads} window {mx.window} (mixtral)", 1,
       mx.n_heads, mx.n_kv_heads, 1, MX_LONG, MX_LONG - 1, bf,
       window=mx.window)
    # 64-wide heads, which the emitter offers flash too (minicpm-2b)
    mc = get_config("minicpm-2b")
    fa(f"d_head {mc.head_dim} decode ({SLOTS}x{mc.n_heads}x1) at pos 255 "
       f"(minicpm-2b)", SLOTS, mc.n_heads, mc.n_kv_heads, 1, 256, 255, bf,
       dk=mc.head_dim, dv=mc.head_dim)
    fa(f"d_head {mc.head_dim} prefill ({SLOTS}x{mc.n_heads}x128) causal "
       f"(minicpm-2b)", SLOTS, mc.n_heads, mc.n_kv_heads, 128, 128, None, bf,
       dk=mc.head_dim, dv=mc.head_dim)
    # the wgmma route's other head-width classes (64; MLA's 192 / 128),
    # and ragged edges there: Dk 40, Dk 72 with Dv 56, Skv no multiple of
    # 64, Sq no multiple of the row tile, rows across chunks
    fa(f"d_head {mc.head_dim} prefill (2x{mc.n_heads}x300) causal "
       f"(minicpm-2b, wgmma)", 2, mc.n_heads, mc.n_kv_heads, 300, 300, None,
       bf, dk=mc.head_dim, dv=mc.head_dim)
    fa(f"MLA prefill (1x{v3.n_heads}x300) Dk {dk} Dv {v3.d_v} causal "
       f"(deepseek-v3, wgmma)", 1, v3.n_heads, v3.n_heads, 300, 300, None,
       bf, dk=dk, dv=v3.d_v)
    fa("ragged (1x2x300) Dk 40 over 330 keys at pos 30 f16 (wgmma)", 1, 2,
       2, 300, 330, 30, torch.float16, dk=40, dv=40)
    fa("ragged (1x2x257) GQA 2:1 Dk 72 Dv 56 over 700 keys at pos 443 "
       "(wgmma, 2 chunks)", 1, 2, 1, 257, 700, 443, bf, dk=72, dv=56)
    # phase 10's attention: recurrentgemma's MQA 16:1, 256-wide heads,
    # window 2048 (the kernel's 256-wide class)
    rg = get_config("recurrentgemma-9b")
    W, Hq, Hkv, dh = rg.local_window, rg.n_heads, rg.n_kv_heads, rg.head_dim
    for B, Sq in ((SLOTS, REC_PROMPT), (1, RG_LONG)):
        fa(f"rg prefill ({B}x{Hq}x{Sq}) MQA {Hq}:{Hkv} Dk {dh} window {W} "
           f"(recurrentgemma-9b)", B, Hq, Hkv, Sq, Sq, None, bf, dk=dh,
           dv=dh, window=W)
    for B, Skv in ((SLOTS, REC_PROMPT + REC_NEW), (1, RG_LONG + RG_LONG_NEW)):
        fa(f"rg decode ({B}x{Hq}x1) at pos {Skv - 1} over {Skv} keys Dk "
           f"{dh} window {W} (recurrentgemma-9b)", B, Hq, Hkv, 1, Skv,
           Skv - 1, bf, dk=dh, dv=dh, window=W)
    return cases


def _hold(case, flush) -> tuple:
    """One case: two launches give the same bits, the kernel agrees with
    its plain version within :data:`TOL`, and its time, its plain
    version's, the library call's, its bound, and for norm_matmul's and
    swiglu's wgmma cases matmul's launches on the same product(s)
    (:data:`MATMUL_ROUTE`).  Returns (max |kernel - plain|, ms, plain ms,
    library ms or None, bound ms, bound by, matmul route ms or None)."""
    name, label, kfn, pfn, lfn, nbytes, flops, dt = case
    out = kfn()
    torch.cuda.synchronize()
    require(_bitwise(out, kfn()),
            f"{name} {label}: two launches on the same inputs differ")
    plain = pfn()
    torch.cuda.synchronize()
    require(out.shape == plain.shape and out.dtype == plain.dtype,
            f"{name} {label}: {out.shape} {out.dtype} vs plain "
            f"{plain.shape} {plain.dtype}")
    o, p = out.double(), plain.double()
    require(bool(torch.isfinite(o).all()), f"{name} {label}: non-finite")
    err = float((o - p).abs().max())
    scale = max(float(p.abs().max()), 1.0)
    require(err <= TOL[out.dtype] * scale,
            f"{name} {label}: max |kernel - plain| {err} > "
            f"{TOL[out.dtype]} x {scale}")
    del out, plain, o, p
    ms = _events_ms(kfn, 20, flush)
    plain_ms = _events_ms(pfn, 5, flush)
    lib_ms = _events_ms(lfn, 20, flush) if lfn is not None else None
    # popped: the closure holds the case's operands
    mfn = MATMUL_ROUTE.pop((name, label), None)
    route_ms = _events_ms(mfn, 20, flush) if mfn is not None else None
    extra = {} if mfn is None else {"matmul_route_ms": f"{route_ms:.4f}"}
    bound_ms, bound_by = _bound(nbytes, flops, dt)
    say("kernel", name=name, case=repr(label), max_abs_err=f"{err:.3e}",
        tol=f"{TOL[dt] * scale:.3e}", kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{lib_ms:.4f}" if lib_ms is not None else None,
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        bound_share=f"{bound_ms / ms:.3f}", **extra)
    return err, ms, plain_ms, lib_ms, bound_ms, bound_by, route_ms


def phase_kernels() -> dict:
    # the f32 flash route keeps its state in registers: no instantiation
    # may spill (the log is empty only where another process built the
    # library)
    from repro_torch.kernels import _build
    log = "\n".join(_build.build_log)
    require(not log or "flash_f32_kernel" in log,
            "the build log names no flash_f32_kernel")
    flash_spills = [ln for ln in _spills(log) if "flash_f32_kernel" in ln]
    require(not flash_spills, f"flash_attention f32 spills: {flash_spills}")
    # nor may the wgmma mainloop (its accumulators live in registers), nor
    # norm_matmul's rows kernel before it
    require(not log or all(t in log for tags in WG_TAGS.values()
                           for t in tags),
            "the build log names no wgmma mainloop of matmul, the batched "
            "kernel, norm_matmul and swiglu")
    wg_spills = [ln for ln in _spills(log)
                 if "gemm_kernel" in ln or "probe_" in ln
                 or "norm_matmul_rows_kernel" in ln]
    require(not wg_spills, f"wgmma mainloop spills: {wg_spills}")
    # nor any instantiation of flash's 16-bit routes (the wgmma route's
    # accumulators and score buffers, the split launch's chunk kernel and
    # its combine)
    require(not log or all(f in log for f in FLASH16_FUNCS),
            f"the build log names no {' / '.join(FLASH16_FUNCS)}")
    f16_spills = [ln for ln in _spills(log)
                  if any(f in ln for f in FLASH16_FUNCS)]
    require(not f16_spills, f"flash_attention 16-bit spills: {f16_spills}")
    check_wgmma_probe()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    report = {}
    for case in kernel_cases(gen):
        name, label = case[0], case[1]
        err, ms, plain_ms, lib_ms, bound_ms, bound_by, route_ms = _hold(
            case, flush)
        if name not in report:   # the decode case is the reported one
            report[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "launches_by_phase": {}}
        if ROUTE_OF.get((name, label)) == "wgmma":
            # the wgmma route of matmul and of the batched kernel: each
            # of its cases under the kernel's entry
            route = report[name].setdefault("routes", {}).setdefault(
                "wgmma", {"route": "cuda",
                          "source": (FLASH_SOURCE if name == "flash_attention"
                                     else WG_SOURCE), "cases": []})
            route["cases"].append({
                "case": label, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                **({} if route_ms is None
                   else {"matmul_route_ms": route_ms})})
    for name in tuple(WG_TAGS) + ("flash_attention",):
        require(report[name].get("routes", {}).get("wgmma"),
                f"{name}: no phase 3 case took the wgmma route")
    del flush
    torch.cuda.empty_cache()
    check_fused_wg_launches(gen)
    check_determinism(gen)
    return report


def check_fused_wg_launches(gen) -> None:
    """norm_matmul's and swiglu's 16-bit calls above ops.WG_MIN_ROWS rows
    launch the wgmma mainloop's instantiations (norm_matmul's rows kernel,
    then ``norm_matmul_wg``; ``swiglu_gate_up_wg``, then
    ``swiglu_down_wg``), two device kernels a call and none of the
    tiles', at a dense prefill's 512 rows and phase 8's 2048; at 64 rows
    they keep the tiles."""
    from repro_torch.kernels import norm_matmul as kn, ops, swiglu as ks
    bf = torch.bfloat16
    w = _rand((D, D), bf, gen, D ** -0.5)
    g = (1 + 0.1 * _rand((D,), torch.float32, gen)).to(bf)
    wg, wu = (_rand((D, F), bf, gen, D ** -0.5) for _ in range(2))
    wd = _rand((F, D), bf, gen, F ** -0.5)
    want = {"norm_matmul": ("norm_matmul_rows_kernel",
                            *WG_TAGS["norm_matmul"]),
            "swiglu": WG_TAGS["swiglu"]}
    tiles = {"norm_matmul": ("norm_matmul_inv_kernel",
                             "norm_matmul_tc_kernel"),
             "swiglu": ("swiglu_gate_up_kernel", "swiglu_down_kernel")}
    seen = {}
    for m in (CHUNK, DENSE, TRAIN_BATCH * TRAIN_SEQ):
        x = _rand((m, D), bf, gen)
        for name, call in (("norm_matmul", lambda: kn.norm_matmul(x, g, w)),
                           ("swiglu", lambda: ks.swiglu(x, wg, wu, wd))):
            call()
            torch.cuda.synchronize()
            rows, _, ours, _ = _profile(call)
            names = {k: _tagged_kernels(rows, k)
                     for k in want[name] + tiles[name]}
            expect = tiles[name] if m <= ops.WG_MIN_ROWS else want[name]
            require(names == {k: int(k in expect) for k in names} and
                    ours.get(name, [0, 0])[1] == KERNEL_FUNCS[name][1],
                    f"{name} at {m} rows launched {names} (port kernels "
                    f"{ours}), not one each of {expect}")
            seen[f"{name}@{m}"] = "+".join(expect)
    say("wg_route", kernels=json.dumps(seen), per_call=2)



def check_wgmma_probe() -> None:
    """Is wgmma's k16 step bitwise mma.sync's?  The 16-bit K order names
    mma.sync's chains, and the wgmma mainloop keeps every bit of it only
    if so (kernels/wgmma_probe.py: 2^27 outputs, bf16 and f16, the
    mainloop's four operand layouts, inputs drawn to find a
    difference)."""
    from repro_torch.kernels import wgmma_probe
    r = wgmma_probe.probe("cuda")
    print(wgmma_probe.verdict_line(r), flush=True)
    require(r["equal"], f"wgmma's k16 step differs from mma.sync's: "
            f"{json.dumps(r['per'])}")
    torch.cuda.empty_cache()


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def check_determinism(gen) -> None:
    """The determinism the serving contracts rest on (chunked == dense
    prefill, batched == alone): two launches on the same inputs give the
    same bits, and a fixed probe row gives the same bits in batches of
    every size the serving paths use, at a different position in each."""
    from repro_torch.kernels import matmul as km, rmsnorm as kr
    from repro_torch.kernels import norm_matmul as kn, swiglu as ks
    bf, f32 = torch.bfloat16, torch.float32

    def probe_rows(kernel, label, sizes, run, make):
        probe = make(1)
        rows = {}
        for m, pos in sizes.items():
            batch = make(m)
            batch[pos] = probe[0]
            out = run(batch)
            require(_bitwise(out, run(batch)),
                    f"{kernel} {label}: two launches at {m} rows differ")
            rows[m] = out[pos:pos + 1]
        first = rows[min(rows)]
        for m, r in rows.items():
            require(_bitwise(r, first), f"{kernel} {label}: the probe row "
                    f"at {m} rows differs from it alone: max |diff| "
                    f"{float((r.double() - first.double()).abs().max())}")
        say("determinism", kernel=kernel, dtype=label, runs="bitwise",
            rows=",".join(map(str, sizes)),
            positions=",".join(map(str, sizes.values())), probe="bitwise")

    def name(dt):
        return str(dt).split(".")[-1]

    b = _rand((D, D), bf, gen, D ** -0.5)
    dense_pos = {1: 0, SLOTS: 2, CHUNK: 45, DENSE: 300}
    probe_rows("matmul", name(bf), dense_pos,
               lambda a: km.matmul(a, b), lambda m: _rand((m, D), bf, gen))
    # across the wgmma route's threshold (more than ops.WG_MIN_ROWS = 96
    # rows): a row alone (the tensor-core tiles) == inside 97 to 4,224
    # rows (the wgmma mainloop), in bf16 and f16, at deepseek-7b's widths
    # and at mixtral's wo
    wg_pos = {1: 0, 96: 50, 97: 3, 128: 77, DENSE: 300, 2048: 1500,
              MX_LONG: 4000}
    for dt in (bf, torch.float16):
        bw = b.to(dt)
        probe_rows("matmul", f"{name(dt)} across the wgmma threshold",
                   wg_pos, lambda a: km.matmul(a, bw),
                   lambda m: _rand((m, D), dt, gen))
    del bw
    wo = _rand((6144, 6144), bf, gen, 6144 ** -0.5)
    probe_rows("matmul", "bfloat16 mixtral wo 6144x6144",
               {1: 0, 128: 5, MX_LONG: 2222}, lambda a: km.matmul(a, wo),
               lambda m: _rand((m, 6144), bf, gen))
    del wo
    # f32: rows that cross every arrangement and tile of the f32 route
    # (F32_PROBE_ROWS), the probe at another place each time
    b = _rand((D, D), f32, gen, D ** -0.5)
    probe_rows("matmul", name(f32),
               _f32_probe_sizes(F32_PROBE_ROWS, dense_pos),
               lambda a: km.matmul(a, b), lambda m: _rand((m, D), f32, gen))
    for dt, w_dt in ((bf, bf), (bf, f32), (f32, f32)):
        w = (1 + 0.1 * _rand((D,), f32, gen)).to(w_dt)
        probe_rows("rmsnorm", f"{name(dt)}/w {name(w_dt)}",
                   {1: 0, SLOTS: 3, CHUNK: 17, DENSE: 400},
                   lambda x: kr.rmsnorm(x, w, 1e-6),
                   lambda m: _rand((m, D), dt, gen))
    w = _rand((D, D), bf, gen, D ** -0.5)
    norm_pos = {1: 0, SLOTS: 1, CHUNK: 33, DENSE: 200}
    # across the wgmma route's threshold too (norm_matmul and swiglu in
    # 16-bit above ops.WG_MIN_ROWS rows: the rows, then the mainloop)
    wg_norm_pos = {**norm_pos, 96: 40, 97: 96, 2048: 1234}
    for g_dt in (bf, f32):
        g = (1 + 0.1 * _rand((D,), f32, gen)).to(g_dt)
        probe_rows("norm_matmul", f"bfloat16/g {name(g_dt)}", wg_norm_pos,
                   lambda x: kn.norm_matmul(x, g, w, 1e-6),
                   lambda m: _rand((m, D), bf, gen))
    w = _rand((D, D), f32, gen, D ** -0.5)
    g = 1 + 0.1 * _rand((D,), f32, gen)
    probe_rows("norm_matmul", "float32/g float32",
               _f32_probe_sizes(F32_PROBE_ROWS, norm_pos),
               lambda x: kn.norm_matmul(x, g, w, 1e-6),
               lambda m: _rand((m, D), f32, gen))
    for dt in (bf, f32):
        wg = _rand((D, F), dt, gen, D ** -0.5)
        wu = _rand((D, F), dt, gen, D ** -0.5)
        wd = _rand((F, D), dt, gen, F ** -0.5)
        probe_rows("swiglu", name(dt),
                   {**dense_pos, 96: 7, 97: 60, 2048: 777} if dt == bf
                   else _f32_probe_sizes(F32_PROBE_ROWS, dense_pos),
                   lambda x: ks.swiglu(x, wg, wu, wd),
                   lambda m: _rand((m, D), dt, gen))
        check_swiglu_alternation(name(dt), wg, wu, wd, gen)
    # phase 9's shapes: 4 slots and deepseek-v3's 256 prefill rows
    moe_rows = {1: 0, SLOTS: 2, V3_ROWS: 101}
    from repro_torch.configs import get_config
    mx, v3 = get_config("mixtral-8x22b"), get_config("deepseek-v3-671b")
    d = v3.d_model
    router = _rand((mx.d_model, mx.n_experts), f32, gen, mx.d_model ** -0.5)
    probe_rows("matmul", f"float32 router N={mx.n_experts}",
               _f32_probe_sizes(F32_PROBE_ROWS + (V3_ROWS, MX_LONG),
                                moe_rows),
               lambda a: km.matmul(a, router),
               lambda m: _rand((m, mx.d_model), f32, gen))
    wkv = _rand((d, v3.kv_lora + v3.d_rope), bf, gen, d ** -0.5)
    probe_rows("matmul", f"bfloat16 wkv_a N={v3.kv_lora + v3.d_rope}",
               moe_rows, lambda a: km.matmul(a, wkv),
               lambda m: _rand((m, d), bf, gen))
    nq = v3.n_heads * (v3.d_nope + v3.d_rope)
    g = (1 + 0.1 * _rand((v3.q_lora,), f32, gen)).to(bf)
    wq = _rand((v3.q_lora, nq), bf, gen, v3.q_lora ** -0.5)
    probe_rows("norm_matmul", f"bfloat16 wq_b {v3.q_lora}x{nq}", moe_rows,
               lambda x: kn.norm_matmul(x, g, wq, 1e-6),
               lambda m: _rand((m, v3.q_lora), bf, gen))
    for f in (v3.d_ff, v3.expert_d_ff):
        wg = _rand((d, f), bf, gen, d ** -0.5)
        wu = _rand((d, f), bf, gen, d ** -0.5)
        wd = _rand((f, d), bf, gen, f ** -0.5)
        probe_rows("swiglu", f"bfloat16 {d}->{f}", moe_rows,
                   lambda x: ks.swiglu(x, wg, wu, wd),
                   lambda m: _rand((m, d), bf, gen))
        del wg, wu, wd
    check_flash_determinism(gen)
    check_moe_flash_determinism(gen)
    for dt in (bf, f32):
        rows = _check_window_rows(get_config("recurrentgemma-9b"), RG_LONG,
                                  gen, dt)
        say("determinism", kernel="flash_attention", dtype=name(dt),
            model="recurrentgemma-9b", heads="16:1 Dk 256",
            window_decode_vs_prefill_rows=",".join(map(str, rows)),
            window_decode_vs_prefill="bitwise")
    check_bmm_determinism(gen)
    check_f32_one_order(gen)
    check_16_one_order(gen)
    check_in_capture(gen)
    check_fixed_order_scans(gen)
    check_linear_recurrence(gen)


# f32 matmul, norm_matmul and swiglu: row counts that cross each
# arrangement and tile of the f32 launches (csrc/f32_gemm.cuh,
# ops.matmul_plan and ops.swiglu_plan's gate/up: the chunk lanes' 1, 2
# and 4 rows, the register tiles on both sides of 32 rows, and at the
# router's 8 columns over 6144 the cluster per output up to 8 rows)
F32_PROBE_ROWS = (1, 2, 4, 5, 16, 17, 64, 65, 128, 129, DENSE)
# phase 3's f32 prefill cases: a 32-token prompt, 4 x 16, 4 x 32
F32_PREFILL_ROWS = (32, 64, 128)


def _f32_probe_sizes(rows, kept) -> dict:
    """{rows: the probe's position}: ``kept``'s positions where it names
    the row count (the bf16 probes' places), else the last row at an odd
    count (the ragged last tile or lane block) and 5/8 of the way in at
    an even one (past the first tile), so the probe sits at another place
    and in another block at each count."""
    return {m: kept.get(m, m - 1 if m % 2 else 5 * m // 8) for m in rows}


def check_f32_one_order(gen) -> None:
    """One f32 order in the port: f32 ``matmul(a, b)`` gives bit for bit
    ``batched_matmul(a[None], b[None])[0]`` (f32 out) at every row count
    of :data:`F32_PROBE_ROWS` (deepseek-7b's wo, and mixtral's router,
    with its 4,224-row prefill) and at the f32 unembed -- whichever
    arrangement and tile each of the two kernels takes there; and f32
    ``swiglu`` gives bit for bit ``matmul(h, wd)`` on the h its first
    kernel wrote, and f32 ``norm_matmul`` ``matmul(rows, w)`` on its
    normalised rows (both read through the wrappers' check-only
    accessors), at :data:`F32_PROBE_ROWS` and :data:`F32_PREFILL_ROWS`;
    h and the rows themselves stay within phase 3's f32 limit of their
    plain versions."""
    from repro_torch.kernels import batched_matmul as kb, matmul as km
    from repro_torch.kernels import norm_matmul as kn, ref, swiglu as ks
    from repro_torch.configs import get_config
    f32 = torch.float32
    mx = get_config("mixtral-8x22b")
    shapes = [(m, D, D) for m in F32_PROBE_ROWS]
    shapes += [(m, mx.d_model, mx.n_experts)
               for m in F32_PROBE_ROWS + (MX_LONG,)]
    shapes += [(1, D, V), (3, 40, 8), (17, 300, 24)]
    for m, k, n in shapes:
        a = _rand((m, k), f32, gen)
        b = _rand((k, n), f32, gen, k ** -0.5)
        mm = km.matmul(a, b)
        bmm = kb.batched_matmul(a[None], b[None], f32)[0]
        require(_bitwise(mm, bmm),
                f"matmul f32 ({m}x{k})@({k}x{n}): differs from the batched "
                f"kernel's f32 order: max |diff| "
                f"{float((mm.double() - bmm.double()).abs().max())}")
        del a, b, mm, bmm
    say("determinism", kernel="matmul", dtype="float32",
        one_order="matmul == batched_matmul bitwise",
        shapes=",".join(f"{m}x{k}x{n}" for m, k, n in shapes))

    def near(got, plain, what):
        p = plain.double()
        err = float((got.double() - p).abs().max())
        require(err <= TOL[f32] * max(float(p.abs().max()), 1.0),
                f"{what}: max |kernel - plain| {err}")

    rows = sorted(set(F32_PROBE_ROWS + F32_PREFILL_ROWS))
    wg = _rand((D, F), f32, gen, D ** -0.5)
    wu = _rand((D, F), f32, gen, D ** -0.5)
    wd = _rand((F, D), f32, gen, F ** -0.5)
    w = _rand((D, D), f32, gen, D ** -0.5)
    g = 1 + 0.1 * _rand((D,), f32, gen)
    for m in rows:
        x = _rand((m, D), f32, gen)
        out, h = ks.swiglu_with_hidden(x, wg, wu, wd)
        require(_bitwise(out, km.matmul(h, wd)),
                f"swiglu f32 at {m} rows: differs from matmul(h, wd)")
        gp = ref.matmul_ref(x, wg)
        near(h, gp * torch.reciprocal(torch.exp(-gp) + 1)
             * ref.matmul_ref(x, wu), f"swiglu f32 h at {m} rows")
        out, xn = kn.norm_matmul_with_rows(x, g, w, 1e-6)
        require(_bitwise(out, km.matmul(xn, w)),
                f"norm_matmul f32 at {m} rows: differs from matmul(rows, w)")
        near(xn, ref.rmsnorm_ref(x, g, 1e-6),
             f"norm_matmul f32 rows at {m} rows")
        del x, out, h, xn
    say("determinism", kernel="swiglu,norm_matmul", dtype="float32",
        one_order="swiglu == matmul(h, wd), norm_matmul == matmul(rows, w) "
        "bitwise", rows=",".join(map(str, rows)))


def check_16_one_order(gen) -> None:
    """Above ops.WG_MIN_ROWS rows 16-bit norm_matmul is its rows kernel
    and then matmul's wgmma launch on the rows: bit for bit ``matmul(rows,
    w)`` on the rows it wrote (g in x's type and f32), and swiglu bit for
    bit ``matmul(h, wd)`` on its h (both read through the wrappers'
    check-only accessors), in bf16 and f16, at the fewest rows of the
    route, 128, a dense prefill and phase 8's 2048; the rows and h stay
    within phase 3's limit of their plain versions."""
    from repro_torch.kernels import matmul as km, norm_matmul as kn
    from repro_torch.kernels import ref, swiglu as ks
    rows = (97, 128, DENSE, TRAIN_BATCH * TRAIN_SEQ)

    def near(got, plain, what):
        p = plain.double()
        err = float((got.double() - p).abs().max())
        require(err <= TOL[got.dtype] * max(float(p.abs().max()), 1.0),
                f"{what}: max |kernel - plain| {err}")

    for dt in (torch.bfloat16, torch.float16):
        w = _rand((D, D), dt, gen, D ** -0.5)
        wg, wu = (_rand((D, F), dt, gen, D ** -0.5) for _ in range(2))
        wd = _rand((F, D), dt, gen, F ** -0.5)
        for m in rows:
            x = _rand((m, D), dt, gen)
            for g_dt in (dt, torch.float32):
                g = (1 + 0.1 * _rand((D,), torch.float32, gen)).to(g_dt)
                out, xn = kn.norm_matmul_with_rows(x, g, w, 1e-6)
                require(_bitwise(out, km.matmul(xn, w)),
                        f"norm_matmul {dt} g {g_dt} at {m} rows: differs "
                        f"from matmul(rows, w)")
                near(xn, ref.rmsnorm_ref(x, g, 1e-6),
                     f"norm_matmul {dt} rows at {m} rows")
            out, h = ks.swiglu_with_hidden(x, wg, wu, wd)
            require(_bitwise(out, km.matmul(h, wd)),
                    f"swiglu {dt} at {m} rows: differs from matmul(h, wd)")
            gp = ref.matmul_ref(x, wg)
            near(h, (gp * torch.reciprocal(torch.exp(-gp) + 1)
                     * ref.matmul_ref(x, wu)).to(dt),
                 f"swiglu {dt} h at {m} rows")
            del x, out, xn, h, gp
        del w, wg, wu, wd
        torch.cuda.empty_cache()
    say("determinism", kernel="swiglu,norm_matmul", dtype="bfloat16,float16",
        one_order="swiglu == matmul(h, wd), norm_matmul == matmul(rows, w) "
        "bitwise", rows=",".join(map(str, rows)))


# the batched kernel's probe: batch counts and row counts of the paged
# decode (4 slots x 32 kv heads, one row), a prefill chunk (up to 64 rows)
# and the one- and three-slot runs of E16 (32 and 96 batch entries); the
# 16-bit rows 1-2048 take each tile (16, 64 and 128 rows, and one lane's
# at K <= 32), the f32 rows up to 2048 each f32 tile, and K 5000 at few
# outputs the cluster per output
BMM_BATCHES = (1, 3, 4, 32)
BMM_ROWS = (1, 3, 5, 8, 16, 32, 64)
BMM_WIDE_BATCHES = (1, 3)
BMM_WIDE_ROWS = (1, 5, 64, 65, 128, DENSE, 2048, MX_LONG)
# (label, n, k, type, A as (K, M), B as (N, K), batches, rows)
BMM_PROBES = (
    ("q.k^T", 256, DH, torch.float32, False, True, BMM_BATCHES,
     BMM_ROWS + (128, 2048)),
    ("p.V", DH, 256, torch.bfloat16, False, False, BMM_BATCHES, BMM_ROWS),
    ("K 5000", 64, 5000, torch.float32, False, False, BMM_BATCHES, BMM_ROWS),
    ("paged write K 4", D, SLOTS, torch.bfloat16, True, False,
     BMM_WIDE_BATCHES, BMM_WIDE_ROWS + (1040,)),
    ("K 32", 256, 32, torch.bfloat16, False, True, BMM_WIDE_BATCHES,
     BMM_WIDE_ROWS),
    ("K 128", 256, DH, torch.bfloat16, False, True, BMM_WIDE_BATCHES,
     BMM_WIDE_ROWS),
    ("K 300", 256, 300, torch.bfloat16, False, True, BMM_WIDE_BATCHES,
     BMM_WIDE_ROWS),
    ("dW K 2048", 128, 2048, torch.bfloat16, True, False, BMM_WIDE_BATCHES,
     BMM_WIDE_ROWS),
    # phase 8's dX at its widths, B as (N, K): a row alone
    # (bmm_seq_kernel) == inside 65 to 4,224 rows (the wgmma mainloop)
    ("dX K 4096", D, D, torch.bfloat16, False, True, (1,), BMM_WIDE_ROWS),
    ("dX K 4096 f16", D, D, torch.float16, False, True, (1,),
     BMM_WIDE_ROWS),
    # scores over 101 keys: f32 rows in no whole 16 bytes, which the
    # wgmma mainloop stores from registers, not through the TMA unit
    ("scores N 101", 101, DH, torch.bfloat16, False, True,
     BMM_WIDE_BATCHES, BMM_WIDE_ROWS))


def check_bmm_determinism(gen) -> None:
    """The fixed-order batched matmul: a probe (batch entry, row) gives
    the same bits alone and inside batches at other row counts
    (:data:`BMM_PROBES`), at another place in each; two launches give the
    same bits; zeros appended to K (a padded cache width) give the same
    bits.  At the paged attention's shapes: q.k^T against a cache read as
    (N, K) in f32, and p.V in bf16; over 20 f32 chunks (K 5000), where the
    batches and rows take each f32 tile and the cluster per output; and in
    bf16 at the paged write's K 4 with A read as (K, M), at K 32 (one
    lane), K 128 and K 300 (B as (N, K)) and K 2048 (A as (K, M)), where
    the rows take the tiles of 16, 64 and 128 rows: one probe, the same
    bits in every tile."""
    from repro_torch.kernels import batched_matmul as kb
    f32 = torch.float32

    def operands(batch, m, n, k, dt, a_t, b_t):
        a = (_rand((batch, k, m), dt, gen).transpose(1, 2) if a_t
             else _rand((batch, m, k), dt, gen))
        b = (_rand((batch, n, k), dt, gen, k ** -0.5).transpose(1, 2)
             if b_t else _rand((batch, k, n), dt, gen, k ** -0.5))
        return a, b

    for label, n, k, dt, a_t, b_t, batches, rows in BMM_PROBES:
        pa, pb = operands(1, 1, n, k, dt, a_t, b_t)
        alone = kb.batched_matmul(pa, pb, f32)
        for batch in batches:
            for m in rows:
                a, b = operands(batch, m, n, k, dt, a_t, b_t)
                i, row = (7 * batch + m) % batch, (5 * m + batch) % m
                a[i, row] = pa[0, 0]
                b[i] = pb[0]
                out = kb.batched_matmul(a, b, f32)
                require(_bitwise(out, kb.batched_matmul(a, b, f32)),
                        f"batched_matmul {label}: two launches at batch "
                        f"{batch} x {m} rows differ")
                require(_bitwise(out[i, row], alone[0, 0]),
                        f"batched_matmul {label}: the probe at batch {batch}"
                        f" x {m} rows (entry {i}, row {row}) differs from it "
                        f"alone: max |diff| "
                        f"{float((out[i, row] - alone[0, 0]).abs().max())}")
        pad = 24 if k < 4096 else 300
        padded = kb.batched_matmul(torch.nn.functional.pad(pa, (0, pad)),
                                   torch.nn.functional.pad(pb,
                                                           (0, 0, 0, pad)),
                                   f32)
        require(_bitwise(padded, alone), f"batched_matmul {label}: K "
                f"zero-padded by {pad} differs")
        say("determinism", kernel="batched_matmul", case=repr(label),
            dtype=str(dt).split(".")[-1], k=k, runs="bitwise",
            batches=",".join(map(str, batches)),
            rows=",".join(map(str, rows)), probe="bitwise",
            zero_padded_k="bitwise")


def check_swiglu_alternation(label, wg, wu, wd, gen) -> None:
    """swiglu's down launch must read h only after the gate/up launch has
    written all of it (griddepcontrol.wait): called on two inputs in turn,
    each call gives the bits of the first call on its input and stays
    within phase 3's limit of the plain version -- a copy of h issued
    early would read the other input's h, which the allocator tends to
    hand back at the same address.  In 16-bit also at a dense prefill's
    rows, where both launches are the wgmma mainloop's."""
    from repro_torch.kernels import ref, swiglu as ks
    rows = (SLOTS, CHUNK) + ((DENSE,) if wg.dtype != torch.float32 else ())
    for m in rows:
        xs = [_rand((m, D), wg.dtype, gen) for _ in range(2)]
        firsts = [ks.swiglu(x, wg, wu, wd) for x in xs]
        for i, x in enumerate(xs):
            p = ref.swiglu_ref(x, wg, wu, wd).double()
            err = float((firsts[i].double() - p).abs().max())
            require(err <= TOL[wg.dtype] * max(float(p.abs().max()), 1.0),
                    f"swiglu {label} alternation at {m} rows: input {i} "
                    f"off its plain version by {err}")
        require(not _bitwise(firsts[0], firsts[1]),
                f"swiglu {label}: two inputs gave the same bits")
        for i in range(6):
            out = ks.swiglu(xs[i % 2], wg, wu, wd)
            require(_bitwise(out, firsts[i % 2]),
                    f"swiglu {label} alternation at {m} rows: call {i} "
                    f"differs from the first call on its input")
    say("determinism", kernel="swiglu", dtype=label,
        alternating_inputs="bitwise", rows=",".join(map(str, rows)))


def check_flash_determinism(gen) -> None:
    """Flash attention (bf16, then f32; deepseek-7b's heads): two
    launches give the same bits; a probe (slot, head) gives the same bits
    alone and inside 4 slots; decode at position p gives row p of the
    causal dense prefill bit for bit (a row's reduction order depends only
    on the keys it can see, never on the query tile or the batch); and
    bf16 over 1,100 keys, across the 16-bit order's chunks: the wgmma
    prefill's rows C - 1, C, 2C and the last against the split decode
    (eager and replayed), a (slot, head) alone against 4 slots.  f32:
    a packed GQA decode (Hq 64 over Hkv 8, the 8 query heads of a kv head
    in one block) gives the bits of its heads launched over K and V
    repeated to 64 heads (a block per head)."""
    from repro_torch.kernels import flash_attention as kf
    P = 128
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        q, k, v = (_rand((SLOTS, HEADS, P, DH), dt, gen) for _ in range(3))
        full = kf.flash_attention(q, k, v, causal=True)
        require(_bitwise(full, kf.flash_attention(q, k, v, causal=True)),
                f"flash_attention {name}: two launches of the dense prefill "
                f"differ")
        alone = kf.flash_attention(q[2:3, 7:8], k[2:3, 7:8], v[2:3, 7:8],
                                   causal=True)
        require(_bitwise(alone, full[2:3, 7:8]), f"flash_attention {name}: "
                f"slot 2 head 7 alone differs from it inside 4 slots")
        for p in (0, 63, 64, 127):
            off = torch.tensor(p, dtype=torch.int32, device="cuda")
            one = kf.flash_attention(q[:, :, p:p + 1], k, v, causal=True,
                                     q_offset=off)
            require(_bitwise(one, kf.flash_attention(
                q[:, :, p:p + 1], k, v, causal=True, q_offset=off)),
                f"flash_attention {name}: two decode launches at {p} differ")
            row = full[:, :, p:p + 1]
            require(_bitwise(one, row), f"flash_attention {name}: decode at "
                    f"{p} differs from row {p} of the prefill: max |diff| "
                    f"{float((one.double() - row.double()).abs().max())}")
        say("determinism", kernel="flash_attention", dtype=name,
            runs="bitwise", slot_alone_vs_batch="bitwise",
            decode_vs_prefill_rows="0,63,64,127",
            decode_vs_prefill="bitwise")
    # across the 16-bit order's chunks (ops.FLASH_CHUNK keys): a 1,100-key
    # prefill of deepseek-7b's heads takes the wgmma route and merges the
    # chunks inside its blocks, decode at p takes the split launch and the
    # combine; the rows on both sides of each chunk edge and the last give
    # the same bits, in a CUDA graph too, and a (slot, head) alone gives
    # its bits inside 4 slots
    from repro_torch.kernels import ops
    bf, C, L = torch.bfloat16, ops.FLASH_CHUNK, 1100
    q, k, v = (_rand((SLOTS, HEADS, L, DH), bf, gen) for _ in range(3))
    require(ops.flash_plan(q.shape, k.shape, v.shape, bf).route == "wgmma",
            "flash_attention: the 1,100-key prefill does not take wgmma")
    full = kf.flash_attention(q, k, v, causal=True)
    require(_bitwise(full, kf.flash_attention(q, k, v, causal=True)),
            "flash_attention bfloat16: two launches of the 1,100-key "
            "prefill differ")
    alone = kf.flash_attention(q[2:3, 7:8], k[2:3, 7:8], v[2:3, 7:8],
                               causal=True)
    require(_bitwise(alone, full[2:3, 7:8]), "flash_attention bfloat16: "
            "slot 2 head 7 alone differs from it inside 4 slots over "
            f"{L} keys")
    rows = (C - 1, C, 2 * C, L - 1)
    offs = {p: torch.full((1,), p, dtype=torch.int32, device="cuda")
            for p in rows}

    def decodes():
        return [kf.flash_attention(q[:, :, p:p + 1], k, v, causal=True,
                                   q_offset=o) for p, o in offs.items()]

    eager = decodes()
    graph, outs = _captured(decodes)
    graph.replay()
    torch.cuda.synchronize()
    for p, one, o in zip(rows, eager, outs):
        row = full[:, :, p:p + 1]
        require(_bitwise(one, row), f"flash_attention bfloat16: decode at "
                f"{p} over {L} keys differs from row {p} of the prefill: "
                f"max |diff| "
                f"{float((one.double() - row.double()).abs().max())}")
        require(_bitwise(o, one), f"flash_attention bfloat16: the split "
                f"decode at {p} replayed differs from the eager launch")
    say("determinism", kernel="flash_attention", dtype="bfloat16",
        keys=L, chunk=C, prefill_route="wgmma", runs="bitwise",
        slot_alone_vs_batch="bitwise",
        decode_vs_prefill_rows=",".join(map(str, rows)),
        decode_vs_prefill="bitwise", split_decode_in_graph="bitwise")
    del q, k, v, full, eager, graph, outs
    f32, rep = torch.float32, 8
    q = _rand((SLOTS, 8 * rep, 1, DH), f32, gen)
    k, v = (_rand((SLOTS, 8, 256, DH), f32, gen) for _ in range(2))
    kr, vr = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    for p in (100, 255):
        off = torch.tensor(p, dtype=torch.int32, device="cuda")
        packed = kf.flash_attention(q, k, v, causal=True, q_offset=off)
        each = kf.flash_attention(q, kr, vr, causal=True, q_offset=off)
        require(_bitwise(packed, each), f"flash_attention float32: the packed "
                f"GQA decode (64:8) at {p} differs from its heads over "
                f"repeated K/V: max |diff| "
                f"{float((packed.double() - each.double()).abs().max())}")
    say("determinism", kernel="flash_attention", dtype="float32",
        gqa="64:8", gqa_positions="100,255",
        gqa_packed_vs_repeated="bitwise")


def _check_window_rows(cfg, length: int, gen, dt=torch.bfloat16) -> tuple:
    """Flash at ``cfg``'s heads under its sliding window (``window`` or
    ``local_window``), in ``dt``: two launches of a ``length``-token
    prefill give the same bits, and decode at p gives row p of it bit for
    bit, for p on both sides of the window's edge and the last row;
    returns those rows."""
    from repro_torch.kernels import flash_attention as kf
    W = cfg.window or cfg.local_window
    q = _rand((1, cfg.n_heads, length, cfg.head_dim), dt, gen)
    k, v = (_rand((1, cfg.n_kv_heads, length, cfg.head_dim), dt, gen)
            for _ in range(2))
    full = kf.flash_attention(q, k, v, causal=True, window=W)
    require(_bitwise(full, kf.flash_attention(q, k, v, causal=True,
                                              window=W)),
            f"flash_attention {cfg.name} {dt}: two launches of the windowed "
            f"prefill differ")
    rows = (W - 1, W, length - 1)
    for p in rows:
        off = torch.tensor(p, dtype=torch.int32, device="cuda")
        one = kf.flash_attention(q[:, :, p:p + 1], k, v, causal=True,
                                 window=W, q_offset=off)
        row = full[:, :, p:p + 1]
        require(_bitwise(one, row), f"flash_attention {cfg.name} {dt}: "
                f"windowed decode at {p} differs from row {p} of the "
                f"prefill: max |diff| "
                f"{float((one.double() - row.double()).abs().max())}")
    return rows


def check_moe_flash_determinism(gen) -> None:
    """Flash attention at phase 9's shapes: mixtral's GQA 48:8 under the
    4096-token window -- decode at p gives row p of the windowed prefill
    bit for bit, for p on both sides of the window's edge and the last
    row; and MLA's prefill (Dk 192, Dv 128): two launches give the same
    bits, and a probe (slot, head) gives them alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    mx, v3 = get_config("mixtral-8x22b"), get_config("deepseek-v3-671b")
    bf = torch.bfloat16
    rows = _check_window_rows(mx, MX_LONG, gen)
    f32_rows = _check_window_rows(mx, MX_LONG, gen, torch.float32)
    dk = v3.d_nope + v3.d_rope
    q, k = (_rand((SLOTS, v3.n_heads, V3_PROMPT, dk), bf, gen)
            for _ in range(2))
    v = _rand((SLOTS, v3.n_heads, V3_PROMPT, v3.d_v), bf, gen)
    full = kf.flash_attention(q, k, v, causal=True)
    require(_bitwise(full, kf.flash_attention(q, k, v, causal=True)),
            "flash_attention: two launches of MLA's prefill differ")
    alone = kf.flash_attention(q[1:2, 77:78], k[1:2, 77:78], v[1:2, 77:78],
                               causal=True)
    require(_bitwise(alone, full[1:2, 77:78]), "flash_attention: MLA slot "
            "1 head 77 alone differs from it inside 4 slots")
    say("determinism", kernel="flash_attention", dtype="bfloat16",
        window_decode_vs_prefill_rows=",".join(map(str, rows)),
        window_decode_vs_prefill="bitwise", mla_dk192_runs="bitwise",
        mla_slot_alone_vs_batch="bitwise")
    say("determinism", kernel="flash_attention", dtype="float32",
        model="mixtral-8x22b", heads=f"{mx.n_heads}:{mx.n_kv_heads}",
        window_decode_vs_prefill_rows=",".join(map(str, f32_rows)),
        window_decode_vs_prefill="bitwise")


def check_fixed_order_scans(gen) -> None:
    """The emitter's CumSum (the sampler's cumulative distribution: a
    4 x 102400 f32 softmax row, 20 runs) and ScatterAdd (10^5 f32
    updates onto one row, 2 runs) give the same bits on every run, and
    the fixed-order guard hands the caller's setting back."""
    from repro_torch.core import ops
    from repro_torch.transformers.torch_emit import EMIT, EmitCtx
    ctx = EmitCtx(torch.device("cuda"))
    p = torch.softmax(torch.randn((SLOTS, V), generator=gen, device="cuda"),
                      dim=-1)
    node = ops.cumsum(ops.parameter((SLOTS, V), "f32", "p").out(), 1).node
    first = EMIT["CumSum"](node, [p], ctx)[0]
    for i in range(19):
        require(_bitwise(EMIT["CumSum"](node, [p], ctx)[0], first),
                f"cumsum: run {i + 2} differs from run 1")
    n = 100_000
    upd = torch.randn((n, 64), generator=gen, device="cuda")
    idx = torch.full((n,), 2, dtype=torch.int32, device="cuda")
    op = torch.zeros((4, 64), device="cuda")
    node = ops.scatter_add(ops.parameter((4, 64), "f32", "op").out(),
                           ops.parameter((n,), "i32", "i").out(),
                           ops.parameter((n, 64), "f32", "u").out()).node
    a = EMIT["ScatterAdd"](node, [op, idx, upd], ctx)[0]
    b = EMIT["ScatterAdd"](node, [op, idx, upd], ctx)[0]
    require(_bitwise(a, b), "scatter_add: two runs differ")
    require(not torch.are_deterministic_algorithms_enabled(),
            "the fixed-order guard leaked its setting")
    # what the guard buys: torch.cumsum without it (a reading, no gate)
    plain = {torch.cumsum(p, 1).cpu().numpy().tobytes() for _ in range(20)}
    say("determinism", kernel="CumSum", shape=f"{SLOTS}x{V}",
        dtype="float32", runs=20, result="bitwise",
        unguarded_distinct_results=len(plain))
    say("determinism", kernel="ScatterAdd", updates=n, rows=1,
        dtype="float32", runs=2, result="bitwise")


def check_linear_recurrence(gen) -> None:
    """The emitter's ``LinearRecurrence`` (torch ops, a log-depth doubling
    scan; the RG-LRU's) at phase 10's prefill shapes, f32, forward and
    reversed: within 1e-4 of scale of the port's sequential interpreter,
    two runs give the same bits, and a row gives the same bits alone and
    inside a batch of 4; with its device time against the bound of
    reading a and b once and writing h once."""
    from repro_torch.core import ops
    from repro_torch.transformers.interpreter import EVAL
    from repro_torch.transformers.torch_emit import EMIT, EmitCtx
    ctx = EmitCtx(torch.device("cuda"))
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    for shape in ((SLOTS, REC_PROMPT, D), (1, RG_LONG, D)):
        a = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda")
                          * 2 + 2)
        b = torch.randn(shape, generator=gen, device="cuda")
        for reverse in (False, True):
            def node(n):
                return ops.linear_recurrence(
                    ops.parameter((n,) + shape[1:], "f32", "a").out(),
                    ops.parameter((n,) + shape[1:], "f32", "b").out(),
                    axis=-2, reverse=reverse).node

            def scan(x, y):
                return EMIT["LinearRecurrence"](node(x.shape[0]), [x, y],
                                                ctx)[0]
            h = scan(a, b)
            require(_bitwise(h, scan(a, b)),
                    f"LinearRecurrence {shape} reverse={reverse}: two runs "
                    f"differ")
            seq = EVAL["LinearRecurrence"](node(shape[0]), [
                a.cpu().numpy(), b.cpu().numpy()])[0]
            p = torch.from_numpy(seq).double()
            err = float((h.cpu().double() - p).abs().max())
            scale = max(float(p.abs().max()), 1.0)
            require(err <= TOL[torch.float32] * scale,
                    f"LinearRecurrence {shape} reverse={reverse}: max "
                    f"|scan - sequential| {err} > 1e-4 x {scale}")
            if shape[0] == 1:   # the row inside a batch of 4
                ab = torch.cat([torch.sigmoid(torch.randn(
                    (3,) + shape[1:], generator=gen, device="cuda")), a])
                bb = torch.cat([torch.randn((3,) + shape[1:], generator=gen,
                                            device="cuda"), b])
                row, alone = scan(ab, bb)[3:4], h
            else:
                row, alone = h[2:3], scan(a[2:3], b[2:3])
            require(_bitwise(row, alone),
                    f"LinearRecurrence {shape} reverse={reverse}: a row "
                    f"alone differs from it in a batch of 4")
            ms = _events_ms(lambda: scan(a, b), 20, flush)
            bound_ms, by = _bound(3 * a.numel() * 4, 2 * a.numel(),
                                  torch.float32)
            say("recurrence", shape="x".join(map(str, shape)),
                reverse=reverse, dtype="float32", max_abs_err=f"{err:.3e}",
                tol=f"{TOL[torch.float32] * scale:.3e}", runs="bitwise",
                row_alone_vs_batch="bitwise", ms=f"{ms:.4f}",
                bound_ms=f"{bound_ms:.4f}", bound_by=by,
                bound_share=f"{bound_ms / ms:.3f}")
    del flush


def _captured(fn):
    """``fn()`` (which returns a list of tensors) captured as a CUDA graph
    after one eager warm-up call; returns (graph, its output tensors)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    return graph, outs


def check_in_capture(gen) -> None:
    """The programmatic-dependent launches keep their order inside a CUDA
    graph, and flash attention keeps its bits there: a graph of six
    calls alternating two inputs (swiglu and norm_matmul, bf16 -- also at
    a dense prefill's rows, the wgmma mainloop's -- and f32: each one's
    second launch is the first one's dependent), replayed
    twice, gives each call the bits of the eager first call on its input
    -- a dependent that read its producer's output early would read the
    other input's, from the same pool address; and flash's dense prefill
    and decode at p = 0, 63, 64, 127, replayed, give the eager bits, and
    decode at p gives row p of the prefill."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import norm_matmul as kn, swiglu as ks
    bf, f32 = torch.bfloat16, torch.float32
    for label, dt, m in (("swiglu bfloat16", bf, SLOTS),
                         ("swiglu bfloat16", bf, CHUNK),
                         ("swiglu bfloat16", bf, DENSE),
                         ("swiglu float32", f32, SLOTS),
                         ("swiglu float32", f32, CHUNK),
                         ("norm_matmul bfloat16", bf, SLOTS),
                         ("norm_matmul bfloat16", bf, CHUNK),
                         ("norm_matmul bfloat16", bf, DENSE),
                         ("norm_matmul float32", f32, SLOTS),
                         ("norm_matmul float32", f32, CHUNK)):
        xs = [_rand((m, D), dt, gen) for _ in range(2)]
        if label.startswith("swiglu"):
            wg = _rand((D, F), dt, gen, D ** -0.5)
            wu = _rand((D, F), dt, gen, D ** -0.5)
            wd = _rand((F, D), dt, gen, F ** -0.5)
            call = lambda x: ks.swiglu(x, wg, wu, wd)  # noqa: E731
        else:
            g = (1 + 0.1 * _rand((D,), f32, gen)).to(dt)
            w = _rand((D, D), dt, gen, D ** -0.5)
            call = lambda x: kn.norm_matmul(x, g, w, 1e-6)  # noqa: E731
        firsts = [call(x) for x in xs]
        require(not _bitwise(firsts[0], firsts[1]),
                f"{label} in a graph: two inputs gave the same bits")
        graph, outs = _captured(lambda: [call(xs[i % 2]) for i in range(6)])
        for rep in range(2):
            for o in outs:
                o.zero_()
            graph.replay()
            torch.cuda.synchronize()
            for i, o in enumerate(outs):
                require(_bitwise(o, firsts[i % 2]),
                        f"{label} at {m} rows, replay {rep}: call {i} "
                        f"differs from the eager call on its input")
        say("determinism", kernel=label.split()[0], dtype=label.split()[1],
            in_graph="alternating inputs bitwise", rows=m, replays=2)
    P = 128
    q, k, v = (_rand((SLOTS, HEADS, P, DH), bf, gen) for _ in range(3))
    offs = {p: torch.full((1,), p, dtype=torch.int32, device="cuda")
            for p in (0, 63, 64, 127)}

    def attend():
        return [kf.flash_attention(q, k, v, causal=True)] + [
            kf.flash_attention(q[:, :, p:p + 1], k, v, causal=True,
                               q_offset=o) for p, o in offs.items()]

    eager = attend()
    graph, outs = _captured(attend)
    for rep in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for i, (o, e) in enumerate(zip(outs, eager)):
            require(_bitwise(o, e), f"flash_attention replay {rep}: "
                    f"output {i} differs from the eager launch")
        for p, o in zip(offs, outs[1:]):
            require(_bitwise(o, outs[0][:, :, p:p + 1]),
                    f"flash_attention in a graph: decode at {p} differs "
                    f"from row {p} of the prefill")
    say("determinism", kernel="flash_attention", dtype="bfloat16",
        in_graph="prefill and decode at 0,63,64,127 bitwise", replays=2)


# -- 4. main path, full width --------------------------------------------------
def _prompts(vocab: int, lengths, shared: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ps = [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]
    ps[2][:shared] = ps[1][:shared]      # a shared system prompt
    return ps


# each wrapper's device kernels (every route and arrangement) and how
# many one call launches: norm_matmul's GEMM follows its inverse-RMS
# kernel, swiglu's down product its gate/up kernel; matmul's f32 route is
# one kernel whichever arrangement a shape takes (and none of its names
# is the batched kernel's, so a profile's rows go to the right wrapper)
# (device kernels, or the tag that names f32_gemm.cuh's f32 matmul
# kernels for a caller; device kernels per call)
KERNEL_FUNCS = {
    "matmul": (("matmul_tc_kernel", "matmul_f32", "matmul_wg"), 1),
    "norm_matmul": (("norm_matmul_inv_kernel", "norm_matmul_tc_kernel",
                     "norm_matmul_rows_kernel", "norm_matmul_wg",
                     "norm_rows_f32_kernel", "norm_matmul_f32"), 2),
    "swiglu": (("swiglu_gate_up_kernel", "swiglu_down_kernel",
                "swiglu_gate_up_wg", "swiglu_down_wg",
                "swiglu_gate_up_f32_kernel",
                "swiglu_gate_up_f32_lanes_kernel", "swiglu_down_f32"), 2),
    "rmsnorm": (("rmsnorm_kernel",), 1),
    # (a split flash call's combine kernel, its second, is left out: a
    # call is one chunk kernel whether it splits or not)
    "flash_attention": (("flash_f32_kernel", "flash_tc_kernel",
                         "flash_wg_kernel"), 1),
    "batched_matmul": (("bmm_seq_kernel", "bmm_f32_kernel",
                        "bmm_f32_split_kernel", "bmm_wg"), 1),
}


def _port_kernel(key: str):
    """The wrapper whose device kernel the profiler row ``key`` names."""
    import re
    for name, (funcs, _) in KERNEL_FUNCS.items():
        for f in funcs:
            if re.search(rf"(?<![A-Za-z0-9_]){f}(?![A-Za-z0-9_])", key):
                return name
    return None


# The profiler drops device records at the edges of its window: Kineto
# counts the first records of a session (now and then the last ones) out
# of range, more of them as the process ages, so a replay's profile can
# miss kernels that ran (``scripts/torch_profile_edges.py`` counts them).
# ``_profile`` brackets the call with marker kernels
# (``torch.cuda._sleep(1)``, ``spin_kernel``) that take those drops, and
# keeps a profile only when markers survive on both sides: then nothing
# between them was cut.
MARKER_KERNEL = "spin_kernel"
MARKER_PADS = (256, 2048, 16384)


def _is_marker(key: str) -> bool:
    import re
    return re.search(rf"(?<![A-Za-z0-9_]){MARKER_KERNEL}(?![A-Za-z0-9_])",
                     key) is not None


def _profile(call) -> tuple:
    """Run ``call`` under ``torch.profiler`` (CUDA activity only), between
    ``pad`` marker kernels on each side.  A session whose profile lost
    every marker on one side is run again with more of them
    (:data:`MARKER_PADS`); if the last one loses them too, this raises.
    Returns the kernel rows (ms, count, name) by time, the merged span of
    their intervals in us (None with no interval), the port's device
    kernels by wrapper (``{name: [ms, count]}``), markers left out of
    all three, and the edges: how many times ``call`` ran, the last
    pad, and the markers lost before and after the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for calls, pad in enumerate(MARKER_PADS, 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(1)
            call()
            for _ in range(pad):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        evs = sorted((ev.time_range.start, ev.time_range.end,
                      _is_marker(ev.name))
                     for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA)
        work = [i for i, e in enumerate(evs) if not e[2]]
        if work and work[0] > 0 and work[-1] < len(evs) - 1:
            break
        print(f"[profile] pad={pad}: the profile kept no marker before "
              f"or after the call (events {len(evs)}, first work event "
              f"{work[0] if work else None}); again with more",
              flush=True)
    else:
        raise AssertionError(
            f"the profiler cut the window's edges even behind "
            f"{MARKER_PADS[-1]} markers a side")
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and not _is_marker(ev.key):
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    spans = [(a, b) for a, b, marker in evs if not marker and b > a]
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    ours = {}
    for ms, n, key in rows:
        name = _port_kernel(key)
        if name is not None:
            t = ours.setdefault(name, [0.0, 0])
            t[0] += ms
            t[1] += n
    edges = {"calls": calls, "pad": pad,
             "markers_lost_before": pad - work[0],
             "markers_lost_after": pad - (len(evs) - 1 - work[-1])}
    return rows, (union if spans else None), ours, edges


def _dispatch_profile(eng) -> dict:
    """Two more decode dispatches, outside the counted run.  The first
    times the host: how long the call takes to return (``host_ms``: the
    emitter's enqueue when eager; the host inputs' copies, the replay
    and the outputs' clones when captured) against its wall time to the
    tokens (``wall_ms``).  The second runs under ``torch.profiler`` and
    sums the kernels' device time (``busy_ms``): busy well below wall
    means the card waits on the host.  ``union_ms`` is the time at least
    one kernel ran (their intervals merged): the sum books a
    programmatic dependent's blocks that wait at griddepcontrol.wait
    while the kernel before it finishes (norm_matmul's GEMM, swiglu's
    down product) as busy, and two overlapping kernels twice.  ``ours``
    counts the port's device kernels by wrapper."""
    from repro_torch.devices import to_numpy

    def dispatch():
        return eng.cf.raw(eng._tok, eng._pos, eng.pool.page_table,
                          eng._temp, eng._topk, eng._key,
                          *eng.pool.buffers, *eng.tparams)

    torch.cuda.synchronize()
    h0 = time.perf_counter()
    outs = dispatch()
    h1 = time.perf_counter()
    to_numpy(outs[0])
    h2 = time.perf_counter()
    del outs
    rows, union, ours, _ = _profile(lambda: to_numpy(dispatch()[0]))
    busy = sum(r[0] for r in rows)
    return {"host_ms": (h1 - h0) * 1e3, "wall_ms": (h2 - h0) * 1e3,
            "busy_ms": f"{busy:.1f}" if rows else "not measured",
            "union_ms": (f"{union / 1e3:.1f}" if union is not None
                         else "not measured"),
            "n_kernels": sum(r[1] for r in rows),
            "ours": {k: [round(v[0], 3), v[1]] for k, v in ours.items()},
            "top": [[k[:48], round(ms, 3), n] for ms, n, k in rows[:8]]}


def _require_replay_profile(label: str, cf, pvals) -> None:
    """One replay of a captured engine graph, profiled: every kernel of
    the port shows by name as often as the counter delta that the
    replays add says (``KERNEL_FUNCS``' device kernels per call).  The
    graph runs on zeros: host zeros for its step inputs, fresh card zeros
    for the caches it donates (a graph of its own, captured by the call
    before the profiled one) and the engine's weights."""
    from repro_torch.devices import torch_dtype
    prog = cf.raw
    types = cf.function.in_types
    n = len(types) - len(pvals)
    donated = set(cf.options.donate_argnums)
    args = [torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device="cuda")
            if i in donated else np.zeros(t.shape, t.dtype)
            for i, t in enumerate(types[:n])] + list(pvals)
    prog(*args)
    torch.cuda.synchronize()
    captures, replays = prog.captures, prog.replays
    rows, union, ours, edges = _profile(lambda: prog(*args))
    require((prog.captures, prog.replays) ==
            (captures, replays + edges["calls"]),
            f"{label}: the profiled calls were not replays")
    seen = {}
    for name, c in prog.launches.items():
        want = c["launches"] * KERNEL_FUNCS[name][1]
        got = ours.get(name, [0.0, 0])[1]
        require(got == want, f"{label}: {name}: {got} device kernels in "
                f"a replay's profile, the counters say {c['launches']} "
                f"calls ({want} kernels)")
        seen[name] = got
    say("replay_profile", graph=label, name=prog.name,
        device_busy_ms=f"{sum(r[0] for r in rows):.1f}",
        device_union_ms=(f"{union / 1e3:.1f}" if union is not None
                         else "not measured"),
        device_kernels=sum(r[1] for r in rows),
        port_kernels_by_wrapper=json.dumps(seen),
        port_kernels_ms=json.dumps({k: round(v[0], 3)
                                    for k, v in ours.items()}),
        profile_edges=json.dumps(edges),
        top=json.dumps([[k[:60], round(ms, 3), n]
                        for ms, n, k in rows[:10]]))
    del args


def _record_launches(report: dict, phase: str, counts: dict,
                     required, main: bool = True) -> None:
    """Gate one run's counts (set to 0 just before it): every kernel the
    path runs launched, none refused; and add them to the report (to
    ``launches`` only for a main-path run, the one a user makes)."""
    for name, c in counts.items():
        require(c["rejected"] == 0,
                f"{phase}: {name}: {c['rejected']} refusals")
        if name in required:
            require(c["launches"] > 0,
                    f"{phase}: {name}: no launch on this path")
        if main:
            report[name]["launches"] += c["launches"]
        report[name]["launches_by_phase"][phase] = c["launches"]


def _graphs(eng) -> list:
    """The engine's compiled functions that were captured as CUDA graphs."""
    from repro_torch.backend.graphed import GraphedProgram
    cfs = [eng.cf] if eng.cf is not None else []
    cfs += [v[1] for v in eng._pf_chunks.values()]
    cfs += [v[1] for v in eng._prefill.values()]
    cfs += [v[1] for v in eng._chunks.values()]
    return [cf.raw for cf in cfs
            if isinstance(cf.raw, GraphedProgram) and cf.raw.captured]


def _per_replay(prog) -> dict:
    return {k: c["launches"] for k, c in prog.launches.items()}


def _serve_main(cfg, params, prompts, static_jit: bool):
    """Phase 4's paged workload on a fresh engine; returns (engine,
    report, counters of the run, peak GB of the run)."""
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, EngineConfig(params=params, **MAIN_ENGINE),
                      options=CompileOptions(level="O2", use_pallas=True,
                                             static_jit=static_jit))
    t_engine = time.perf_counter() - t0
    kernels.reset_counters()
    rids = [eng.submit(p, 16) for p in prompts]
    rep = eng.run()
    torch.cuda.synchronize()
    counts = kernels.counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    what = "captured" if static_jit else "eager"
    require(all(rep.statuses[r] == "completed" for r in rids),
            f"{what}: statuses {rep.statuses} {rep.errors}")
    for r in rids:
        toks = rep.results[r]
        require(len(toks) == 16 and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab, f"request {r}: {toks}")
    require(rep.pool.pages_in_use == 0, f"{what}: pages leaked: {rep.pool}")
    problems = eng.pool.verify()
    require(problems == [], f"{what}: pool.verify(): {problems}")
    require(rep.pool.shared_attaches > 0, "no prefix page was shared")
    return eng, rep, counts, peak, t_engine


MAIN_ENGINE = dict(mode="paged", slots=SLOTS, max_len=256, page_size=16,
                   chunk_steps=4, device="cuda")


def phase_main(report: dict, smi: str):
    """Paged serving of full-width deepseek-7b, eager (``static_jit=False``)
    and then captured (the default), on the same weights: the same
    greedy tokens bit for bit, and each run's dispatch numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_dense_chunk
    from repro_torch.models.weights import init_params_on_device

    cfg = get_config("deepseek-7b")
    require((cfg.n_layers, cfg.d_model, cfg.vocab) == (30, D, V),
            f"deepseek-7b config changed: {cfg}")
    t0 = time.perf_counter()
    builder = build_dense_chunk(cfg, 256, SLOTS, 4, page_size=16).builder
    params = init_params_on_device(builder, 0, "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in params.values())
    prompts = _prompts(cfg.vocab, (17, 33, 48, 64, 81, 100), 32)
    tokens = {}
    for static_jit in (False, True):
        what = "captured" if static_jit else "eager"
        eng, rep, counts, peak, t_engine = _serve_main(cfg, params, prompts,
                                                       static_jit)
        tokens[what] = [rep.results[r].tolist() for r in sorted(rep.results)]
        _record_launches(report, "main" if static_jit else "main_eager",
                         counts, PAGED_KERNELS, main=static_jit)
        pipeline_s = eng.cf.report.seconds + sum(
            v[1].report.seconds for v in eng._pf_chunks.values())
        graphs = _graphs(eng)
        per_replay = (_per_replay(eng.cf.raw) if eng.cf.raw in graphs
                      else None)
        require(not static_jit or per_replay is not None,
                "captured: the decode chunk was never captured")
        disp = _dispatch_profile(eng)
        if static_jit:
            # the kernels sit in the graph: one replay's profile shows
            # each of them by name, as often as the counters say
            for name in PAGED_KERNELS:
                want = per_replay[name] * KERNEL_FUNCS[name][1]
                got = disp["ours"].get(name, [0.0, 0])[1]
                require(got == want, f"captured: {name}: {got} device "
                        f"kernels in a replay's profile, the counters "
                        f"say {per_replay[name]} calls ({want} kernels)")
            C = max(eng._pf_chunks)
            _, pcf, pvals, _ = eng._pf_chunks[C]
            _require_replay_profile(f"paged_prefill_chunk_{C}", pcf, pvals)
            report_graphs = {g.name: _per_replay(g) for g in graphs}
            for name in report:
                report[name].setdefault("launches_per_replay", {})
                report[name]["launches_per_replay"]["paged_chunk"] = \
                    per_replay[name]
        say("main", dispatch=what, model="deepseek-7b",
            params_gb=f"{n_bytes / 1e9:.2f}", init_s=f"{t_init:.2f}",
            engine_build_s=f"{t_engine:.2f}",
            pipeline_s=f"{pipeline_s:.3f}", requests=len(prompts),
            generated=rep.generated_tokens, decode_dispatches=rep.steps,
            decode_tok_s=f"{rep.decode_tok_s:.2f}",
            ttft_p50_ms=f"{rep.ttft_p50_ms:.1f}",
            ttft_p95_ms=f"{rep.ttft_p95_ms:.1f}",
            p50_ms=f"{rep.p50_ms:.1f}", wall_s=f"{rep.wall_seconds:.2f}",
            prefill_s=f"{rep.prefill_seconds:.2f}",
            dispatch_host_ms=f"{disp['host_ms']:.2f}",
            dispatch_wall_ms=f"{disp['wall_ms']:.2f}",
            dispatch_device_busy_ms=disp["busy_ms"],
            dispatch_device_union_ms=disp["union_ms"],
            shared_attaches=rep.pool.shared_attaches,
            cow_copies=rep.pool.cow_copies, peak_gb=f"{peak:.2f}",
            steady_decode_tok_s=f"{SLOTS * 4 / disp['wall_ms'] * 1e3:.2f}",
            dispatch_s=json.dumps([round(t, 4) for t in eng.step_seconds]),
            captured_graphs=len(graphs),
            launches_per_replay=json.dumps(per_replay),
            launches=json.dumps({k: v["launches"]
                                 for k, v in counts.items()}),
            card=repr(smi))
        say("profile", dispatch=f"decode chunk (4 steps x 30 layers), "
            f"{what}", device_kernels=disp["n_kernels"],
            port_kernels_ms_launches=json.dumps(disp["ours"]),
            top=json.dumps(disp["top"]))
        if static_jit:
            say("graphs", captured=json.dumps(report_graphs))
        del eng
    require(tokens["captured"] == tokens["eager"],
            "main: captured greedy tokens differ from eager: "
            f"{tokens['captured']} vs {tokens['eager']}")
    say("main", captured_vs_eager="bitwise", requests=len(prompts))
    torch.cuda.empty_cache()
    return cfg, params, prompts, tokens["captured"]


# -- 5. the flash-attention path, full width --------------------------------
def _flash_run(cfg, params, ecfg, prompts, max_new, static_jit):
    """One flash-path workload on a fresh engine; returns (engine, report,
    counters, peak GB, engine build seconds)."""
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, EngineConfig(device="cuda", params=params,
                                        **ecfg),
                      options=CompileOptions(level="O2", use_pallas=True,
                                             static_jit=static_jit))
    t_engine = time.perf_counter() - t0
    kernels.reset_counters()
    rids = [eng.submit(p, max_new) for p in prompts]
    rep = eng.run()
    torch.cuda.synchronize()
    counts = kernels.counters()
    require(all(rep.statuses[r] == "completed" for r in rids),
            f"{ecfg['mode']}: statuses {rep.statuses} {rep.errors}")
    for r in rids:
        toks = rep.results[r]
        require(len(toks) == max_new and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab, f"{ecfg['mode']} {r}: {toks}")
    return (eng, rep, counts, torch.cuda.max_memory_allocated() / 1e9,
            t_engine)


def phase_flash(report: dict, cfg, params) -> None:
    """Donated decode of full-width deepseek-7b on phase 4's weights (the
    engines map parameters by name), then the paged engine's dense
    prefill.  Flash attention runs in every dense prefill (one launch
    per layer) and in every step of the fused decode chunk.  Each path
    runs eagerly (``static_jit=False``) and then three times with capture
    on: the first of those runs each graph eagerly (its first call), the
    second captures and replays it, the third replays it where its
    caches come back at the same addresses (``captures_replays`` shows
    which); all four give the same tokens."""
    P, G, L = 128, 16, cfg.n_layers
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, P).astype(np.int32)
               for _ in range(SLOTS)]
    donated = dict(mode="donated", slots=SLOTS, max_len=256)
    # one dense prefill (B 4) plus G - 1 fused decode steps, each layer
    expect = L * (1 + (G - 1))
    # eager; then with capture on: each graph's first call (eager), its
    # capture (and first replay), and a run of replays alone
    runs = [("eager", False), ("first", True), ("captured", True),
            ("replayed", True)]
    toks = {}
    for what, sj in runs:
        eng, rep, counts, peak, t_engine = _flash_run(
            cfg, params, donated, prompts, G, sj)
        toks[what] = [rep.results[r].tolist() for r in sorted(rep.results)]
        got = counts["flash_attention"]["launches"]
        require(got == expect, f"donated {what}: {got} flash launches, "
                f"{expect} expected (a prefill and {G - 1} steps x {L} "
                f"layers)")
        graphs = _graphs(eng)
        require(not sj or what == "first" or len(graphs) == 2,
                f"donated: {len(graphs)} graphs captured, 2 expected "
                f"(the prefill and the 15-step chunk)")
        _record_launches(report, f"flash_donated_{what}", counts,
                         PORTED_KERNELS, main=what == "replayed")
        if what == "replayed":
            for key, (_, cf, pvals) in list(eng._chunks.items()) + \
                    list(eng._prefill.items()):
                _require_replay_profile(f"donated_{key}", cf, pvals)
            (chunk,) = [g for g in graphs if "chunk" in g.name]
            for name in report:
                report[name].setdefault("launches_per_replay", {})
                report[name]["launches_per_replay"]["donated_chunk"] = \
                    chunk.launches[name]["launches"]
        say("flash", path="donated", dispatch=what, model="deepseek-7b",
            requests=len(prompts), prompt_len=P,
            generated=rep.generated_tokens,
            engine_build_s=f"{t_engine:.2f}",
            decode_tok_s=f"{rep.decode_tok_s:.2f}",
            ttft_p50_ms=f"{rep.ttft_p50_ms:.1f}",
            chunk_ms=f"{rep.p50_ms:.1f}", wall_s=f"{rep.wall_seconds:.2f}",
            prefill_s=f"{rep.prefill_seconds:.2f}", peak_gb=f"{peak:.2f}",
            captured_graphs=len(graphs),
            captures_replays=json.dumps({g.name: [g.captures, g.replays]
                                         for g in graphs}),
            launches=json.dumps({k: v["launches"]
                                 for k, v in counts.items()}))
        del eng
    require(all(t == toks["eager"] for t in toks.values()),
            f"donated: captured tokens differ from eager: {toks}")

    # the repaired path: the paged engine with a dense prefill
    dense = dict(mode="paged", slots=SLOTS, max_len=256, page_size=16,
                 chunk_steps=4, prefill_chunk=0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (100, 37)]
    toks = {}
    for what, sj in runs:
        eng, rep, counts, peak, _ = _flash_run(cfg, params, dense, prompts,
                                               8, sj)
        toks[what] = [rep.results[r].tolist() for r in sorted(rep.results)]
        require(rep.pool.pages_in_use == 0 and eng.pool.verify() == [],
                f"paged dense prefill {what}: pool not drained")
        got = counts["flash_attention"]["launches"]
        require(got == L * len(prompts), f"paged dense prefill {what}: "
                f"{got} flash launches, {L * len(prompts)} expected (one "
                f"per layer and prompt)")
        _record_launches(report, f"flash_paged_dense_{what}", counts,
                         ALL_KERNELS, main=what == "replayed")
        if what == "replayed":
            key, (_, cf, pvals) = next(iter(eng._prefill.items()))
            _require_replay_profile(f"paged_dense_prefill_{key}", cf, pvals)
        say("flash", path="paged prefill_chunk=0", dispatch=what,
            requests=len(prompts), prompt_lens="100,37",
            generated=rep.generated_tokens,
            ttft_p50_ms=f"{rep.ttft_p50_ms:.1f}",
            decode_tok_s=f"{rep.decode_tok_s:.2f}", peak_gb=f"{peak:.2f}",
            captured_graphs=len(_graphs(eng)),
            launches=json.dumps({k: v["launches"]
                                 for k, v in counts.items()}))
        del eng
    require(all(t == toks["eager"] for t in toks.values()),
            f"paged dense prefill: captured tokens differ from eager: "
            f"{toks}")
    say("flash", captured_vs_eager="bitwise", paths="donated,paged-dense")
    torch.cuda.empty_cache()


# -- 5b. sampling at full vocabulary, and the fixed-order scans ---------------
def phase_sampled(cfg, params) -> None:
    """Four keyed requests sampled at temperature 0.8 over the whole
    vocabulary (top_k 0) through phase 4's captured paged graphs, served
    twice: the same tokens."""
    from repro_torch.backend import CompileOptions
    from repro_torch.launch.engine import EngineConfig, ServeEngine

    prompts = _prompts(cfg.vocab, (21, 40, 9, 64), 8, seed=3)
    runs = []
    for _ in range(2):
        eng = ServeEngine(cfg, EngineConfig(params=params, **MAIN_ENGINE),
                          options=CompileOptions(level="O2",
                                                 use_pallas=True))
        rids = [eng.submit(p, 12, temperature=0.8, top_k=0, key=100 + i)
                for i, p in enumerate(prompts)]
        rep = eng.run()
        require(all(rep.statuses[r] == "completed" for r in rids),
                f"sampled: {rep.statuses} {rep.errors}")
        require(eng.cf.raw.captured, "sampled: the chunk ran uncaptured")
        runs.append([rep.results[r].tolist() for r in rids])
        del eng
    require(runs[0] == runs[1], f"sampled: two runs differ: {runs}")
    say("sampled", requests=len(prompts), temperature=0.8, top_k=0,
        tokens_per_request=12, two_runs="identical",
        distinct_tokens=len({t for r in runs[0] for t in r}))


# -- 6. port on the card vs port on the CPU ----------------------------------
def _serve_both(cfg, params, ecfg, prompts, max_new):
    """The same engine config, weights and prompts on the card and on the
    CPU; returns ({device: tokens (requests, max_new)}, card counters)."""
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.launch.engine import EngineConfig, ServeEngine

    results, card = {}, None
    for dev in ("cuda", "cpu"):
        kernels.reset_counters()
        eng = ServeEngine(cfg, EngineConfig(device=dev, params=params,
                                            **ecfg),
                          options=CompileOptions(level="O2",
                                                 use_pallas=True))
        rids = [eng.submit(p, max_new) for p in prompts]
        rep = eng.run()
        mode = ecfg["mode"]
        require(all(rep.statuses[r] == "completed" for r in rids),
                f"{mode} {dev}: {rep.statuses} {rep.errors}")
        if eng.pool is not None:
            require(eng.pool.verify() == [] and rep.pool.active == 0,
                    f"{mode} {dev}: pool not drained")
        results[dev] = np.stack([rep.results[r] for r in rids])
        if dev == "cuda":
            card = kernels.counters()
    return results, card


def _ulp(x: float, dtype: torch.dtype) -> float:
    """One unit in the last place of a value of magnitude ``|x|`` in
    ``dtype`` (normal range)."""
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    return 2.0 ** (math.floor(math.log2(max(abs(float(x)), 2.0 ** -14)))
                   - mant)


@contextlib.contextmanager
def _kernels_held_to_plain(readings: dict):
    """While open, every kernel wrapper also runs its plain version on the
    same card inputs and records in ``readings[kernel]`` the largest
    |kernel - plain| in units in the last place of the output's scale
    (max |plain|).  The kernel's output is what the caller gets."""
    from repro_torch.kernels import MODULES, ref
    plain = {"matmul": ref.matmul_ref, "norm_matmul": ref.norm_matmul_ref,
             "swiglu": ref.swiglu_ref, "rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.flash_attention_ref,
             "batched_matmul": ref.batched_matmul_ref}
    saved = {name: getattr(mod, name) for name, mod in MODULES.items()}

    def held(name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            p = plain[name](*args, **kw).double()
            err = float((out.double() - p).abs().max())
            ulps = err / _ulp(float(p.abs().max()), out.dtype)
            readings[name] = max(readings.get(name, 0.0), ulps)
            return out
        return run

    for name, mod in MODULES.items():
        setattr(mod, name, held(name, saved[name]))
    try:
        yield
    finally:
        for name, mod in MODULES.items():
            setattr(mod, name, saved[name])


def _prefill_logits(cfg, params, dev: str, tokens) -> np.ndarray:
    """The next-token logits after ``tokens`` from the dense (1, P) prefill
    graph at O2 with the kernels on ``dev`` -- the graph continuous and
    paged-dense serving admit a request with -- as f32.  Eager
    (``static_jit=False``): the witness holds every kernel call of it
    against its plain version on the host, which a replay would skip."""
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs
    P = len(tokens)
    g = build_graphs(cfg, ShapeConfig("prefill", "prefill", P, 1), 1)
    cf = Backend.create("torch", device=dev).compile(
        g.fn, CompileOptions(level="O2", use_pallas=True, static_jit=False))
    outs = cf(np.asarray(tokens, np.int32).reshape(1, P),
              *[params[n] for n in g.builder.param_names()])
    return np.asarray(outs[0], np.float32).reshape(-1)


def _divergence_witness(cfg, params, prompts, results) -> list:
    """For each request whose card tokens differ from the CPU's: the first
    step that differs, and that step's logits from a dense prefill of the
    prompt plus the tokens both devices agree on -- the CPU's top two and
    their gap in bf16 units in the last place, the card's logits for the
    same two -- with every kernel of the card's prefill held against its
    plain version on the same inputs (in units in the last place of its
    output's scale)."""
    found = []
    for r, (card_t, cpu_t) in enumerate(zip(results["cuda"],
                                            results["cpu"])):
        differ = np.nonzero(card_t != cpu_t)[0]
        if not len(differ):
            continue
        j = int(differ[0])
        seq = np.concatenate([prompts[r], cpu_t[:j]])
        cpu = _prefill_logits(cfg, params, "cpu", seq)
        readings = {}
        with _kernels_held_to_plain(readings):
            card = _prefill_logits(cfg, params, "cuda", seq)
        a, b = (int(t) for t in np.argsort(-cpu, kind="stable")[:2])
        found.append({
            "request": r, "prompt_len": len(prompts[r]), "step": j,
            "card_token": int(card_t[j]), "cpu_token": int(cpu_t[j]),
            "cpu_top2": [a, b],
            "cpu_top2_logits": [float(cpu[a]), float(cpu[b])],
            "cpu_gap_ulps": float(cpu[a] - cpu[b]) / _ulp(cpu[a],
                                                          torch.bfloat16),
            "card_logits_at_cpu_top2": [float(card[a]), float(card[b])],
            "card_pick": int(np.argmax(card)),
            "kernel_vs_plain_ulps": {k: round(v, 3)
                                     for k, v in readings.items()}})
    return found


def phase_parity() -> None:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs

    base = get_config("deepseek-7b").reduced()
    line = {}
    # (label, widths, modes): d_head 64 keeps the composed attention, d_head
    # 128 takes flash attention wherever the graph holds an Attention op
    configs = [("dh64", dict(d_model=128, d_head=64, d_ff=256), ("paged",)),
               ("dh128", dict(d_model=256, n_heads=2, n_kv_heads=2,
                              d_head=128, d_ff=256),
                ("lockstep", "donated", "continuous", "paged_dense"))]
    for label, widths, modes in configs:
        for dtype in ("f32", "bf16"):
            cfg = dataclasses.replace(base, compute_dtype=dtype, **widths)
            params = build_graphs(cfg, ShapeConfig("decode", "decode", 64,
                                                   SLOTS),
                                  SLOTS).builder.init_params(0)
            for mode in modes:
                ecfg = dict(mode=mode, slots=SLOTS, max_len=64)
                if mode == "paged":
                    ecfg.update(page_size=8, chunk_steps=4)
                    prompts = _prompts(cfg.vocab, (5, 19, 27, 12, 40), 16,
                                       seed=1)
                elif mode == "paged_dense":
                    ecfg.update(mode="paged", page_size=8, chunk_steps=4,
                                prefill_chunk=0)
                    prompts = _prompts(cfg.vocab, (5, 19, 27, 12, 40), 16,
                                       seed=1)
                elif mode == "continuous":
                    prompts = _prompts(cfg.vocab, (5, 19, 27, 12, 40), 16,
                                       seed=1)
                else:   # lockstep, donated: one batch of uniform prompts
                    prompts = _prompts(cfg.vocab, (24,) * SLOTS, 8, seed=1)
                results, card = _serve_both(cfg, params, ecfg, prompts, 10)
                launched = {k: c["launches"] for k, c in card.items()}
                require(sum(launched.values()) > 0,
                        f"{label} {mode} {dtype}: no kernel on the card")
                if label == "dh128":
                    require(launched["flash_attention"] > 0,
                            f"{mode} {dtype}: no flash launch on the card")
                agree = float((results["cuda"] == results["cpu"]).mean())
                key = f"{label}_{mode}_{dtype}"
                line[f"{key}_agreement"] = f"{agree:.4f}"
                line[f"{key}_flash"] = launched["flash_attention"]
                line[f"{key}_refused"] = sum(c["rejected"]
                                             for c in card.values())
                if dtype == "f32":
                    # f32 logits leave no near-ties for the two summation
                    # orders to split: the greedy tokens must be identical
                    require(agree == 1.0, f"{key}: greedy tokens differ: "
                            f"cuda {results['cuda'].tolist()} cpu "
                            f"{results['cpu'].tolist()}")
                elif agree < 1.0:
                    # a bf16 divergence must be a near-tie the kernels'
                    # rounding split, not a kernel off its plain version
                    found = _divergence_witness(cfg, params, prompts,
                                                results)
                    say("parity-witness", case=key,
                        divergent=json.dumps(found))
                    for w in found:
                        worst = max(w["kernel_vs_plain_ulps"].values(),
                                    default=0.0)
                        require(w["cpu_gap_ulps"] <= 2 and worst <= 2,
                                f"{key}: request {w['request']} diverges "
                                f"at step {w['step']} without a near-tie: "
                                f"{w}")
    say("parity", models="deepseek-7b reduced d_head 64 (d_model 128) and "
        "d_head 128 (d_model 256, 2 heads)", **line)


# -- 7. the HTTP front door, full width --------------------------------------
HTTP_SERVER = dict(host="127.0.0.1", port=0, max_wait_queue=8)
HTTP_NEW = 16      # tokens per request, as in phase 4
HTTP_DROP_AFTER = 4


def phase_http(report: dict, cfg, params, main_prompts, main_tokens,
               smi: str) -> None:
    """Phase 4's paged engine (the same weights and shape, O2 with the
    kernels, the captured dispatch) behind ``ServeHTTPServer`` on an
    ephemeral localhost port, driven by ``loadgen`` from this thread:
    phase 4's six greedy prompts plus two more, 8 concurrent streams on
    4 slots (the rest wait in the server's queue), and a ninth client
    that hangs up after 4 tokens through the ``client.disconnect_after_n``
    fault site.  The engine serves the nine prompts directly twice first
    (the warm runs: each graph's eager first call and its capture), so
    the graphs are captured before the load begins; the load may still
    meet a prefill-chunk length the warm runs did not (prefix sharing
    depends on arrival order), which it then runs eagerly and captures.
    Only the server's engine thread calls torch during the load; this
    thread touches the card again after the drain."""
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.launch import faults, loadgen
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    from repro_torch.launch.server import ServeHTTPServer

    rng = np.random.default_rng(7)
    extra = [rng.integers(0, cfg.vocab, n).astype(np.int32)
             for n in (40, 72, 24)]
    prompts = list(main_prompts) + extra   # the last one hangs up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, EngineConfig(params=params, **MAIN_ENGINE),
                      options=CompileOptions(level="O2", use_pallas=True))
    direct = []
    for _ in range(2):
        rids = [eng.submit(p, HTTP_NEW) for p in prompts]
        rep = eng.run()
        require(all(rep.statuses[r] == "completed" for r in rids),
                f"http warm run: {rep.statuses} {rep.errors}")
        direct.append([rep.results[r].tolist() for r in rids])
    require(direct[0] == direct[1], "http: the two warm runs differ")
    require(direct[0][:len(main_prompts)] == main_tokens,
            "http: the warm run's tokens differ from phase 4's")
    want = {str(i): t for i, t in enumerate(main_tokens)}
    want.update({str(len(main_tokens) + i): direct[0][len(main_tokens) + i]
                 for i in range(len(extra) - 1)})
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    graphs = _graphs(eng)
    require(eng.cf.raw in graphs,
            "http: the decode chunk was not captured by the warm runs")
    n_graphs = 1 + len(eng._pf_chunks)   # the chunk and each prefill
    captures = sum(g.captures for g in graphs)
    before = dict(eng.counters)
    first_rid, n_steps = eng._next_rid, len(eng.step_seconds)
    prefill_s = eng.prefill_seconds

    srv = ServeHTTPServer(eng, **HTTP_SERVER)
    srv.start_in_thread()
    kernels.reset_counters()
    faults.configure(f"client.disconnect_after_n=after:{len(prompts)}:"
                     f"{HTTP_DROP_AFTER}")
    try:
        t1 = time.perf_counter()
        res = loadgen.run_load(srv.base_url, prompts, HTTP_NEW,
                               timeout=300)
        wall = time.perf_counter() - t1
        deadline = time.monotonic() + 60   # the cancel lands at a boundary
        while time.monotonic() < deadline and (
                eng.counters["cancelled"] == before["cancelled"]
                or eng.pool.active):
            time.sleep(0.05)
        metrics = loadgen.fetch_json(srv.base_url, "/v1/metrics")
    finally:
        faults.configure("")
        srv.shutdown()
    counts = kernels.counters()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    snap, live = metrics["server"], metrics["engine"]
    rep = srv.engine_report
    require(rep is not None, f"http: no engine report ({srv.report_doc()})")
    done = {k: rep.counters[k] - before[k] for k in rep.counters}
    require(res.statuses == {200: len(prompts)} and not res.errors,
            f"http: statuses {res.statuses} errors {res.errors}")
    require(res.results == want, "http: streamed tokens differ from the "
            f"direct engine's: {res.results} vs {want}")
    require(res.disconnects == 1 and snap["client_disconnects"] >= 1,
            f"http: disconnect not counted: client {res.disconnects}, "
            f"server {snap['client_disconnects']}")
    require(done["cancelled"] == 1 and done["completed"] == len(prompts) - 1
            and done["failed"] == 0, f"http: terminal counts {done}")
    require(srv.drain_ok is True, "http: the drain left engine state")
    require(eng.pool.pages_in_use == 0 and eng.pool.active == 0,
            f"http: pool after the drain: {eng.pool.stats()}")
    problems = eng.pool.verify()
    require(problems == [], f"http: pool.verify(): {problems}")
    _record_launches(report, "http", counts, PAGED_KERNELS)
    after = sum(g.captures for g in _graphs(eng))
    # the engine's side of TTFT (from its submit, on the engine thread):
    # the wait for a slot, then admission to the first token; and the
    # decode dispatches' wall times during the load
    from repro_torch.launch.engine import _percentile
    load = [r for rid, r in eng._requests.items() if rid >= first_rid
            and r.t_first is not None]
    waits = [(r.t_admit - r.t_submit) * 1e3 for r in load]
    firsts = [(r.t_first - r.t_admit) * 1e3 for r in load]
    steps = [t * 1e3 for t in eng.step_seconds[n_steps:]]
    say("http", card=repr(smi), server="ServeHTTPServer 127.0.0.1:0",
        slots=SLOTS, max_wait_queue=HTTP_SERVER["max_wait_queue"],
        clients=len(prompts), new_tokens=HTTP_NEW,
        disconnect_after=HTTP_DROP_AFTER,
        graphs_captured_before_load=f"{len(graphs)}/{n_graphs}",
        captures_before_load=captures, captures_during_load=after - captures,
        warm_runs_s=f"{t_warm:.2f}", load_wall_s=f"{wall:.2f}",
        completed=done["completed"], cancelled=done["cancelled"],
        client_disconnects=snap["client_disconnects"],
        engine_slot_wait_p50_ms=f"{_percentile(waits, 50):.1f}",
        engine_slot_wait_p95_ms=f"{_percentile(waits, 95):.1f}",
        engine_admit_to_first_p50_ms=f"{_percentile(firsts, 50):.1f}",
        engine_admit_to_first_p95_ms=f"{_percentile(firsts, 95):.1f}",
        decode_dispatches=len(steps),
        dispatch_wall_p50_ms=f"{_percentile(steps, 50):.1f}",
        dispatch_wall_p95_ms=f"{_percentile(steps, 95):.1f}",
        prefill_s=f"{eng.prefill_seconds - prefill_s:.3f}",
        drain_ok=srv.drain_ok, pages_in_use=eng.pool.pages_in_use,
        live_pages_in_use=live["pages_in_use"], peak_gb=f"{peak:.2f}",
        launches=json.dumps({k: v["launches"] for k, v in counts.items()}))
    say("http_metrics", source="/v1/metrics", card=repr(smi),
        ttft_p50_ms=f"{snap['ttft_p50_ms']:.1f}",
        ttft_p95_ms=f"{snap['ttft_p95_ms']:.1f}",
        inter_token_p50_ms=f"{snap['tok_p50_ms']:.2f}",
        inter_token_p95_ms=f"{snap['tok_p95_ms']:.2f}",
        sustained_tok_s=f"{snap['sustained_tok_s']:.2f}",
        tokens_streamed=snap["tokens_streamed"])
    say("http_clients", source="loadgen", card=repr(smi),
        ttft_p50_ms=f"{res.ttft_p50_ms:.1f}",
        ttft_p95_ms=f"{res.ttft_p95_ms:.1f}",
        inter_token_p50_ms=f"{res.gap_p50_ms:.2f}",
        inter_token_p95_ms=f"{res.gap_p95_ms:.2f}",
        tok_s=f"{res.tok_s:.2f}", completed_tokens=res.total_tokens)
    del eng, srv


# -- 8. training, full width ---------------------------------------------------
TRAIN_LAYERS = 4        # p, m and v of all 30 layers (83 GB) exceed one card
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6
TRAIN_SMALL = dict(d_model=256, n_heads=2, n_kv_heads=2, d_head=128,
                   d_ff=256, compute_dtype="f32")   # phase 6's d_head 128
SMALL_BATCH, SMALL_SEQ, SMALL_STEPS, SMALL_CKPT = 2, 64, 5, 3
# limits on a train state held against another run of the same steps
# (:func:`_state_gaps`), by compute dtype: each AdamW moment in L2 over
# its own norm; each parameter's update from the start in norm ratio
# and, in L2 over its own norm, in direction.  AdamW scales a gradient
# element to about +-lr, so an element whose bf16 rounding crosses zero
# flips its whole update: bf16's update limit is wider than its moments'.
STATE_LIMITS = {"f32": {"m": 1e-4, "v": 1e-4, "update_norm": 1e-4,
                        "update": 1e-4},
                "bf16": {"m": 3e-2, "v": 3e-2, "update_norm": 3e-2,
                         "update": 0.25}}


def _free_card() -> float:
    """Drop every backend's compiled functions (their CUDA graphs hold
    static outputs and their pools) and release the cached blocks;
    returns the GB still allocated."""
    import gc
    from repro_torch.backend import Backend
    for be in list(Backend._INSTANCES.values()):
        be.clear_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def _train_step_graph(cfg, batch: int, seq: int, g=None):
    """The train step of ``cfg`` (IR autodiff + AdamW; over its forward
    graphs ``g`` when given) and the indices of its donated state (p, m
    and v)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs
    from repro_torch.models.train_graph import make_train_step
    if g is None:
        g = build_graphs(cfg, ShapeConfig("train", "train", seq, batch),
                         batch)
    ts = make_train_step(g, cfg)
    n_data, n_p = len(g.builder.inputs), ts.n_params
    return ts, tuple(range(n_data + 1, n_data + 1 + 3 * n_p))


def _train_params(ts, dev: str, seed: int = 0) -> list:
    """The step's parameters, drawn on ``dev`` from ``seed``."""
    from repro_torch.models.weights import init_params_on_device
    p = init_params_on_device(ts.graphs.builder, seed, dev)
    return [p[n] for n in ts.param_names]


def _train_state(ts, cfg, dev: str, seed: int = 0) -> list:
    """Fresh state on ``dev``: the parameters of :func:`_train_params`,
    the AdamW moments zero."""
    from repro_torch.devices import torch_dtype
    opt = torch_dtype(cfg.opt_dtype)
    ps = _train_params(ts, dev, seed)
    return ps + [torch.zeros_like(t, dtype=opt) for t in ps] + \
        [torch.zeros_like(t, dtype=opt) for t in ps]


def _state_gaps(start: list, ref: list, got: list) -> dict:
    """The worst gap of each kind between two flat (p, m, v) train states
    that ran the same steps from the same parameters ``start``, leaf by
    leaf in f64 on ``got``'s device (``ref`` may lie on the host): the
    moments in L2 over their own norm, each parameter's update from
    ``start`` in norm ratio (``|1 - ratio|``) and in L2 over its norm."""
    n = len(start)
    assert len(ref) == len(got) == 3 * n
    gaps = {"m": 0.0, "v": 0.0, "update_norm": 0.0, "update": 0.0}

    def f64(t):
        t = torch.as_tensor(t)
        return t.to(device=dev, dtype=torch.float64)

    def rel(a, b):
        return float(torch.linalg.vector_norm(b - a) /
                     torch.linalg.vector_norm(a))

    for i in range(n):
        dev = torch.as_tensor(got[i]).device
        p0 = f64(start[i])
        d_ref, d_got = f64(ref[i]) - p0, f64(got[i]) - p0
        del p0
        ratio = float(torch.linalg.vector_norm(d_got) /
                      torch.linalg.vector_norm(d_ref))
        gaps["update_norm"] = max(gaps["update_norm"], abs(1 - ratio))
        gaps["update"] = max(gaps["update"], rel(d_ref, d_got))
        del d_ref, d_got
        for kind, j in (("m", n + i), ("v", 2 * n + i)):
            gaps[kind] = max(gaps[kind], rel(f64(ref[j]), f64(got[j])))
    return gaps


def _require_state(gaps: dict, dtype: str, what: str) -> None:
    over = {k: g for k, g in gaps.items() if not g <= STATE_LIMITS[dtype][k]}
    require(not over, f"{what}: state gaps {over} over the {dtype} limits "
            f"{STATE_LIMITS[dtype]}")


def _train_batches(cfg, ts, batch: int, seq: int, steps, seed: int = 0):
    """Each of ``steps``' data arguments as the trainer passes them
    (``launch/train.py::step_data``): SyntheticLM's tokens and labels at
    ``seed``, and whisper's frames or vlm's images drawn for that step."""
    from repro_torch.launch.train import step_data
    from repro_torch.runtime.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(cfg.vocab, seq, batch, seed=seed))
    return [step_data(cfg, ts.graphs.builder, data.batch(s), seed, s, batch)
            for s in steps]


def _train_steps(cf, flat: list, batches, first: int = 0,
                 required=ALL_KERNELS, label: str = "train"):
    """Run ``len(batches)`` steps of ``cf.raw`` from step ``first``, each
    on its data arguments (:func:`_train_batches`); each step's counters
    are set to 0 just before it and read just after.  Returns (losses,
    step ms, per-step counters, the state after)."""
    from repro_torch import kernels
    from repro_torch.backend.graphed import GraphedProgram
    losses, ms, counts = [], [], []
    for k, batch in enumerate(batches):
        kernels.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = cf.raw(*batch, np.int32(first + k), *flat)
        loss = outs[0].item()
        ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        c = kernels.counters()
        counts.append(c)
        require(math.isfinite(loss), f"{label} step {first + k}: loss {loss}")
        for name in required:
            require(c[name]["launches"] > 0 and c[name]["rejected"] == 0,
                    f"{label} step {first + k}: {name}: {c[name]}")
        new = list(outs[1:])
        if isinstance(cf.raw, GraphedProgram):
            # donated state is written back in place: the same tensors
            require(all(a is b for a, b in zip(new, flat)),
                    f"{label} step {first + k}: the donated state did not "
                    f"come back as the same tensors")
        flat = new
        losses.append(loss)
        del outs
    return losses, ms, counts, flat


def phase_train(report: dict, smi: str) -> None:
    """Training on the card: deepseek-7b at full width with the depth cut
    to 4 layers (AdamW's p, m and v of 30 layers would not fit), batch 4
    x seq 512 of ``SyntheticLM`` (seed 0), f32 parameters, bf16 compute,
    O2 with the kernels, the step captured as a CUDA graph.  Six steps
    (the eager first call, the capture, four replays) launch all five
    kernels each (the forward and the backward scan's recompute); the
    same six from the same state eagerly give the same losses bit for
    bit; the six steps without the kernels (O1) agree on every loss to
    3e-2 of scale and on the state after them within the bf16
    :data:`STATE_LIMITS` (the moments carry the gradients, so a kernel
    that is wrong in the backward's recompute fails here); and a fresh
    backend over the same cache dir takes the step from disk and gives
    the first loss's bits.  Then, at phase 6's
    d_head-128 width in f32: five steps on the card against the port on
    the CPU, a checkpoint resumed bit for bit, a card checkpoint restored
    on the CPU, and an autotune record re-resolved with zero sweeps."""
    import shutil
    import tempfile
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs import get_config

    held = _free_card()
    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=TRAIN_LAYERS)
    require((cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
             cfg.compute_dtype, cfg.param_dtype) ==
            (D, HEADS, DH, F, V, "bf16", "f32"), f"deepseek-7b: {cfg}")
    ts, donate = _train_step_graph(cfg, TRAIN_BATCH, TRAIN_SEQ)
    batches = _train_batches(cfg, ts, TRAIN_BATCH, TRAIN_SEQ,
                             range(TRAIN_STEPS + 1))
    extra = batches.pop()
    n_params = sum(int(np.prod(s.shape))
                   for s in ts.graphs.builder.params.values())
    n_matmul = n_params - cfg.vocab * cfg.d_model   # all but the embedding
    tokens = TRAIN_BATCH * TRAIN_SEQ
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    cache = tempfile.mkdtemp(prefix="train_cache_", dir=build)
    opts = CompileOptions(level="O2", use_pallas=True, donate_argnums=donate,
                          cache_dir=cache)
    try:
        # captured: eager first call, capture, replays
        torch.cuda.reset_peak_memory_stats()
        be = Backend.create("torch", fresh=True, device="cuda")
        t0 = time.perf_counter()
        cf = be.compile(ts.fn, opts)
        compile_cold_s = time.perf_counter() - t0
        pipeline_s = cf.report.seconds
        require(not cf.from_disk and be.cache_stats().disk_misses == 1,
                f"train: cold compile {be.cache_stats()}")
        fused = dict(cf.report.stats).get("fuse-compounds", {})
        flat = _train_state(ts, cfg, "cuda")
        losses, ms, counts, flat = _train_steps(cf, flat, batches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        reserved = torch.cuda.max_memory_reserved() / 1e9
        require((cf.raw.captures, cf.raw.replays) == (1, TRAIN_STEPS - 1),
                f"train: {cf.raw.captures} captures, {cf.raw.replays} "
                f"replays")
        total = {k: {"launches": sum(c[k]["launches"] for c in counts),
                     "rejected": sum(c[k]["rejected"] for c in counts)}
                 for k in counts[0]}
        _record_launches(report, "train", total, ALL_KERNELS)
        per_step = {k: counts[-1][k]["launches"] for k in counts[-1]}
        for name in report:
            report[name]["launches_per_train_step"] = per_step[name]
        # the state after the six steps, on the host, for the O1 run
        t0 = time.perf_counter()
        kernel_state = [t.to("cpu") for t in flat]
        stash_s = time.perf_counter() - t0
        # one more replay, outside the counted run, under the profiler:
        # where the step's device time goes
        rows, union, ours = _train_profile("train", cf, extra, TRAIN_STEPS,
                                           flat, per_step)
        # the step's 2048-row products go through the wgmma mainloop
        for name, tags in WG_TAGS.items():
            n_wg = {tag: _tagged_kernels(rows, tag) for tag in tags}
            require(all(n_wg.values()), f"train: no {' or '.join(tags)} "
                    f"kernel in a replayed step: {n_wg}")
            report[name].setdefault("routes", {}).setdefault(
                "wgmma", {})["kernels_per_train_step"] = n_wg
        del cf, be, flat
        _free_card()

        # the same six steps eagerly, from the same state
        be = Backend.create("torch", fresh=True, device="cuda")
        cf = be.compile(ts.fn, opts.replace(static_jit=False))
        flat = _train_state(ts, cfg, "cuda")
        eager, eager_ms, _, flat = _train_steps(cf, flat, batches,
                                                label="train eager")
        require(eager == losses, f"train: captured losses {losses} != "
                f"eager {eager}")
        del cf, be, flat
        _free_card()

        # without the kernels: the same six steps, their losses and the
        # state after them
        be = Backend.create("torch", fresh=True, device="cuda")
        cf = be.compile(ts.fn, CompileOptions(level="O1", use_pallas=False,
                                              donate_argnums=donate,
                                              static_jit=False))
        flat = _train_state(ts, cfg, "cuda")
        plain, _, _, flat = _train_steps(cf, flat, batches, required=(),
                                         label="train O1")
        d_plain = max(abs(a - b) / max(abs(b), 1.0)
                      for a, b in zip(plain, losses))
        require(d_plain <= 3e-2, f"train: O1 losses {plain} vs O2 kernels "
                f"{losses}")
        del cf, be
        start = _train_params(ts, "cuda")
        o1_gaps = _state_gaps(start, kernel_state, flat)
        _require_state(o1_gaps, "bf16", "train: O1 vs O2 kernels")
        del flat, start, kernel_state
        _free_card()

        # a cold process over the same cache dir: the step from disk
        be = Backend.create("torch", fresh=True, device="cuda")
        t0 = time.perf_counter()
        cf = be.compile(ts.fn, opts)
        compile_disk_s = time.perf_counter() - t0
        require(cf.from_disk and be.cache_stats().disk_hits == 1,
                f"train: disk {be.cache_stats()}")
        flat = _train_state(ts, cfg, "cuda")
        disk, _, _, flat = _train_steps(cf, flat, batches[:1],
                                        label="train disk")
        require(disk[0] == losses[0], f"train: disk-hit loss {disk[0]} != "
                f"{losses[0]}")
        del cf, be, flat
        _free_card()
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    replay_ms = statistics.median(ms[2:])
    flops = 6 * n_matmul * tokens
    READINGS["train"] = {"replay_ms": replay_ms, "per_step": per_step}
    say("train", model=f"deepseek-7b full width, {TRAIN_LAYERS} layers",
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        card_allocated_gb_before=f"{held:.2f}",
        fused=json.dumps({k: v for k, v in fused.items() if v}),
        losses=json.dumps(losses), captured_vs_eager="bitwise",
        o1_losses=json.dumps(plain), o1_vs_o2_loss=f"{d_plain:.3e}",
        o1_vs_o2_state=json.dumps({k: f"{g:.3e}" for k, g in o1_gaps.items()}),
        state_to_host_s=f"{stash_s:.2f}",
        eager_step_ms=f"{ms[0]:.1f}", capture_step_ms=f"{ms[1]:.1f}",
        replay_step_ms=f"{replay_ms:.1f}",
        replay_steps_ms=json.dumps([round(t, 2) for t in ms[2:]]),
        eager_run_ms=json.dumps([round(t, 1) for t in eager_ms]),
        tok_s=f"{tokens / replay_ms * 1e3:.1f}",
        model_tflop_s=f"{flops / replay_ms / 1e9:.2f}",
        share_of_989=f"{flops / replay_ms / 1e9 / 989:.4f}",
        peak_gb=f"{peak:.2f}", peak_reserved_gb=f"{reserved:.2f}",
        launches_per_step=json.dumps(per_step),
        pipeline_s=f"{pipeline_s:.3f}",
        compile_cold_s=f"{compile_cold_s:.3f}",
        compile_disk_hit_s=f"{compile_disk_s:.3f}",
        disk_hit_loss="bitwise", card=repr(smi))
    say("train_profile", dispatch="one replayed train step",
        device_busy_ms=f"{sum(r[0] for r in rows):.1f}",
        device_union_ms=(f"{union / 1e3:.1f}" if union is not None
                         else "not measured"),
        device_kernels=sum(r[1] for r in rows),
        port_kernels_ms_launches=json.dumps(
            {k: [round(v[0], 3), v[1]] for k, v in ours.items()}),
        top=json.dumps([[k[:60], round(ms_, 3), n]
                        for ms_, n, k in rows[:16]]))
    phase_train_small()


def phase_train_small() -> None:
    """Phase 8 at phase 6's d_head-128 width in f32: the card against the
    CPU over five steps, a checkpoint after step 3 resumed into fresh
    tensors (steps 4-5 bitwise), the card's checkpoint restored on the
    CPU, and an autotune sweep of the prefill graph re-resolved by a
    fresh backend with zero sweeps."""
    import shutil
    import tempfile
    from repro_torch.backend import Backend, CompileOptions, autotune
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.devices import to_numpy
    from repro_torch.models.lm import build_graphs
    from repro_torch.runtime.checkpoint import CheckpointManager

    cfg = get_config("deepseek-7b").reduced(**TRAIN_SMALL)
    ts, donate = _train_step_graph(cfg, SMALL_BATCH, SMALL_SEQ)
    batches = _train_batches(cfg, ts, SMALL_BATCH, SMALL_SEQ,
                             range(SMALL_STEPS))
    params = ts.graphs.builder.init_params(0)
    names = ts.param_names
    host = [params[n] for n in names] + \
        [np.zeros_like(params[n]) for n in names] * 2
    opts = CompileOptions(level="O2", use_pallas=True, donate_argnums=donate)
    build = os.path.join(ROOT, "build")
    tmp = tempfile.mkdtemp(prefix="train_small_", dir=build)
    try:
        runs, cut = {}, None
        for dev in ("cuda", "cpu"):
            cf = Backend.create("torch", fresh=True, device=dev).compile(
                ts.fn, opts)
            flat = [torch.from_numpy(a.copy()).to(dev) for a in host]
            need = ("flash_attention",) if dev == "cuda" else ()
            card = dev == "cuda" and not runs
            losses, _, _, flat = _train_steps(
                cf, flat, batches[:SMALL_CKPT], required=need,
                label=f"small {dev}")
            if card:
                mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
                mgr.save(SMALL_CKPT, {f"s{i}": t for i, t in enumerate(flat)})
                cut = [to_numpy(t) for t in flat]
            more, _, _, flat = _train_steps(
                cf, flat, batches[SMALL_CKPT:], first=SMALL_CKPT,
                required=need, label=f"small {dev}")
            runs["card" if card else "cpu"] = (losses + more,
                                               [to_numpy(t) for t in flat])
            if card:
                # resumed into fresh tensors on the card: steps 4-5 bitwise
                _, got, _ = mgr.restore(device="cuda")
                flat = [got[f"s{i}"] for i in range(len(host))]
                again, _, _, flat = _train_steps(
                    cf, flat, batches[SMALL_CKPT:], first=SMALL_CKPT,
                    required=need, label="small resumed")
                require(again == more, f"small: resumed losses {again} != "
                        f"{more}")
                require(all(_bitwise(torch.from_numpy(a),
                                     torch.from_numpy(to_numpy(b)))
                            for a, b in zip(runs["card"][1], flat)),
                        "small: the resumed state differs from the run's")
                # the card's checkpoint on the CPU
                _, got, _ = mgr.restore(device="cpu")
                require(all(np.array_equal(got[f"s{i}"].numpy(), a)
                            for i, a in enumerate(cut)),
                        "small: the card's checkpoint restored on the CPU "
                        "differs")
            del cf, flat
        (lc, pc), (lh, ph) = runs["card"], runs["cpu"]
        loss_err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(lc, lh))
        param_err = max(float(np.abs(a.astype(np.float64) - b).max())
                        / max(float(np.abs(b).max()), 1.0)
                        for a, b in zip(pc, ph))
        require(loss_err <= 1e-4 and param_err <= 1e-4,
                f"small: card vs CPU loss {loss_err:.3e} state "
                f"{param_err:.3e} of scale")
        small_gaps = _state_gaps(host[:len(names)], ph, pc)
        _require_state(small_gaps, "f32", "small: card vs CPU")

        # autotune: a sweep of the prefill graph, then a re-resolve
        g = build_graphs(cfg, ShapeConfig("prefill", "prefill", SMALL_SEQ, 1),
                         1)
        topts = CompileOptions(level="O2", use_pallas=True, autotune=True,
                               cache_dir=os.path.join(tmp, "cache"))
        be = Backend.create("torch", fresh=True, device="cuda")
        be.compile(g.fn, topts)
        st1 = be.cache_stats()
        recs = [os.path.join(tmp, "cache", "autotune", n) for n in
                os.listdir(os.path.join(tmp, "cache", "autotune"))]
        require(st1.autotune_sweeps == 1 and len(recs) == 1,
                f"autotune: {st1}, records {recs}")
        with open(recs[0]) as fh:
            rec = json.load(fh)
        require(autotune.validate_record(rec) == [],
                f"autotune record: {autotune.validate_record(rec)}")
        require(be.cache_stats().size == 1,
                f"autotune: {be.cache_stats().size} compiled functions kept")
        require(all(c["use_pallas"] is True for c in rec["candidates"]),
                f"autotune: a candidate without the kernels: {rec}")
        be2 = Backend.create("torch", fresh=True, device="cuda")
        be2.compile(g.fn, topts)
        st2 = be2.cache_stats()
        require(st2.autotune_sweeps == 0 and st2.autotune_hits == 1,
                f"autotune re-resolve: {st2}")
        del be, be2
        _free_card()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("train_small", model="deepseek-7b reduced d_head 128 (d_model 256, "
        "2 heads), f32", steps=SMALL_STEPS, card_losses=json.dumps(lc),
        card_vs_cpu_loss=f"{loss_err:.3e}",
        card_vs_cpu_state=f"{param_err:.3e}",
        card_vs_cpu_gaps=json.dumps({k: f"{g:.3e}"
                                     for k, g in small_gaps.items()}),
        resume="bitwise",
        card_checkpoint_on_cpu="bitwise",
        autotune_candidates=len(rec["candidates"]),
        autotune_winner=json.dumps({k: rec["winner"][k] for k in
                                    ("attn_impl", "attn_chunk", "use_pallas",
                                     "fuse_swiglu", "fuse_norm_matmul",
                                     "fuse_rotary_qkv")}),
        autotune_ms=json.dumps([round(c["ms"], 3)
                                for c in rec["candidates"]]),
        re_resolve_sweeps=st2.autotune_sweeps)
    for label, (over, n_micro) in SMALL_VARIANTS.items():
        _train_small_variant(cfg, label, over, n_micro)


# the train step's other paths at phase 8's small width: gradient
# accumulation over two microbatches (``_microbatch_grads``), and
# ``lr_schedule``'s WSD and constant branches; WSD decays over the last
# three of its five steps (total_steps 5, decay_frac 0.6), so steps 3 and
# 4 take a decayed rate
SMALL_VARIANTS = {
    "n_micro=2": ({}, 2),
    "wsd": (dict(schedule="wsd", total_steps=SMALL_STEPS, decay_frac=0.6),
            1),
    "constant": (dict(schedule="constant"), 1),
}


def _train_small_variant(cfg, label: str, over: dict, n_micro: int,
                         card: str = "cuda") -> dict:
    """Five steps of ``cfg`` with ``over`` and ``n_micro`` microbatches
    from the builder's seed-0 weights: on ``card`` captured, then eagerly
    (the same losses and state bit for bit), and on the CPU (loss within
    1e-4 of scale, the state within ``STATE_LIMITS["f32"]``)."""
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.devices import to_numpy
    from repro_torch.models.lm import build_graphs
    from repro_torch.models.train_graph import make_train_step

    vcfg = dataclasses.replace(cfg, **over)
    mb = SMALL_BATCH // n_micro
    g = build_graphs(vcfg, ShapeConfig("train", "train", SMALL_SEQ, mb), mb)
    ts = make_train_step(g, vcfg, n_micro=n_micro)
    n_data, n_p = len(g.builder.inputs), ts.n_params
    donate = tuple(range(n_data + 1, n_data + 1 + 3 * n_p))
    batches = _train_batches(vcfg, ts, SMALL_BATCH, SMALL_SEQ,
                             range(SMALL_STEPS))
    params = g.builder.init_params(0)
    host = [params[n] for n in ts.param_names] + \
        [np.zeros_like(params[n]) for n in ts.param_names] * 2
    runs = {}
    for what, dev, static in (("captured", card, True),
                              ("eager", card, False), ("cpu", "cpu", True)):
        cf = Backend.create("torch", fresh=True, device=dev).compile(
            ts.fn, CompileOptions(level="O2", use_pallas=True,
                                  donate_argnums=donate, static_jit=static))
        flat = [torch.from_numpy(a.copy()).to(dev) for a in host]
        need = ("flash_attention",) if dev == "cuda" else ()
        losses, _, _, flat = _train_steps(cf, flat, batches, required=need,
                                          label=f"small {label} {what}")
        runs[what] = (losses, [to_numpy(t) for t in flat])
        del cf, flat
    (lc, pc), (le, pe), (lh, ph) = runs["captured"], runs["eager"], \
        runs["cpu"]
    require(lc == le and all(np.array_equal(a, b) for a, b in zip(pc, pe)),
            f"small {label}: captured {lc} != eager {le} (or the state)")
    loss_err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(lc, lh))
    require(loss_err <= 1e-4, f"small {label}: card vs CPU loss "
            f"{loss_err:.3e} of scale")
    gaps = _state_gaps(host[:n_p], ph, pc)
    _require_state(gaps, "f32", f"small {label}: card vs CPU")
    say("train_small", variant=label, steps=SMALL_STEPS,
        card_losses=json.dumps(lc), captured_vs_eager="bitwise",
        card_vs_cpu_loss=f"{loss_err:.3e}",
        card_vs_cpu_gaps=json.dumps({k: f"{v:.3e}" for k, v in gaps.items()}))
    return {"losses": lc, "loss_err": loss_err, "gaps": gaps}


# -- 9. the mixture-of-experts families, full width -----------------------------
MOE_LAYERS = 2          # mixtral 56 -> 2, deepseek-v3 61 -> 2 (1 dense, 1 MoE)
MOE_NEW, MX_LONG_NEW = 16, 8
# card against CPU at a reduced width whose attention takes flash: d_head
# 128 for mixtral (GQA 4:2, the reduced 8-token window); for MLA the
# prefill's d_nope + d_rope and the absorbed decode's kv_lora + d_rope
# both 128 wide
MOE_SMALL = {"mixtral-8x22b": dict(d_model=256, n_heads=4, n_kv_heads=2,
                                   d_head=128, compute_dtype="f32"),
             "deepseek-v3-671b": dict(d_model=256, d_nope=64, d_rope=64,
                                      d_v=128, kv_lora=64,
                                      compute_dtype="f32")}
MOE_SMALL_PROMPT, MOE_SMALL_NEW = 24, 10


def _moe_config(arch: str):
    """``arch`` at full width with the depth cut to :data:`MOE_LAYERS`;
    deepseek-v3's parameters in bf16 (f32 parameters and their
    per-dispatch bf16 converts would not fit in 80 GB)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.mla:
        return dataclasses.replace(cfg, n_layers=MOE_LAYERS, first_dense=1,
                                   param_dtype="bf16")
    return dataclasses.replace(cfg, n_layers=MOE_LAYERS)


@contextlib.contextmanager
def _launched_shapes(seen: dict):
    """While open, each call of a kernel wrapper on the card adds one to
    ``seen[signature]``: the kernel, its tensors' shapes and dtypes, its
    other arguments, and which keywords were tensors (flash's q_offset).
    The wrappers are looked up on their modules at every call, so the
    emitter's calls (and those a CUDA-graph capture makes) pass here."""
    from repro_torch import kernels

    def recording(name, fn):
        def call(*args, **kw):
            if args[0].is_cuda:
                # the batched kernel's operands are strided views: which
                # of them is transposed is part of what it launched
                extra = tuple(a for a in args
                              if not isinstance(a, torch.Tensor))
                if name == "batched_matmul":
                    extra += (args[0].stride(-1) != 1,
                              args[1].stride(-1) != 1)
                sig = (name,
                       tuple((tuple(a.shape), a.dtype) for a in args
                             if isinstance(a, torch.Tensor)),
                       extra,
                       tuple(sorted((k, "tensor" if isinstance(
                           v, torch.Tensor) else v) for k, v in kw.items())))
                seen[sig] = seen.get(sig, 0) + 1
            return fn(*args, **kw)
        return call

    wrapped = {name: getattr(mod, name)
               for name, mod in kernels.MODULES.items()}
    try:
        for name, fn in wrapped.items():
            setattr(kernels.MODULES[name], name, recording(name, fn))
        yield seen
    finally:
        for name, fn in wrapped.items():
            setattr(kernels.MODULES[name], name, fn)


def _launched_case(gen, sig, calls: int, model: str):
    """The :func:`_case_makers` case of one :func:`_launched_shapes`
    signature: its shapes and dtypes, inputs drawn from ``gen``; a query
    offset given as a tensor puts the queries at the end of the keys (a
    decode step at the cache's last row: every key in the window
    visible)."""
    cases = []
    mm, nm, sw, rn, fa, bm = _case_makers(gen, cases)
    name, tensors, extra, kw = sig
    shp = [s for s, _ in tensors]
    dts = [d for _, d in tensors]
    kw = dict(kw)
    eps = extra[0] if extra else kw.get("eps")
    label = (f"{model} launched " + " ".join(
        "x".join(map(str, s)) + ":" + str(d).split(".")[-1]
        for s, d in tensors) + f" ({calls} calls)")
    if name == "matmul":
        (M, K), (_, N) = shp
        mm(label, M, K, N, dts[0])
    elif name == "norm_matmul":
        (M, K), _, (_, N) = shp
        nm(label, M, N, dts[1], K=K, dt=dts[0], eps=eps)
    elif name == "swiglu":
        (M, d), (_, f) = shp[0], shp[1]
        sw(label, M, dts[0], d=d, f=f)
    elif name == "rmsnorm":
        x, (d,) = shp
        rn(label, math.prod(x[:-1]), dts[1], d=d, dt=dts[0], eps=eps)
    elif name == "batched_matmul":
        (batch, M, K), (_, _, N) = shp
        out, a_t, b_t = (extra if len(extra) == 3
                         else (kw.get("out_dtype"),) + extra)
        bm(label, batch, M, N, K, dts[0], a_t=a_t, b_t=b_t,
           out=out or (dts[0] if dts[0] == dts[1] else torch.float32))
    else:
        (B, Hq, Sq, dk), (_, Hkv, Skv, _), (*_, dv) = shp
        off = Skv - Sq if kw.get("q_offset") == "tensor" else None
        fa(label, B, Hq, Hkv, Sq, Skv, off, dts[0], dk=dk, dv=dv,
           window=kw.get("window"), causal=kw.get("causal", True),
           scale=kw.get("scale"))
    return cases[0]


def _hold_launched(seen: dict, model: str) -> dict:
    """Hold each distinct shape a model's runs launched (recorded by
    :func:`_launched_shapes`) against its plain version, with its time,
    its bound and the library call's; returns the shapes held per
    kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    held = {}
    for sig, calls in sorted(seen.items(), key=repr):
        _hold(_launched_case(gen, sig, calls, model), flush)
        held[sig[0]] = held.get(sig[0], 0) + 1
        torch.cuda.empty_cache()
    del flush
    return held


def _lockstep_run(cfg, params, prompts, max_new, static_jit: bool):
    """One lockstep workload on a fresh engine (as many slots as
    prompts); returns (engine, report, counters of the run, peak GB
    allocated, peak GB reserved)."""
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, EngineConfig(
        mode="lockstep", slots=len(prompts),
        max_len=len(prompts[0]) + max_new, device="cuda", params=params),
        options=CompileOptions(level="O2", use_pallas=True,
                               static_jit=static_jit))
    kernels.reset_counters()
    rids = [eng.submit(p, max_new) for p in prompts]
    rep = eng.run()
    torch.cuda.synchronize()
    counts = kernels.counters()
    for r in rids:
        toks = rep.results[r]
        require(rep.statuses[r] == "completed" and len(toks) == max_new
                and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
                f"{cfg.name}: request {r}: {rep.statuses[r]} "
                f"{rep.errors.get(r)} {toks}")
    return (eng, rep, counts, torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)


def _lockstep_gate(report, phase, cfg, counts, flash_per_run: int,
              main: bool) -> None:
    """Exactly the kernels ``serve.smoke_kernels`` names for the family
    launched; none refused but deepseek-v3's absorbed-decode attention
    (Hkv 1, Dk kv_lora + d_rope = 576, wider than the flash kernel's
    256), refused exactly once per layer and decode step; flash launched
    exactly ``flash_per_run`` times."""
    from repro_torch.launch.serve import smoke_kernels
    need, may_refuse = smoke_kernels(cfg)
    launched = {k for k, c in counts.items() if c["launches"]}
    require(launched == need, f"{phase}: launched {sorted(launched)}, "
            f"the path's kernels are {sorted(need)}")
    got = counts["flash_attention"]["launches"]
    require(got == flash_per_run, f"{phase}: {got} flash launches, "
            f"{flash_per_run} expected")
    refused = counts["flash_attention"]["rejected"]
    if "flash_attention" in may_refuse:
        want = cfg.n_layers * (MOE_NEW - 1)
        require(refused == want, f"{phase}: {refused} flash refusals, "
                f"{want} expected (the absorbed decode: {cfg.n_layers} "
                f"layers x {MOE_NEW - 1} steps)")
        counts = dict(counts, flash_attention=dict(
            counts["flash_attention"], rejected=0))
    _record_launches(report, phase, counts, need, main=main)
    if may_refuse:
        report["flash_attention"].setdefault("refused_by_phase", {})[
            phase] = refused


def phase_moe(report: dict, smi: str) -> None:
    """Both mixture-of-experts families at full width through
    ``ServeEngine(mode="lockstep")`` at O2 with the kernels, bf16
    compute, weights drawn on the card from seed 0, depth cut to
    :data:`MOE_LAYERS`.  Mixtral-8x22b (f32 parameters): 4 greedy
    requests of 128 prompt tokens and 16 new ones, eagerly and then
    captured (the same tokens bit for bit), then one request of 4,224
    prompt tokens and 8 new ones on one slot, whose prefill and decode
    attend across the 4096-token window.  Deepseek-v3-671b (bf16
    parameters): 4 requests of 64 prompt tokens and 16 new ones, eagerly
    and then captured.  Each run's kernels launched (mixtral: matmul,
    norm_matmul, rmsnorm, flash; deepseek-v3: all five) and none refused
    but deepseek-v3's absorbed decode attention; a replay's profile of
    each model's decode graph shows each kernel at its counted launches.
    After each model, every distinct shape its runs gave a kernel is
    held against the plain version (:func:`_hold_launched`).  Then both
    families at a reduced d_head-128 width in f32, the same
    numpy weights on the card (kernels) and on the CPU (plain versions):
    the same greedy tokens."""
    from repro_torch.models.weights import init_params_on_device
    from repro_torch.launch.serve import full_width_builder

    held = _free_card()
    rng = np.random.default_rng(9)
    for arch in ("mixtral-8x22b", "deepseek-v3-671b"):
        cfg = _moe_config(arch)
        P = V3_PROMPT if cfg.mla else MX_PROMPT
        t0 = time.perf_counter()
        params = init_params_on_device(
            full_width_builder(cfg, P + MOE_NEW, SLOTS), 0, "cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n = sum(t.numel() for t in params.values())
        gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
        prompts = [rng.integers(0, cfg.vocab, P).astype(np.int32)
                   for _ in range(SLOTS)]
        # a prefill (one launch a layer) and MOE_NEW - 1 decode steps;
        # deepseek-v3's decode attention is the refused absorbed one
        flash = cfg.n_layers * (1 if cfg.mla else MOE_NEW)
        toks = {}
        shapes = contextlib.ExitStack()
        seen = shapes.enter_context(_launched_shapes({}))
        for what, sj in (("eager", False), ("captured", True)):
            eng, rep, counts, peak, reserved = _lockstep_run(
                cfg, params, prompts, MOE_NEW, sj)
            toks[what] = [rep.results[r].tolist() for r in sorted(rep.results)]
            _lockstep_gate(report, f"moe_{cfg.name}_{what}", cfg, counts, flash,
                      main=sj)
            if sj:
                require(eng.cf.raw.captured,
                        f"{cfg.name}: the decode graph was never captured")
                _require_replay_profile(f"{cfg.name}_decode", eng.cf,
                                        eng.tparams)
            say("moe", model=cfg.name, dispatch=what, layers=cfg.n_layers,
                params_b=f"{n / 1e9:.3f}", params_gb=f"{gb:.2f}",
                param_dtype=cfg.param_dtype, init_s=f"{t_init:.2f}",
                requests=len(prompts), prompt_len=P,
                generated=rep.generated_tokens,
                prefill_ms=f"{rep.prefill_seconds * 1e3:.1f}",
                decode_tok_s=f"{rep.decode_tok_s:.2f}",
                decode_step_p50_ms=f"{rep.p50_ms:.1f}",
                wall_s=f"{rep.wall_seconds:.2f}", peak_gb=f"{peak:.2f}",
                reserved_gb=f"{reserved:.2f}",
                launches=json.dumps({k: v["launches"]
                                     for k, v in counts.items()}),
                refused=json.dumps({k: v["rejected"]
                                    for k, v in counts.items()}),
                card=repr(smi))
            del eng
        require(toks["captured"] == toks["eager"],
                f"{cfg.name}: captured greedy tokens differ from eager: "
                f"{toks['captured']} vs {toks['eager']}")
        say("moe", model=cfg.name, captured_vs_eager="bitwise",
            requests=len(prompts))
        if not cfg.mla:
            # one request across the sliding window: prefill attends over
            # 4224 keys under the 4096 window, decode past it
            long_prompt = [rng.integers(0, cfg.vocab, MX_LONG).astype(
                np.int32)]
            eng, rep, counts, peak, reserved = _lockstep_run(
                cfg, params, long_prompt, MX_LONG_NEW, True)
            _lockstep_gate(report, f"moe_{cfg.name}_long", cfg, counts,
                      cfg.n_layers * MX_LONG_NEW, main=True)
            say("moe", model=cfg.name, dispatch="captured", slots=1,
                prompt_len=MX_LONG, window=cfg.window,
                generated=rep.generated_tokens,
                prefill_ms=f"{rep.prefill_seconds * 1e3:.1f}",
                decode_tok_s=f"{rep.decode_tok_s:.2f}",
                decode_step_p50_ms=f"{rep.p50_ms:.1f}",
                peak_gb=f"{peak:.2f}", reserved_gb=f"{reserved:.2f}",
                launches=json.dumps({k: v["launches"]
                                     for k, v in counts.items()}),
                card=repr(smi))
            del eng
        shapes.close()
        del params
        held = _free_card()
        by_kernel = _hold_launched(seen, cfg.name)
        require(set(by_kernel) == {k for k, c in report.items()
                                   if c["launches_by_phase"].get(
                                       f"moe_{cfg.name}_eager")},
                f"{cfg.name}: shapes held {by_kernel}, launched "
                f"{report}")
        say("moe_shapes", model=cfg.name, held=sum(by_kernel.values()),
            by_kernel=json.dumps(by_kernel), card=repr(smi))
    _lockstep_parity("moe_parity", MOE_SMALL)
    say("moe", families="moe,mla_moe", result="ok",
        held_gb=f"{held:.2f}")


def _lockstep_parity(line: str, smalls: dict) -> None:
    """Each ``{arch: reduced() overrides}`` of ``smalls``, the builder's
    numpy weights carried across by ``params_from_numpy``: lockstep on
    the card with the kernels and on the CPU with their plain versions
    give the same greedy tokens, and every kernel of the path launched
    on the card."""
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    from repro_torch.launch.serve import full_width_builder, smoke_kernels
    from repro_torch.models.weights import params_from_numpy

    out = {}
    for arch, over in smalls.items():
        cfg = get_config(arch).reduced(**over)
        max_len = MOE_SMALL_PROMPT + MOE_SMALL_NEW
        np_params = full_width_builder(cfg, max_len, SLOTS).init_params(0)
        for name in MM_GATES:   # vlm's cross blocks add nothing at tanh(0)
            if name in np_params:
                np_params[name][...] = 0.5
        prompts = _prompts(cfg.vocab, (MOE_SMALL_PROMPT,) * SLOTS, 8, seed=4)
        results = {}
        for dev in ("cuda", "cpu"):
            kernels.reset_counters()
            eng = ServeEngine(cfg, EngineConfig(
                mode="lockstep", slots=SLOTS, max_len=max_len, device=dev,
                params=params_from_numpy(np_params, dev)),
                options=CompileOptions(level="O2", use_pallas=True))
            rids = [eng.submit(p, MOE_SMALL_NEW) for p in prompts]
            rep = eng.run()
            require(all(rep.statuses[r] == "completed" for r in rids),
                    f"{arch} small {dev}: {rep.statuses} {rep.errors}")
            results[dev] = [rep.results[r].tolist() for r in rids]
            if dev == "cuda":
                card = kernels.counters()
        launched = {k: c["launches"] for k, c in card.items()}
        need, _ = smoke_kernels(cfg)
        require(all(launched[k] > 0 for k in need),
                f"{arch} small: a kernel never launched on the card: "
                f"{launched}")
        require(results["cuda"] == results["cpu"],
                f"{arch} small f32: card tokens {results['cuda']} differ "
                f"from the CPU's {results['cpu']}")
        out[f"{arch}_d_head"] = cfg.head_dim
        out[f"{arch}_tokens"] = "identical"
        out[f"{arch}_launches"] = json.dumps(launched)
        out[f"{arch}_refused"] = sum(c["rejected"] for c in card.values())
    say(line, width="reduced, f32", **out)


# -- 10. the recurrent families, full width -----------------------------------
RG_LAYERS = 8    # 38 -> 8: two (rec, rec, attn) groups and the two-rec tail
# card against CPU at a reduced width, f32: rg at d_head 128 (MQA 2:1,
# the reduced 8-token window), so its attention takes flash on the card
REC_SMALL = {"recurrentgemma-9b": dict(d_model=256, n_heads=2, d_head=128,
                                       compute_dtype="f32"),
             "xlstm-350m": dict(d_model=256, compute_dtype="f32")}


def _rec_config(arch: str):
    """``arch`` at full width; recurrentgemma's depth cut to
    :data:`RG_LAYERS` (both of its Scans run as at 38 layers: the groups
    Scan twice, then the tail); xlstm at full depth (24 blocks)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.family == "rg_hybrid":
        return dataclasses.replace(cfg, n_layers=RG_LAYERS)
    return cfg


def _rec_line(cfg, what, rep, eng, counts, peak, reserved, smi,
              line="recurrent", **kw):
    per_step = (_per_replay(eng.cf.raw) if getattr(eng.cf.raw, "captured",
                                                   False) else None)
    say(line, model=cfg.name, dispatch=what, layers=cfg.n_layers,
        **kw, generated=rep.generated_tokens,
        prefill_ms=f"{rep.prefill_seconds * 1e3:.1f}",
        decode_tok_s=f"{rep.decode_tok_s:.2f}",
        decode_step_p50_ms=f"{rep.p50_ms:.1f}",
        wall_s=f"{rep.wall_seconds:.2f}", peak_gb=f"{peak:.2f}",
        reserved_gb=f"{reserved:.2f}",
        launches_per_step=json.dumps(per_step),
        launches=json.dumps({k: v["launches"] for k, v in counts.items()}),
        refused=json.dumps({k: v["rejected"] for k, v in counts.items()}),
        card=repr(smi))


def phase_recurrent(report: dict, smi: str) -> None:
    """Both recurrent families at full width through
    ``ServeEngine(mode="lockstep")`` at O2 with the kernels, bf16
    compute, f32 parameters drawn on the card from seed 0.
    Recurrentgemma-9b, depth 8 (:data:`RG_LAYERS`): 4 greedy requests of
    128 prompt tokens and 16 new ones, eagerly and then captured (the
    same tokens bit for bit), then one request of 2,176 tokens (past the
    2048-token window) and 8 new ones.  Xlstm-350m, all 24 blocks: 4
    requests of 128 tokens and 16 new ones, eagerly and then captured.
    Each run launches exactly the kernels ``serve.smoke_kernels`` names
    for the family (rg: all five; xlstm: matmul, norm_matmul, rmsnorm)
    and refuses none; flash launches once per attention layer and call
    (the prefill and each decode step); a replay's profile of each
    decode graph shows each kernel at its counted launches.  After each
    model, every distinct shape its runs gave a kernel is held against
    the plain version (:func:`_hold_launched`).  Then both at
    :data:`REC_SMALL` in f32: the card's greedy tokens equal the CPU's.
    Decode starts the recurrent states from zeros, as the reference's
    does (its prefill exports only rg's attention caches)."""
    from repro_torch.launch.serve import full_width_builder, smoke_kernels
    from repro_torch.models.weights import init_params_on_device

    held = _free_card()
    rng = np.random.default_rng(10)
    for arch in ("recurrentgemma-9b", "xlstm-350m"):
        cfg = _rec_config(arch)
        need, _ = smoke_kernels(cfg)
        n_attn = sum(cfg.pattern[i % len(cfg.pattern)] == "attn"
                     for i in range(cfg.n_layers)) if cfg.pattern else 0
        t0 = time.perf_counter()
        params = init_params_on_device(
            full_width_builder(cfg, REC_PROMPT + REC_NEW, SLOTS), 0, "cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n = sum(t.numel() for t in params.values())
        gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
        prompts = [rng.integers(0, cfg.vocab, REC_PROMPT).astype(np.int32)
                   for _ in range(SLOTS)]
        toks = {}
        shapes = contextlib.ExitStack()
        seen = shapes.enter_context(_launched_shapes({}))
        for what, sj in (("eager", False), ("captured", True)):
            eng, rep, counts, peak, reserved = _lockstep_run(
                cfg, params, prompts, REC_NEW, sj)
            toks[what] = [rep.results[r].tolist() for r in sorted(rep.results)]
            _lockstep_gate(report, f"rec_{cfg.name}_{what}", cfg, counts,
                           n_attn * REC_NEW, main=sj)
            if sj:
                require(eng.cf.raw.captured,
                        f"{cfg.name}: the decode graph was never captured")
                _require_replay_profile(f"{cfg.name}_decode", eng.cf,
                                        eng.tparams)
            _rec_line(cfg, what, rep, eng, counts, peak, reserved, smi,
                      params_b=f"{n / 1e9:.3f}", params_gb=f"{gb:.2f}",
                      init_s=f"{t_init:.2f}", requests=len(prompts),
                      prompt_len=REC_PROMPT)
            del eng
        require(toks["captured"] == toks["eager"],
                f"{cfg.name}: captured greedy tokens differ from eager: "
                f"{toks['captured']} vs {toks['eager']}")
        say("recurrent", model=cfg.name, captured_vs_eager="bitwise",
            requests=len(prompts))
        if n_attn:
            # one request past the window: prefill attends over 2176 keys
            # under the 2048 window, decode past it
            long_prompt = [rng.integers(0, cfg.vocab, RG_LONG).astype(
                np.int32)]
            eng, rep, counts, peak, reserved = _lockstep_run(
                cfg, params, long_prompt, RG_LONG_NEW, True)
            _lockstep_gate(report, f"rec_{cfg.name}_long", cfg, counts,
                           n_attn * RG_LONG_NEW, main=True)
            _require_replay_profile(f"{cfg.name}_long_decode", eng.cf,
                                    eng.tparams)
            _rec_line(cfg, "captured", rep, eng, counts, peak, reserved, smi,
                      slots=1, prompt_len=RG_LONG, window=cfg.local_window)
            del eng
        shapes.close()
        del params
        held = _free_card()
        by_kernel = _hold_launched(seen, cfg.name)
        require(set(by_kernel) == need,
                f"{cfg.name}: shapes held {by_kernel}, written {need}")
        say("recurrent_shapes", model=cfg.name, held=sum(by_kernel.values()),
            by_kernel=json.dumps(by_kernel), card=repr(smi))
    _lockstep_parity("recurrent_parity", REC_SMALL)
    say("recurrent", families="rg_hybrid,xlstm", result="ok",
        held_gb=f"{held:.2f}")


# -- 11. the multimodal families, full width -----------------------------------
MM_ARCHS = ("whisper-medium", "llama-3.2-vision-11b")
MM_PROMPT = {"whisper-medium": 64, "llama-3.2-vision-11b": 128}
MM_NEW = 16
# vlm's depth: full (40 layers, 8 groups) when the reckoned peak fits
# under MM_PEAK_LIMIT_GB, else 20 layers (4 groups), never below 2 groups
MM_PEAK_LIMIT_GB, VLM_CUT_LAYERS = 70.0, 20
MM_GATES = ("groups/x_gate_attn", "groups/x_gate_ffn")
# card against CPU at a reduced width whose attention takes flash, f32:
# whisper at d_head 64 (its full-width head), vlm at d_head 128 (GQA 2:1)
MM_SMALL = {"whisper-medium": dict(d_model=128, n_heads=2, n_kv_heads=2,
                                   d_head=64, d_ff=256,
                                   compute_dtype="f32"),
            "llama-3.2-vision-11b": dict(d_model=256, n_heads=2,
                                         n_kv_heads=1, d_head=128,
                                         d_ff=256, compute_dtype="f32")}


def _reckon_peak_gb(cfg, builder, prompt_len: int) -> float:
    """The lockstep run's peak as the builder's parameter census reckons
    it: the f32 parameters, their bf16 copies (a dispatch converts every
    weight it reads, and the Scans' stacked weights are converted before
    the Scan runs, all of them at once), the stubbed frames or images
    and the decode's self and cross caches in bf16."""
    n = sum(math.prod(s.shape) for s in builder.params.values())
    row = SLOTS * cfg.n_kv_heads * cfg.head_dim * 2   # one key's K and V
    if cfg.family == "encdec":   # per decoder layer: self and cross
        media = SLOTS * cfg.enc_seq * cfg.d_model
        caches = cfg.n_layers * row * (prompt_len + MM_NEW + cfg.enc_seq)
    else:   # per self block, and per group the image keys and values
        media = SLOTS * cfg.vision_tokens * cfg.vision_dim
        caches = (cfg.n_layers * row * (prompt_len + MM_NEW)
                  + cfg.n_layers // cfg.cross_every * row
                  * cfg.vision_tokens)
    return (n * (4 + 2) + 2 * (media + caches)) / 1e9


def _mm_config(arch: str, prompt_len: int):
    """(config, the builder that declares its parameters, the reckoned
    peak GB, why this depth): whisper at full depth (24 + 24 layers); vlm at full
    depth (40 layers) when :func:`_reckon_peak_gb` is under
    :data:`MM_PEAK_LIMIT_GB`, else :data:`VLM_CUT_LAYERS`."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import full_width_builder
    cfg = get_config(arch)
    b = full_width_builder(cfg, prompt_len + MM_NEW, SLOTS)
    gb = _reckon_peak_gb(cfg, b, prompt_len)
    if cfg.family == "vlm" and gb >= MM_PEAK_LIMIT_GB:
        full = gb
        cfg = dataclasses.replace(cfg, n_layers=VLM_CUT_LAYERS)
        require(cfg.n_layers // cfg.cross_every >= 2,
                f"{arch}: fewer than two cross-attention groups")
        b = full_width_builder(cfg, prompt_len + MM_NEW, SLOTS)
        return (cfg, b, _reckon_peak_gb(cfg, b, prompt_len),
                f"full depth reckoned {full:.1f} GB >= {MM_PEAK_LIMIT_GB}")
    return cfg, b, gb, "full depth"


def _mm_flash_per_run(cfg) -> tuple:
    """(flash launches per prefill, per decode step): one per Attention
    op -- whisper's encoder self-attention, decoder self- and
    cross-attention in the prefill, the decoder's two in a decode step;
    vlm's cross block and self blocks of every group in both."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    per = (cfg.n_layers // cfg.cross_every) * (1 + cfg.cross_every)
    return per, per


def _prefill_profile(eng, prompts, cfg, smi) -> None:
    """Two more eager calls of the engine's prefill graph on the run's
    inputs, outside the counted run: the first times it on the host's
    clock (``wall_ms``, to the logits on the host), the second runs under
    ``torch.profiler`` (device busy and union ms, the top kernels)."""
    g, cf, pvals = eng._prefill_for(len(prompts[0]), len(prompts))
    pin = eng._prefill_inputs(g, np.stack(prompts))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cf(*pin, *pvals)
    wall = time.perf_counter() - t0
    rows, union, ours, edges = _profile(lambda: cf(*pin, *pvals))
    say("multimodal_prefill", model=cfg.name, dispatch="eager",
        wall_ms=f"{wall * 1e3:.1f}",
        device_busy_ms=f"{sum(r[0] for r in rows):.1f}",
        device_union_ms=(f"{union / 1e3:.1f}" if union is not None
                         else "not measured"),
        device_kernels=sum(r[1] for r in rows),
        port_kernels_ms=json.dumps({k: round(v[0], 3)
                                    for k, v in ours.items()}),
        profile_edges=json.dumps(edges),
        top=json.dumps([[k[:60], round(ms, 3), n]
                        for ms, n, k in rows[:10]]), card=repr(smi))


def phase_multimodal(report: dict, smi: str) -> None:
    """Both multimodal families at full width through
    ``ServeEngine(mode="lockstep")`` at O2 with the kernels, bf16
    compute, f32 parameters drawn on the card from seed 0 (the prefill
    builder's: whisper's encoder, vlm's vision projection too).
    Whisper-medium at full depth: 4 greedy requests of 64 prompt tokens
    and 16 new ones, the encoder over 4 x 1500 stubbed frames.
    Llama-3.2-vision-11b at the depth :func:`_mm_config` settles: 4
    requests of 128 prompt tokens and 16 new ones over 1601 stubbed
    image tokens of width 7680.  Each eagerly and then captured (the
    same tokens bit for bit, the decode graph captured); each run
    launches exactly the kernels ``serve.smoke_kernels`` names (whisper:
    matmul and flash; vlm: all five) and refuses none; flash launches
    once per Attention op and call (:func:`_mm_flash_per_run`); a
    replay's profile of each decode graph shows each kernel at its
    counted launches.  After each model, every distinct shape its runs
    gave a kernel (flash at 64-wide heads and over 1500 and 1601 keys
    among them) is held against the plain version
    (:func:`_hold_launched`).  Then both at :data:`MM_SMALL` in f32,
    vlm's gates open: the card's greedy tokens equal the CPU's.  The
    lockstep decode cross-attends over zeros, as the reference's does:
    the prefill exports only the self-attention caches."""
    from repro_torch.launch.serve import smoke_kernels
    from repro_torch.models.weights import init_params_on_device

    held = _free_card()
    rng = np.random.default_rng(11)
    for arch in MM_ARCHS:
        P = MM_PROMPT[arch]
        cfg, builder, reckoned, why = _mm_config(arch, P)
        need, _ = smoke_kernels(cfg)
        t0 = time.perf_counter()
        params = init_params_on_device(builder, 0, "cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n = sum(t.numel() for t in params.values())
        gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
        prompts = [rng.integers(0, cfg.vocab, P).astype(np.int32)
                   for _ in range(SLOTS)]
        f_pre, f_dec = _mm_flash_per_run(cfg)
        toks = {}
        shapes = contextlib.ExitStack()
        seen = shapes.enter_context(_launched_shapes({}))
        for what, sj in (("eager", False), ("captured", True)):
            eng, rep, counts, peak, reserved = _lockstep_run(
                cfg, params, prompts, MM_NEW, sj)
            toks[what] = [rep.results[r].tolist() for r in sorted(rep.results)]
            _lockstep_gate(report, f"mm_{cfg.name}_{what}", cfg, counts,
                           f_pre + f_dec * (MM_NEW - 1), main=sj)
            if sj:
                require(eng.cf.raw.captured,
                        f"{cfg.name}: the decode graph was never captured")
                _require_replay_profile(f"{cfg.name}_decode", eng.cf,
                                        eng.tparams)
            _rec_line(cfg, what, rep, eng, counts, peak, reserved, smi,
                      line="multimodal", params_b=f"{n / 1e9:.3f}",
                      params_gb=f"{gb:.2f}", reckoned_peak_gb=f"{reckoned:.2f}",
                      depth=repr(why), init_s=f"{t_init:.2f}",
                      requests=len(prompts), prompt_len=P,
                      media_tokens=(cfg.enc_seq if cfg.family == "encdec"
                                    else cfg.vision_tokens))
            if not sj:
                _prefill_profile(eng, prompts, cfg, smi)
            del eng
        require(toks["captured"] == toks["eager"],
                f"{cfg.name}: captured greedy tokens differ from eager: "
                f"{toks['captured']} vs {toks['eager']}")
        say("multimodal", model=cfg.name, captured_vs_eager="bitwise",
            requests=len(prompts))
        shapes.close()
        del params
        held = _free_card()
        by_kernel = _hold_launched(seen, cfg.name)
        require(set(by_kernel) == need,
                f"{cfg.name}: shapes held {by_kernel}, written {need}")
        say("multimodal_shapes", model=cfg.name,
            held=sum(by_kernel.values()), by_kernel=json.dumps(by_kernel),
            card=repr(smi))
    _lockstep_parity("multimodal_parity", MM_SMALL)
    say("multimodal", families="encdec,vlm", result="ok",
        held_gb=f"{held:.2f}")


# -- 12. tensor-parallel paged serving, full width ---------------------------
TP = 2
TP_CARD = "cuda"           # the device both shards name
TP_LEVELS = ("O2", "O1")   # the main path first, then local-width products
TP_PEAK_LIMIT_GB = 70.0
TP_NEW = 16
# the cancel workload: a published prefix of three pages, and a request
# that attaches them and is cancelled while it prefills the rest
TP_BASE, TP_LONG = 48, 208


def _tp_census(cfg, tp: int = TP) -> dict:
    """The parameter census of phase 12's engine: all parameters (n),
    those the tp profile shards (s), and the KV pool's elements."""
    from repro_torch.backend.sharding import partition_profile
    from repro_torch.core.passes import PartitionGraph
    from repro_torch.models.lm import build_dense_chunk
    g = build_dense_chunk(cfg, MAIN_ENGINE["max_len"], SLOTS,
                          MAIN_ENGINE["chunk_steps"],
                          page_size=MAIN_ENGINE["page_size"])
    pg = PartitionGraph.from_profile(partition_profile("tp"), (tp,))
    specs = {p.name: pg.seed_spec(p) for p in g.fn.parameters}
    n = s = 0
    for name, spec in g.builder.params.items():
        size = math.prod(spec.shape)
        n += size
        if any(specs.get(name, ())):
            s += size
    pool = sum(math.prod(node.out_types[0].shape) for node in g.builder.inputs
               if node.name not in ("token", "pos", "page_tbl",
                                    "temperature", "top_k", "key"))
    return {"n": n, "s": s, "pool": pool}


def _reckon_tp_peak_gb(cfg, level: str, tp: int = TP) -> float:
    """:func:`_reckon_peak_gb` for the shards on one card: the f32
    parameters (n), the split copies of the sharded ones (s, one whole
    copy across the shards), every shard's bf16 converts (its half of
    each sharded weight, all of each replicated one), at O2 the gathered
    bf16 weights (the shards on one card share each AllGather's output),
    and the bf16 pool four times over (the pool, its split, the join and
    the tokens' caches)."""
    c = _tp_census(cfg, tp)
    n, s, pool = c["n"], c["s"], c["pool"]
    r = n - s
    total = 4 * n + 4 * s + 2 * (r * tp + s) + 2 * 4 * pool
    if level == "O2":
        total += 2 * s
    return total / 1e9


def _tp_config():
    """(config, the reckoned O2 peak GB, why this depth): deepseek-7b at
    full width, as deep as :func:`_reckon_tp_peak_gb` stays under
    :data:`TP_PEAK_LIMIT_GB` at O2 (30 layers at most)."""
    from repro_torch.configs import get_config
    full = get_config("deepseek-7b")
    depth = full.n_layers
    while depth > 2:
        cfg = dataclasses.replace(full, n_layers=depth)
        gb = _reckon_tp_peak_gb(cfg, "O2")
        if gb < TP_PEAK_LIMIT_GB:
            break
        depth -= 1
    why = ("full depth" if depth == full.n_layers else
           f"{full.n_layers} layers reckoned over {TP_PEAK_LIMIT_GB} GB")
    return cfg, gb, why


def _tp_partition_reference(cfg):
    """Start ``scripts/check_torch_parity.py --kind tp`` on phase 12's
    graphs (full width, ``cfg``'s depth, the engine's shape) in a
    process of its own: it partitions them with the reference's pass and
    with the port's (numpy only, no device) and writes both stats."""
    out = os.path.join(ROOT, "build", "tp_partition_stats.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    cmd = [sys.executable, os.path.join(ROOT, "scripts",
                                        "check_torch_parity.py"),
           "--kind", "tp", "--tp", str(TP), "--tp-width", "full",
           "--layers", str(cfg.n_layers), "--slots", str(SLOTS),
           "--max-len", str(MAIN_ENGINE["max_len"]),
           "--page-size", str(MAIN_ENGINE["page_size"]),
           "--chunk-steps", str(MAIN_ENGINE["chunk_steps"]),
           "--prefill-chunk", str(CHUNK), "--json", out]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return proc, out


def _tp_reference_stats(proc, out) -> dict:
    try:
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0 and os.path.exists(out),
            f"check_torch_parity.py --kind tp: rc {proc.returncode}: "
            f"{log[-2000:]}")
    with open(out) as f:
        return json.load(f)


def _tp_engine(cfg, params, level: str, tp: int, static_jit: bool):
    """Phase 4's paged engine shape at ``level`` over ``tp`` shards that
    share the card (an explicit mesh), or unsharded at tp=1."""
    from repro_torch.backend import CompileOptions
    from repro_torch.backend.sharding import make_mesh
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    opts = dict(level=level, use_pallas=True, static_jit=static_jit)
    if tp > 1:
        opts["mesh"] = make_mesh((tp,), ("model",), devices=[TP_CARD] * tp)
    return ServeEngine(cfg, EngineConfig(params=params, tp=tp,
                                         **MAIN_ENGINE),
                       options=CompileOptions(**opts))


def _tp_serve(cfg, params, prompts, level, tp, static_jit):
    """Phase 4's six requests on a fresh engine, drained; returns
    (engine, report, counters of the run, peak GB, tokens).  The caller
    holds no earlier engine nor any of its compiled functions, whose
    captured graphs keep their memory pools."""
    from repro_torch import kernels
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    eng = _tp_engine(cfg, params, level, tp, static_jit)
    what = f"tp={tp} {level} {'captured' if static_jit else 'eager'}"
    kernels.reset_counters()
    rids = [eng.submit(p, TP_NEW) for p in prompts]
    try:
        rep = eng.run()
    except RuntimeError as exc:   # a contained step failure halted it
        errors = {r: eng._requests[r].error for r in rids}
        raise AssertionError(f"{what}: {exc}; the requests' errors: "
                             f"{errors}") from exc
    torch.cuda.synchronize()
    counts = kernels.counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for r in rids:
        toks = rep.results[r]
        require(rep.statuses[r] == "completed" and len(toks) == TP_NEW
                and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
                f"{what}: request {r}: {rep.statuses[r]} "
                f"{rep.errors.get(r)} {toks}")
    _require_drained(what, eng, rep)
    require(rep.pool.shared_attaches > 0, f"{what}: no prefix page shared")
    require(rep.tp == tp and rep.kv_bytes_per_device * tp
            == eng.pool.total_bytes, f"{what}: kv_bytes_per_device "
            f"{rep.kv_bytes_per_device} x {tp} != {eng.pool.total_bytes}")
    return eng, rep, counts, peak, [rep.results[r].tolist() for r in rids]


def _require_drained(what, eng, rep) -> None:
    p = rep.pool
    require(p.pages_in_use == 0 and p.ref_allocs == p.ref_frees
            and p.page_allocs == p.page_frees,
            f"{what}: pool not drained: {p}")
    problems = eng.pool.verify()
    require(problems == [], f"{what}: pool.verify(): {problems}")


def _tp_cancel(eng, cfg) -> tuple:
    """A request that attaches a published three-page prefix and is
    cancelled while it prefills the rest; returns (the publisher's
    tokens, the pool's sharing and page counts).  The engine drains."""
    rng = np.random.default_rng(21)
    base = rng.integers(0, cfg.vocab, TP_BASE).astype(np.int32)
    longp = np.concatenate([base, rng.integers(
        0, cfg.vocab, TP_LONG - TP_BASE).astype(np.int32)])
    before = eng.pool.stats()
    rp = eng.submit(base, TP_NEW)
    rl = eng.submit(longp, 4)
    for _ in range(8):
        eng.step()
        req = eng._requests[rl]
        if req.prefill_pos is not None and req.prefill_pos > TP_BASE:
            break
    require(eng._requests[rl].prefill_pos is not None,
            "cancel: the sharer is not mid-prefill")
    require(eng.cancel(rl, "phase 12") is True, "cancel: refused")
    rep = eng.run()
    require(rep.statuses[rl] == "cancelled"
            and rep.statuses[rp] == "completed",
            f"cancel: statuses {rep.statuses[rl]} {rep.statuses[rp]}")
    _require_drained("cancel", eng, rep)
    p = rep.pool
    moved = tuple(getattr(p, k) - getattr(before, k)
                  for k in ("shared_attaches", "cow_copies", "page_allocs",
                            "page_frees"))
    require(moved[0] > 0, f"cancel: no prefix page was attached ({p})")
    return rep.results[rp].tolist(), moved


def _tp_dispatch_split(eng) -> dict:
    """The device time of one captured decode dispatch (phase 4's
    ``_dispatch_profile``) split by kernel: the port's kernels, ``cat``
    (the AllGathers and the outputs' joins), ``copy`` (the inputs'
    splits, the bf16 converts and the donated pools' write-back) and the
    rest; and the splits and joins alone, timed with CUDA events
    outside the graph on the dispatch's own inputs."""
    from repro_torch.backend.sharded import ShardLayout, graph_specs
    from repro_torch.devices import to_numpy

    def dispatch():
        return eng.cf.raw(eng._tok, eng._pos, eng.pool.page_table,
                          eng._temp, eng._topk, eng._key,
                          *eng.pool.buffers, *eng.tparams)

    torch.cuda.synchronize()
    rows, union, ours, edges = _profile(lambda: to_numpy(dispatch()[0]))
    split = {"kernels": 0.0, "cat": 0.0, "copy": 0.0, "other": 0.0}
    for ms, _, key in rows:
        if _port_kernel(key) is not None:
            split["kernels"] += ms
        elif "CatArray" in key:
            split["cat"] += ms
        elif "copy" in key.lower():
            split["copy"] += ms
        else:
            split["other"] += ms
    out = {k: round(v, 3) for k, v in split.items()}
    out["busy_ms"] = round(sum(r[0] for r in rows), 3)
    out["union_ms"] = (round(union / 1e3, 3) if union is not None
                       else "not measured")
    out["ours"] = {k: [round(v[0], 3), v[1]] for k, v in ours.items()}
    out["edges"] = edges
    mesh = eng.base_options.mesh
    if mesh is not None:
        lay = ShardLayout(mesh)
        args = [eng._tok, eng._pos, eng.pool.page_table, eng._temp,
                eng._topk, eng._key, *eng.pool.buffers, *eng.tparams]
        ts = [a if isinstance(a, torch.Tensor) else
              torch.as_tensor(a, device=eng.device) for a in args]
        specs, _ = graph_specs(eng.cf.function)

        def splits():
            return [lay.split(t, sp) for t, sp in zip(ts, specs)]

        # the joined outputs are the pools, in their inputs' specs
        first = 6
        pools = [(lay.split(t, sp), sp) for t, sp in zip(
            ts[first:first + len(eng.pool.buffers)],
            specs[first:first + len(eng.pool.buffers)])]

        def joins():
            return [lay.join(pc, sp, eng.device) for pc, sp in pools]

        flush = torch.empty(128 << 20, dtype=torch.float32,
                            device=eng.device)
        out["split_ms"] = round(_events_ms(splits, 5, flush), 3)
        out["join_ms"] = round(_events_ms(joins, 5, flush), 3)
        del pools, flush
    return out


def phase_tp(report: dict, smi: str) -> None:
    """Tensor-parallel paged serving of full-width deepseek-7b over two
    shards on the one card (``make_mesh((2,), ("model",),
    devices=[cuda:0, cuda:0])``), f32 parameters drawn on the card from
    seed 0, bf16 compute, the depth :func:`_tp_config` settles.  At each
    level of :data:`TP_LEVELS` (O2 with the kernels, the main path; O1
    with the kernels, where the sharded products run at local width):
    phase 4's six requests at tp=1 and at tp=2, each eagerly and
    captured: the same tokens bit for bit, every pool drained
    (``pages_in_use`` 0, ``verify()`` clean, ``ref_allocs ==
    ref_frees``), ``kv_bytes_per_device * 2 == pool.total_bytes``, the
    path's kernels launched and none refused; the partitioned graphs'
    stats equal the reference's (``check_torch_parity.py --kind tp`` on
    the same graphs); a cancel mid-prefill over a shared prefix moves
    the pool at tp=2 as at tp=1, and the publisher's tokens agree; a
    captured decode dispatch's device time split (kernels, gathers and
    joins, splits and converts), host ms and steady decode tok/s at tp=1
    and tp=2.  Every distinct shape the runs gave a kernel is held
    against its plain version."""
    from repro_torch.models.weights import init_params_on_device
    from repro_torch.models.lm import build_dense_chunk

    held = _free_card()
    cfg, reckoned, why = _tp_config()
    ref_proc, ref_out = _tp_partition_reference(cfg)
    t0 = time.perf_counter()
    builder = build_dense_chunk(cfg, 256, SLOTS, 4, page_size=16).builder
    params = init_params_on_device(builder, 0, TP_CARD)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
    prompts = _prompts(cfg.vocab, (17, 33, 48, 64, 81, 100), 32)
    need = {"O2": PAGED_KERNELS,
            "O1": ("matmul", "rmsnorm", "batched_matmul")}
    reference = None
    shapes = contextlib.ExitStack()
    seen = shapes.enter_context(_launched_shapes({}))
    for level in TP_LEVELS:
        tokens, lines = {}, {}
        for tp, sj in ((1, False), (1, True), (TP, False), (TP, True)):
            what = f"tp={tp} {'captured' if sj else 'eager'}"
            eng, rep, counts, peak, toks = _tp_serve(cfg, params, prompts,
                                                     level, tp, sj)
            tokens[what] = toks
            phase = f"tp{tp}_{level}_{'captured' if sj else 'eager'}"
            _record_launches(report, phase, counts, need[level],
                             main=(tp == TP and sj))
            line = dict(level=level, tp=tp,
                        dispatch="captured" if sj else "eager",
                        decode_tok_s=f"{rep.decode_tok_s:.2f}",
                        wall_s=f"{rep.wall_seconds:.2f}",
                        decode_dispatches=rep.steps,
                        kv_bytes_per_device=rep.kv_bytes_per_device,
                        pool_bytes=eng.pool.total_bytes,
                        peak_gb=f"{peak:.2f}",
                        launches=json.dumps({k: v["launches"]
                                             for k, v in counts.items()}))
            if tp == TP:
                st = dict(eng.cf.report.stats["partition"])
                require(CHUNK in eng._pf_chunks,
                        f"{what}: no {CHUNK}-row prefill")
                lines["stats"] = {"paged_chunk": st, "paged_prefill": dict(
                    eng._pf_chunks[CHUNK][1].report.stats["partition"])}
                line["partition"] = json.dumps(st)
            disp = _dispatch_profile(eng)
            line.update(dispatch_host_ms=f"{disp['host_ms']:.2f}",
                        dispatch_wall_ms=f"{disp['wall_ms']:.2f}",
                        steady_decode_tok_s=(
                            f"{SLOTS * 4 / disp['wall_ms'] * 1e3:.2f}"),
                        reserved_gb=(
                            f"{torch.cuda.max_memory_reserved() / 1e9:.2f}"))
            if sj:
                require(eng.cf.raw.captured,
                        f"{what}: the chunk never captured")
                per_replay = _per_replay(eng.cf.raw)
                for name in need[level]:
                    want = per_replay[name] * KERNEL_FUNCS[name][1]
                    got = disp["ours"].get(name, [0.0, 0])[1]
                    require(got == want, f"{what} {level}: {name}: {got} "
                            f"device kernels in a replay's profile, the "
                            f"counters say {per_replay[name]} calls")
                line["launches_per_replay"] = json.dumps(per_replay)
                split = _tp_dispatch_split(eng)
                if tp == TP and level == "O2":
                    READINGS["tp"] = {"stats": lines["stats"]["paged_chunk"],
                                      "wall_ms": disp["wall_ms"],
                                      "cat_ms": split["cat"]}
                say("tp_profile", level=level, tp=tp,
                    dispatch=f"decode chunk (4 steps x {cfg.n_layers} "
                    f"layers), captured", **{k: (json.dumps(v)
                                                 if isinstance(v, dict)
                                                 else v)
                                             for k, v in split.items()},
                    card=repr(smi))
                lines[tp] = _tp_cancel(eng, cfg)
            say("tp", **line, card=repr(smi))
            del eng
        base = tokens["tp=1 eager"]
        for what, toks in tokens.items():
            require(toks == base, f"{level}: {what} tokens differ from "
                    f"tp=1 eager: {toks} vs {base}")
        require(lines[TP] == lines[1], f"{level}: cancel at tp={TP} "
                f"{lines[TP]} vs tp=1 {lines[1]}")
        if reference is None:
            reference = _tp_reference_stats(ref_proc, ref_out)
            require(not reference["errors"] and reference["layers"]
                    == cfg.n_layers, f"tp reference: {reference}")
        for kind, st in lines["stats"].items():
            ref = reference["graphs"][f"{kind}/{level}"]
            require(ref["signature_equal"] and st == ref["reference"],
                    f"{level} {kind}: partition stats {st}, the "
                    f"reference's {ref['reference']}")
        say("tp", level=level, tp2_vs_tp1="bitwise",
            captured_vs_eager="bitwise", cancel=json.dumps(lines[TP]),
            partition_vs_reference="equal",
            stats=json.dumps(lines["stats"]))
    shapes.close()
    del params
    held = _free_card()
    by_kernel = _hold_launched(seen, "deepseek-7b tp")
    say("tp_shapes", held=sum(by_kernel.values()),
        by_kernel=json.dumps(by_kernel), card=repr(smi))
    say("tp", model=cfg.name, layers=cfg.n_layers, depth=repr(why),
        reckoned_peak_gb=f"{reckoned:.2f}", params_gb=f"{gb:.2f}",
        init_s=f"{t_init:.2f}", result="ok", held_gb=f"{held:.2f}")

# -- 13. roofline: the meter held against the card ----------------------------
ROOFLINE_CARD = "cuda"
ROOFLINE_REPLAYS = 7       # CUDA-event timings of a dispatch, median
ROOFLINE_LIMIT = 1.05      # a fraction above this counts work not done
MFU_AGREEMENT = 0.01
def _roofline_terms(label: str, rl, measured_ms, cost) -> dict:
    """Gate one Roofline against the ms it was measured in: every term
    finite, compute and memory positive, collective positive exactly when
    there are collectives, and ``max(t_*) / measured`` at most
    :data:`ROOFLINE_LIMIT` (above it the cost model counts work the
    program does not do: the phase fails naming the top five ops of
    ``cost.by_op``)."""
    terms = {"compute": rl.t_compute, "memory": rl.t_memory,
             "collective": rl.t_collective}
    for k, v in terms.items():
        require(math.isfinite(v) and v >= 0, f"{label}: t_{k} = {v}")
    require(terms["compute"] > 0 and terms["memory"] > 0,
            f"{label}: terms {terms}")
    require((terms["collective"] > 0) == (rl.collective_bytes > 0),
            f"{label}: t_collective {terms['collective']} for "
            f"{rl.collective_bytes} wire bytes")
    out = {f"t_{k}_ms": f"{v * 1e3:.4f}" for k, v in terms.items()}
    out["bottleneck"] = rl.bottleneck
    if measured_ms is None:
        out.update(measured_ms="not measured", fraction="not measured")
        return out
    require(math.isfinite(measured_ms) and measured_ms > 0,
            f"{label}: measured {measured_ms} ms")
    fraction = max(terms.values()) * 1e3 / measured_ms
    top = sorted((cost.by_op or {}).items(), key=lambda kv: -kv[1])[:5]
    require(fraction <= ROOFLINE_LIMIT,
            f"{label}: roofline fraction {fraction:.3f} over "
            f"{ROOFLINE_LIMIT} (the cost model counts work the program "
            f"does not do); top ops by flops: {top}")
    out.update(measured_ms=f"{measured_ms:.3f}", fraction=f"{fraction:.4f}")
    return out


def _replay_ms(call, reps: int = ROOFLINE_REPLAYS) -> list:
    """Device ms of ``reps`` calls, each between two CUDA events."""
    call()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def _roofline_main(report: dict, smi: str) -> None:
    """Phase 4's paged engine again: its decode chunk's Roofline against
    the median of CUDA-event timed replays of the captured dispatch."""
    from repro_torch.configs import get_config
    from repro_torch.core.cost import function_cost
    from repro_torch.launch.roofline import Roofline, model_flops_for
    from repro_torch.models.lm import build_dense_chunk
    from repro_torch.models.weights import init_params_on_device

    cfg = get_config("deepseek-7b")
    steps = MAIN_ENGINE["chunk_steps"]
    g = build_dense_chunk(cfg, MAIN_ENGINE["max_len"], SLOTS, steps,
                          page_size=MAIN_ENGINE["page_size"])
    params = init_params_on_device(g.builder, 0, ROOFLINE_CARD)
    prompts = _prompts(cfg.vocab, (17, 33, 48, 64, 81, 100), 32)
    eng, rep, counts, peak, _ = _serve_main(cfg, params, prompts, True)
    _record_launches(report, "roofline_main", counts, PAGED_KERNELS,
                     main=False)
    main = {k: v["launches_by_phase"].get("main")
            for k, v in report.items()}
    got = {k: c["launches"] for k, c in counts.items()}
    if all(v is not None for v in main.values()):
        require(got == main, f"roofline main: launches {got}, phase 4's "
                f"{main}")

    def args():
        return (eng._tok, eng._pos, eng.pool.page_table, eng._temp,
                eng._topk, eng._key, *eng.pool.buffers, *eng.tparams)

    prog = eng.cf.raw
    require(prog.captured, "roofline main: the decode chunk never captured")
    ms = _replay_ms(lambda: prog(*args()))
    measured = statistics.median(ms)
    # one eager dispatch (the emitted program itself), its peak
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = prog._run(*args())
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    del outs
    cf = eng.cf
    plan = cf.memory_plan
    ir = function_cost(g.fn, attn_impl="chunked", by_op=True)
    rl = Roofline(
        arch=cfg.name, shape="paged_chunk", mesh="1xH100", n_devices=1,
        hlo_flops=cf.cost.flops, hlo_bytes=cf.cost.bytes,
        ir_flops=ir.flops, ir_bytes=ir.bytes, collective_bytes=0.0,
        model_flops=model_flops_for(g.builder, cfg, "decode", 1,
                                    SLOTS * steps),
        collectives={}, coll_bytes_by_kind={},
        per_device_memory=float(plan.peak_live_bytes + plan.io_bytes))
    line = _roofline_terms("roofline main", rl, measured, ir)
    say("roofline", path="main", model=f"deepseek-7b full width, "
        f"{cfg.n_layers} layers, paged decode chunk ({steps} steps x "
        f"{SLOTS} slots)", **line,
        replays_ms=json.dumps([round(m, 3) for m in ms]),
        model_flops=f"{rl.model_flops:.4e}", ir_flops=f"{ir.flops:.4e}",
        ir_bytes=f"{ir.bytes:.4e}", compiled_flops=f"{cf.cost.flops:.4e}",
        compiled_bytes=f"{cf.cost.bytes:.4e}",
        useful_flops_ratio=f"{rl.useful_flops_ratio:.4f}",
        roofline_fraction=f"{rl.roofline_fraction:.6f}",
        memory_plan_gb=f"{rl.per_device_memory / 1e9:.2f}",
        memory_plan_intermediates_gb=f"{plan.peak_live_bytes / 1e9:.2f}",
        eager_dispatch_peak_gb=f"{eager_peak / 1e9:.2f}",
        eager_dispatch_added_gb=f"{(eager_peak - base) / 1e9:.2f}",
        launches=json.dumps(got), card=repr(smi))
    del eng, params, prog
    _free_card()


def _roofline_train(report: dict, smi: str) -> None:
    """Phase 8's train step again: its Roofline against CUDA-event timed
    replays, and its MFU against phase 8's (or, run alone, against this
    phase's own host-timed replays, phase 8's way)."""
    from repro_torch import kernels
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.core.cost import function_cost
    from repro_torch.launch.roofline import (PEAK_FLOPS, Roofline,
                                             model_flops_for)

    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=TRAIN_LAYERS)
    ts, donate = _train_step_graph(cfg, TRAIN_BATCH, TRAIN_SEQ)
    batches = _train_batches(cfg, ts, TRAIN_BATCH, TRAIN_SEQ,
                             range(TRAIN_STEPS))
    be = Backend.create("torch", fresh=True, device=ROOFLINE_CARD)
    cf = be.compile(ts.fn, CompileOptions(level="O2", use_pallas=True,
                                          donate_argnums=donate))
    flat = _train_state(ts, cfg, ROOFLINE_CARD)
    _, host_ms, counts, flat = _train_steps(cf, flat, batches,
                                            required=ALL_KERNELS,
                                            label="roofline train")
    per_step = {k: counts[-1][k]["launches"] for k in counts[-1]}
    want = READINGS.get("train", {}).get("per_step")
    if want is not None:
        require(per_step == want, f"roofline train: launches per step "
                f"{per_step}, phase 8's {want}")
    b = batches[-1]
    kernels.reset_counters()
    ms = _replay_ms(lambda: cf.raw(*b, np.int32(TRAIN_STEPS), *flat))
    measured = statistics.median(ms)
    n_params = sum(int(np.prod(s.shape))
                   for s in ts.graphs.builder.params.values())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # phase 8's model FLOPs: 6 x the parameters less the embedding table
    matmul_flops = 6 * (n_params - cfg.vocab * cfg.d_model) * tokens
    mfu = matmul_flops / (measured / 1e3) / PEAK_FLOPS
    host_replay = statistics.median(host_ms[2:])
    ref = READINGS.get("train", {}).get("replay_ms", host_replay)
    against = "phase 8" if "train" in READINGS else "host-timed replays"
    mfu_ref = matmul_flops / (ref / 1e3) / PEAK_FLOPS
    require(abs(mfu / mfu_ref - 1) <= MFU_AGREEMENT,
            f"roofline train: MFU {mfu:.5f} vs {against}'s {mfu_ref:.5f}")
    plan = cf.memory_plan
    ir = function_cost(ts.fn, attn_impl="chunked", by_op=True)
    rl = Roofline(
        arch=cfg.name, shape=f"train {TRAIN_BATCH}x{TRAIN_SEQ}",
        mesh="1xH100", n_devices=1, hlo_flops=cf.cost.flops,
        hlo_bytes=cf.cost.bytes, ir_flops=ir.flops, ir_bytes=ir.bytes,
        collective_bytes=0.0,
        model_flops=model_flops_for(ts.graphs.builder, cfg, "train",
                                    TRAIN_SEQ, TRAIN_BATCH),
        collectives={}, coll_bytes_by_kind={},
        per_device_memory=float(plan.peak_live_bytes + plan.io_bytes))
    line = _roofline_terms("roofline train", rl, measured, ir)
    say("roofline", path="train", model=f"deepseek-7b full width, "
        f"{TRAIN_LAYERS} layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}", **line,
        replays_ms=json.dumps([round(m, 2) for m in ms]),
        host_replay_ms=f"{host_replay:.2f}",
        model_flops=f"{rl.model_flops:.4e}",
        matmul_model_flops=f"{matmul_flops:.4e}",
        mfu=f"{mfu:.5f}", mfu_against=against, mfu_ref=f"{mfu_ref:.5f}",
        mfu_model_flops=f"{rl.model_flops / (measured / 1e3) / PEAK_FLOPS:.5f}",
        ir_flops=f"{ir.flops:.4e}", ir_bytes=f"{ir.bytes:.4e}",
        useful_flops_ratio=f"{rl.useful_flops_ratio:.4f}",
        roofline_fraction=f"{rl.roofline_fraction:.6f}",
        memory_plan_gb=f"{rl.per_device_memory / 1e9:.2f}",
        launches_per_step=json.dumps(per_step), card=repr(smi))
    del cf, be, flat
    _free_card()


def _roofline_tp(smi: str) -> None:
    """Phase 12's O2 chunk graph at tp=2: the collective census beside
    what phase 12 measured (the gathers' ``cat`` ms and the captured
    dispatch), the census's AllGather and AllReduce nodes equal to the
    pass's stats."""
    from repro_torch.backend.sharding import partition_profile
    from repro_torch.core.cost import function_cost
    from repro_torch.core.passes import PartitionGraph, run_pipeline
    from repro_torch.launch.roofline import (Roofline, census_collectives,
                                             model_flops_for)
    from repro_torch.models.lm import build_dense_chunk

    cfg, _, _ = _tp_config()
    steps = MAIN_ENGINE["chunk_steps"]
    g = build_dense_chunk(cfg, MAIN_ENGINE["max_len"], SLOTS, steps,
                          page_size=MAIN_ENGINE["page_size"])
    pg = PartitionGraph.from_profile(partition_profile("tp"), (TP,))
    fused = {"swiglu": True, "norm_matmul": True, "rotary_qkv": True}
    fn, rep = run_pipeline(g.fn, "O2", fuse=fused, partition=pg)
    stats = dict(rep.stats["partition"])
    seen = READINGS.get("tp", {})
    if "stats" in seen:
        require(stats == seen["stats"], f"roofline tp: the pass's stats "
                f"{stats}, phase 12's {seen['stats']}")
    census = census_collectives(fn, {"model": TP})
    nodes = {"all-gather": stats.get("all_gather", 0),
             "all-reduce": stats.get("all_reduce", 0)}
    require({k: census.nodes.get(k, 0) for k in nodes} == nodes,
            f"roofline tp: census nodes {census.nodes}, the pass's "
            f"stats {stats}")
    hlo = function_cost(fn, attn_impl="chunked")
    ir = function_cost(g.fn, attn_impl="chunked", by_op=True)
    rl = Roofline(
        arch=cfg.name, shape="paged_chunk", mesh=f"tp{TP} (NVLink)",
        n_devices=TP, hlo_flops=hlo.flops, hlo_bytes=hlo.bytes,
        ir_flops=ir.flops, ir_bytes=ir.bytes,
        collective_bytes=census.total_bytes,
        model_flops=model_flops_for(g.builder, cfg, "decode", 1,
                                    SLOTS * steps),
        collectives=census.counts, coll_bytes_by_kind=census.bytes_by_kind,
        per_device_memory=0.0, coll_bytes_by_axis=census.bytes_by_axis)
    line = _roofline_terms("roofline tp", rl, seen.get("wall_ms"), ir)
    say("roofline", path=f"tp={TP}", model=f"deepseek-7b full width, "
        f"{cfg.n_layers} layers, O2 paged decode chunk", **line,
        census_nodes=json.dumps(census.nodes),
        census_counts=json.dumps(census.counts),
        census_wire_bytes=json.dumps({k: f"{v:.4e}" for k, v in
                                      census.bytes_by_kind.items()}),
        partition=json.dumps(stats),
        cat_ms=seen.get("cat_ms", "not measured (phase 12 did not run)"),
        card=repr(smi))


def phase_roofline(report: dict, smi: str) -> None:
    """The IR cost model's roofline (``launch/roofline.py``, H100
    data-sheet constants) read against what the card measured, on three
    paths the script already runs: phase 4's paged decode chunk (its
    launches equal phase 4's), phase 8's train step (the MFU agrees with
    phase 8's to 1%) and phase 12's tp=2 chunk graph (the census's
    gathers equal the pass's stats).  Every term finite, and no fraction
    of a measured time above :data:`ROOFLINE_LIMIT`."""
    _free_card()
    _roofline_main(report, smi)
    _roofline_train(report, smi)
    _roofline_tp(smi)


# -- 14. the serving matrix, full width ---------------------------------------
MATRIX_CARD = "cuda"
MATRIX_DIR = os.path.join(ROOT, "build", "serving_matrix")
MATRIX_SEED = 0    # the weights' draw and the prompts
# the legs attend through different forms -- flash in the donated and
# continuous prefills and donated's decode, the IR compositions in the
# paged prefill chunks and the row-position decode -- which round apart
# in bf16, so there a greedy pick whose top logits lie close goes either
# way.  The bf16 run (the serving path's compute) may fail the checker's
# token parity alone, and each split is measured; the f32 run keeps the
# forms within summation order of each other, and is what the checker's
# token parity holds.  A split within MATRIX_TIE_ULPS bf16 units is
# counted a tie.
MATRIX_TIE_ULPS = 1
MATRIX_PREFILL_BATCHES = (SLOTS, 1)   # donated's admission, continuous's


def _matrix_script():
    """``scripts/torch_serving_matrix.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_serving_matrix",
        os.path.join(ROOT, "scripts", "torch_serving_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _matrix_line(leg: str, doc: dict, info: dict, compute: str,
                 smi: str) -> None:
    if leg == "chaos":
        say("matrix", leg=leg, seconds=f"{info['seconds']:.2f}",
            scenarios=json.dumps({k: v["ok"] for k, v in
                                  doc["scenarios"].items()}),
            counters=json.dumps(doc["counters"]), card=repr(smi))
        return
    srv = doc.get("server")
    kv = doc.get("kv_bytes_per_active_token")
    say("matrix", leg=leg, compute=compute,
        mode=doc.get("engine_mode", doc["mode"]),
        tok_s=f"{(srv['sustained_tok_s'] if srv else doc['tok_s']):.2f}",
        decode_tok_s=(f"{doc['decode_tok_s']:.2f}" if not srv else "n/a"),
        ttft_p50_ms=f"{(srv or doc)['ttft_p50_ms']:.1f}",
        ttft_p95_ms=f"{(srv or doc)['ttft_p95_ms']:.1f}",
        kv_b_per_active_token=f"{kv:.1f}" if kv else "n/a",
        peak_gb=("n/a" if info["peak_gb"] is None
                 else f"{info['peak_gb']:.2f}"),
        seconds=f"{info['seconds']:.2f}",
        launches=json.dumps({k: v["launches"]
                             for k, v in doc["kernels"].items()}),
        card=repr(smi))


def _matrix_legs(report: dict, mx, cfg, params, mesh, legs, smi: str):
    """Run ``legs`` of the matrix's full-width workload on ``cfg`` into
    ``MATRIX_DIR/<compute>``: every engine leg launched the kernels
    ``serve.smoke_kernels`` names for its path and refused none, all
    five launched across the legs, and every distinct shape they gave a
    kernel is held against its plain version.  Returns each leg's run
    info and report."""
    from repro_torch.launch.serve import smoke_kernels
    tag = cfg.compute_dtype
    with _launched_shapes({}) as seen:
        infos = mx.run_matrix(cfg, MATRIX_CARD, os.path.join(MATRIX_DIR, tag),
                              params=params, tp_mesh=mesh,
                              workload=mx.FULL_WORKLOAD, seed=MATRIX_SEED,
                              legs=legs)
    total = {k: 0 for k in ALL_KERNELS}
    docs = {}
    for leg, info in infos.items():
        with open(info["path"]) as f:
            docs[leg] = doc = json.load(f)
        _matrix_line(leg, doc, info, tag, smi)
        if leg == "chaos":
            continue
        paged = doc.get("engine_mode", doc["mode"]) == "paged"
        need, may_refuse = smoke_kernels(cfg, attention=not paged)
        require(not may_refuse, f"matrix {leg}: {may_refuse} may refuse")
        _record_launches(report, f"matrix_{tag}_{leg}", doc["kernels"], need)
        for k in total:
            total[k] += doc["kernels"][k]["launches"]
    require(all(total.values()), f"matrix {tag}: a kernel never launched "
            f"across the legs: {total}")
    by_kernel = _hold_launched(seen, f"deepseek-7b matrix {tag}")
    say("matrix_shapes", compute=tag, held=sum(by_kernel.values()),
        by_kernel=json.dumps(by_kernel), launches=json.dumps(total),
        card=repr(smi))
    return infos, docs, total


# the legs that decode through one form, the paged composition, at other
# batch shapes or prefill chunks: paged, its tp=2 split and the front
# door (requests arriving over time), and the shared pair (prefix
# sharing moves where a prefill chunk starts)
MATRIX_PAGED_FORM = (("paged", "paged-tp2", "server"),
                     ("paged-shared-base", "paged-shared-prefix"))


def _matrix_paged_parity(docs: dict, smi: str) -> None:
    """In bf16 every request's greedy tokens are equal across the legs
    of each :data:`MATRIX_PAGED_FORM` group: their contractions take the
    fixed-order kernels, whose bits do not follow the batch's shape."""
    for group in MATRIX_PAGED_FORM:
        base = docs[group[0]]["results"]
        for leg in group[1:]:
            got = docs[leg]["results"]
            bad = sorted(r for r in base if got.get(r) != base[r])
            require(got.keys() == base.keys() and not bad,
                    f"matrix bf16: {leg} differs from {group[0]} on "
                    f"requests {bad}: "
                    f"{[(got.get(r), base[r]) for r in bad[:2]]}")
    say("matrix_bf16_paged_parity",
        groups=json.dumps([list(g) for g in MATRIX_PAGED_FORM]),
        requests=json.dumps([len(docs[g[0]]["results"])
                             for g in MATRIX_PAGED_FORM]),
        tokens="equal", card=repr(smi))


def _matrix_splits(cfg, docs: dict) -> dict:
    """Each first token where a leg leaves the leg the checker holds it
    to (continuous for the standard workload, the sharing-off leg for the
    shared pair), by (prompt, tokens both agree on): the legs' picks
    there and the (leg, request) pairs the checker reports."""
    from repro_torch.launch.serve import workload_prompts
    groups = [("continuous", [leg for leg, d in docs.items()
                              if leg not in ("chaos", "continuous")
                              and not d.get("workload", {}).get(
                                  "shared_prefix_len")]),
              ("paged-shared-base", ["paged-shared-prefix"])]
    splits = {}
    for base_leg, legs in groups:
        w = docs[base_leg]["workload"]
        base = docs[base_leg]["results"]
        prompts = workload_prompts(cfg, len(base), w["prompt_len"],
                                   w.get("shared_prefix_len") or 0,
                                   MATRIX_SEED)
        for leg in legs:
            for rid, toks in docs[leg]["results"].items():
                b = base[rid]
                differ = [i for i, (x, y) in enumerate(zip(toks, b)) if x != y]
                if not differ:
                    continue
                j = differ[0]
                seq = tuple(int(t) for t in np.concatenate(
                    [prompts[int(rid)], np.asarray(b[:j], np.int64)]))
                s = splits.setdefault(seq, {"request": rid, "step": j,
                                            "picks": {base_leg: b[j]},
                                            "pairs": []})
                s["picks"][leg] = toks[j]
                s["pairs"].append((leg, rid))
    return splits


def _matrix_ties(cfg16, cfg32, params, docs: dict, paths: list, mx,
                 smi: str) -> tuple:
    """The bf16 legs' reports (``docs``; with the f32 run's chaos report,
    ``paths``) before the unchanged checker: it may fail them on greedy
    parity alone, and every split it reports is found and measured.  At
    each split a (1, P + j) prefill of the prompt and the tokens the legs
    agree on, bf16 at O2 with the kernels (the CPU tie test's method),
    gives each leg's pick in bf16 units below its top logit; the same
    prefill in f32 gives those gaps at the higher precision, and the
    spread of bf16 - f32 over the f32 prefill's top 32 tokens (in bf16
    units) is how far one bf16 form moves a gap there.  A split whose
    picks all lie within :data:`MATRIX_TIE_ULPS` of the bf16 top is a
    tie; the others are counted, not gated (PERF.md section 7, ROADMAP
    Queue 3).  Returns (splits, ties)."""
    proc = mx.check_reports(paths)
    fails = [ln for ln in proc.stderr.splitlines()
             if ln.startswith("MATRIX FAIL")]
    say("matrix_bf16_checker", rc=proc.returncode, fails=len(fails),
        parity_fails=sum("diverged from" in ln for ln in fails),
        out=repr(proc.stdout.strip()[:60]), card=repr(smi))
    require(proc.returncode == 0 or all("diverged from" in ln
                                        for ln in fails),
            f"matrix bf16: the checker failed on more than parity: {fails}")
    splits = _matrix_splits(cfg16, docs)
    pairs = sum(len(s["pairs"]) for s in splits.values())
    require(pairs == len(fails), f"matrix bf16: {pairs} splits found, "
            f"the checker reports {len(fails)}: {fails}")
    ties = 0
    for seq, s in splits.items():
        lg = {c.compute_dtype: _prefill_logits(c, params, MATRIX_CARD, seq)
              for c in (cfg16, cfg32)}
        gaps = {}
        for dt, x in lg.items():
            top = int(np.argmax(x))
            unit = _ulp(x[top], torch.bfloat16)
            gaps[dt] = {"top": top, "top_logit": float(x[top]),
                        "pick_gap_ulps": {leg: float(x[top] - x[t]) / unit
                                          for leg, t in s["picks"].items()}}
        near = np.argsort(-lg["f32"], kind="stable")[:32]
        drift = (lg["bf16"][near] - lg["f32"][near]) / _ulp(
            lg["f32"][near[0]], torch.bfloat16)
        tie = max(gaps["bf16"]["pick_gap_ulps"].values()) <= MATRIX_TIE_ULPS
        ties += tie
        say("matrix_tie", request=s["request"], step=s["step"],
            prompt_len=len(seq) - s["step"],
            picks=json.dumps(s["picks"]), pairs=len(s["pairs"]),
            bf16=json.dumps(gaps["bf16"]), f32=json.dumps(gaps["f32"]),
            bf16_drift_spread_ulps=f"{float(drift.max() - drift.min()):.3f}",
            tie=tie, card=repr(smi))
    return len(splits), ties


def _matrix_prefill_profile(cfg, params, batch: int, smi: str) -> None:
    """Where a leg's first token goes: the matrix's prompt prefill at
    ``batch`` x 32 rows, eager as a first call runs, timed on the host
    and traced by ``torch.profiler`` (device ms by kernel wrapper)."""
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import workload_prompts
    from repro_torch.models.lm import build_graphs
    P = 32
    g = build_graphs(cfg, ShapeConfig("prefill", "prefill", P, batch), batch)
    cf = Backend.create("torch", device=MATRIX_CARD).compile(
        g.fn, CompileOptions(level="O2", use_pallas=True, static_jit=False))
    toks = np.stack(workload_prompts(cfg, batch, P, 0, MATRIX_SEED))
    args = [params[n] for n in g.builder.param_names()]
    cf(toks, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cf(toks, *args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows, union, ours, _ = _profile(lambda: cf(toks, *args))
    say("matrix_prefill", compute=cfg.compute_dtype, rows=batch * P,
        layers=cfg.n_layers, wall_ms=f"{wall:.3f}",
        device_union_ms=(f"{union / 1e3:.3f}" if union else None),
        by_kernel=json.dumps({k: [round(v[0], 3), v[1]]
                              for k, v in ours.items()}),
        top=json.dumps([[round(ms, 3), n, key[:60]]
                        for ms, n, key in rows[:6]]),
        card=repr(smi))


def phase_matrix(report: dict, smi: str) -> None:
    """The serving matrix's eight legs (``scripts/torch_serving_matrix.py``,
    ``FULL_WORKLOAD``) on full-width deepseek-7b, as deep as phase 12's
    reckoning allows two shards on the card (:func:`_tp_config`), one f32
    weight draw from seed 0 for every leg, at O2 with the kernels; the tp
    leg's two shards share the card.  In f32 the unchanged
    ``scripts/check_serving_matrix.py`` must pass the eight reports.  In
    bf16 the seven engine legs run again: the paged-form legs must agree
    token for token (:func:`_matrix_paged_parity`); the checker may fail
    the others (donated and continuous prefill through the Attention
    op) on greedy parity alone, and each split is measured
    (:func:`_matrix_ties`).  Both runs gate
    their kernels (:func:`_matrix_legs`).  Then the prompt prefill's
    trace in each compute type."""
    from repro_torch.backend.sharding import make_mesh
    from repro_torch.launch.serve import full_width_builder
    from repro_torch.models.weights import init_params_on_device

    t0 = time.perf_counter()
    _free_card()
    mx = _matrix_script()
    cfg, reckoned, why = _tp_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="f32")
    cfg16 = dataclasses.replace(cfg, compute_dtype="bf16")
    params = init_params_on_device(full_width_builder(cfg, 64, SLOTS),
                                   MATRIX_SEED, MATRIX_CARD)
    mesh = make_mesh((TP,), ("model",), devices=[MATRIX_CARD] * TP)
    infos, _, total = _matrix_legs(report, mx, cfg32, params, mesh, mx.LEGS,
                                   smi)
    _free_card()
    proc = mx.check_reports([info["path"] for info in infos.values()])
    require(proc.returncode == 0 and "serving matrix ok" in proc.stdout,
            f"matrix: check_serving_matrix.py rc {proc.returncode}: "
            f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    t_f32 = time.perf_counter() - t0
    infos16, docs16, total16 = _matrix_legs(
        report, mx, cfg16, params, mesh,
        tuple(leg for leg in mx.LEGS if leg != "chaos"), smi)
    _matrix_paged_parity(docs16, smi)
    del mesh
    _free_card()
    splits, ties = _matrix_ties(cfg16, cfg32, params, docs16,
                                [info["path"] for info in infos16.values()]
                                + [infos["chaos"]["path"]], mx, smi)
    _free_card()
    for c in (cfg16, cfg32):
        for batch in MATRIX_PREFILL_BATCHES:
            _matrix_prefill_profile(c, params, batch, smi)
        _free_card()
    del params
    _free_card()
    say("matrix", checker=repr(proc.stdout.strip()[:40]), legs=len(infos),
        model=cfg.name, layers=cfg.n_layers, depth=repr(why),
        compute="f32 (checker), bf16 (splits measured)",
        bf16_splits=splits, bf16_ties=ties,
        reckoned_tp_peak_gb=f"{reckoned:.2f}",
        launches_f32=json.dumps(total), launches_bf16=json.dumps(total16),
        result="ok", seconds_f32=f"{t_f32:.2f}",
        seconds=f"{time.perf_counter() - t0:.2f}", card=repr(smi))


# -- 15. the non-dense families' training, published widths ------------------
TF_ARCHS = ("mixtral-8x22b", "deepseek-v3-671b", "recurrentgemma-9b",
            "xlstm-350m", "whisper-medium", "llama-3.2-vision-11b")
TF_BATCH, TF_SEQ, TF_STEPS = 4, 512, 4
# whisper's decoder context as published (n_text_ctx 448, arXiv:2212.04356)
TF_WHISPER_SEQ = 448
TF_PEAK_LIMIT_GB = 70.0
TF_CARD = "cuda"
TF_RESUME_AT = 2     # whisper: a checkpoint after two steps, then steps 3-4
# card against CPU at a reduced f32 width whose attention takes flash
TF_SMALL = {**MOE_SMALL, **REC_SMALL, **MM_SMALL}
# those five steps' update direction (L2 over its norm), card against CPU:
# tests/test_torch_recurrent.py's UPDATE_L2, the port against JAX.
# AdamW scales each gradient element to about +-lr, so an element whose
# gradient lies within f32 rounding of zero moves its update by up to
# 2 lr; STATE_LIMITS' 1e-4 holds the rest (loss, m, v, update norm)
TF_UPDATE_L2 = 1e-2


def _tf_seq(cfg) -> int:
    return TF_WHISPER_SEQ if cfg.family == "encdec" else TF_SEQ


def _reckon_train_peak_gb(cfg, builder, batch: int, seq: int) -> float:
    """A train step's peak as the train builder's parameter census
    reckons it: p and g in ``param_dtype``, AdamW's m and v in
    ``opt_dtype``; the bf16 casts of every weight; the f32 copies of the
    cast routed-expert stacks that the emitter's batched einsum makes;
    the logits and their gradient in f32 (twice with an MTP head); and
    the stubbed frames or images in f32, as the trainer draws them."""
    from repro_torch.core.types import as_dtype

    def size(dt: str) -> int:
        return np.dtype(as_dtype(dt)).itemsize

    n = sum(math.prod(s.shape) for s in builder.params.values())
    experts = sum(math.prod(s.shape) for k, s in builder.params.items()
                  if "moe_we_" in k)
    state = n * 2 * (size(cfg.param_dtype) + size(cfg.opt_dtype))
    logits = batch * seq * cfg.vocab * 4 * 2 * (2 if cfg.mtp else 1)
    media = 0
    if cfg.family == "encdec":
        media = batch * cfg.enc_seq * cfg.d_model * 4
    elif cfg.family == "vlm":
        media = batch * cfg.vision_tokens * cfg.vision_dim * 4
    return (state + 2 * n + 4 * experts + logits + media) / 1e9


def _plan_peak_gb(ts, donate) -> float:
    """The train step's state plus the most bytes its emitted plan holds
    at once (``torch_emit.plan_peak_bytes``, the donated p, m and v taken
    back as soon as they are dead), compiled at O2 with the kernels on
    the meta device: shapes only, no card."""
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.backend.graphed import pair_donations
    from repro_torch.transformers.torch_emit import plan_peak_bytes
    fn = Backend.create("torch", fresh=True, device="meta").compile(
        ts.fn, CompileOptions(level="O2", use_pallas=True,
                              donate_argnums=donate)).function
    state = sum(t.nbytes for t in fn.in_types)
    return (state + plan_peak_bytes(fn, pair_donations(
        fn.in_types, fn.out_types, donate))) / 1e9


def _tf_depths(cfg) -> tuple:
    """(the depths a family may train at, deepest first; why the others
    are out).  deepseek-v3 trains its dense prefix alone (``n_layers ==
    first_dense``, its MoE Scan of length 0) with the MTP head: one MoE
    layer's routed experts are 256 x 3 x 7168 x 2048 = 11.27e9
    parameters, ~135 GB of state, more than one card holds.  vlm keeps
    whole groups of ``cross_every`` layers (one cross-attention block
    each); rg at least one (rec, rec, attn) group."""
    if cfg.mla:
        return ([dict(n_layers=k, first_dense=k)
                 for k in range(cfg.first_dense, 0, -1)],
                "MoE layers out: one layer's experts alone hold ~135 GB "
                "of state")
    if cfg.family == "vlm":
        return ([dict(n_layers=k) for k in range(
            cfg.n_layers, cfg.cross_every - 1, -cfg.cross_every)], "")
    if cfg.family == "rg_hybrid":
        return ([dict(n_layers=k) for k in range(
            cfg.n_layers, len(cfg.pattern) - 1, -1)], "")
    return [dict(n_layers=k) for k in range(cfg.n_layers, 0, -1)], ""


def _tf_config(arch: str) -> tuple:
    """(config, train step, donated indices, reckoned peak GB, plan peak
    GB, why this depth): ``arch`` at published width, as deep as both
    :func:`_reckon_train_peak_gb` and :func:`_plan_peak_gb` stay under
    :data:`TF_PEAK_LIMIT_GB` (:func:`_tf_depths`).  The census misses
    the AdamW update's f32 temporaries, which the plan counts: at 3
    dense layers deepseek-v3's census is 64.3 GB, its plan 77.0 GB, and
    the card ran out of memory there."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs
    full = get_config(arch)
    depths, out = _tf_depths(full)
    over_limit = []
    for over in depths:
        cfg = dataclasses.replace(full, **over)
        seq = _tf_seq(cfg)
        g = build_graphs(cfg, ShapeConfig("train", "train", seq, TF_BATCH),
                         TF_BATCH)
        gb = _reckon_train_peak_gb(cfg, g.builder, TF_BATCH, seq)
        plan = None
        if gb < TF_PEAK_LIMIT_GB:
            ts, donate = _train_step_graph(cfg, TF_BATCH, seq, g)
            plan = _plan_peak_gb(ts, donate)
        if plan is not None and plan < TF_PEAK_LIMIT_GB:
            why = f"{cfg.n_layers} of {full.n_layers} layers: " + (
                "; ".join(over_limit) if over_limit
                else "the deepest allowed")
            return (cfg, ts, donate, gb, plan,
                    "; ".join(w for w in (why, out) if w))
        over_limit.append(
            f"{cfg.n_layers} reckoned {gb:.1f} GB" + (
                f", plan {plan:.1f} GB" if plan is not None else "")
            + f" >= {TF_PEAK_LIMIT_GB}")
        del over_limit[:-1]
    raise AssertionError(f"{arch}: no depth under {TF_PEAK_LIMIT_GB} GB: "
                         f"{over_limit}")


def _tagged_kernels(rows, tag: str) -> int:
    """Device kernels of a profile's ``rows`` whose name holds ``tag``."""
    import re
    pat = re.compile(rf"(?<![A-Za-z0-9_]){tag}(?![A-Za-z0-9_])")
    return sum(n for _, n, k in rows if pat.search(k))


def _train_profile(label: str, cf, batch, step: int, flat,
                   per_step: dict) -> tuple:
    """One more replay of a captured train step on the run's own state,
    outside the counted run, under the profiler: each kernel of the port
    shows by name as often as the counters of a replayed step say
    (:data:`KERNEL_FUNCS`' device kernels per call).  Returns the
    profile's rows, union and the port's kernels."""
    replays = cf.raw.replays
    rows, union, ours, edges = _profile(lambda: cf.raw(
        *batch, np.int32(step), *flat)[0].item())
    require(cf.raw.replays == replays + edges["calls"],
            f"{label}: the profiled calls were not replays")
    for name, n in per_step.items():
        want = n * KERNEL_FUNCS[name][1]
        got = ours.get(name, [0.0, 0])[1]
        require(got == want, f"{label}: {name}: {got} device kernels in "
                f"a replay's profile, the counters say {n} calls "
                f"({want} kernels)")
    return rows, union, ours


def _tf_small(arch: str) -> dict:
    """``arch`` at :data:`TF_SMALL`'s reduced f32 width (attention on
    flash on the card; vlm's gates open; AdamW's moments in f32, where
    deepseek-v3 keeps them in bf16): five train steps of the same numpy
    state on the card with the kernels and on the CPU with their plain
    versions; the losses and the state after them within the f32
    :data:`STATE_LIMITS`, the update's direction within
    :data:`TF_UPDATE_L2`.  Returns the gaps."""
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.devices import to_numpy
    from repro_torch.launch.serve import smoke_kernels

    cfg = get_config(arch).reduced(opt_dtype="f32", **TF_SMALL[arch])
    ts, donate = _train_step_graph(cfg, SMALL_BATCH, SMALL_SEQ)
    batches = _train_batches(cfg, ts, SMALL_BATCH, SMALL_SEQ,
                             range(SMALL_STEPS))
    params = ts.graphs.builder.init_params(0)
    for name in MM_GATES:
        if name in params:
            params[name][...] = 0.5
    host = [params[n] for n in ts.param_names]
    host += [np.zeros_like(a) for a in host] * 2
    need = {"flash_attention"} & smoke_kernels(cfg)[0]
    runs = {}
    for dev in (TF_CARD, "cpu"):
        cf = Backend.create("torch", fresh=True, device=dev).compile(
            ts.fn, CompileOptions(level="O2", use_pallas=True,
                                  donate_argnums=donate))
        flat = [torch.from_numpy(a.copy()).to(dev) for a in host]
        losses, _, _, flat = _train_steps(
            cf, flat, batches, required=need if dev != "cpu" else (),
            label=f"{arch} small {dev}")
        runs[dev] = (losses, [to_numpy(t) for t in flat])
        del cf, flat
    (lc, pc), (lh, ph) = runs[TF_CARD], runs["cpu"]
    loss_err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(lc, lh))
    require(loss_err <= STATE_LIMITS["f32"]["update"],
            f"{arch} small: card losses {lc} vs CPU {lh}")
    gaps = _state_gaps(host[:len(ts.param_names)], ph, pc)
    _require_state({k: g for k, g in gaps.items() if k != "update"}, "f32",
                   f"{arch} small: card vs CPU")
    require(gaps["update"] <= TF_UPDATE_L2,
            f"{arch} small: card vs CPU update direction {gaps['update']}")
    return {"loss": loss_err, **gaps}


def _train_family(report: dict, arch: str, smi: str) -> dict:
    """Phase 15 for one family; returns its launches per kernel over the
    captured run's steps."""
    import resource
    import shutil
    import tempfile
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.launch.serve import smoke_kernels
    from repro_torch.runtime.checkpoint import CheckpointManager

    held = _free_card()
    torch.cuda.reset_peak_memory_stats()
    cfg, ts, donate, reckoned, plan_gb, why = _tf_config(arch)
    seq = _tf_seq(cfg)
    need, _ = smoke_kernels(cfg, train=True)
    t0 = time.perf_counter()
    batches = _train_batches(cfg, ts, TF_BATCH, seq, range(TF_STEPS + 1))
    extra = batches.pop()
    data_s = time.perf_counter() - t0
    n_params = sum(math.prod(s.shape)
                   for s in ts.graphs.builder.params.values())
    tokens = TF_BATCH * seq
    flops = 6 * (n_params - cfg.vocab * cfg.d_model) * tokens
    opts = CompileOptions(level="O2", use_pallas=True, donate_argnums=donate)
    resume = cfg.family == "encdec"
    label = f"train_families {cfg.name}"

    # captured: eager first call, capture, replays
    be = Backend.create("torch", fresh=True, device=TF_CARD)
    t0 = time.perf_counter()
    cf = be.compile(ts.fn, opts)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = _train_state(ts, cfg, TF_CARD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cut = TF_RESUME_AT if resume else TF_STEPS
    tmp = tempfile.mkdtemp(prefix="train_family_",
                           dir=os.path.join(ROOT, "build"))
    try:
        with _launched_shapes({}) as seen:
            losses, ms, counts, flat = _train_steps(
                cf, flat, batches[:cut], required=need, label=label)
            if resume:
                mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
                mgr.save(cut, {f"s{i}": t for i, t in enumerate(flat)})
            more, ms2, counts2, flat = _train_steps(
                cf, flat, batches[cut:], first=cut, required=need,
                label=label)
        losses, ms, counts = losses + more, ms + ms2, counts + counts2
        peak = torch.cuda.max_memory_allocated() / 1e9
        reserved = torch.cuda.max_memory_reserved() / 1e9
        require((cf.raw.captures, cf.raw.replays) == (1, TF_STEPS - 1),
                f"{label}: {cf.raw.captures} captures, {cf.raw.replays} "
                f"replays")
        total = {k: {"launches": sum(c[k]["launches"] for c in counts),
                     "rejected": sum(c[k]["rejected"] for c in counts)}
                 for k in counts[0]}
        _record_launches(report, f"train_families_{cfg.name}", total, need)
        per_step = {k: counts[-1][k]["launches"] for k in counts[-1]}
        if resume:
            # restored into fresh card tensors: the same steps 3-4
            _, got, _ = mgr.restore(device=TF_CARD)
            again = [got[f"s{i}"] for i in range(len(flat))]
            del got
            back, _, _, again = _train_steps(
                cf, again, batches[cut:], first=cut, required=need,
                label=f"{label} resumed")
            require(back == more, f"{label}: resumed losses {back} != "
                    f"{more}")
            require(all(_bitwise(a, b) for a, b in zip(again, flat)),
                    f"{label}: the resumed state differs from the run's")
            del again
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows, union, ours = _train_profile(label, cf, extra, TF_STEPS, flat,
                                       per_step)
    del cf, be, flat
    _free_card()

    # the same steps eagerly, from the same state
    be = Backend.create("torch", fresh=True, device=TF_CARD)
    cf = be.compile(ts.fn, opts.replace(static_jit=False))
    flat = _train_state(ts, cfg, TF_CARD)
    eager, eager_ms, _, flat = _train_steps(cf, flat, batches, required=need,
                                            label=f"{label} eager")
    require(eager == losses, f"{label}: captured losses {losses} != eager "
            f"{eager}")
    del cf, be, flat
    _free_card()
    by_kernel = _hold_launched(seen, cfg.name)
    require(set(by_kernel) == need,
            f"{label}: shapes held {by_kernel}, the path's {need}")
    gaps = _tf_small(arch)
    replay_ms = statistics.median(ms[2:])
    rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    say("train_family", arch=cfg.name, family=cfg.family,
        layers=cfg.n_layers, depth=repr(why), params=n_params,
        param_dtype=cfg.param_dtype, opt_dtype=cfg.opt_dtype,
        batch=TF_BATCH, seq=seq, reckoned_peak_gb=f"{reckoned:.2f}",
        plan_peak_gb=f"{plan_gb:.2f}", peak_gb=f"{peak:.2f}",
        peak_reserved_gb=f"{reserved:.2f}",
        card_allocated_gb_before=f"{held:.2f}",
        losses=json.dumps(losses), captured_vs_eager="bitwise",
        resumed_steps_3_4="bitwise" if resume else "n/a",
        eager_step_ms=f"{ms[0]:.1f}", capture_step_ms=f"{ms[1]:.1f}",
        replay_step_ms=f"{replay_ms:.1f}",
        replay_steps_ms=json.dumps([round(t, 2) for t in ms[2:]]),
        eager_run_ms=json.dumps([round(t, 1) for t in eager_ms]),
        tok_s=f"{tokens / replay_ms * 1e3:.1f}",
        model_tflop_s=f"{flops / replay_ms / 1e9:.2f}",
        share_of_989=f"{flops / replay_ms / 1e9 / 989:.4f}",
        launches_per_step=json.dumps(per_step),
        refused=json.dumps({k: v["rejected"] for k, v in total.items()}),
        device_busy_ms=f"{sum(r[0] for r in rows):.1f}",
        device_union_ms=(f"{union / 1e3:.1f}" if union is not None
                         else "not measured"),
        port_kernels_ms=json.dumps({k: round(v[0], 3)
                                    for k, v in ours.items()}),
        top=json.dumps([[k[:48], round(t, 3), n] for t, n, k in rows[:6]]),
        shapes_held=json.dumps(by_kernel),
        small_card_vs_cpu=json.dumps({k: f"{g:.3e}" for k, g in
                                      gaps.items()}),
        compile_s=f"{compile_s:.2f}", init_s=f"{init_s:.2f}",
        data_s=f"{data_s:.2f}",
        host_peak_rss_gb=f"{rss_kb / 1e6:.2f}",
        card=repr(smi))
    return {k: v["launches"] for k, v in total.items()}


def phase_train_families(report: dict, smi: str) -> None:
    """The six non-dense families train on the card at published widths
    (:func:`_train_family` each, the depth from the census), their
    graphs and state freed between them; then every kernel launched on
    this phase's main path."""
    t0 = time.perf_counter()
    total = {name: 0 for name in report}
    for arch in TF_ARCHS:
        for name, n in _train_family(report, arch, smi).items():
            total[name] += n
    for name in report:
        report[name]["launches_by_phase"]["train_families"] = total[name]
    require(all(total[k] > 0 for k in ALL_KERNELS),
            f"train_families: a kernel never launched: {total}")
    say("train_families", families=len(TF_ARCHS), result="ok",
        launches=json.dumps(total),
        seconds=f"{time.perf_counter() - t0:.2f}", card=repr(smi))


# -- 16. the benchmark harness, full width ------------------------------------
BENCH_CARD = "cuda"
BENCH_LAYERS = 4     # phase 8's depth: the train_loop section's state fits
BENCH_OUT = os.path.join(ROOT, "results", "bench_torch.json")
BENCH_CSV = os.path.join(ROOT, "results", "bench_torch.csv")
BENCH_DRYRUN = ("xlstm-350m", "decode_32k")   # a cell for E8 to read


def _bench_script():
    """``scripts/torch_bench_to_json.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_bench_to_json",
        os.path.join(ROOT, "scripts", "torch_bench_to_json.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_bench(report: dict, smi: str) -> None:
    """The benchmark harness (``scripts/torch_bench.py``) on the card: a
    snapshot of all 18 sections (``torch_bench_to_json.py``) at
    deepseek-7b's published widths, :data:`BENCH_LAYERS` deep, O2 with
    the kernels, then its ``--check``.  Every section runs; each of the
    five kernels launches and none is refused but the kernels section's
    one deliberate refusal (``matmul_refused_count``); every shape the
    harness launched is held against its plain version."""
    from repro_torch import kernels
    from repro_torch.launch import dryrun
    _free_card()
    t0 = time.perf_counter()
    arch, shape = BENCH_DRYRUN
    require(dryrun.main(["--arch", arch, "--shape", shape, "--out-dir",
                         os.path.join(ROOT, "results", "dryrun_torch")]) == 0,
            f"bench: the dry run of {arch} {shape} failed")
    snap = _bench_script()
    names = list(snap.harness().SECTIONS)
    seen = {}
    os.makedirs(os.path.dirname(BENCH_CSV), exist_ok=True)
    kernels.reset_counters()
    with open(BENCH_CSV, "w") as csv, _launched_shapes(seen):
        doc = snap.snapshot(names, BENCH_OUT, device=BENCH_CARD,
                            layers=BENCH_LAYERS, csv=csv)
    torch.cuda.synchronize()
    counts = kernels.counters()
    t_run = time.perf_counter() - t0
    require(snap.check(BENCH_OUT) == 0, f"bench: {BENCH_OUT} failed --check")
    model = doc["model"]
    require(not model["reduced"] and model["d_model"] == 4096
            and model["layers"] == BENCH_LAYERS,
            f"bench: ran at {model}, not full width at {BENCH_LAYERS}")
    require(sorted(doc["section_stats"]) == sorted(names),
            f"bench: sections run {sorted(doc['section_stats'])}")
    rows = {(r["section"], r["name"]): r["value"] for r in doc["rows"]}
    parity = {k: v for k, v in rows.items()
              if ("matches" in k[1] or "parity" in k[1])
              and not k[1].endswith("_bf16")}
    require(parity and all(v == "1" for v in parity.values()),
            f"bench: parity rows {parity}")
    probe = int(rows[("E14_kernels", "matmul_refused_count")])
    require(probe >= 1 and counts["matmul"]["rejected"] == probe,
            f"bench: matmul refusals {counts['matmul']['rejected']}, the "
            f"kernels section's probe {probe}")
    counts = dict(counts, matmul=dict(counts["matmul"], rejected=0))
    _record_launches(report, "bench", counts, ALL_KERNELS)
    for name, st in doc["section_stats"].items():
        say("bench", section=name, seconds=f"{st['seconds']:.2f}",
            launches=json.dumps(st["launches"]),
            rejected=sum(st["rejected"].values()))
    held = _hold_launched(seen, "bench")
    say("bench_shapes", shapes=sum(held.values()), held=json.dumps(held),
        calls=sum(seen.values()))
    # the cross-form comparisons in bf16, recorded beside the f32 gates
    say("bench_bf16_forms", **{k[1]: v for k, v in sorted(rows.items())
                               if k[1].endswith("_bf16")
                               and ("matches" in k[1] or "parity" in k[1])})
    say("bench", sections=len(names), model=f"{model['name']} full width",
        layers=model["layers"], run_seconds=f"{t_run:.2f}",
        seconds=f"{time.perf_counter() - t0:.2f}", snapshot=BENCH_OUT,
        csv=BENCH_CSV, launches=json.dumps(
            {k: c["launches"] for k, c in counts.items()}),
        card=repr(smi))


# -- 17. one request across graph shapes ---------------------------------------------
PREFIX_LAYERS = BENCH_LAYERS   # E16's depth in phase 16


@contextlib.contextmanager
def _einsum_calls(calls: dict):
    """While open, each ``torch.einsum`` call on CUDA operands adds one to
    ``calls["float"]`` (an f32, bf16 or f16 operand) or ``calls["f64"]``
    (the emitter's integer one-hot picks, an exact f64 product)."""
    plain = torch.einsum

    def counted(spec, *ops):
        ts = [t for t in ops if isinstance(t, torch.Tensor)]
        if any(t.is_cuda for t in ts):
            kind = "float" if any(t.dtype in (torch.float32, torch.bfloat16,
                                              torch.float16) for t in ts) \
                else "f64"
            calls[kind] = calls.get(kind, 0) + 1
        return plain(spec, *ops)

    torch.einsum = counted
    try:
        yield calls
    finally:
        torch.einsum = plain


def phase_prefix(report: dict, smi: str) -> None:
    """``scripts/torch_prefix_shapes.py``'s legs at deepseek-7b's published
    widths, :data:`PREFIX_LAYERS` deep, O2 with the kernels, run eagerly
    in bf16 and in f32: E16's request alone on three slots, then on one
    slot at prefill chunks 16, 5, 8 and 32, must give the same greedy
    tokens and bit-identical first-decode-step logits (the dense leg,
    chunk 0, attends through the Attention op: printed, not held).  No
    ``torch.einsum`` call on CUDA float operands while the legs run."""
    from repro_torch import kernels
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_bench as tb
    import torch_prefix_shapes as ps
    _free_card()
    t0 = time.perf_counter()
    tb.configure("cuda", False, PREFIX_LAYERS)
    cfg = tb._cfg()
    kernels.reset_counters()
    calls = {}
    legs = {}
    with _einsum_calls(calls):
        for model in (cfg, tb._f32(cfg)):
            legs[model.compute_dtype] = ps.run_legs(tb, model)
            tb.free()
    torch.cuda.synchronize()
    counts = kernels.counters()
    for dt, rows in legs.items():
        for slots, chunk, tokens, logits, same_t, same_l in rows:
            held = chunk != 0
            say("prefix_shapes", compute=dt, slots=slots,
                chunk="default" if chunk is None else chunk,
                tokens=json.dumps(tokens), same_tokens=same_t,
                same_first_step_logits=same_l,
                held="yes" if held else "no (dense prefill: another form)")
            require(not held or (same_t and same_l),
                    f"prefix {dt}: slots={slots} chunk={chunk} tokens "
                    f"{tokens} (same {same_t}), first-step logits same "
                    f"{same_l}, against the three-slot run "
                    f"{rows[0][2]}")
    require(not calls.get("float"),
            f"prefix: {calls.get('float')} torch.einsum calls on CUDA "
            f"float operands in the emitted program")
    _record_launches(report, "prefix", counts, ALL_KERNELS, main=False)
    say("prefix_shapes", layers=cfg.n_layers, model=f"{cfg.name} full "
        "width", einsum_cuda_float=calls.get("float", 0),
        einsum_cuda_f64=calls.get("f64", 0),
        launches=json.dumps({k: c["launches"] for k, c in counts.items()}),
        seconds=f"{time.perf_counter() - t0:.2f}", card=repr(smi))
    tb.free()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    if "--kernels-only" in sys.argv[1:]:
        return 0    # a first check of new kernels: no result line
    if "--train-only" in sys.argv[1:]:
        phase_train(report, smi)
        return 0    # phase 8 alone: no result line
    if "--moe-only" in sys.argv[1:]:
        phase_moe(report, smi)
        return 0    # phase 9 alone: no result line
    if "--recurrent-only" in sys.argv[1:]:
        phase_recurrent(report, smi)
        return 0    # phase 10 alone: no result line
    if "--multimodal-only" in sys.argv[1:]:
        phase_multimodal(report, smi)
        return 0    # phase 11 alone: no result line
    if "--tp-only" in sys.argv[1:]:
        phase_tp(report, smi)
        return 0    # phase 12 alone: no result line
    if "--roofline-only" in sys.argv[1:]:
        phase_roofline(report, smi)
        return 0    # phase 13 alone: no result line
    if "--matrix-only" in sys.argv[1:]:
        phase_matrix(report, smi)
        return 0    # phase 14 alone: no result line
    if "--train-families-only" in sys.argv[1:]:
        phase_train_families(report, smi)
        return 0    # phase 15 alone: no result line
    if "--bench-only" in sys.argv[1:]:
        phase_bench(report, smi)
        return 0    # phase 16 alone: no result line
    if "--prefix-only" in sys.argv[1:]:
        phase_prefix(report, smi)
        return 0    # phase 17 alone: no result line
    cfg, params, prompts, tokens = phase_main(report, smi)
    phase_flash(report, cfg, params)
    phase_sampled(cfg, params)
    phase_parity()
    phase_http(report, cfg, params, prompts, tokens, smi)
    del params
    phase_train(report, smi)
    phase_moe(report, smi)
    phase_recurrent(report, smi)
    phase_multimodal(report, smi)
    phase_tp(report, smi)
    phase_roofline(report, smi)
    phase_matrix(report, smi)
    phase_train_families(report, smi)
    phase_bench(report, smi)
    phase_prefix(report, smi)
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
