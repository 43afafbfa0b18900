#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases:
  0. setup       the card (nvidia-smi name and power limit), torch/CUDA/nvcc
                 versions; builds every kernel from `src/repro_torch/**/csrc`
                 (one nvcc per source, all started together)
  0b. analysis   (a) the port's vedalint (`python -m repro_torch.analysis` on
                 `src/repro_torch tools chip_smoke.py` of the tree on the
                 card): exit code, findings by rule, seconds; (b) the
                 `cuda-smem-budget` rule's static shared-memory bytes of each
                 kernel against ptxas's `bytes smem` for every compiled entry
                 function of that kernel (setup's build reports, demangled
                 with `cu++filt`): equal wherever the rule resolves the sizes,
                 and every entry within the 48 KB a block has statically;
                 (c) row 1's K > 32 body near the top of its K range (2 K
                 floats of dynamic shared memory: 48 KB at K 6,144, 64 KB at
                 8,192, past the default 48 KB, so opted in): the single entry
                 and the batched one at M 2 on N 4,096 tokens, D 64, V 512, in
                 both noise modes against their plain versions, timed and
                 bounded
  1. kernels     each kernel against its plain PyTorch version on the card,
                 over a grid of shapes and count formats (and, for alias_mh,
                 MH round counts; for every lda_gibbs entry and both
                 alias_mh entries, both noise or draw modes: injected, and
                 Philox drawn in the kernel, against the plain version on
                 `ops.philox_noise` / `ops.philox_draws`; alias_mh records the
                 body it picks, direct or log tables); near-ties are exempt
                 and counted; each library's Philox4x32-10 words against
                 cuRAND's `curand_Philox4x32_10` on 2^20 counters
  2. main path   the §5 case study (`examples/quickstart.py`'s config) over the
                 wire through an in-process `VedaliaClient(device="cuda")`:
                 fit 30, refine 70, two view syncs, top reviews, perplexity,
                 once on the exact `torch` backend and once on `alias`;
                 kernel launch counters are zeroed just before each run and
                 read just after (the `torch` route's blocks take injected
                 noise: no Philox launch; the `alias` sweeps draw in the
                 kernel: 100 Philox launches), and each perplexity must land
                 within 5% of the same run of the port on the CPU; after each
                 run, that path's kernel against its plain version at the
                 path's own shape (one 4096-token block, in both noise modes;
                 all tokens with one sweep's alias tables, in both draw modes,
                 and the two alias_mh bodies forced, by CUDA graph)
  3. scale       a popular product (10,000 reviews, V = 10,000) fit with the
                 single-launch `cuda` backend (30 launches, all with Philox
                 noise drawn in the kernel): sweep time, tokens/s, the stages with each route's noise
                 stage, the kernel in both noise modes against its bounds
                 (the Philox mode's without the noise bytes) and its plain
                 version
  4. large_fit   the same popular product over the wire with `backend="auto"`,
                 which must route to `alias` (>= 100k tokens): fit 100 sweeps
                 (one alias_mh launch each, all in the Philox mode), a view
                 sync, the count invariants, perplexity within 0.3 in log of
                 phase 3's exact fit; then sweep time, a per-stage breakdown
                 (the Philox key beside the injected mode's draws), the
                 profiler's top device ops and the kernel in both draw modes
                 against its bounds (the Philox mode's without the draw
                 bytes) and plain version
  5. zoo         the batched slice's main path: 64 products at the case
                 study's widths (300 or 600 reviews, base vocab 800, K = 12)
                 through `TopicEngine.fit_many` — one `fit_batch` request,
                 `auto` -> `batched`, two buckets (32 x 32,768 and 32 x 65,536
                 token slots) — 30 sweeps, a `refine_batch` of all 64 handles
                 (20 sweeps) and a view sync of each: one batched lda_gibbs
                 launch per bucket and sweep (100, all in the Philox mode),
                 none single-model; the
                 count invariants of every model; four products fit one at a
                 time on `cuda` from the same seeds within 5% perplexity; one
                 batched sweep against 64 single-model launches on the same
                 noise, and one batched Philox sweep against 64 single-model
                 `cuda` sweeps from clones of the generators, bit for bit;
                 zoo sweep time, tokens/s and models/s against 64 sequential
                 sweeps, stages (key table, drawn noise, kernel in each mode,
                 rebuild), and the kernel at the larger bucket in both modes
                 against its bounds and plain version
  6. zoo_alias   the same 64 products through `fit_batch(backend="alias")`,
                 50 sweeps: 100 batched alias_mh launches, all in the Philox
                 mode, invariants, four sequential `alias` fits within 5%;
                 one batched Philox sweep against 64 single `alias` sweeps
                 from clones of the generators, bit for bit; the kernel at the
                 larger bucket in both draw modes against its plain version,
                 bounds and time
  7. packed      the packed-table path at the popular product, uncut: 30
                 sweeps on `cuda` with `QuantSpec.int8(w_bits=8)` and with
                 `int4` (30 lda_gibbs.resample_quant launches each, all in
                 the Philox mode, and 30 pack-kernel launches; no exact
                 launch; the exact run's 30 in the Philox mode), 100 on
                 `alias` exact and with int8 (100 alias_mh launches each, all
                 Philox; the kernel on the int8 run's tables in both modes),
                 each training perplexity beside the exact run from the same
                 seed (int8 within 5%; int4 reported); sweep times, stages
                 (key, table build, kernel in each mode, rebuild), the quant
                 kernel in both modes against its bounds and plain version,
                 and the pack kernel against its bound and plain version
  8. packed_case_study
                 the case study fit 100 sweeps on `cuda` with int8 and int4
                 tables, on the card (100 Philox quant launches and 100 pack
                 launches each) and on the CPU: perplexity within 5%; the
                 quant kernel in both modes and the pack kernel at its shape
  9. stream      the streaming tier: a 600 s burst stream with a concept
                 shift (16 products, about 5,850 reviews) routed onto 2
                 in-process servers on the card, micro-batched drain-updates,
                 drift refits coalesced into `refine_batch`; shard 0 killed
                 at 300 s and restored from its JSON snapshot; every acked
                 review must be applied; staleness, reviews/s, launches and
                 the device's share of a profiled 40 s window
 10. offload     the Chital offload tier on 2 in-process servers on the card,
                 `refit_policy="always"`: each stream replayed server-only,
                 then with every refit leased by `offload.OffloadCoordinator`
                 to a 1,000-device `DeviceFleet` (20% malicious: fabricate
                 and corrupt; churn 0.05; stragglers 0.1 x 8); (a)
                 `offload_gate`, the JAX package's `offload_bench.py` config
                 exactly (4 products, 80 s, K 4), the fleet on `torch` (fits
                 on the card) and on `sparse` (the phone's numpy sampler):
                 >= 50% of refit sweep-work off the server, held-out
                 perplexity within 2% of server-only, no phony model
                 adopted, honest credit above malicious, a zero-sum ledger;
                 (b) `offload_service`, the stream phase's widths (16
                 products, K 12, `w_bits` 8, `auto`) cut to 120 s, the fleet
                 on `torch`: the same gates with a 5% band, every lease
                 adopted or fallen back, every view valid; both hold the
                 refit task lists of the two replays equal; launches counted
                 from 0 just before each replay (the `torch` route's blocks
                 of up to 4096 tokens: servers' fits, updates, spot checks,
                 fallback refines, and the `torch` fleet's fits; the
                 server-only replays' coalesced `refine_batch` stacks); obs
                 on in every replay, its spans giving each lease stage's
                 seconds and the servers' measured refit seconds beside the
                 sweep-work accounting; then, for each case, the Gibbs
                 kernel against its plain version at the case's largest
                 product's first block and at a block of its mean tokens a
                 launch, and the batched kernel at the largest stack a
                 server-only window coalesced
 11. mesh        the mesh fit tiers (`pserver`, its W workers stacked on the
                 card): (a) one worker on the reference bench's claim-1
                 corpus (Zipf 1.3, 4,096 tokens, V 20,000, K 8, unit
                 weights), 3 sweeps, bit for bit `core.gibbs.run` on
                 `gibbs`, the `cuda` backend on `cuda`, the `alias` backend
                 on `mh`, from cloned generators; (b) the claim-2 corpus (4 x
                 80,000 tokens, V 20,000, K 16): sync bytes of 4 workers
                 strictly under the replicated tier's, and the stacked W = 1
                 and W = 4 times of 8 sweeps on `gibbs` and `cuda`
                 (reported: one card cannot measure weak scaling); (c) the
                 popular product over the wire on `pserver`, (4, 1) and
                 (2, 2) stacked workers at staleness 2, 30 sweeps, `cuda` then
                 `mh` (`w_bits` 8: a sync a sweep), and (2, 2) on both in
                 float32 (whole staleness-2 windows): one batched launch a
                 sweep (row 2 or row 5), all Philox, none other, the syncs
                 counted by obs, the count invariants, perplexity within 5%
                 of phase 3's exact fit (`cuda`) or 0.3 in log (`mh`); (d)
                 the claim-4 planted corpus: (2, 2) at staleness 2 within 2%
                 held-out perplexity of the oracle (`gibbs`; `cuda` and `mh`
                 reported); (e) rows 1 and 4 against their plain versions
                 on one worker's slab of (c)'s (2, 2) support shapes, both
                 noise or draw modes, timed and bounded. Counts zeroed just
                 before each run of the tier and read just after; each
                 run's launches filed by shape, and every entry held
                 against its plain version, in both modes, on the inputs of
                 its first launch at each shape (one kernels-line row a run
                 and shape)
 12. hybrid_serve
                 the transformer zoo's serving path: the full zamba2-2.7b
                 (54 Mamba2 layers, d_model 2560, weights from seed 0) through
                 `Engine(cache_len=8192, max_batch=2)`: 2 x 4096-token prompts
                 (the 4096-slot ring wraps at the first decode step), 2 x 512
                 greedy and 1 x 512 at temperature 0.8, 32 new tokens each;
                 launch counters zeroed before the run and read after (54
                 chunk_scan launches a prefill wave, 9 decode_attn launches a
                 decode step); prefill ms a wave, decode ms a step, tokens/s,
                 peak memory, the device's share of a traced decode step and
                 of a traced 2 x 4096 prefill; gates: finite logits and the
                 full model's prefill/decode consistency below 2%, at 512
                 tokens and at 4102 (past the 4096 window and not a multiple
                 of it: the ring tail must hold position p in slot p mod w)
 13. hybrid_parity
                 the card against the port on the CPU at full width and one
                 group's depth (6 Mamba2 layers + the shared block): prefill
                 logits and two teacher-forced decode steps within 4% of the
                 logits' scale (bf16 on both sides)
 14. dense_serve the dense family at published widths, weights from seed 0,
                 each model freed before the next: qwen2-7b and gemma2-9b
                 through `Engine(cache_len=8192, max_batch=2)` on the zamba2
                 mix, gemma-7b, gemma2-9b-sw and phi3-medium-14b one 512-token
                 request of 16 new tokens each; counts zeroed before each
                 run and read after (decode_attn num_layers calls a decode
                 step: 28 / 42 (21 rings) / 28 / 42 (rings) / 40; no
                 chunk_scan), each call filed by shape; prefill ms, decode
                 ms a step, tokens/s, peak memory; prefill/decode within 2%
                 two steps after 512 tokens (the gemma2 family within 3% in
                 bf16, and within 1e-4 on a float32 copy of its weights,
                 with its bf16 gap by depth and with the plain attention),
                 and for gemma2 12 steps after the 4102-token prompt (its
                 local rings past the window; the unrolled twin must read
                 past the float32 limit at every step); qwen2 and gemma2 profiled (a
                 traced 2 x 4096 prefill, decode steps) and `logits_last`
                 timed against the parent's widened table
 15. rwkv_serve  rwkv6-1.6b at published widths on the zamba2 mix: 24
                 general-entry chunk_scan launches (rwkv6 mode, chunk 32) a
                 prefill wave, no decode_attn, prefill/decode within 2% after
                 512 and 4096 tokens, profiled as above
 16. dense_parity, 17. rwkv_parity
                 the card against the port on the CPU at full width and two
                 layers (one local/global pair for gemma2), each dense arch
                 and rwkv6: prefill logits, two teacher-forced decode steps
                 and the caches within 4%
 18. cross_serve the cross-attention families, weights from seed 0, each
                 freed before the next: whisper-base whole (6 encoder + 6
                 decoder layers) through `Engine(cache_len=448,
                 max_batch=2)`, 2 x 4-token prompts greedy for 128 tokens
                 and 1 x 64 at temperature 0.8 for 64; llama-3.2-vision-90b
                 at full width cut to 20 layers (4 groups of 4 self + 1
                 gated cross layer, the gates set to 0.5) through
                 `Engine(cache_len=2048, max_batch=2)`, 2 x 512 greedy and
                 1 x 512 at 0.8, 32 new tokens each; the engine feeds zero
                 frames or patches; counts zeroed before each run and read
                 after (decode_attn 12 calls a step for whisper, 6 self + 6
                 cross; 20 for the VLM, 16 + 4; filed by shape, a cross call
                 reading every slot of its static cache, `length = pos =
                 S`); prefill ms, decode ms a step, the profile; prefill /
                 decode within 2% in bf16 over 12 teacher-forced steps on
                 random frames or patches (x 0.02)
 19. cross_parity
                 the card against the port on the CPU at published widths:
                 whisper 2 encoder + 2 decoder layers, the VLM 1 self + 1
                 gated cross layer, on random frames or patches; within 4%
 20. moe_serve   the MoE family at published widths, weights from seed 0,
                 each freed before the next, holding expert shard 0 of 8
                 (16 of 128 experts a MoE layer; the router's 128 outputs
                 and top-k as published; `MOE_SERVE`): arctic-480b at 10
                 layers (19.4 B) and llama4-maverick-400b-a17b at 12 (6
                 dense / MoE pairs, 17.2 B), each through
                 `Engine(cache_len=8192, max_batch=8)` on 2 x 4096 greedy, 8
                 x 512 greedy (one wave) and 1 x 512 at 0.8, 32 new tokens
                 each; counts zeroed before the run and read after
                 (decode_attn num_layers calls a decode step: 10 and 12, G 7
                 and G 5; no chunk_scan); prefill ms a wave, decode ms a
                 step, tokens/s, peak memory, the profile; prefill/decode
                 over 12 teacher-forced steps after 512 tokens at the served
                 capacity (cf 2.0) and at no-drop capacity (cf = E), the
                 dropped pairs a MoE layer of each forward filed, within 2%
                 in bf16 (the served comparison gates where nothing dropped,
                 else the no-drop one), and each MoE layer's routing spread
                 in the served prefill (router logits' spread across
                 positions and across experts, the hidden state's share
                 common to all positions, the busiest expert's share)
 21. moe_parity  the card against the port on the CPU at published widths,
                 2 layers at the served share (Arctic 2 MoE layers,
                 Maverick one pair), a 128-token prompt, within 4%; and
                 `moe_layer` alone on the first MoE layer's weights at the
                 prefill's shape (one bf16 input of 128 tokens, cf 2.0) and
                 the decode step's (16 inputs of 8 sequences x 1 token, cf =
                 E): the picks equal but at counted near-ties (top-k margin
                 under 1e-5), the output and its routed part within 1%, the
                 held pairs counted (none fails)
 22. train       training on the card (no kernel: the training path takes
                 the plain scans): (a) every registered arch reduced, one
                 AdamW step (`make_train_step`) on a (2, 64) bigram batch
                 against the same step of the port on the CPU (loss within
                 2e-3, grad_norm within 1%, gradients within 0.1 of their
                 scale at cosine 0.998, bf16 noise past that judged against
                 the CPU's float32 gradient; updated weights equal up to
                 rounding where the gradient is firm, within two steps
                 elsewhere; MoE picks equal but at near-ties); (b) qwen2-7b
                 at published widths cut to `TRAIN_QWEN_LAYERS` layers, (c)
                 rwkv6-1.6b and (d) whisper-base whole (`TRAIN_RUNS`: 2 x
                 4096, 2 x 4096, 16 x 448 with 1,500 stub frames; 20, 6 and
                 20 AdamW steps on `batches_for` data): step ms (median of
                 steps 3 on), tokens/s, peak GB, the loss a step (the first
                 within 0.5 of ln V, the last below it), no chunk_scan
                 launch, and (qwen2, whisper) one traced step's top device
                 ops and busy share; (e) both chunk_scan entries raising on
                 CUDA inputs that require grad under grad mode, and matching
                 their plain versions under `torch.no_grad`
 23. dryrun      the paper's production RLDA sweep (`launch.dryrun_rlda`: K
                 256, V 250,000, D 200,000, `w_bits` 8, 16,777,216 tokens of
                 a seeded corpus made on the card, blocks of 8,192): (a)
                 token-parallel, `core.gibbs.sweep` (2,048 Gibbs launches a
                 sweep, gated), a warm-up, 3 timed sweeps and 1 traced:
                 sweep ms, peak, busy share and top ops, the invariants and
                 the largest counts beside int32's fixed-point limit; (b)
                 client-server at W 16 and 32 stacked workers, one sync a
                 sweep (the same, plus sync bytes; peak gated under 70 GB);
                 the `cuda` route once (one Philox launch); (c) the Gibbs
                 kernel against its plain version on the sweep's first,
                 middle and last blocks and on the first 2^17 tokens in both
                 noise modes, timed at the block in both modes and as one
                 Philox launch over all the tokens, with bounds from the
                 rows read; (d) `launch.dryrun`'s estimate of each
                 `TRAIN_RUNS` run against the peak phase 22 measured (within
                 10%), its depth extrapolation against a full-depth `meta`
                 run of qwen2-7b at train_4k, and every arch and shape's
                 static `fits_card` on the card
Phase 1 also holds both batched kernels against their plain versions over M
in {1, 5, 64} ragged models x K in {12, 128, 1000} x f32/`w_bits` 8 x both
noise or draw modes (x S in {2, 4} for alias_mh), the packed-table entry in
both noise modes over K in {12, 128, 1000} x int8/int4 x stored n_dt
f32/`w_bits` 8 (K 12 at N 262,147 and 40,009, both of its bodies; K 128 and
1000 at 65,536), and the pack kernel bit for bit at V 10,000; chunk_scan
(the general entry: prep + scan, two CUDA launches a call) over both modes x
float32/bf16 x s0 given/absent at Zamba2's prefill shape (B 2, S 4096, H 80,
dk = dv = 64, chunk 32), RWKV6's (H 32, chunk 64) and its three served
prefill shapes (chunk 32, B 2 x S 4096, 2 x 512, 1 x 512: timed each, no
start state, with its state slices and CUDA launches a call), B 1 x S 4096,
two ragged lengths and dk != dv, dk 128 at chunk 64 and dk 20 with dv 40,
and the Mamba2 entry (w
(B, S, H), k and q (B, S, dk): the one the served prefill runs) at Zamba2's
prefill, at B 1, at the ragged chunks 25 and 60, dk 128 at chunk 64 and rows
that are not whole 16-byte units, each timed with both bounds (bytes,
float32 operations); decode_attn at Zamba2's decode shape (B 2, a 4096-slot
ring, Hkv 32, hd 80) before, at and past the wrap, a ring written into its
first partition only (the later ones all masked), S not divisible by P * T,
a qwen2-like GQA shape (Hkv 4, G 7, hd 128, 8192 long), a capped window, and
hd in {32, 64, 80, 128, 256} x G in {1, 2, 4, 7, 8}, every shape a served
decode step gives it (`SERVED_DECODE`: zamba2's rings, qwen2's GQA, gemma2's
hd 256 capped rings and flat caches, gemma-7b's, phi3's, whisper's and the
VLM's self caches; B 2 and 1) at up to seven positions in bf16, and the
cross-attention shapes (whisper's 1,500 frames at G 1 hd 64, the VLM's 1,024
patches at G 8 hd 128; every slot valid) at their one served call, and the
MoE archs' (G 7 and G 5, hd 128, 8,192 rows; B 2, 8 and 1), each
timed at its heaviest served step, plus its
merge kernel alone against `merge_partials` (partitions with no valid slot
included);
each with its ms, plain ms, bound, its split (P, CUDA launches a call) and
(decode_attn) the masked `F.scaled_dot_product_attention` as `library_ms` (a
yardstick the port never calls).

Every kernel's `ms` is CUDA events over raw launches. The lda_gibbs
entries and both alias_mh entries give beside it `graph_ms`, device time
with no host gaps (launches captured in a CUDA graph, replayed between CUDA
events), and `wrapper_ms`, CUDA events through the wrapper; the general
chunk_scan entry gives `graph_ms` through its wrapper. The kernels
line's `lda_gibbs.resample`, `lda_gibbs.resample_quant` and
`alias_mh.resample` entries give their launches by shape and noise or draw
mode (`by_shape`), counted where the wrapper launches (`launches`,
`launches_philox`): lda_gibbs.resample's are the main path's blocks, the
popular product's single launches, each offload case's blocks and the
mesh phase's by run and shape and the dryrun phase's production blocks and
Philox launch (lda_gibbs.resample_many's: the zoo's, each
offload case's server-only stacks and the mesh phase's stacked workers);
alias_mh.resample's are the case study's on `alias`,
the popular product's on int32 tables (`large_fit` and `packed`'s exact
`alias` run), on packed int8 tables and the mesh phase's (alias_mh.resample_many's:
the zoo's and the mesh phase's); resample_quant's the popular
product's int8 and int4 runs (`packed`) and the case study's
(`packed_case_study`). `chunk_scan` is the Mamba2 entry, whose launches
are hybrid_serve's; `chunk_scan.general`'s are rwkv_serve's and
decode_attn's hybrid_serve's, dense_serve's, cross_serve's and moe_serve's,
both with
`by_shape` rows by arch and served shape (`calls_by_shape` files every call
a serving run makes; a cross call under its own key).
`lda_gibbs.pack_word_table`, the packed sweep's
table build, is no TPU kernel (the reference quantizes with jnp before its
Pallas call); its row names the jnp function it replaces.

Prints one JSON line per phase, then the kernels line, then
`{"ok": true, "device": {...}}` as the last line. Any failure raises and
exits non-zero; without CUDA it exits 2 before doing anything.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores; the kernel's bound is the larger of bytes/rate and ops/rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
NEAR_TIE = 1e-5  # margin below which an ulp of `log` may flip a decision
PPX_BAND = 0.05
LOG_PPX_BAND = 0.3  # alias at 100 sweeps vs the exact sweep at 30 (the reference's band)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_launches(fn) -> int:
    """CUDA kernels one call of `fn` launches, from the profiler's device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if str(ev.device_type).endswith("CUDA"))


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of `fn()` on the card, by CUDA events over `reps`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Mean milliseconds of one `fn()` on the card with no host gaps:
    `launches` calls captured in one CUDA graph, replayed `reps` times
    between CUDA events. `fn` must launch on the current stream and
    allocate nothing the graph keeps."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * launches)


# -- phase 0 ---------------------------------------------------------------


def phase_setup():
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.alias_mh import kernel as alias_kernel
    from repro_torch.kernels.chunk_scan import kernel as scan_kernel
    from repro_torch.kernels.decode_attn import kernel as attn_kernel
    from repro_torch.kernels.lda_gibbs import kernel as lda_kernel

    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    builds = {"lda_gibbs.resample": lda_kernel.build, "alias_mh.resample": alias_kernel.build,
              "chunk_scan": scan_kernel.build, "chunk_scan_mamba2": scan_kernel.build_mamba2,
              "decode_attn": attn_kernel.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = {name: pool.submit(b) for name, b in builds.items()}
        reports = {name: f.result() for name, f in futures.items()}
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry function" in ln]
             for name, (_, rep) in reports.items()}
    emit({
        "phase": "setup",
        "gpu": smi,
        "driver": run_text(["nvidia-smi", "--query-gpu=driver_version",
                            "--format=csv,noheader"]).splitlines()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": run_text([_build.nvcc(), "--version"]).splitlines()[-1],
        "python": sys.version.split()[0],
        "build_s": round(build_s, 3),
        "ptxas": ptxas,
    })
    return smi


# -- phase 0b --------------------------------------------------------------

VEDALINT_PATHS = ("src/repro_torch", "tools", "chip_smoke.py")
K_LIMIT = dict(n=4096, d=64, v=512, m=2, ks=(6144, 8192))


def ptxas_entries(report: str) -> list[dict]:
    """Each entry function of an `nvcc -Xptxas -v` report: its mangled
    name, registers and static shared-memory bytes (ptxas leaves `bytes
    smem` out when there are none)."""
    import re

    out, entry = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = {"mangled": m.group(1), "registers": None, "smem": 0}
            out.append(entry)
            continue
        if entry is not None and "Used" in line and "registers" in line:
            entry["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(smem.group(1)) if smem else 0
            entry = None
    return out


def kernel_of(demangled: str) -> str:
    """`void (anonymous namespace)::merge_kernel<float>(float const*, ...)`
    -> `merge_kernel`: the name before the parameter list, template
    arguments (which may hold parentheses) skipped."""
    depth, head = 0, []
    for ch in demangled.replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            head.append(ch)
    return "".join(head).split()[-1].split("::")[-1]


def smem_against_ptxas() -> dict:
    """(b): for each kernel source, the rule's static `__shared__` bytes of
    each `__global__` kernel against ptxas's for each of its compiled entry
    functions (all instantiations), from the build reports kept beside the
    libraries."""
    from repro_torch.analysis import AnalysisConfig, load_modules
    from repro_torch.analysis.rules.cuda_smem import static_smem
    from repro_torch.kernels import _build
    from repro_torch.kernels.alias_mh import kernel as alias_kernel
    from repro_torch.kernels.chunk_scan import kernel as scan_kernel
    from repro_torch.kernels.decode_attn import kernel as attn_kernel
    from repro_torch.kernels.lda_gibbs import kernel as lda_kernel

    config = AnalysisConfig()
    builds = {lda_kernel.SOURCE: lda_kernel.build, alias_kernel.SOURCE: alias_kernel.build,
              scan_kernel.SOURCE: scan_kernel.build,
              scan_kernel.MAMBA2_SOURCE: scan_kernel.build_mamba2,
              attn_kernel.SOURCE: attn_kernel.build}
    entries = {src: ptxas_entries(build()[1]) for src, build in builds.items()}
    if not all(entries.values()):
        raise SystemExit("a build report has no entry function: "
                         f"{[str(s.name) for s, e in entries.items() if not e]}")
    names = [e["mangled"] for es in entries.values() for e in es]
    cufilt = Path(_build.nvcc()).parent / "cu++filt"
    demangled = subprocess.run([str(cufilt)], input="\n".join(names) + "\n",
                               capture_output=True, text=True, timeout=120,
                               check=True).stdout.splitlines()
    if len(demangled) != len(names):
        raise SystemExit(f"cu++filt gave {len(demangled)} names for {len(names)}")
    by_mangled = dict(zip(names, demangled))
    out, bad = {}, []
    for src, es in entries.items():
        rel = src.relative_to(ROOT).as_posix()
        (mod,) = load_modules([src], root=ROOT)
        rule = static_smem(mod, config)
        rows = {}
        for e in es:
            name = kernel_of(by_mangled[e["mangled"]])
            row = rows.setdefault(name, {"entries": 0, "ptxas_bytes": [],
                                         "rule_bytes": rule.get(name, {}).get("bytes"),
                                         "assumed": rule.get(name, {}).get("assumed")})
            row["entries"] += 1
            if e["smem"] not in row["ptxas_bytes"]:
                row["ptxas_bytes"].append(e["smem"])
            if e["smem"] > config.smem_default_bytes:
                bad.append(f"{rel} {name}: {e['smem']} B static")
        for name, row in rows.items():
            row["resolved"] = row["rule_bytes"] is not None and not row["assumed"]
            row["agrees"] = (row["ptxas_bytes"] == [row["rule_bytes"]]
                             if row["resolved"] else None)
            if row["agrees"] is False:
                bad.append(f"{rel} {name}: rule {row['rule_bytes']} B, ptxas "
                           f"{row['ptxas_bytes']}")
        out[rel] = rows
    return {"kernels": out, "bad": bad}


def k_limit_checks(reps=10) -> dict:
    """(c): row 1's K > 32 body at `K_LIMIT`'s K (2 K floats of dynamic
    shared memory a block), single entry and batched at M 2, both noise
    modes against the plain versions, timed (`_lda_timing`) and bounded."""
    import torch

    n, d, v, m = (K_LIMIT[key] for key in ("n", "d", "v", "m"))
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * v, w_bits=None)
    out = {"single": {}, "batched": {}}
    for k in K_LIMIT["ks"]:
        args = _random_inputs(n, k, None, d=d, v=v, seed=k)
        row = {"shape": f"N={n} K={k} D={d} V={v} w_bits=None", "smem_bytes": 2 * k * 4}
        row.update(_lda_timing(args[:7], args[7], (2 ** 64 - 5 - k, 4 * k), hp, False, n, 0,
                               reps))
        out["single"][k] = row
        args = _stack_random_inputs(m, n, k, None, d, v, seed=k + 1)
        table = torch.stack([torch.arange(m, device="cuda") * 7919 + k,
                             torch.arange(m, device="cuda") * 4 + 4 * k], 1)
        live = int((args[3] > 0).sum())
        row = {"shape": f"M={m} N={n} K={k} D={d} V={v} w_bits=None", "smem_bytes": 2 * k * 4,
               "live_tokens": live}
        row.update(_lda_timing(args[:7], args[7], table, hp, True, live, m * n - live, reps))
        out["batched"][k] = row
        del args
    return out


def vedalint_run() -> dict:
    """(a): `python -m repro_torch.analysis` on the tree on the card."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--format", "json",
                           *VEDALINT_PATHS], cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
                          check=False)
    report = json.loads(proc.stdout) if proc.returncode in (0, 1) else {}
    return {"exit": proc.returncode, "counts": report.get("counts"),
            "files": report.get("files_checked"),
            "suppressed": len(report.get("suppressed", ())),
            "seconds": time.perf_counter() - t0,
            "findings": report.get("findings"), "stderr": proc.stderr[-2000:]}


def phase_analysis():
    """The port's static analysis on the tree shipped to the card, its
    shared-memory figures against ptxas's, and the K > 32 body past 48 KB."""
    lint = vedalint_run()
    findings, stderr = lint.pop("findings"), lint.pop("stderr")
    t0 = time.perf_counter()
    smem = smem_against_ptxas()
    smem_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    limit = k_limit_checks()
    out = {"phase": "analysis", "vedalint": lint, "smem": smem["kernels"],
           "smem_s": smem_s, "k_limit": limit, "k_limit_s": time.perf_counter() - t0}
    emit(out)
    if lint["exit"] != 0:
        raise SystemExit(f"vedalint exits {lint['exit']} on the port: {findings} {stderr}")
    if smem["bad"]:
        raise SystemExit(f"shared memory against ptxas: {smem['bad']}")
    bad = {f"{entry} K {k}": row["mismatch"] for entry, rows in limit.items()
           for k, row in rows.items() if row["mismatch"]}
    if bad:
        raise SystemExit(f"the K > 32 body disagrees with its plain version: {bad}")
    return out


# -- phase 1 ---------------------------------------------------------------


def _random_inputs(n, k, w_bits, d=2000, v=10000, seed=0):
    """Token ids, assignments, weights (10% zero), count tables of plausible
    magnitude (float32 or int32 fixed point) and Gumbel noise, on the card."""
    import torch

    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    docs = torch.randint(0, d, (n,), generator=gen, device=dev, dtype=torch.int32)
    words = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
    z = torch.randint(0, k, (n,), generator=gen, device=dev, dtype=torch.int32)
    weights = torch.rand(n, generator=gen, device=dev)
    weights = torch.where(torch.rand(n, generator=gen, device=dev) < 0.1, 0.0, weights)
    n_dt = torch.rand(d, k, generator=gen, device=dev) * 6.0
    n_wt = torch.rand(v, k, generator=gen, device=dev) * 3.0
    n_t = n_wt.sum(0)
    if w_bits is not None:
        s = float(1 << (w_bits + 1))
        n_dt, n_wt, n_t = (torch.round(x * s).to(torch.int32) for x in (n_dt, n_wt, n_t))
    noise = ops.gumbel((n, k), gen, dev)
    return (docs, words, z, weights, n_dt, n_wt, n_t, noise)


def compare(args, *, alpha, beta, beta_bar, w_bits, many=False, bits=None, philox=None):
    """Kernel vs plain on identical inputs — one model, with `many` a stack
    of M models through the batched kernel, or with `bits` one model with a
    packed word table through the quant entry; with a Philox key `philox`
    the kernel draws its own noise and the plain version takes
    `ops.philox_noise` of that key in place of the last argument:
    (mismatches outside near-ties, near-tie mismatches, tokens with a
    near-tie top-2, max score gap)."""
    import torch

    from repro_torch.kernels.lda_gibbs import ops

    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    if bits is not None:
        hp["bits"] = bits
        kernel, plain = ops.resample_quant, ops.resample_quant_plain
        scores_fn = ops.perturbed_scores_quant
    else:
        kernel, plain = ((ops.resample_many, ops.resample_many_plain) if many
                         else (ops.resample, ops.resample_plain))
        scores_fn = ops.perturbed_scores
    if philox is None:
        z_k = kernel(*args, **hp).flatten()
    else:
        z_k = kernel(*args[:-1], None, philox=philox, **hp).flatten()
        args = (*args[:-1], ops.philox_noise(args[2], args[-2], philox))
    torch.cuda.synchronize()
    z_p = plain(*args, **hp).flatten()
    scores = scores_fn(*args, **hp)
    scores = scores.reshape(-1, scores.shape[-1])
    live = args[3].flatten() > 0
    top2 = torch.topk(scores, min(2, scores.shape[1]), dim=1).values
    near = live & (top2[:, 0] - top2[:, -1] < NEAR_TIE)
    best = scores.gather(1, z_p.long()[:, None])[:, 0]
    got = scores.gather(1, z_k.long()[:, None])[:, 0]
    gap = torch.where(live, best - got, 0.0)
    differ = z_k != z_p
    bad = differ & (gap >= NEAR_TIE)
    frozen_bad = (~live) & (z_k != args[2].flatten())
    return (int(bad.sum()) + int(frozen_bad.sum()), int((differ & ~bad).sum()),
            int(near.sum()), float(gap.abs().max()))


def _summary(kernels, cases, **extra):
    return {"phase": "kernels", "kernels": kernels,
            "mismatches": sum(c["mismatch"] for c in cases),
            "near_tie_flips": sum(c["near_tie_flips"] for c in cases),
            "near_ties": sum(c["near_ties"] for c in cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases), **extra, "cases": cases}


def philox_words_check(kernel, n=1 << 20, seed=0):
    """A kernel library's Philox4x32-10 (its `philox_words` test entry)
    against cuRAND's `curand_Philox4x32_10` and the plain version on n
    random counters and keys (the all-zero and all-ones words included):
    counts of words that differ."""
    import torch

    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ctr = torch.randint(-2 ** 31, 2 ** 31, (n, 4), generator=gen, device="cuda",
                        dtype=torch.int32)
    philox = torch.randint(-2 ** 31, 2 ** 31, (n, 2), generator=gen, device="cuda",
                        dtype=torch.int32)
    ctr[0], philox[0], ctr[1], philox[1] = 0, 0, -1, -1
    ours, theirs = kernel.philox_words(ctr, philox)
    u32 = 0xFFFFFFFF
    plain = ops.philox4x32_10_plain(ctr.to(torch.int64) & u32, philox.to(torch.int64) & u32)
    return {"n": n, "differ_curand": int((ours != theirs).sum()),
            "differ_plain": int(((ours.to(torch.int64) & u32) != plain).sum())}


def phase_kernels():
    """The single-model entry in both noise modes (injected, Philox) against
    its plain version over K x N x count format, and its Philox words
    against cuRAND's."""
    from repro_torch.kernels.lda_gibbs import kernel

    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 10000)
    cases = []
    for k in (12, 20, 128, 1000):
        # 262,147 tokens take a thread a token at K <= 32; 65,536 and 40,009
        # a group of lanes a token there (fewer than 2^17 tokens: 16 lanes
        # at K 12, 32 at K 20).
        for n in (262147, 65536, 40009) if k < 1000 else (65536, 40009):
            for w_bits in (None, 8):
                args = _random_inputs(n, k, w_bits, seed=k * 7 + n)
                for mode, philox in (("injected", None), ("philox", (2 ** 64 - 1 - n, 4 * k))):
                    bad, near_flip, near, gap = compare(args, w_bits=w_bits, philox=philox, **hp)
                    cases.append({"k": k, "n": n, "w_bits": w_bits, "noise": mode,
                                  "mismatch": bad, "near_tie_flips": near_flip,
                                  "near_ties": near, "max_abs_err": gap})
    words = philox_words_check(kernel)
    out = _summary(["lda_gibbs.resample"], cases, philox_words=words)
    emit(out)
    if out["mismatches"]:
        raise SystemExit(f"kernel disagrees with its plain version: {out['mismatches']} tokens")
    if words["differ_curand"] or words["differ_plain"]:
        raise SystemExit(f"the kernels' Philox words differ: {words}")
    return out


def _alias_inputs(n, k, w_bits, mh_steps, d=2000, v=10000, seed=0):
    """The alias_mh kernel's arguments on the card: token ids, assignments,
    weights (10% zero), stored count tables (float32, or int32 fixed point
    with real counts on its grid), the stale alias tables built from the
    real counts, and one sweep's (S, N) draws."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.core.types import LDAConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    sc = codec.codec_for(cfg)
    docs = torch.randint(0, d, (n,), generator=gen, device=dev, dtype=torch.int32)
    words = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
    z = torch.randint(0, k, (n,), generator=gen, device=dev, dtype=torch.int32)
    weights = torch.rand(n, generator=gen, device=dev)
    weights = torch.where(torch.rand(n, generator=gen, device=dev) < 0.1, 0.0, weights)
    n_dt = sc.decode_array(sc.encode_array(torch.rand(d, k, generator=gen, device=dev) * 6.0))
    n_wt = sc.decode_array(sc.encode_array(torch.rand(v, k, generator=gen, device=dev) * 3.0))
    tables = alias.sweep_tables(cfg, n_dt, n_wt)
    counts = tuple(sc.encode_array(x) for x in (n_dt, n_wt, n_wt.sum(0)))
    draws = alias.sweep_draws(gen, n, k, mh_steps, dev)
    return (docs, words, z, weights, *counts, *tables, *draws)


def compare_alias(args, *, alpha, beta, beta_bar, w_bits, many=False, philox=None):
    """alias_mh kernel vs plain on identical inputs — one model, or with
    `many` a stack of M models through the batched kernel; with a Philox key
    `philox` the kernel draws its own rounds (as many as the injected draws
    in `args` have) and the plain version takes `ops.philox_draws` of that
    key in their place: (mismatches outside near-ties plus frozen tokens
    that moved, near-tie mismatches, tokens with a near-tie — accept margin
    |log u - log a| or proposal margin |u_prop - thresh| below NEAR_TIE — in
    some round, the largest smallest-margin among mismatched tokens — 0 when
    the two agree everywhere, tokens the kernel moved)."""
    import torch

    from repro_torch.kernels.alias_mh import ops

    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    kernel, plain = ((ops.mh_resample_many, ops.mh_resample_many_plain) if many
                     else (ops.mh_resample, ops.mh_resample_plain))
    if philox is None:
        z_k = kernel(*args, **hp)
    else:
        s = args[11].shape[-2]
        z_k = kernel(*args[:11], philox=philox, mh_steps=s, **hp)
        args = (*args[:11], *ops.philox_draws(args[2], args[6], philox, s))
    torch.cuda.synchronize()
    z_p = plain(*args, **hp)
    acc, prop = ops.margins(*args, **hp)
    live = args[3] > 0
    near = live & ((acc < NEAR_TIE) | (prop < NEAR_TIE))
    differ = z_k != z_p
    bad = differ & ~near
    frozen_bad = (~live) & (z_k != args[2])
    gap = torch.where(differ & live, torch.minimum(acc, prop), 0.0)
    return (int(bad.sum()) + int(frozen_bad.sum()), int((differ & near).sum()),
            int(near.sum()), float(gap.max()), int((z_k != args[2]).sum()))


def alias_body(m, n, d, v, k, s):
    """The body the alias_mh kernel picks for a call of these shapes."""
    from repro_torch.kernels.alias_mh import kernel

    return "tables" if kernel._workspace_floats(m, n, d, v, k, s, -1) else "direct"


def phase_alias_kernel():
    """The single-model entry in both draw modes (injected, Philox) against
    its plain version over K x N x count format x S (the body it picks
    recorded), and its Philox words against cuRAND's."""
    from repro_torch.kernels.alias_mh import kernel

    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 10000)
    cases = []
    for k in (12, 128, 1000):
        for n in (65536, 40009):
            for w_bits in (None, 8):
                for mh_steps in (2, 4):
                    args = _alias_inputs(n, k, w_bits, mh_steps, seed=k * 7 + n + mh_steps)
                    body = alias_body(1, n, 2000, 10000, k, mh_steps)
                    for mode, philox in (("injected", None),
                                         ("philox", (2 ** 64 - 1 - n - mh_steps, 4 * k))):
                        bad, near_flip, near, gap, moved = compare_alias(
                            args, w_bits=w_bits, philox=philox, **hp)
                        cases.append({"k": k, "n": n, "w_bits": w_bits, "mh_steps": mh_steps,
                                      "draws": mode, "body": body, "mismatch": bad,
                                      "near_tie_flips": near_flip, "near_ties": near,
                                      "max_abs_err": gap, "moved": moved})
    words = philox_words_check(kernel)
    out = _summary(["alias_mh.resample"], cases, philox_words=words)
    emit(out)
    if out["mismatches"]:
        raise SystemExit(f"alias_mh kernel disagrees with its plain version: "
                         f"{out['mismatches']} tokens")
    if any(c["moved"] == 0 for c in cases):
        raise SystemExit("alias_mh kernel moved no token in some case")
    if words["differ_curand"] or words["differ_plain"]:
        raise SystemExit(f"the alias_mh kernel's Philox words differ: {words}")
    return out


def _stack_random_inputs(m, n, k, w_bits, d, v, seed, mh_steps=None):
    """A ragged stack of m models on the card (each model's tokens past its
    own length, between n/2 and n, are weight-0 padding; 10% of its real
    tokens weigh 0 too), with the stored count tables of plausible
    magnitude, then the (m, n, k) Gumbel noise or, with `mh_steps`, the
    stale alias tables and one sweep's (m, S, n) draws."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    sc = codec.codec_for(cfg)
    lengths = torch.randint(n // 2, n + 1, (m,), generator=gen, device=dev)
    lengths[0] = n
    lengths[-1] = n - 37 if m > 1 else n
    docs = torch.randint(0, d, (m, n), generator=gen, device=dev, dtype=torch.int32)
    words = torch.randint(0, v, (m, n), generator=gen, device=dev, dtype=torch.int32)
    z = torch.randint(0, k, (m, n), generator=gen, device=dev, dtype=torch.int32)
    weights = torch.rand((m, n), generator=gen, device=dev)
    weights = torch.where(torch.rand((m, n), generator=gen, device=dev) < 0.1, 0.0, weights)
    weights = torch.where(torch.arange(n, device=dev)[None, :] < lengths[:, None], weights, 0.0)
    n_dt = sc.decode_array(sc.encode_array(torch.rand((m, d, k), generator=gen, device=dev) * 6))
    n_wt = sc.decode_array(sc.encode_array(torch.rand((m, v, k), generator=gen, device=dev) * 3))
    counts = tuple(sc.encode_array(x) for x in (n_dt, n_wt, n_wt.sum(1)))
    if mh_steps is None:
        return (docs, words, z, weights, *counts, ops.gumbel((m, n, k), gen, dev))
    tables = alias.sweep_tables(cfg, n_dt, n_wt)
    draws = (torch.randint(0, k, (m, mh_steps, n), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.rand((m, mh_steps, n), generator=gen, device=dev),
             torch.rand((m, mh_steps, n), generator=gen, device=dev))
    return (docs, words, z, weights, *counts, *tables, *draws)


def _grid_width(m, k):
    """Token slots per model of a grid case: up to 16,384, fewer where the
    (m, n, k) noise would pass about 0.5 GB."""
    return min(16384, max(256, (2 ** 27 // (m * k)) // 256 * 256))


def phase_batched_kernels():
    """Both batched kernels against their plain versions over M x ragged N
    x K x count format x noise or draw mode (injected or Philox; x S for
    alias_mh)."""
    import torch

    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 4000)
    out = {}
    for name in ("lda_gibbs.resample_many", "alias_mh.resample_many"):
        cases = []
        for m in (1, 5, 64):
            for k in (12, 128, 1000):
                n = _grid_width(m, k)
                d, v = (256, 4000) if k < 1000 else (64, 500)
                for w_bits in (None, 8):
                    seed = m * 1009 + k * 7 + (w_bits or 0)
                    if name == "lda_gibbs.resample_many":
                        args = _stack_random_inputs(m, n, k, w_bits, d, v, seed)
                        table = torch.stack([torch.arange(m, device="cuda") * 7919 - seed,
                                            torch.arange(m, device="cuda") * 4 + 4 * k], 1)
                        for mode, philox in (("injected", None), ("philox", table)):
                            bad, near_flip, near, gap = compare(args, w_bits=w_bits, many=True,
                                                                philox=philox, **hp)
                            cases.append({"m": m, "k": k, "n": n, "w_bits": w_bits,
                                          "noise": mode, "mismatch": bad,
                                          "near_tie_flips": near_flip, "near_ties": near,
                                          "max_abs_err": gap})
                        continue
                    for mh_steps in (2, 4):
                        args = _stack_random_inputs(m, n, k, w_bits, d, v, seed + mh_steps,
                                                    mh_steps=mh_steps)
                        table = torch.stack([torch.arange(m, device="cuda") * 7919 - seed,
                                             torch.arange(m, device="cuda") * 4 + mh_steps],
                                            1)
                        for mode, philox in (("injected", None), ("philox", table)):
                            bad, near_flip, near, gap, moved = compare_alias(
                                args, w_bits=w_bits, many=True, philox=philox, **hp)
                            cases.append({"m": m, "k": k, "n": n, "w_bits": w_bits,
                                          "mh_steps": mh_steps, "draws": mode,
                                          "body": alias_body(m, n, d, v, k, mh_steps),
                                          "mismatch": bad, "near_tie_flips": near_flip,
                                          "near_ties": near, "max_abs_err": gap,
                                          "moved": moved})
        res = _summary([name], cases)
        emit(res)
        if res["mismatches"]:
            raise SystemExit(f"{name} disagrees with its plain version: "
                             f"{res['mismatches']} tokens")
        if any(c.get("moved", 1) == 0 for c in cases):
            raise SystemExit(f"{name} moved no token in some case")
        out[name] = res
    return out


# -- phase 2 ---------------------------------------------------------------

QUICKSTART = dict(num_reviews=487, vocab_size=800, num_topics=8, mean_tokens=60, seed=42)


def _quickstart_run(device, corp_reviews, backend):
    import torch

    from repro_torch.api import VedaliaClient

    if device == "cpu":
        # One thread: the CPU reference runs small (4096, 12) blocks, where
        # a thread pool costs more than it gains.
        torch.set_num_threads(1)
    client = VedaliaClient(device=device, backend=backend)
    t0 = time.perf_counter()
    fit = client.fit(corp_reviews, num_topics=12, base_vocab=QUICKSTART["vocab_size"],
                     w_bits=8, num_sweeps=30, seed=0)
    fit_s = time.perf_counter() - t0
    fit = client.refine(fit.handle_id, num_sweeps=70, seed=1)
    total_s = time.perf_counter() - t0
    sync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=6)
    resync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=6)
    tops = {t: client.top_reviews(fit.handle_id, t, n=3).review_ids for t in sync.topic_ids}
    ppx = client.perplexity(fit.handle_id)
    return client, fit, sync, resync, tops, ppx, fit_s, total_s


def _check_invariants(service, handle_id):
    """n_t sums to the total weight; the counts rebuild from z."""
    h = service.handles[handle_id]
    _check_state(h.cfg, h.model.corpus, h.model.state)


def _check_state(cfg, corpus, state):
    """`_check_invariants` of one model's config, corpus and stored state."""
    import torch

    from repro_torch.core import codec

    n_t = codec.decode_array(cfg, state.n_t)
    total_w = float(corpus.weights.double().sum())
    # fixed point rounds each of the K totals by at most half a unit
    tol = 1e-4 * total_w + cfg.num_topics / (1 << ((cfg.w_bits or 0) + 1))
    if abs(float(n_t.double().sum()) - total_w) > tol:
        raise SystemExit(f"n_t sums to {float(n_t.sum())}, weights to {total_w}")
    rebuilt = codec.rebuild_state(cfg, corpus, state.z)
    w_bits = codec.codec_for(cfg).spec.w_bits
    per_real = 1.0 if w_bits is None else float(1 << (w_bits + 1))  # stored units
    for name in ("n_dt", "n_wt", "n_t"):
        stored = getattr(state, name).double()
        dev = (getattr(rebuilt, name).double() - stored).abs()
        # Float scatter-add order on the card moves a sum by a few float32
        # ulps of its magnitude, and its encoding may then round the other
        # way: allow 2 stored units plus 4 ulps of each entry (an n_t of the
        # popular product, ~33k real counts, has ulps of 2 stored units).
        real = (stored / per_real).float().abs()
        ulp = torch.nextafter(real, torch.full_like(real, math.inf)) - real
        excess = dev - (2.0 + 4.0 * ulp.double() * per_real)
        if float(excess.max()) > 0:
            raise SystemExit(f"{name} does not rebuild from z (max deviation "
                             f"{float(dev.max())}, {float(excess.max())} past its bound)")
    tensors = (state.z, state.n_dt, state.n_wt, state.n_t, corpus.docs)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise SystemExit("served state is not on the card")


def phase_main_path(backend):
    """The case study on `backend`: "jnp" (the reference's name for the
    exact blocked `torch` sweep, ⌈N/4096⌉ lda_gibbs launches a sweep) or
    "alias" (one alias_mh launch a sweep, its draws made in the kernel)."""
    import torch

    from repro_torch.data import reviews
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    corp = reviews.generate(reviews.SyntheticSpec(**QUICKSTART))
    ops.resample.launches = ops.resample.launches_philox = 0
    alias_ops.mh_resample.launches = alias_ops.mh_resample.launches_philox = 0
    client, fit, sync, resync, tops, ppx, fit_s, total_s = _quickstart_run(
        "cuda", corp.reviews, backend)
    torch.cuda.synchronize()
    launches = {"lda_gibbs.resample": ops.resample.launches,
                "alias_mh.resample": alias_ops.mh_resample.launches}
    launches_philox = {"lda_gibbs.resample": ops.resample.launches_philox,
                       "alias_mh.resample": alias_ops.mh_resample.launches_philox}
    service = client.server.service
    _check_invariants(service, fit.handle_id)
    handle = service.handles[fit.handle_id]
    n = handle.model.corpus.num_tokens
    expected = {"jnp": {"lda_gibbs.resample": 100 * math.ceil(n / 4096), "alias_mh.resample": 0},
                "alias": {"lda_gibbs.resample": 0, "alias_mh.resample": 100}}[backend]
    if backend == "jnp" and launches["lda_gibbs.resample"] == 0:
        raise SystemExit("the main path launched no lda_gibbs kernel")
    if launches_philox["lda_gibbs.resample"]:  # the `torch` route injects its blocks' noise
        raise SystemExit(f"the main path launched {launches_philox} in the Philox mode")
    if backend == "alias" and (launches != expected or launches_philox["alias_mh.resample"]
                               != expected["alias_mh.resample"]):  # its sweeps draw in the kernel
        raise SystemExit(f"the alias main path launched {launches} (Philox "
                         f"{launches_philox}), expected {expected}, all Philox")
    if not sync.valid or len(resync.topics) != 0 or not resync.delta:
        raise SystemExit(f"view sync failed: valid={sync.valid}, re-sent {len(resync.topics)}")
    cpu = _quickstart_run("cpu", corp.reviews, backend)
    ppx_cpu = cpu[5]
    rel = abs(ppx - ppx_cpu) / ppx_cpu
    out = {
        "phase": "main_path" if backend == "jnp" else f"main_path_{backend}",
        "tokens": n, "num_topics": fit.num_topics,
        "vocab": handle.cfg.vocab_size, "backend": fit.backend,
        "launches": launches, "launches_philox": launches_philox,
        "expected_launches": expected, "fit_30_s": round(fit_s, 4), "fit_plus_refine_100_s": round(total_s, 4),
        "core_topics": sync.topic_ids, "view_bytes": sync.payload_bytes,
        "delta_bytes": resync.payload_bytes, "top_reviews": {str(k): v for k, v in tops.items()},
        "perplexity": ppx, "perplexity_cpu": ppx_cpu, "perplexity_rel_diff": rel,
    }
    emit(out)
    if not math.isfinite(ppx) or rel > PPX_BAND:
        raise SystemExit(f"card perplexity {ppx} vs CPU {ppx_cpu}: {rel:.2%} > {PPX_BAND:.0%}")
    return out, handle


# -- phase 3 ---------------------------------------------------------------

POPULAR = dict(num_reviews=10_000, vocab_size=2_000, num_topics=8, mean_tokens=60, seed=42)


def lda_bound(n_live, n_pad, k, table_bytes, philox):
    """The least time of one resample: the bytes it must move (each live
    token's ids/z/weight and output, its (K,) noise row in the injected
    mode, each padding slot's z/weight/output, the count tables once) over
    the HBM rate, or its operations — 3 logs (about 4 ops each) a token and
    topic, and in the Philox mode the Gumbel transform's 2 more logs and one
    Philox4x32-10 call (about 40 ops) a 4 topics — over the float32 rate,
    whichever is larger: (bytes, bound ms, what bounds it)."""
    moved = n_live * (4 * 4 + 4 + (0 if philox else 4 * k)) + n_pad * 12 + table_bytes
    ops_count = n_live * k * 12
    if philox:
        ops_count += n_live * (k * 8 + (k + 3) // 4 * 40)
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S
    return moved, max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


PHILOX_TIMING_KEY = (2 ** 64 - 123, 8)


def kernel_timing(cfg, corpus, state, reps=50):
    """The single-model entry in both noise modes on one sweep's inputs:
    agreement with its plain version, its ms (CUDA events over raw
    launches; `graph_ms`, the same launches replayed from a CUDA graph:
    device time with no host gaps; `wrapper_ms`, CUDA events through
    `ops.resample`), the plain version's ms
    (in the Philox mode with its noise drawn by `ops.philox_noise`), and
    the bound from these inputs."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import ops

    n, k = corpus.num_tokens, cfg.num_topics
    noise = ops.gumbel((n, k), torch.Generator(device="cuda").manual_seed(123), "cuda")
    args = (corpus.docs, corpus.words, state.z, corpus.weights,
            state.n_dt, state.n_wt, state.n_t)
    w_bits = codec.codec_for(cfg).spec.w_bits
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=w_bits)
    out = {"n": n, "k": k, "d": state.n_dt.shape[0], "v": state.n_wt.shape[0],
           "w_bits": w_bits,
           "shape": f"N={n} K={k} D={state.n_dt.shape[0]} V={state.n_wt.shape[0]} "
                    f"w_bits={w_bits}",
           "gathered_bytes": n * (4 * 4 + 4 * k + 4 + 2 * 4 * k)}
    out.update(_lda_timing(args, noise, PHILOX_TIMING_KEY, hp, False, n, 0, reps))
    return out


def first_block_timing(handle, n=4096):
    """`kernel_timing` at a served `torch`-route model's own shape: its
    first block of `n` tokens (the route's 4096 by default) against its
    tables (the route hands the kernel real-unit, decoded float32
    tables)."""
    from repro_torch.core import codec
    from repro_torch.core.types import Corpus, LDAState

    cfg, corpus, state = handle.cfg, handle.model.corpus, handle.model.state
    block = Corpus(*(t[:n].contiguous() for t in (corpus.docs, corpus.words, corpus.weights)))
    block_state = LDAState(state.z[:n].contiguous(), *codec.decode_counts(cfg, state))
    return kernel_timing(dataclasses.replace(cfg, w_bits=None), block, block_state, reps=200)


def sweep_breakdown(cfg, corpus, state, reps=20):
    """Mean ms of each stage of one `cuda`-backend sweep, by CUDA events,
    with the noise stage of each route: the `cuda` route's Philox key
    (host only; the kernel draws the noise), the (N, K) `torch.rand`
    Gumbel draw the injected routes take (the packed sweep; the `torch`
    route draws it a block at a time), the resample in each mode, and the
    count rebuild."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device="cuda").manual_seed(11)
    shape = (corpus.num_tokens, cfg.num_topics)
    noise = ops.gumbel(shape, gen, "cuda")
    z_new = ops.sweep_resample(cfg, state, corpus, gen)
    t0 = time.perf_counter()
    for _ in range(1000):
        ops.philox_key(gen)
    key_host_ms = time.perf_counter() - t0  # seconds over 1000 calls = ms a call
    return {
        "noise_cuda_philox_key_host_ms": key_host_ms,
        "noise_injected_draw": cuda_ms(lambda: ops.gumbel(shape, gen, "cuda"), reps),
        "resample_philox": cuda_ms(lambda: ops.sweep_resample(cfg, state, corpus, gen), reps),
        "resample_injected": cuda_ms(lambda: ops.sweep_resample(cfg, state, corpus, gen, noise),
                                     reps),
        "rebuild": cuda_ms(lambda: codec.rebuild_state(cfg, corpus, z_new), reps),
    }


def profile_device(step, reps=5, top=8):
    """Device time over `reps` calls of `step` (`torch.profiler`): the top
    ops and kernels by device time a call, and the device's busy ms a call
    (the kernels' and copies' own time summed; 0 when the profiler saw no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    return device_summary(prof, reps, top)


def device_summary(prof, reps=1, top=8, unit="sweep"):
    """A finished `torch.profiler` run's top ops and kernels by device time,
    per rep (one `unit`), and the device's busy ms per rep."""
    rows, busy_us = [], 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
            if str(ev.device_type).endswith("CUDA"):
                busy_us += dev_us
    rows.sort(reverse=True)
    return ([{"name": k[:80], f"ms_per_{unit}": us / 1e3 / reps, "calls": c}
             for us, k, c in rows[:top]], busy_us / 1e3 / reps)


def profile_sweeps(sampler, cfg, corpus, state, sweeps=5):
    """`profile_device` over single-model sweeps of `sampler`."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    box = [state]

    def step():
        box[0] = sampler.sweep(cfg, box[0], corpus, gen)

    return profile_device(step, sweeps)


@functools.lru_cache(maxsize=None)
def popular_reviews():
    """The popular product's reviews (generated once, on the host) and the
    seconds the generation took."""
    from repro_torch.data import reviews

    t0 = time.perf_counter()
    corp = reviews.generate(reviews.SyntheticSpec(**POPULAR))
    return corp, time.perf_counter() - t0


def phase_scale():
    import torch

    from repro_torch.api import VedaliaClient
    from repro_torch.api.backends import get_backend
    from repro_torch.kernels.lda_gibbs import ops

    corp, gen_s = popular_reviews()
    torch.cuda.reset_peak_memory_stats()
    ops.resample.launches = ops.resample.launches_philox = 0
    client = VedaliaClient(device="cuda", backend="cuda")
    t0 = time.perf_counter()
    fit = client.fit(corp.reviews, num_topics=12, base_vocab=POPULAR["vocab_size"],
                     w_bits=8, num_sweeps=30, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, launches_philox = ops.resample.launches, ops.resample.launches_philox
    service = client.server.service
    _check_invariants(service, fit.handle_id)
    handle = service.handles[fit.handle_id]
    cfg, corpus = handle.cfg, handle.model.corpus
    n = corpus.num_tokens

    sampler = get_backend("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    state = handle.model.state
    sweep_ms = []
    for _ in range(30):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = sampler.sweep(cfg, state, corpus, gen)
        torch.cuda.synchronize()
        sweep_ms.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(sweep_ms)
    timing = kernel_timing(cfg, corpus, state)
    breakdown = sweep_breakdown(cfg, corpus, state)
    out = {
        "phase": "scale", "tokens": n, "docs": cfg.num_docs, "vocab": cfg.vocab_size,
        "num_topics": cfg.num_topics, "generate_s": round(gen_s, 3),
        "fit_30_s": round(fit_s, 4), "fit_launches": launches,
        "fit_launches_philox": launches_philox,
        "sweep_ms_median": med, "sweep_ms_min": min(sweep_ms), "sweep_ms_max": max(sweep_ms),
        "tokens_per_s": n / (med / 1e3), "perplexity": fit.perplexity,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "kernel": timing,
        "sweep_breakdown_ms": breakdown,
    }
    out["profile_top_device_ms"], out["device_busy_ms_per_sweep"] = profile_sweeps(
        sampler, cfg, corpus, state)
    emit(out)
    if launches != 30 or launches_philox != 30 or timing["mismatch"] \
            or not math.isfinite(fit.perplexity):
        raise SystemExit(f"scale phase failed: launches={launches} "
                         f"(Philox {launches_philox}), "
                         f"mismatch={timing['mismatch']}, ppx={fit.perplexity}")
    return out


# -- phase 4 ---------------------------------------------------------------


def alias_bound(n_live, n_pad, mh_steps, table_bytes, philox):
    """The least time of one MH resample: the bytes it must move (each live
    token's ids/z/weight and output, its three draws a round in the injected
    mode, each padding slot's z/weight/output, the count and alias tables
    once) over the HBM rate, or its operations — 9 logs (about 4 ops each)
    and about 20 others a round, and in the Philox mode one Philox4x32-10
    call (about 40 ops) a round — over the float32 rate, whichever is
    larger: (bytes, bound ms, what bounds it)."""
    moved = n_live * (4 * 4 + 4 + (0 if philox else 12 * mh_steps)) + n_pad * 12 + table_bytes
    ops_count = n_live * mh_steps * (9 * 4 + 20 + (40 if philox else 0))
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S
    return moved, max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


ALIAS_TIMING_KEY = (2 ** 64 - 321, 12)


def _alias_timing(args, draws, hp, philox, mh_steps, many, n_live, n_pad, reps):
    """`alias_kernel_timing`'s body for one entry: both draw modes on one
    sweep's ids, counts and tables `args` (11 tensors) and injected `draws`,
    the Philox mode under `philox`."""
    import torch

    from repro_torch.kernels.alias_mh import kernel, ops

    launch = kernel.launch_many if many else kernel.launch
    wrapper = ops.mh_resample_many if many else ops.mh_resample
    plain = ops.mh_resample_many_plain if many else ops.mh_resample_plain
    raw_hp = dict(alpha=hp["alpha"], beta=hp["beta"], beta_bar=hp["beta_bar"],
                  scale=1.0 if hp["w_bits"] is None else 2.0 ** -(hp["w_bits"] + 1))
    table_bytes = sum(t.numel() * t.element_size() for t in args[4:11])
    z_out = torch.empty_like(args[2])
    out = {}
    for mode, key in (("injected", None), ("philox", philox)):
        bad, near_flip, near, gap, moved = compare_alias((*args, *draws), many=many,
                                                         philox=key, **hp)
        kw = {} if key is None else dict(philox=key, mh_steps=mh_steps)
        d_k = draws if key is None else (None, None, None)

        def raw(d_k=d_k, kw=kw):
            launch(*args, *d_k, z_out, **raw_hp, **kw)

        def through(d_k=d_k, kw=kw):
            return wrapper(*args, *d_k, **hp, **kw)

        def plain_run(key=key):  # in the Philox mode its draw included
            d_p = draws if key is None else ops.philox_draws(args[2], args[6], key, mh_steps)
            return plain(*args, *d_p, **hp)

        moved_bytes, bound_ms, bound_by = alias_bound(n_live, n_pad, mh_steps, table_bytes,
                                                      key is not None)
        out[mode] = {
            "mismatch": bad, "near_tie_flips": near_flip, "near_ties": near,
            "max_abs_err": gap, "moved": moved, "ms": cuda_ms(raw, reps * 4),
            "graph_ms": graph_ms(raw), "wrapper_ms": cuda_ms(through, reps),
            "plain_ms": cuda_ms(plain_run, max(3, reps // 10)), "bytes": moved_bytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    out["mismatch"] = out["injected"]["mismatch"] + out["philox"]["mismatch"]
    out["max_abs_err"] = max(out["injected"]["max_abs_err"], out["philox"]["max_abs_err"])
    return out


def alias_kernel_timing(cfg, corpus, state, mh_steps, reps=50):
    """The single-model alias_mh entry in both draw modes on one sweep's
    inputs, as `ops.mh_sweep` builds them (a packed `cfg.quant` included):
    agreement with its plain version, its ms (CUDA events over raw
    launches; `graph_ms`, the same launches replayed from a CUDA graph:
    device time with no host gaps; `wrapper_ms`, CUDA events through
    `ops.mh_resample`), the plain version's ms (in the Philox mode with its
    draws by `ops.philox_draws`), the body the kernel picks, and the bound
    from these inputs."""
    import torch

    from repro_torch.core import alias
    from repro_torch.kernels.alias_mh import ops

    n, k = corpus.num_tokens, cfg.num_topics
    counts, w_bits, real = ops.sweep_counts(cfg, state)
    tables = alias.sweep_tables(cfg, *real)
    draws = alias.sweep_draws(torch.Generator(device="cuda").manual_seed(123), n, k,
                              mh_steps, "cuda")
    args = (corpus.docs, corpus.words, state.z, corpus.weights, *counts, *tables)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=w_bits)
    d, v = counts[0].shape[0], counts[1].shape[0]
    out = {"n": n, "k": k, "d": d, "v": v, "w_bits": w_bits, "mh_steps": mh_steps,
           "body": alias_body(1, n, d, v, k, mh_steps),
           "shape": f"N={n} K={k} D={d} V={v} w_bits={w_bits} S={mh_steps}"
                    + (f" quant={cfg.quant_spec.mode}" if cfg.quant_spec.packed else "")}
    out.update(_alias_timing(args, draws, hp, ALIAS_TIMING_KEY, mh_steps, False, n, 0, reps))
    return out


def alias_bodies_at(cfg, corpus, state, mh_steps):
    """Both bodies of the single-model alias_mh entry forced at one sweep's
    inputs, in both draw modes: ms by CUDA graph (device time; the tables
    body's is its two launches) and the tokens where a body's topics differ
    from the direct body's (both give the same bits)."""
    import torch

    from repro_torch.core import alias
    from repro_torch.kernels.alias_mh import kernel, ops

    n, k = corpus.num_tokens, cfg.num_topics
    counts, w_bits, real = ops.sweep_counts(cfg, state)
    args = (corpus.docs, corpus.words, state.z, corpus.weights, *counts,
            *alias.sweep_tables(cfg, *real))
    draws = alias.sweep_draws(torch.Generator(device="cuda").manual_seed(5), n, k, mh_steps,
                              "cuda")
    raw_hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                  scale=1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    out = {}
    for mode, d_k, kw in (("injected", draws, {}),
                          ("philox", (None,) * 3,
                           dict(philox=ALIAS_TIMING_KEY, mh_steps=mh_steps))):
        zs = {}
        for body in ("direct", "tables"):
            zs[body] = torch.empty_like(state.z)

            def run(body=body, d_k=d_k, kw=kw):
                kernel.launch(*args, *d_k, zs[body], body=body, **raw_hp, **kw)

            out[f"{mode}_{body}_graph_ms"] = graph_ms(run)
            run()
        torch.cuda.synchronize()
        out[f"{mode}_differ"] = int((zs["direct"] != zs["tables"]).sum())
    return out


def alias_sweep_breakdown(cfg, corpus, state, mh_steps, reps=20):
    """Mean ms of each stage of one `alias`-backend sweep, by CUDA events:
    the table build, the resample in each draw mode (the card's sweep takes
    the Philox mode, whose draw stage is the key: host time only), the
    (S, N) draws the injected mode needs (`sweep_draws`, the CPU route's
    stage), and the count rebuild."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.kernels.alias_mh import ops

    n, k = corpus.num_tokens, cfg.num_topics
    gen = torch.Generator(device="cuda").manual_seed(17)
    counts, w_bits, real = ops.sweep_counts(cfg, state)

    def tables():
        return alias.sweep_tables(cfg, *real)

    tabs = tables()
    draws = alias.sweep_draws(gen, n, k, mh_steps, "cuda")
    args = (corpus.docs, corpus.words, state.z, corpus.weights, *counts, *tabs)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=w_bits)
    z_new = ops.mh_resample(*args, *draws, **hp)
    t0 = time.perf_counter()
    for _ in range(1000):
        ops.philox_key(gen)
    key_host_ms = time.perf_counter() - t0  # seconds over 1000 calls = ms a call
    return {
        "tables": cuda_ms(tables, reps),
        "draws_philox_key_host_ms": key_host_ms,
        "draws_injected": cuda_ms(lambda: alias.sweep_draws(gen, n, k, mh_steps, "cuda"), reps),
        "kernel_philox": cuda_ms(lambda: ops.mh_resample(
            *args, philox=ops.philox_key(gen), mh_steps=mh_steps, **hp), reps),
        "kernel_injected": cuda_ms(lambda: ops.mh_resample(*args, *draws, **hp), reps),
        "rebuild": cuda_ms(lambda: codec.rebuild_state(cfg, corpus, z_new), reps),
    }


def phase_large_fit(exact_ppx):
    """The popular product over the wire with `backend="auto"`: it must
    resolve to `alias` and launch the alias_mh kernel once a sweep, in the
    Philox mode."""
    import torch

    from repro_torch.api import VedaliaClient
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    corp, _ = popular_reviews()
    torch.cuda.reset_peak_memory_stats()
    client = VedaliaClient(device="cuda", backend="auto")
    ops.resample.launches = 0
    alias_ops.mh_resample.launches = alias_ops.mh_resample.launches_philox = 0
    t0 = time.perf_counter()
    fit = client.fit(corp.reviews, num_topics=12, base_vocab=POPULAR["vocab_size"],
                     w_bits=8, num_sweeps=100, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"lda_gibbs.resample": ops.resample.launches,
                "alias_mh.resample": alias_ops.mh_resample.launches}
    launches_philox = {"alias_mh.resample": alias_ops.mh_resample.launches_philox}
    sync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=6)
    resync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=6)
    service = client.server.service
    _check_invariants(service, fit.handle_id)
    handle = service.handles[fit.handle_id]
    cfg, corpus = handle.cfg, handle.model.corpus
    n = corpus.num_tokens
    sampler = service.sampler("alias")
    mh_steps = sampler.mh_steps
    log_gap = abs(math.log(fit.perplexity) - math.log(exact_ppx))

    gen = torch.Generator(device="cuda").manual_seed(7)
    state = handle.model.state
    sweep_ms = []
    for _ in range(30):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = sampler.sweep(cfg, state, corpus, gen)
        torch.cuda.synchronize()
        sweep_ms.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(sweep_ms)
    timing = alias_kernel_timing(cfg, corpus, state, mh_steps)
    out = {
        "phase": "large_fit", "tokens": n, "docs": cfg.num_docs, "vocab": cfg.vocab_size,
        "num_topics": cfg.num_topics, "mh_steps": mh_steps, "backend": fit.backend,
        "fit_100_s": round(fit_s, 4), "launches": launches,
        "launches_philox": launches_philox,
        "perplexity": fit.perplexity, "perplexity_exact_cuda_30": exact_ppx,
        "log_perplexity_gap": log_gap, "core_topics": sync.topic_ids,
        "view_bytes": sync.payload_bytes, "delta_bytes": resync.payload_bytes,
        "sweep_ms_median": med, "sweep_ms_min": min(sweep_ms), "sweep_ms_max": max(sweep_ms),
        "tokens_per_s": n / (med / 1e3),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "kernel": timing,
        "sweep_breakdown_ms": alias_sweep_breakdown(cfg, corpus, state, mh_steps),
    }
    out["profile_top_device_ms"], out["device_busy_ms_per_sweep"] = profile_sweeps(
        sampler, cfg, corpus, state)
    emit(out)
    want = {"lda_gibbs.resample": 0, "alias_mh.resample": 100}
    if fit.backend != "alias" or launches != want \
            or launches_philox["alias_mh.resample"] != 100:
        raise SystemExit(f"auto resolved to {fit.backend!r} with launches {launches} "
                         f"(Philox {launches_philox}); expected 'alias' with {want}, all Philox")
    if not sync.valid or len(resync.topics) != 0 or not resync.delta:
        raise SystemExit(f"view sync failed: valid={sync.valid}, re-sent {len(resync.topics)}")
    if not math.isfinite(fit.perplexity) or log_gap > LOG_PPX_BAND:
        raise SystemExit(f"alias perplexity {fit.perplexity} vs exact {exact_ppx}: "
                         f"log gap {log_gap:.3f} > {LOG_PPX_BAND}")
    if timing["mismatch"]:
        raise SystemExit(f"alias_mh kernel disagrees with its plain version at the "
                         f"large-fit shape: {timing['mismatch']} tokens")
    return out


# -- phases 5 and 6: the product zoo -------------------------------------------

ZOO_PRODUCTS = 64
ZOO_FIT_SWEEPS, ZOO_REFINE_SWEEPS, ZOO_ALIAS_SWEEPS = 30, 20, 50
ZOO_REFINE_SEED, ZOO_ALIAS_SEED = 500, 2000
ZOO_FIT = dict(num_topics=12, base_vocab=800, w_bits=8)
ZOO_SEQUENTIAL = (0, 2, 1, 3)  # the first two products of each bucket


def zoo_review_sets():
    """64 products at the case study's widths: 300 or 600 reviews each
    (about 18k or 36k tokens), base vocab 800, seeds 1000 + i."""
    from repro_torch.data import reviews

    return [reviews.generate(reviews.SyntheticSpec(
        num_reviews=300 if i % 2 == 0 else 600, vocab_size=800, num_topics=8,
        mean_tokens=60, seed=1000 + i)).reviews for i in range(ZOO_PRODUCTS)]


def zoo_buckets(service, handle_ids):
    """The served models restacked as the batch engine stacks them: per
    bucket its shared config, stacked corpora and states, handles and real
    token counts."""
    from repro_torch.core import batch
    from repro_torch.serving import batch_engine

    handles = [service.handles[h] for h in handle_ids]
    out = []
    for idxs in batch_engine.plan_buckets([(h.cfg, h.model.corpus) for h in handles]):
        hs = [handles[i] for i in idxs]
        lengths = [h.model.corpus.num_tokens for h in hs]
        n_pad = batch_engine.length_bucket(max(lengths))
        cfg = batch.batch_cfg([h.cfg for h in hs],
                              batch_engine.doc_bucket(max(h.cfg.num_docs for h in hs)))
        out.append(dict(cfg=cfg, corpora=batch.stack_corpora([h.model.corpus for h in hs], n_pad),
                        states=batch.stack_states(cfg, [h.state for h in hs], n_pad),
                        handles=hs, lengths=lengths))
    return out


def _bucket_shape(b):
    m, n = b["corpora"].docs.shape
    return (f"M={m} N={n} K={b['cfg'].num_topics} D={b['cfg'].num_docs} "
            f"V={b['cfg'].vocab_size} w_bits={b['cfg'].w_bits}")


def batched_kernel_timing(b, reps=50):
    """The batched Gibbs kernel at one bucket's shape in both noise modes
    (one sweep's drawn noise; a Philox philox a model): agreement with its
    plain version, ms (CUDA events over raw launches; `graph_ms` from a CUDA
    graph of them; through its wrapper), the plain version's ms, and the bound
    from these inputs (`lda_bound`: live tokens in full, padding slots' z,
    weight and output, the tables once)."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import ops

    cfg, corpora, states = b["cfg"], b["corpora"], b["states"]
    m, n = corpora.docs.shape
    k = cfg.num_topics
    noise = ops.gumbel((m, n, k), torch.Generator(device="cuda").manual_seed(123), "cuda")
    table = ops.philox_keys([torch.Generator(device="cuda").manual_seed(123 + i)
                            for i in range(m)], "cuda")
    args = (corpora.docs, corpora.words, states.z, corpora.weights,
            states.n_dt, states.n_wt, states.n_t)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
              w_bits=codec.codec_for(cfg).spec.w_bits)
    live = int((corpora.weights > 0).sum())
    out = {"shape": _bucket_shape(b), "live_tokens": live}
    out.update(_lda_timing(args, noise, table, hp, True, live, m * n - live, reps))
    return out


def _lda_timing(args, noise, philox, hp, many, n_live, n_pad, reps):
    """`batched_kernel_timing`'s body for one lda_gibbs entry (the batched
    one with `many`): both noise modes on one sweep's ids and counts `args`
    (7 tensors), the injected `noise` and the Philox key `philox`."""
    import torch

    from repro_torch.kernels.lda_gibbs import kernel, ops

    launch = kernel.launch_many if many else kernel.launch
    wrapper = ops.resample_many if many else ops.resample
    plain_fn = ops.resample_many_plain if many else ops.resample_plain
    w_bits = hp["w_bits"]
    raw_hp = dict(alpha=hp["alpha"], beta=hp["beta"], beta_bar=hp["beta_bar"],
                  scale=1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    z_out = torch.empty_like(args[2])
    table_bytes = sum(t.numel() * t.element_size() for t in args[4:7])
    k = args[6].shape[-1]
    out = {}
    for mode, key in (("injected", None), ("philox", philox)):
        g = noise if key is None else None
        bad, near_flip, near, gap = compare((*args, noise), many=many, philox=key, **hp)

        def raw(g=g, key=key):
            launch(*args, g, z_out, philox=key if many else (key or (0, 0)), **raw_hp)

        def through(g=g, key=key):
            return wrapper(*args, g, philox=key, **hp)

        def plain(key=key):  # in the Philox mode its draw included
            g = noise if key is None else ops.philox_noise(args[2], args[6], key)
            return plain_fn(*args, g, **hp)

        moved, bound_ms, bound_by = lda_bound(n_live, n_pad, k, table_bytes, key is not None)
        out[mode] = {
            "mismatch": bad, "near_tie_flips": near_flip, "near_ties": near,
            "max_abs_err": gap, "ms": cuda_ms(raw, reps * 4), "graph_ms": graph_ms(raw),
            "wrapper_ms": cuda_ms(through, reps), "plain_ms": cuda_ms(plain, max(3, reps // 10)),
            "bytes": moved, "bound_ms": bound_ms, "bound_by": bound_by,
        }
    out["mismatch"] = out["injected"]["mismatch"] + out["philox"]["mismatch"]
    out["max_abs_err"] = max(out["injected"]["max_abs_err"], out["philox"]["max_abs_err"])
    return out


def batched_alias_kernel_timing(b, mh_steps, reps=50):
    """The batched alias_mh entry at one bucket's shape in both draw modes
    (one sweep's tables; draws from a generator a model, or a Philox key a
    model): agreement, ms (raw launches, CUDA graph, wrapper, plain) and the
    bounds from these inputs (live tokens' ids/z/weight, draws and output,
    padding slots' z/weight/output, every count and alias table once)."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.kernels.lda_gibbs.ops import philox_keys

    cfg, corpora, states = b["cfg"], b["corpora"], b["states"]
    m, n = corpora.docs.shape
    k = cfg.num_topics
    sc = codec.codec_for(cfg)
    tables = alias.sweep_tables(cfg, sc.decode_array(states.n_dt), sc.decode_array(states.n_wt))
    gens = [torch.Generator(device="cuda").manual_seed(123 + i) for i in range(m)]
    draws = (torch.zeros((m, mh_steps, n), dtype=torch.int32, device="cuda"),
             torch.zeros((m, mh_steps, n), device="cuda"),
             torch.ones((m, mh_steps, n), device="cuda"))
    for i, (gen, n_i) in enumerate(zip(gens, b["lengths"])):
        for buf, draw in zip(draws, alias.sweep_draws(gen, n_i, k, mh_steps, "cuda")):
            buf[i, :, :n_i] = draw
    args = (corpora.docs, corpora.words, states.z, corpora.weights,
            states.n_dt, states.n_wt, states.n_t, *tables)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=sc.spec.w_bits)
    live = int((corpora.weights > 0).sum())
    out = {"shape": _bucket_shape(b) + f" S={mh_steps}", "live_tokens": live,
           "body": alias_body(m, n, cfg.num_docs, cfg.vocab_size, k, mh_steps)}
    out.update(_alias_timing(args, draws, hp, philox_keys(gens, "cuda"), mh_steps, True, live,
                             m * n - live, reps))
    return out


def _zoo_seed_check(sets, batched_ppx, seeds, backend, sweeps, refine_seed=None):
    """Fit `ZOO_SEQUENTIAL`'s products one at a time on `backend` from the
    seeds their batched chains had (and refine as the zoo did): the
    relative perplexity gap to each batched model."""
    from repro_torch.api import VedaliaClient

    client = VedaliaClient(device="cuda", backend=backend)
    gaps = {}
    for i in ZOO_SEQUENTIAL:
        fit = client.fit(sets[i], num_sweeps=sweeps[0], seed=seeds[i], **ZOO_FIT)
        if refine_seed is not None:
            fit = client.refine(fit.handle_id, num_sweeps=sweeps[1], seed=refine_seed + i)
        gaps[str(i)] = {"sequential": fit.perplexity, "batched": batched_ppx[i],
                        "rel_gap": abs(fit.perplexity - batched_ppx[i]) / batched_ppx[i]}
    return gaps


def _median_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), min(times), max(times)


def phase_zoo(sets):
    """The slice's main path: 64 products through `TopicEngine.fit_many`
    (one `fit_batch` request, `auto` -> `batched`), a `refine_batch` of all
    64 handles and a view sync of each, over the wire on the card."""
    import torch

    from repro_torch.api import VedaliaClient
    from repro_torch.api.backends import get_backend
    from repro_torch.api.service import FitRequest
    from repro_torch.core import batch, codec
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops
    from repro_torch.serving import TopicEngine

    client = VedaliaClient(device="cuda", backend="auto")
    engine = TopicEngine(client=client, max_batch=ZOO_PRODUCTS, backend="auto")
    service = client.server.service
    op0 = service._op
    counters = (ops.resample, ops.resample_many, alias_ops.mh_resample,
                alias_ops.mh_resample_many)
    for c in counters:
        c.launches = 0
    ops.resample.launches_philox = ops.resample_many.launches_philox = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.fit_many([FitRequest(uid=i, reviews=rs, num_sweeps=ZOO_FIT_SWEEPS,
                                          **ZOO_FIT) for i, rs in enumerate(sets)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ids = [r.handle_id for r in results]
    t0 = time.perf_counter()
    refined = client.refine_batch(ids, ZOO_REFINE_SWEEPS, seed=ZOO_REFINE_SEED)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    syncs = [client.sync_view(h, top_n=8) for h in ids]
    launches = {"lda_gibbs.resample": ops.resample.launches,
                "lda_gibbs.resample_many": ops.resample_many.launches,
                "alias_mh.resample": alias_ops.mh_resample.launches,
                "alias_mh.resample_many": alias_ops.mh_resample_many.launches}
    launches_philox = {"lda_gibbs.resample": ops.resample.launches_philox,
                       "lda_gibbs.resample_many": ops.resample_many.launches_philox}
    peak = torch.cuda.max_memory_allocated()
    want = {"lda_gibbs.resample": 0,
            "lda_gibbs.resample_many": 2 * (ZOO_FIT_SWEEPS + ZOO_REFINE_SWEEPS),
            "alias_mh.resample": 0, "alias_mh.resample_many": 0}
    for h in ids:
        _check_invariants(service, h)
    backends = sorted({r.fit.backend for r in results} | {r.backend for r in refined})
    ppx = [r.perplexity for r in refined]
    seeds = [service._seed * 1_000_003 + op0 + 1 + i for i in range(ZOO_PRODUCTS)]
    gaps = _zoo_seed_check(sets, ppx, seeds, "cuda", (ZOO_FIT_SWEEPS, ZOO_REFINE_SWEEPS),
                           ZOO_REFINE_SEED)

    buckets = zoo_buckets(service, ids)
    # One batched sweep from the fitted stack against the single-model
    # kernel on each model's rows of the same noise.
    stack_vs_single = {"mismatch": 0, "near_tie_flips": 0}
    for b in buckets:
        cfg, corpora, states = b["cfg"], b["corpora"], b["states"]
        m, n = corpora.docs.shape
        # vedalint: disable=generator-hygiene -- one seed each bucket on purpose: the buckets
        # differ in shape, so each draws its own noise, the same each run
        noise = ops.gumbel((m, n, cfg.num_topics),
                           torch.Generator(device="cuda").manual_seed(77), "cuda")
        z_many = ops.sweep_many(cfg, states, corpora, noise).z
        for i, (h, n_i) in enumerate(zip(b["handles"], b["lengths"])):
            g = noise[i, :n_i].contiguous()
            z_one = ops.sweep_resample(h.cfg, h.state, h.model.corpus, None, noise=g)
            differ = z_one != z_many[i, :n_i]
            if bool(differ.any()):
                real = codec.decode_state(h.cfg, h.state)
                c = h.model.corpus
                sc = ops.perturbed_scores(c.docs, c.words, h.state.z, c.weights, real.n_dt,
                                          real.n_wt, real.n_t, g, alpha=h.cfg.alpha,
                                          beta=h.cfg.beta, beta_bar=h.cfg.beta_bar)
                top2 = sc.topk(2, dim=1).values
                near = (top2[:, 0] - top2[:, 1]) < NEAR_TIE
                stack_vs_single["mismatch"] += int((differ & ~near).sum())
                stack_vs_single["near_tie_flips"] += int((differ & near).sum())
    # The route's own noise: one Philox sweep of each stack against each
    # model's single `cuda` sweep from a clone of its generator, bit for bit.
    stack_vs_single["philox_differ"] = 0
    for b in buckets:
        gens = [torch.Generator(device="cuda").manual_seed(500 + i)
                for i in range(len(b["handles"]))]
        twins = []
        for g in gens:
            twins.append(torch.Generator(device="cuda"))
            twins[-1].set_state(g.get_state())
        z_many = batch.sweep_batch(b["cfg"], b["states"], b["corpora"], gens, b["lengths"]).z
        for i, (h, n_i, twin) in enumerate(zip(b["handles"], b["lengths"], twins)):
            z_one = ops.sweep_resample(h.cfg, h.state, h.model.corpus, twin)
            stack_vs_single["philox_differ"] += int((z_one != z_many[i, :n_i]).sum())

    # Time: the zoo sweep (both buckets, as `run_many` sweeps them), the same
    # 64 products as 64 single-model `cuda` sweeps, stages, the kernel.
    real_tokens = sum(sum(b["lengths"]) for b in buckets)
    runs = []
    for b in buckets:
        m, n = b["corpora"].docs.shape
        runs.append(dict(b, gens=[torch.Generator(device="cuda").manual_seed(41 + i)
                                  for i in range(m)],
                         noise=torch.zeros((m, n, b["cfg"].num_topics), device="cuda")))

    def zoo_sweep():
        for r in runs:
            r["states"] = batch.sweep_batch(r["cfg"], r["states"], r["corpora"], r["gens"],
                                            r["lengths"])

    zoo_sweep()
    med, lo, hi = _median_ms(zoo_sweep, 20)
    top, busy = profile_device(zoo_sweep)
    cuda = get_backend("cuda")
    singles = [(h, torch.Generator(device="cuda").manual_seed(h.handle_id))
               for b in buckets for h in b["handles"]]

    def sequential_sweeps():
        for h, gen in singles:
            cuda.sweep(h.cfg, h.state, h.model.corpus, gen)

    sequential_sweeps()
    seq_med, seq_lo, seq_hi = _median_ms(sequential_sweeps, 5)
    breakdown = []
    for r in runs:
        c, st, cfg = r["corpora"], r["states"], r["cfg"]
        args = (c.docs, c.words, st.z, c.weights, st.n_dt, st.n_wt, st.n_t)
        hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=cfg.w_bits)
        table = ops.philox_keys(r["gens"], "cuda")
        batch.draw_noise(r["noise"], r["gens"], r["lengths"])
        z_new = ops.resample_many(*args, philox=table, **hp)
        breakdown.append({
            "shape": _bucket_shape(r),
            "keys": cuda_ms(lambda r=r: ops.philox_keys(r["gens"], "cuda"), 20),
            "draws": cuda_ms(lambda r=r: batch.draw_noise(r["noise"], r["gens"], r["lengths"]),
                             20),
            "kernel_philox": cuda_ms(lambda a=args, h=hp, t=table: ops.resample_many(
                *a, philox=t, **h), 20),
            "kernel_injected": cuda_ms(lambda a=args, h=hp, r=r: ops.resample_many(
                *a, r["noise"], **h), 20),
            "rebuild": cuda_ms(lambda r=r, z=z_new: codec.rebuild_state(r["cfg"], r["corpora"], z),
                               20),
        })
    larger = max(buckets, key=lambda b: b["corpora"].docs.shape[1])
    timing = batched_kernel_timing(larger)
    out = {
        "phase": "zoo", "products": ZOO_PRODUCTS, "real_tokens": real_tokens,
        "buckets": [_bucket_shape(b) for b in buckets], "backends": backends,
        "launches": launches, "launches_philox": launches_philox,
        "expected_launches": want, "fit_many_30_s": round(fit_s, 4), "refine_batch_20_s": round(refine_s, 4),
        "views_valid": all(s.valid for s in syncs),
        "perplexity_min": min(ppx), "perplexity_max": max(ppx),
        "sequential_cuda_check": gaps,
        "max_rel_gap": max(g["rel_gap"] for g in gaps.values()),
        "stack_vs_single": stack_vs_single,
        "zoo_sweep_ms_median": med, "zoo_sweep_ms_min": lo, "zoo_sweep_ms_max": hi,
        "real_tokens_per_s": real_tokens / (med / 1e3),
        "models_per_s": ZOO_PRODUCTS / (med / 1e3),
        "sequential_64_sweeps_ms_median": seq_med, "sequential_64_sweeps_ms_min": seq_lo,
        "sequential_64_sweeps_ms_max": seq_hi, "amortization": seq_med / med,
        "sweep_breakdown_ms": breakdown, "profile_top_device_ms": top,
        "device_busy_ms_per_sweep": busy, "device_idle_share": 1.0 - busy / med,
        "peak_mem_bytes": peak, "kernel": timing,
    }
    emit(out)
    if launches != want:
        raise SystemExit(f"the zoo launched {launches}, expected {want}")
    if launches_philox["lda_gibbs.resample_many"] != want["lda_gibbs.resample_many"]:
        raise SystemExit(f"the zoo's batched sweeps drew {launches_philox} in the kernel, "
                         f"expected all {want['lda_gibbs.resample_many']}")
    if backends != ["batched"]:
        raise SystemExit(f"the zoo resolved to {backends}, expected ['batched']")
    if not out["views_valid"] or not all(math.isfinite(p) for p in ppx):
        raise SystemExit("zoo views invalid or perplexity not finite")
    if out["max_rel_gap"] > PPX_BAND:
        raise SystemExit(f"batched vs sequential cuda perplexity gap {out['max_rel_gap']:.2%}")
    if stack_vs_single["mismatch"] or stack_vs_single["philox_differ"] or timing["mismatch"]:
        raise SystemExit(f"batched kernel disagrees: {stack_vs_single}, "
                         f"plain at the larger bucket {timing['mismatch']}")
    return out


def phase_zoo_alias(sets):
    """The same 64 products through `fit_batch(backend="alias")`: one
    batched MH launch per bucket and sweep, its draws made in the kernel;
    one batched Philox sweep of each bucket against the single `alias`
    sweeps of its models from clones of the generators, bit for bit."""
    import torch

    from repro_torch.api import VedaliaClient
    from repro_torch.core import alias
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    client = VedaliaClient(device="cuda", backend="auto")
    service = client.server.service
    counters = (ops.resample, ops.resample_many, alias_ops.mh_resample,
                alias_ops.mh_resample_many)
    for c in counters:
        c.launches = 0
    alias_ops.mh_resample_many.launches_philox = 0
    t0 = time.perf_counter()
    fits = client.fit_batch(sets, backend="alias", num_sweeps=ZOO_ALIAS_SWEEPS,
                            seed=ZOO_ALIAS_SEED, **ZOO_FIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"lda_gibbs.resample": ops.resample.launches,
                "lda_gibbs.resample_many": ops.resample_many.launches,
                "alias_mh.resample": alias_ops.mh_resample.launches,
                "alias_mh.resample_many": alias_ops.mh_resample_many.launches}
    launches_philox = {"alias_mh.resample_many": alias_ops.mh_resample_many.launches_philox}
    want = {"lda_gibbs.resample": 0, "lda_gibbs.resample_many": 0, "alias_mh.resample": 0,
            "alias_mh.resample_many": 2 * ZOO_ALIAS_SWEEPS}
    ids = [f.handle_id for f in fits]
    for h in ids:
        _check_invariants(service, h)
    ppx = [f.perplexity for f in fits]
    seeds = [ZOO_ALIAS_SEED + i for i in range(ZOO_PRODUCTS)]
    gaps = _zoo_seed_check(sets, ppx, seeds, "alias", (ZOO_ALIAS_SWEEPS,))
    mh_steps = service.sampler("alias").mh_steps
    buckets = zoo_buckets(service, ids)
    # The route's own draws: one Philox sweep of each stack against each
    # model's single `alias` sweep from a clone of its generator, bit for bit.
    philox_differ, singles = 0, 0
    for b in buckets:
        gens = [torch.Generator(device="cuda").manual_seed(700 + i)
                for i in range(len(b["handles"]))]
        twins = []
        for g in gens:
            twins.append(torch.Generator(device="cuda"))
            twins[-1].set_state(g.get_state())
        z_many = alias.run_many(b["cfg"], b["states"], b["corpora"], gens, 1, mh_steps,
                                b["lengths"]).z
        for i, (h, n_i, twin) in enumerate(zip(b["handles"], b["lengths"], twins)):
            z_one = alias_ops.mh_sweep(h.cfg, h.state, h.model.corpus, twin, mh_steps).z
            philox_differ += int((z_one != z_many[i, :n_i]).sum())
            singles += 1
    runs = [dict(b, gens=[torch.Generator(device="cuda").manual_seed(51 + i)
                          for i in range(len(b["handles"]))]) for b in buckets]

    def zoo_sweep():
        for r in runs:
            r["states"] = alias.run_many(r["cfg"], r["states"], r["corpora"], r["gens"], 1,
                                         mh_steps, r["lengths"])

    zoo_sweep()
    med, lo, hi = _median_ms(zoo_sweep, 20)
    top, busy = profile_device(zoo_sweep)
    larger = max(buckets, key=lambda b: b["corpora"].docs.shape[1])
    timing = batched_alias_kernel_timing(larger, mh_steps)
    real_tokens = sum(sum(b["lengths"]) for b in buckets)
    out = {
        "phase": "zoo_alias", "products": ZOO_PRODUCTS, "mh_steps": mh_steps,
        "backends": sorted({f.backend for f in fits}), "launches": launches,
        "launches_philox": launches_philox,
        "expected_launches": want, "fit_batch_50_s": round(fit_s, 4),
        "stack_vs_single": {"single_sweeps": singles, "philox_differ": philox_differ},
        "perplexity_min": min(ppx), "perplexity_max": max(ppx),
        "sequential_alias_check": gaps,
        "max_rel_gap": max(g["rel_gap"] for g in gaps.values()),
        "zoo_sweep_ms_median": med, "zoo_sweep_ms_min": lo, "zoo_sweep_ms_max": hi,
        "real_tokens_per_s": real_tokens / (med / 1e3),
        "models_per_s": ZOO_PRODUCTS / (med / 1e3), "profile_top_device_ms": top,
        "device_busy_ms_per_sweep": busy, "device_idle_share": 1.0 - busy / med,
        "kernel": timing,
    }
    emit(out)
    if launches != want or out["backends"] != ["alias"] \
            or launches_philox["alias_mh.resample_many"] != want["alias_mh.resample_many"]:
        raise SystemExit(f"the alias zoo launched {launches} (Philox {launches_philox}) on "
                         f"{out['backends']}, expected {want}, all Philox, on ['alias']")
    if philox_differ or singles != ZOO_PRODUCTS:
        raise SystemExit(f"the batched Philox alias sweep differs from {singles} single "
                         f"alias sweeps on {philox_differ} tokens")
    if not all(math.isfinite(p) for p in ppx) or out["max_rel_gap"] > PPX_BAND:
        raise SystemExit(f"batched vs sequential alias perplexity gap {out['max_rel_gap']:.2%}")
    if timing["mismatch"]:
        raise SystemExit(f"batched alias_mh kernel disagrees with its plain version at the "
                         f"larger bucket: {timing['mismatch']} tokens")
    return out


# -- phases 7-9: packed-table sweeps -------------------------------------------


def _quant_inputs(n, k, w_bits, bits, seed):
    """`_random_inputs` with its word table packed: the real-unit (V, K)
    counts row-quantized to `bits` (nibble-packed for 4) with their scales.
    Returns the quant entry's arguments (n_dt and n_t stay stored)."""
    import torch

    from repro_torch.core import quant

    docs, words, z, weights, n_dt, n_wt, n_t, noise = _random_inputs(n, k, w_bits, seed=seed)
    real = n_wt.to(torch.float32)
    if w_bits is not None:
        real = real * 2.0 ** -(w_bits + 1)
    codes, scales = quant.quantize_rows_torch(real, bits)
    if bits == 4:
        codes = quant.pack_nibbles_torch(codes).contiguous()
    return (docs, words, z, weights, n_dt, codes, scales, n_t, noise)


def pack_check(v, k, w_bits, bits, seed):
    """The pack kernel (`ops.pack_word_table` on a card table) against
    `ops.pack_word_table_plain` on the same stored (V, K) counts: entries
    of the codes and bits of the scales that differ (0 and 0 to pass)."""
    import torch

    from repro_torch.core.quant import QuantSpec
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels.lda_gibbs import ops

    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=1, w_bits=w_bits,
                    quant=QuantSpec("int8" if bits == 8 else "int4_packed", w_bits=w_bits))
    n_wt = _random_inputs(1, k, w_bits, d=1, v=v, seed=seed)[5]
    codes, scales = ops.pack_word_table(cfg, n_wt)
    want_codes, want_scales = ops.pack_word_table_plain(cfg, n_wt)
    torch.cuda.synchronize()
    return (int((codes != want_codes).sum()),
            int((scales.view(torch.int32) != want_scales.view(torch.int32)).sum()))


def phase_quant_kernel():
    """The packed-table entry in both noise modes (injected; Philox drawn in
    the kernel, against the plain version on `ops.philox_noise`) against its
    plain version: K 12 at 262,147 tokens (a thread a token, log tables from
    the codes) and 40,009 (16 lanes a token), K 128 and 1000 at 65,536 (a
    warp a token) x int8/int4 x stored n_dt f32/`w_bits` 8; then the pack
    kernel against `ops.pack_word_table_plain`, bit for bit, at V 10,000."""
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 10000)
    cases, packs = [], []
    for k in (12, 128, 1000):
        for n in (262147, 40009) if k == 12 else (65536,):
            for bits in (8, 4):
                for w_bits in (None, 8):
                    args = _quant_inputs(n, k, w_bits, bits, seed=k * 13 + bits + n)
                    for mode, philox in (("injected", None),
                                         ("philox", (2 ** 64 - 1 - n, 4 * k + bits))):
                        bad, near_flip, near, gap = compare(args, w_bits=w_bits, bits=bits,
                                                            philox=philox, **hp)
                        cases.append({"k": k, "bits": bits, "n": n, "w_bits": w_bits,
                                      "noise": mode, "mismatch": bad,
                                      "near_tie_flips": near_flip, "near_ties": near,
                                      "max_abs_err": gap})
        for bits in (8, 4):
            for w_bits in (None, 8):
                codes_differ, scales_differ = pack_check(10000, k, w_bits, bits, seed=k + bits)
                packs.append({"k": k, "v": 10000, "bits": bits, "w_bits": w_bits,
                              "codes_differ": codes_differ, "scales_differ": scales_differ})
    out = _summary(["lda_gibbs.resample_quant", "lda_gibbs.pack_word_table"], cases,
                   pack_differ=sum(p["codes_differ"] + p["scales_differ"] for p in packs),
                   pack_cases=packs)
    emit(out)
    if out["mismatches"]:
        raise SystemExit(f"lda_gibbs.resample_quant disagrees with its plain version: "
                         f"{out['mismatches']} tokens")
    if out["pack_differ"]:
        raise SystemExit(f"the pack kernel differs from its plain version: {packs}")
    return out


def quant_kernel_timing(cfg, corpus, state, reps=50):
    """The packed-table entry in both noise modes at a sweep's inputs (the
    stale table packed by the pack kernel): agreement with its plain
    version, its ms (CUDA events over raw launches; `graph_ms`, the same
    launches replayed from a CUDA graph; `wrapper_ms`, CUDA events through
    `ops.resample_quant`), the plain version's ms (in the Philox mode with
    its draw), and the bound from these inputs (the Philox mode's without
    the noise row)."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import kernel, ops

    n, k = corpus.num_tokens, cfg.num_topics
    bits = cfg.quant_spec.bits
    w_bits = codec.codec_for(cfg).spec.w_bits
    noise = ops.gumbel((n, k), torch.Generator(device="cuda").manual_seed(123), "cuda")
    codes, scales = ops.pack_word_table(cfg, state.n_wt)
    args = (corpus.docs, corpus.words, state.z, corpus.weights, state.n_dt, codes, scales,
            state.n_t)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=w_bits, bits=bits)
    raw_hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, bits=bits,
                  scale=1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    z_out = torch.empty_like(state.z)
    table_bytes = sum(t.numel() * t.element_size()
                      for t in (codes, scales, state.n_dt, state.n_t))
    out = {"n": n, "k": k, "d": state.n_dt.shape[0], "v": codes.shape[0], "bits": bits,
           "w_bits": w_bits, "table_bytes": table_bytes,
           "shape": f"N={n} K={k} D={state.n_dt.shape[0]} V={codes.shape[0]} bits={bits} "
                    f"w_bits={w_bits}"}
    for mode, philox in (("injected", None), ("philox", PHILOX_TIMING_KEY)):
        g = noise if philox is None else None
        bad, near_flip, near, gap = compare((*args, noise), philox=philox, **hp)

        def raw(g=g, philox=philox):
            kernel.launch_quant(*args, g, z_out, philox=philox or (0, 0), **raw_hp)

        def wrapper(g=g, philox=philox):
            return ops.resample_quant(*args, g, philox=philox, **hp)

        def plain(philox=philox):  # in the Philox mode its draw included
            g = noise if philox is None else ops.philox_noise(state.z, state.n_t, philox)
            return ops.resample_quant_plain(*args, g, **hp)

        moved, bound_ms, bound_by = lda_bound(n, 0, k, table_bytes, philox is not None)
        out[mode] = {
            "mismatch": bad, "near_tie_flips": near_flip, "near_ties": near,
            "max_abs_err": gap, "ms": cuda_ms(raw, reps * 4), "graph_ms": graph_ms(raw),
            "wrapper_ms": cuda_ms(wrapper, reps), "plain_ms": cuda_ms(plain, max(3, reps // 10)),
            "bytes": moved, "bound_ms": bound_ms, "bound_by": bound_by,
        }
    out["mismatch"] = out["injected"]["mismatch"] + out["philox"]["mismatch"]
    out["max_abs_err"] = max(out["injected"]["max_abs_err"], out["philox"]["max_abs_err"])
    return out


def pack_timing(cfg, n_wt, reps=200):
    """The pack kernel at a packed sweep's stored word table: its ms (CUDA
    events over raw launches, and by CUDA graph), the plain version's, and
    the bound (the stored table read once, codes and scales written once)."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import kernel, ops

    bits = cfg.quant_spec.bits
    w_bits = codec.codec_for(cfg).spec.w_bits
    codes, scales = ops.pack_word_table(cfg, n_wt)
    want_codes, want_scales = ops.pack_word_table_plain(cfg, n_wt)
    differ = int((codes != want_codes).sum()) + int(
        (scales.view(torch.int32) != want_scales.view(torch.int32)).sum())
    scale = 1.0 if w_bits is None else 2.0 ** -(w_bits + 1)

    def raw():
        kernel.pack_rows(n_wt, codes, scales, bits=bits, scale=scale)

    moved = n_wt.numel() * n_wt.element_size() + codes.numel() + scales.numel() * 4
    v, k = n_wt.shape
    # Operations: a decode, a clip and a max a count; a division, a round
    # and a clamp a code (a byte of packing for int4); one division a row.
    ops_count = v * k * 6 + v
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S
    return {"shape": f"V={v} K={k} bits={bits} w_bits={w_bits}", "differ": differ,
            "max_abs_err": float(differ), "ms": cuda_ms(raw, reps), "graph_ms": graph_ms(raw),
            "plain_ms": cuda_ms(lambda: ops.pack_word_table_plain(cfg, n_wt), reps // 4),
            "bytes": moved, "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def packed_sweep_breakdown(cfg, corpus, state, reps=20):
    """Mean ms of each stage of one packed `cuda` sweep, by CUDA events: the
    Philox key (host only: the kernel draws the noise), the stale table's
    build (the pack kernel; the plain version beside it), the resample in
    the Philox mode the sweep takes (and the injected mode's (N, K) draw and
    resample beside it), the rebuild."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device="cuda").manual_seed(11)
    shape = (corpus.num_tokens, cfg.num_topics)
    noise = ops.gumbel(shape, gen, "cuda")
    codes, scales = ops.pack_word_table(cfg, state.n_wt)
    args = (corpus.docs, corpus.words, state.z, corpus.weights, state.n_dt, codes, scales,
            state.n_t)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
              bits=cfg.quant_spec.bits, w_bits=codec.codec_for(cfg).spec.w_bits)
    z_new = ops.sweep_resample(cfg, state, corpus, gen)
    t0 = time.perf_counter()
    for _ in range(1000):
        ops.philox_key(gen)
    key_host_ms = time.perf_counter() - t0  # seconds over 1000 calls = ms a call
    return {
        "key_host_ms": key_host_ms,
        "pack_table": cuda_ms(lambda: ops.pack_word_table(cfg, state.n_wt), reps),
        "pack_table_plain": cuda_ms(lambda: ops.pack_word_table_plain(cfg, state.n_wt), reps),
        "resample_philox": cuda_ms(
            lambda: ops.resample_quant(*args, philox=ops.philox_key(gen), **hp), reps),
        "noise_injected_draw": cuda_ms(lambda: ops.gumbel(shape, gen, "cuda"), reps),
        "resample_injected": cuda_ms(lambda: ops.resample_quant(*args, noise, **hp), reps),
        "sweep_resample": cuda_ms(lambda: ops.sweep_resample(cfg, state, corpus, gen), reps),
        "rebuild": cuda_ms(lambda: codec.rebuild_state(cfg, corpus, z_new), reps),
    }


def _timed_run(sampler, cfg, corpus, seed, sweeps):
    """`sampler.run` from a seeded generator on the card: (state, seconds)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sampler.run(cfg, corpus, gen, sweeps)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def phase_packed():
    """The packed-table path at the popular product (uncut widths): 30
    sweeps on `cuda` with int8 and with int4 tables (one pack launch and one
    quant launch in the Philox mode a sweep, no exact launch), 100 on
    `alias` with int8 (one alias_mh launch a sweep), each fit's training
    perplexity beside the exact fit from the same seed; then the quant
    kernel and the pack kernel at this shape and the packed sweep's
    stages."""
    import torch

    from repro_torch.api import VedaliaService
    from repro_torch.api.backends import get_backend
    from repro_torch.core import perplexity
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    corp, _ = popular_reviews()
    prep = VedaliaService(device="cuda").prepare(
        corp.reviews, base_vocab=POPULAR["vocab_size"], num_topics=12, w_bits=8)
    cfg, corpus = prep.cfg, prep.corpus
    specs = {"int8": QuantSpec.int8(w_bits=8), "int4": QuantSpec.int4(w_bits=8)}
    runs = {}
    for backend, sweeps, modes in (("cuda", 30, ("exact", "int8", "int4")),
                                   ("alias", 100, ("exact", "int8"))):
        sampler = get_backend(backend)
        for mode in modes:
            run_cfg = cfg if mode == "exact" else dataclasses.replace(cfg, quant=specs[mode])
            ops.resample.launches = ops.resample_quant.launches = 0
            ops.resample.launches_philox = ops.resample_quant.launches_philox = 0
            ops.pack_word_table.launches = 0
            alias_ops.mh_resample.launches = alias_ops.mh_resample.launches_philox = 0
            state, secs = _timed_run(sampler, run_cfg, corpus, seed=0, sweeps=sweeps)
            runs[f"{backend}_{mode}"] = {
                "sweeps": sweeps, "s": round(secs, 4), "state": state, "cfg": run_cfg,
                "launches": {"lda_gibbs.resample": ops.resample.launches,
                             "lda_gibbs.resample_quant": ops.resample_quant.launches,
                             "lda_gibbs.pack_word_table": ops.pack_word_table.launches,
                             "alias_mh.resample": alias_ops.mh_resample.launches},
                "launches_philox": {
                    "lda_gibbs.resample": ops.resample.launches_philox,
                    "lda_gibbs.resample_quant": ops.resample_quant.launches_philox,
                    "alias_mh.resample": alias_ops.mh_resample.launches_philox},
                "perplexity": perplexity.perplexity(run_cfg, state, corpus),
            }
    for name, r in runs.items():
        exact = runs[name.split("_")[0] + "_exact"]["perplexity"]
        r["rel_gap_to_exact"] = abs(r["perplexity"] - exact) / exact
    # Every launch of a sweep in the Philox mode; a packed `cuda` sweep packs
    # its table once (the `alias` sweep fake-quantizes it for its tables).
    none = {"lda_gibbs.resample": 0, "lda_gibbs.resample_quant": 0,
            "lda_gibbs.pack_word_table": 0, "alias_mh.resample": 0}
    want = {"cuda_exact": {**none, "lda_gibbs.resample": 30},
            "cuda_int8": {**none, "lda_gibbs.resample_quant": 30,
                          "lda_gibbs.pack_word_table": 30},
            "cuda_int4": {**none, "lda_gibbs.resample_quant": 30,
                          "lda_gibbs.pack_word_table": 30},
            "alias_exact": {**none, "alias_mh.resample": 100},
            "alias_int8": {**none, "alias_mh.resample": 100}}
    for name in ("cuda_int8", "cuda_int4", "alias_int8"):
        _check_state(runs[name]["cfg"], corpus, runs[name]["state"])

    # Sweep times (exact vs packed, same corpus), stages, the kernel.
    sampler = get_backend("cuda")
    sweep_ms = {}
    for name in ("cuda_exact", "cuda_int8", "cuda_int4"):
        r = runs[name]
        # vedalint: disable=generator-hygiene -- the same stream for each run on purpose: exact
        # and packed sweeps are timed on the same draws
        gen = torch.Generator(device="cuda").manual_seed(7)
        state = r["state"]
        times = []
        for _ in range(30):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state = sampler.sweep(r["cfg"], state, corpus, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        sweep_ms[name] = statistics.median(times)
    timing = {m: quant_kernel_timing(runs[f"cuda_{m}"]["cfg"], corpus, runs[f"cuda_{m}"]["state"])
              for m in ("int8", "int4")}
    packing = {m: pack_timing(runs[f"cuda_{m}"]["cfg"], runs[f"cuda_{m}"]["state"].n_wt)
               for m in ("int8", "int4")}
    ra = runs["alias_int8"]
    alias_timing = alias_kernel_timing(ra["cfg"], corpus, ra["state"],
                                       get_backend("alias").mh_steps)
    r8 = runs["cuda_int8"]
    out = {
        "phase": "packed", "tokens": corpus.num_tokens, "docs": cfg.num_docs,
        "vocab": cfg.vocab_size, "num_topics": cfg.num_topics, "w_bits": 8,
        "runs": {name: {k: v for k, v in r.items() if k not in ("state", "cfg")}
                 for name, r in runs.items()},
        "expected_launches": want,
        "sweep_ms_median": sweep_ms,
        "kernel": timing, "pack_kernel": packing, "alias_kernel": alias_timing,
        "sweep_breakdown_ms": packed_sweep_breakdown(r8["cfg"], corpus, r8["state"]),
    }
    out["profile_top_device_ms"], out["device_busy_ms_per_sweep"] = profile_sweeps(
        sampler, r8["cfg"], corpus, r8["state"])
    emit(out)
    for name, r in runs.items():  # the `cuda` exact and `alias` runs draw in the kernel
        if r["launches"] != want[name] or any(
                r["launches_philox"][k] != want[name][k] for k in r["launches_philox"]):
            raise SystemExit(f"packed phase: {name} launched {r['launches']} "
                             f"(Philox {r['launches_philox']}), expected {want[name]}")
        if not math.isfinite(r["perplexity"]):
            raise SystemExit(f"packed phase: {name} perplexity {r['perplexity']}")
    for name in ("cuda_int8", "alias_int8"):
        if runs[name]["rel_gap_to_exact"] > PPX_BAND:
            raise SystemExit(f"{name} perplexity {runs[name]['perplexity']} is "
                             f"{runs[name]['rel_gap_to_exact']:.2%} from the exact fit")
    for m, t in timing.items():
        if t["mismatch"]:
            raise SystemExit(f"lda_gibbs.resample_quant ({m}) disagrees with its plain "
                             f"version at the popular product: {t['mismatch']} tokens")
        if packing[m]["differ"]:
            raise SystemExit(f"the pack kernel ({m}) differs from its plain version at the "
                             f"popular product: {packing[m]['differ']} entries")
    if alias_timing["mismatch"]:
        raise SystemExit(f"alias_mh disagrees with its plain version on the packed int8 "
                         f"tables: {alias_timing['mismatch']} tokens")
    return out


def phase_packed_case_study():
    """The quickstart case study (29,232 tokens) fit 100 sweeps on `cuda`
    with int8 and with int4 tables, on the card (one pack launch and one
    quant launch in the Philox mode a sweep) and on the CPU (the plain
    versions, one thread, `torch.rand` noise): training perplexity within
    5%; then the quant kernel and the pack kernel at the card run's
    state."""
    import torch

    from repro_torch.api import VedaliaService
    from repro_torch.api.backends import get_backend
    from repro_torch.core import perplexity
    from repro_torch.core.quant import QuantSpec
    from repro_torch.data import reviews
    from repro_torch.kernels.lda_gibbs import ops

    corp = reviews.generate(reviews.SyntheticSpec(**QUICKSTART))
    torch.set_num_threads(1)
    out = {"phase": "packed_case_study", "sweeps": 100, "runs": {}}
    for mode, spec in (("int8", QuantSpec.int8(w_bits=8)), ("int4", QuantSpec.int4(w_bits=8))):
        res = {}
        for device in ("cuda", "cpu"):
            prep = VedaliaService(device=device).prepare(
                corp.reviews, base_vocab=QUICKSTART["vocab_size"], num_topics=12, w_bits=8)
            cfg = dataclasses.replace(prep.cfg, quant=spec)
            ops.resample_quant.launches = ops.resample_quant.launches_philox = 0
            ops.resample.launches = ops.pack_word_table.launches = 0
            # vedalint: disable=generator-hygiene -- the same seed on the card and on the CPU on
            # purpose: their perplexities are compared
            gen = torch.Generator(device=device).manual_seed(0)
            t0 = time.perf_counter()
            state = get_backend("cuda").run(cfg, prep.corpus, gen, 100)
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = {"s": round(time.perf_counter() - t0, 4),
                           "launches": ops.resample_quant.launches,
                           "launches_philox": ops.resample_quant.launches_philox,
                           "exact_launches": ops.resample.launches,
                           "pack_launches": ops.pack_word_table.launches,
                           "perplexity": perplexity.perplexity(cfg, state, prep.corpus)}
            if device == "cuda":
                card = (cfg, prep.corpus, state)
        res["tokens"] = prep.corpus.num_tokens
        res["kernel"] = quant_kernel_timing(*card, reps=200)
        res["pack_kernel"] = pack_timing(card[0], card[2].n_wt)
        res["rel_diff"] = abs(res["cuda"]["perplexity"] - res["cpu"]["perplexity"]) \
            / res["cpu"]["perplexity"]
        out["runs"][mode] = res
    emit(out)
    for mode, res in out["runs"].items():
        launched = {dev: tuple(res[dev][key] for key in ("launches", "launches_philox",
                                                         "pack_launches", "exact_launches"))
                    for dev in ("cuda", "cpu")}
        if launched != {"cuda": (100, 100, 100, 0), "cpu": (0, 0, 0, 0)}:
            raise SystemExit(f"packed case study ({mode}) launched (quant, Philox, pack, exact) "
                             f"{launched}, expected 100, 100, 100, 0 on the card and none on "
                             f"the CPU")
        if res["kernel"]["mismatch"] or res["pack_kernel"]["differ"]:
            raise SystemExit(f"packed case study ({mode}): the quant kernel or the pack kernel "
                             f"disagrees with its plain version")
        if not math.isfinite(res["cuda"]["perplexity"]) or res["rel_diff"] > PPX_BAND:
            raise SystemExit(f"packed case study ({mode}): card {res['cuda']['perplexity']} "
                             f"vs CPU {res['cpu']['perplexity']}")
    return out


# -- phase 10: the streaming tier ----------------------------------------------

STREAM = dict(num_products=16, duration=600.0, rate=8.0, shape="burst", shift_at=300.0,
              vocab_size=800, num_topics=12, mean_tokens=60, seed=0)
STREAM_KILL_AT = 300.0  # event seconds: shard 0 is killed and restored here
STREAM_PROFILE = (420.0, 460.0)  # event seconds: the window traced by torch.profiler


def phase_stream():
    """The streaming tier at the service's widths: a burst stream with a
    concept shift, routed by consistent hash onto 2 in-process servers on
    the card, micro-batched into drain-updates, drift-triggered refits
    coalesced into `refine_batch`; shard 0 killed mid-run and restored from
    its JSON snapshot. Every acked review must be applied."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import VedaliaClient, VedaliaServer
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops
    from repro_torch.stream import (IncrementalScheduler, StreamRouter, StreamSpec, pump,
                                    restore_from_json, snapshot_to_json, synthetic_events)

    class Client(VedaliaClient):
        """Counts the reviews its server acknowledged by a fit (ingest
        acknowledgements are the server's ack cursors)."""

        fit_acked = 0

        def fit(self, reviews, **kwargs):
            result = super().fit(reviews, **kwargs)
            self.fit_acked += len(reviews)
            return result

    t0 = time.perf_counter()
    events = synthetic_events(StreamSpec(**STREAM))
    gen_s = time.perf_counter() - t0
    servers = {s: VedaliaServer(device="cuda", backend="auto") for s in (0, 1)}
    clients = {s: Client(server=servers[s]) for s in (0, 1)}
    router = StreamRouter([0, 1], capacity=128, policy="block")
    sched = IncrementalScheduler(
        clients, router, refit_policy="drift", refit_sweeps=10,
        fit_kwargs=dict(num_topics=12, base_vocab=STREAM["vocab_size"], w_bits=8,
                        num_sweeps=30))
    kill, window = {}, {}

    def on_step(t):
        if t == STREAM_PROFILE[0]:  # a steady window: the device's share of it
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        elif t == STREAM_PROFILE[1]:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            window["prof"].__exit__(None, None, None)
            window["top"], window["busy_ms"] = device_summary(window.pop("prof"), unit="window")
            # The traced window and the trace's processing, left out of reviews/s.
            window["traced_s"] = time.perf_counter() - window.pop("t0")
        if kill or t < STREAM_KILL_AT:
            return
        k0 = time.perf_counter()
        raw = snapshot_to_json(servers[0])
        restored = restore_from_json(raw, device="cuda")
        servers[0] = restored  # the old shard is dropped: its state lives on in `raw`
        clients[0].rebind(server=restored)
        sched.rebind_shard(0, clients[0])
        kill.update(at=t, snapshot_bytes=len(raw), handles=len(restored.service.handles),
                    restore_s=round(time.perf_counter() - k0, 4))

    names = ("lda_gibbs.resample", "lda_gibbs.resample_many", "lda_gibbs.resample_quant",
             "alias_mh.resample", "alias_mh.resample_many")
    counters = (ops.resample, ops.resample_many, ops.resample_quant, alias_ops.mh_resample,
                alias_ops.mh_resample_many)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pump(events, router, sched, step_interval=2.0, on_step=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {n: c.launches for n, c in zip(names, counters)}

    st = sched.stats
    ingest_acked = sum(sum(s.ingest_acked.values()) for s in servers.values())
    client_acked = sum(p.acked for p in sched.products.values())
    acked = ingest_acked + sum(c.fit_acked for c in clients.values())
    queued = sum(sum(len(q) for q in s.ingest_queues.values()) for s in servers.values())
    served_docs = sum(h.cfg.num_docs for s in servers.values()
                      for h in s.service.handles.values())
    tokens = sum(h.model.corpus.num_tokens for s in servers.values()
                 for h in s.service.handles.values())
    largest = max(sched.products.values(), key=lambda p: p.tokens_ingested)
    traced = sum(1 for e in events if STREAM_PROFILE[0] < e.t <= STREAM_PROFILE[1])
    out = {
        "phase": "stream", "events": len(events), "products": len(sched.products),
        "generate_s": round(gen_s, 3), "wall_s": round(wall_s, 3),
        "traced_s": round(window["traced_s"], 3), "traced_events": traced,
        # reviews/s outside the traced window (the tracer slows what it sees)
        "reviews_per_s": (len(events) - traced) / (wall_s - window["traced_s"]),
        "events_applied": st.events_applied, "events_held_out": st.events_held_out,
        "acked": acked, "ingest_acked": ingest_acked,
        "ingest_acked_by_clients": client_acked, "ingest_queued_at_end": queued,
        "served_reviews": served_docs, "served_tokens": tokens,
        "largest_product_tokens": largest.tokens_ingested,
        "fits": st.fits, "updates": st.updates, "refits": st.refits,
        "refit_launches": st.refit_launches, "coalesced_refits": st.coalesced_refits,
        "drift_triggers": st.drift_triggers, "ppx_triggers": st.ppx_triggers,
        "forced_by_staleness": st.forced_by_staleness,
        "staleness_p50_s": st.staleness_p(50), "staleness_p99_s": st.staleness_p(99),
        "staleness_budget_s": sched.staleness_budget, "router": dataclasses.asdict(
            router.stats()), "kill": kill, "launches": launches,
        "profile_window_s": list(STREAM_PROFILE), "profile_wall_ms": window["wall_ms"],
        "profile_top_device_ms": window["top"], "device_busy_ms": window["busy_ms"],
        "device_idle_share": 1.0 - window["busy_ms"] / window["wall_ms"],
    }
    emit(out)
    if not kill:
        raise SystemExit("stream phase: shard 0 was never killed and restored")
    if not st.events_applied == acked == served_docs or queued \
            or ingest_acked != client_acked \
            or st.events_applied + st.events_held_out != len(events):
        raise SystemExit(f"stream phase: {st.events_applied} applied, {acked} acked, "
                         f"{served_docs} served, {queued} still queued, {ingest_acked} "
                         f"ingest acks ({client_acked} seen by the clients), "
                         f"{st.events_held_out} held out of {len(events)} events")
    if sum(launches.values()) == 0 or st.fits == 0 or st.updates == 0:
        raise SystemExit(f"stream phase ran no device work: {launches}")
    return out


# -- phase 10b: the offload tier ---------------------------------------------------

OFFLOAD_SHARDS = (0, 1)
# A 1,000-device fleet, 20% malicious (half fabricate, half corrupt), churn
# 0.05, stragglers 0.1 x 8: the JAX package's `benchmarks/offload_bench.py`.
OFFLOAD_FLEET = dict(num_devices=1000, malicious_frac=0.2, fabricate_frac=0.5, churn_prob=0.05,
                     straggler_frac=0.1, straggler_factor=8.0, seed=0)
OFFLOAD_CASES = {
    # (a) the JAX package's `benchmarks/offload_bench.py` config, exactly
    "offload_gate": dict(
        stream=dict(num_products=4, duration=80.0, rate=2.5, shape="burst", shift_at=20.0,
                    seed=0),
        server=dict(backend="jnp", num_sweeps=4, update_sweeps=1),
        router=dict(capacity=256),
        sched=dict(microbatch=6, min_fit_reviews=8, staleness_budget=8.0, refit_sweeps=6,
                   fit_kwargs=dict(num_topics=4, base_vocab=120, num_sweeps=4)),
        ppx_band=0.02),
    # (b) the service's widths: the stream phase's config, its 600 s cut to 120 s
    "offload_service": dict(
        stream=dict(num_products=16, duration=120.0, rate=8.0, shape="burst", shift_at=60.0,
                    vocab_size=800, num_topics=12, mean_tokens=60, seed=0),
        server=dict(backend="auto"),
        router=dict(capacity=128, policy="block"),
        sched=dict(refit_sweeps=10,
                   fit_kwargs=dict(num_topics=12, base_vocab=800, w_bits=8, num_sweeps=30)),
        ppx_band=PPX_BAND),
}
OFFLOAD_COUNTERS = ("lda_gibbs.resample", "lda_gibbs.resample_many", "lda_gibbs.resample_quant",
                    "alias_mh.resample", "alias_mh.resample_many")


def _offload_counters():
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    return dict(zip(OFFLOAD_COUNTERS, (ops.resample, ops.resample_many, ops.resample_quant,
                                       alias_ops.mh_resample, alias_ops.mh_resample_many)))


# The server verbs a refit costs the server: the built-in path's `refine`
# and `refine_batch`; a lease's `export_model`, `spot_check` (validation and
# reverify), `adopt_state` and its fallback `refine`.
REFIT_VERBS = ("refine", "refine_batch", "export_model", "spot_check", "adopt_state")
# The obs spans a lease's stages are read from (its client-side calls and
# the coordinator's and fleet's own spans), by stage.
LEASE_SPANS = {"offload.lease": "lease", "client.export_model": "export",
               "offload.device_fit": "device_fit", "offload.validate": "validation",
               "offload.reverify": "reverify", "client.adopt_state": "adopt",
               "client.refine": "fallback"}


def span_seconds(spans):
    """A replay's obs spans summed: `lease_stages` (each stage's seconds
    and calls, by `LEASE_SPANS`) and `server_refit` (the servers' dispatch
    spans of `REFIT_VERBS`, a `spot_check` filed under the coordinator span
    it ran under: `validation` or `reverify`), with their total seconds."""
    by_id = {sp.span_id: sp for sp in spans}

    def server_stage(sp):
        verb = sp.name.removeprefix("server.")
        if verb != "spot_check":
            return verb
        while sp.parent_id in by_id:
            sp = by_id[sp.parent_id]
            if sp.name in ("offload.validate", "offload.reverify"):
                return LEASE_SPANS[sp.name]
        return verb

    out = {"lease_stages": collections.defaultdict(lambda: {"s": 0.0, "calls": 0}),
           "server_refit": collections.defaultdict(lambda: {"s": 0.0, "calls": 0})}
    for sp in spans:
        if sp.name in LEASE_SPANS:
            key, stage = "lease_stages", LEASE_SPANS[sp.name]
        elif sp.name.removeprefix("server.") in REFIT_VERBS:
            key, stage = "server_refit", server_stage(sp)
        else:
            continue
        out[key][stage]["s"] += sp.duration_s
        out[key][stage]["calls"] += 1
    out = {key: dict(stages) for key, stages in out.items()}
    out["server_refit_s"] = sum(v["s"] for v in out["server_refit"].values())
    return out


def stack_size(b):
    """A batch-engine stack's models, then its slots."""
    return len(b["handles"]), b["corpora"].docs.numel()


def offload_stream(device, case, events, executor=None):
    """Replay `events` onto 2 in-process servers on `device` under
    `refit_policy="always"` (a refit a micro-batch: the schedule depends on
    the event times alone), with obs on. Returns the scheduler, its
    clients, the refit task list (shard, product, tokens, sweeps) in order,
    the largest stack a coalesced window handed `refine_batch` (restacked
    by `zoo_buckets` as the window arrived; None when no window coalesced),
    the held-out
    perplexity of every product that has a reservoir, whether every view
    syncs valid, the wall seconds, each kernel's launches (counted from 0
    just before the replay) and `lda_gibbs.resample`'s tokens, and the
    replay's spans summed by `span_seconds`."""
    import torch

    from repro_torch import obs
    from repro_torch.api import VedaliaClient, VedaliaServer
    from repro_torch.kernels.lda_gibbs import ops
    from repro_torch.obs import trace
    from repro_torch.stream import IncrementalScheduler, StreamRouter, pump

    class Scheduler(IncrementalScheduler):
        """Records each refit task as the executor (or the built-in path)
        receives it, and the largest stack of a coalesced window."""

        tasks: list
        stack: dict = None

        def _execute_refits(self, sid, statuses, now):
            self.tasks += [(sid, s.product_id, int(s.tokens_ingested), self.refit_sweeps)
                           for s in statuses]
            if self.refit_executor is None and len(statuses) > 1:
                for b in zoo_buckets(self.clients[sid].server.service,
                                     [s.handle_id for s in statuses]):
                    if self.stack is None or stack_size(b) > stack_size(self.stack):
                        self.stack = b
            return super()._execute_refits(sid, statuses, now)

    router = StreamRouter(list(OFFLOAD_SHARDS), **case["router"])
    clients = {s: VedaliaClient(server=VedaliaServer(device=device, **case["server"]))
               for s in OFFLOAD_SHARDS}
    sched = Scheduler(clients, router, refit_policy="always", refit_executor=executor,
                      **case["sched"])
    sched.tasks = []
    counters = _offload_counters()
    for c in counters.values():
        c.launches = c.launches_philox = 0
    ops.resample.tokens = 0
    trace.reset()
    if device == "cuda":
        torch.cuda.synchronize()
    with obs.scope(True):
        t0 = time.perf_counter()
        pump(events, router, sched, step_interval=2.0)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans = trace.spans()
    trace.reset()
    if len(spans) >= trace.MAX_SPANS:
        raise SystemExit(f"offload replay: the span buffer filled ({len(spans)} spans)")
    launches = {name: c.launches for name, c in counters.items()}
    launches_philox = {name: c.launches_philox for name, c in counters.items()}
    heldout = {pid: float(clients[st.shard_id].perplexity(st.handle_id, reviews=st.heldout))
               for pid, st in sched.products.items() if st.heldout}
    views_valid = all(clients[st.shard_id].sync_view(st.handle_id).valid
                      for st in sched.products.values())
    return dict(sched=sched, clients=clients, tasks=sched.tasks, stack=sched.stack,
                heldout=heldout, views_valid=views_valid, wall_s=wall_s, launches=launches,
                launches_philox=launches_philox, resample_tokens=ops.resample.tokens,
                **span_seconds(spans))


def offload_run(device, name, case, events, base, fleet_backend):
    """The same stream leased to the 1,000-device fleet on `fleet_backend`
    ("torch", the reference bench's "jnp", or "sparse", the phone's
    sampler) against the server-only replay `base`; emits the run and
    fails on a missed gate."""
    import numpy as np

    from repro_torch.offload import DeviceFleet, FleetSpec, OffloadCoordinator

    fleet = DeviceFleet(FleetSpec(**OFFLOAD_FLEET, backend=fleet_backend), device=device)
    coord = OffloadCoordinator(fleet, spot_check_sweeps=2, seed=0)
    run = offload_stream(device, case, events, executor=coord)
    st, ledger = coord.stats, coord.marketplace.ledger
    base_work = base["sched"].stats.refit_sweep_work
    offloaded = 1.0 - st.server_sweep_work / base_work
    shared = sorted(set(base["heldout"]) & set(run["heldout"]))
    base_ppx = float(np.mean([base["heldout"][p] for p in shared]))
    off_ppx = float(np.mean([run["heldout"][p] for p in shared]))
    ppx_delta = abs(off_ppx - base_ppx) / base_ppx
    credit = {kind: float(np.mean([ledger.get(d.device_id) for d in fleet.devices.values()
                                   if d.honest == honest]))
              for kind, honest in (("honest", True), ("malicious", False))}
    server_s = run["server_refit_s"] / base["server_refit_s"]
    out = {
        "phase": name, "fleet_backend": fleet_backend, "events": len(events),
        "products": len(run["sched"].products), "refits": st.tasks,
        "server_only_refits": base["sched"].stats.refits, "task_lists_equal": run[
            "tasks"] == base["tasks"],
        "adopted": st.adopted, "adopted_phony": st.adopted_phony,
        "fallback_unmatched": st.fallback_unmatched, "fallback_rejected": st.fallback_rejected,
        "invalid_uploads": st.invalid_submissions, "churned": st.churned,
        "lease_timeouts": st.lease_timeouts, "validations": st.validations,
        "spot_checks": st.spot_checks, "offloaded_sweep_fraction": offloaded,
        "server_sweep_work": st.server_sweep_work, "server_only_sweep_work": base_work,
        "device_sweep_work": st.device_sweep_work,
        # The server's measured seconds for refit work (its dispatch spans of
        # `REFIT_VERBS`) in each replay, beside the sweep-work accounting.
        "server_refit_s": {"server_only": base["server_refit_s"],
                           "offloaded": run["server_refit_s"], "ratio": server_s,
                           "measured_offloaded_fraction": 1.0 - server_s,
                           "server_only_by_stage": base["server_refit"],
                           "offloaded_by_stage": run["server_refit"]},
        "heldout_ppx": {"server_only": base_ppx, "offloaded": off_ppx, "rel_delta": ppx_delta,
                        "products": len(shared), "band": case["ppx_band"]},
        "credit": {**credit, "ledger_total": ledger.total()},
        "matched_rate": coord.marketplace.matched_rate(),
        "verification_rate": coord.marketplace.verification_rate(),
        "views_valid": run["views_valid"], "wall_s": run["wall_s"],
        "lease_stages": run["lease_stages"], "server_only_wall_s": base["wall_s"],
        "leases_per_s": st.tasks / run["wall_s"],
        "launches": run["launches"], "launches_philox": run["launches_philox"],
        "server_only_launches": base["launches"],
        "server_only_launches_philox": base["launches_philox"],
    }
    emit(out)
    failed = [msg for bad, msg in (
        (st.tasks != base["sched"].stats.refits or run["tasks"] != base["tasks"],
         "the refit task lists differ: the comparison is invalid"),
        (offloaded < 0.5, f"only {offloaded:.1%} of refit sweep-work moved off the server"),
        (ppx_delta > case["ppx_band"], f"held-out perplexity {ppx_delta:.2%} from server-only"),
        (st.adopted_phony != 0, f"{st.adopted_phony} phony model(s) adopted"),
        (not credit["honest"] > credit["malicious"], f"credit did not separate: {credit}"),
        (abs(ledger.total()) > 1e-9, f"the ledger is not zero-sum: {ledger.total()}"),
        (st.adopted == 0 or st.device_sweep_work <= 0, "the fleet adopted nothing"),
        (st.adopted + st.fallbacks != st.tasks, "a lease was neither adopted nor fallen back"),
        (not run["views_valid"], "a view failed to sync valid"),
        (run["launches"]["lda_gibbs.resample"] == 0, "the offloaded run launched no kernel"),
    ) if bad]
    if failed:
        raise SystemExit(f"{name} ({fleet_backend} fleet): " + "; ".join(failed))
    return out, run


def phase_offload(device="cuda"):
    """The Chital offload tier on in-process servers on `device`: (a) the
    JAX package's offload bench config with the fleet on `torch` and on
    `sparse`, against one server-only replay; (b) the service's widths
    with the fleet on `torch`. Returns the emitted runs and each case's
    replays by name (`server_only` and the fleet backends)."""
    from repro_torch.stream import StreamSpec, synthetic_events

    runs, replays = {}, {}
    for name, case in OFFLOAD_CASES.items():
        events = synthetic_events(StreamSpec(**case["stream"]))
        base = offload_stream(device, case, events)
        replays[name] = {"server_only": base}
        for backend in (("torch", "sparse") if name == "offload_gate" else ("torch",)):
            runs[f"{name}_{backend}"], replays[name][backend] = offload_run(
                device, name, case, events, base, backend)
    return runs, replays


def offload_kernels(replays):
    """Each offload case's Gibbs kernels held against their plain versions
    at the case's own shapes, and timed: `lda_gibbs.resample` at the
    largest product's first block (the largest launch) and at a block of
    the case's mean tokens a launch, from the last offloaded replay's
    served state; `lda_gibbs.resample_many` at the largest stack the
    server-only replay's coalesced windows handed `refine_batch`, from the
    states it had then. Fails on a mismatch.
    Returns, by case, the timings and the launches counted over its
    replays."""
    out = {}
    for name, case_runs in replays.items():
        base, last = case_runs["server_only"], list(case_runs.values())[-1]
        largest = max(last["sched"].products.values(), key=lambda p: p.tokens_ingested)
        handle = last["clients"][largest.shard_id].server.service.handles[largest.handle_id]
        launches = {run: r["launches"]["lda_gibbs.resample"] for run, r in case_runs.items()}
        tokens = sum(r["resample_tokens"] for r in case_runs.values())
        per_launch = tokens / sum(launches.values())
        first = first_block_timing(handle)
        typical = first_block_timing(handle, n=max(1, round(per_launch)))
        many = batched_kernel_timing(base["stack"])
        corpora = sorted(p.tokens_ingested for p in last["sched"].products.values())
        row = {
            "case": name, "first_block": first, "typical_block": typical, "many": many,
            "resample": {"launches": launches, "launches_philox": sum(
                r["launches_philox"]["lda_gibbs.resample"] for r in case_runs.values()),
                "tokens": tokens, "tokens_per_launch": per_launch,
                "corpora_tokens": [corpora[0], corpora[len(corpora) // 2], corpora[-1]]},
            "resample_many": {"launches": {run: r["launches"]["lda_gibbs.resample_many"]
                                           for run, r in case_runs.items()},
                              "launches_philox": sum(
                                  r["launches_philox"]["lda_gibbs.resample_many"]
                                  for r in case_runs.values()),
                              "live_tokens": sum(base["stack"]["lengths"])},
        }
        emit({"phase": "offload_kernel", **row})
        if first["mismatch"] or typical["mismatch"] or many["mismatch"]:
            raise SystemExit(f"{name}: a Gibbs kernel disagrees with its plain version: "
                             f"first block {first['mismatch']}, typical block "
                             f"{typical['mismatch']}, stack {many['mismatch']}")
        out[name] = row
    return out


# -- phase 11: the mesh fit tiers ------------------------------------------------

MESH_V = 20_000  # the reference bench's vocabulary (`benchmarks/distributed_bench.py`)
MESH_GRIDS = ((4, 1), (2, 2))
MESH_STALENESS, MESH_SWEEPS, MESH_SCALING_SWEEPS = 2, 30, 8
MESH_HELD = dict(n=8000, d=61, v=120, k=6, seed=5, warm=60, measured=36, chunk=6)


def _mesh_wrappers():
    """The kernel wrappers the mesh tiers' local engines launch, by kernels-line name."""
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    return {"lda_gibbs.resample": ops.resample, "lda_gibbs.resample_many": ops.resample_many,
            "alias_mh.resample": alias_ops.mh_resample,
            "alias_mh.resample_many": alias_ops.mh_resample_many}


def _mesh_launchers():
    """The raw launch each mesh wrapper makes, by kernels-line name:
    (module, attribute)."""
    from repro_torch.kernels.alias_mh import kernel as alias_kernel
    from repro_torch.kernels.lda_gibbs import kernel

    return {"lda_gibbs.resample": (kernel, "launch"),
            "lda_gibbs.resample_many": (kernel, "launch_many"),
            "alias_mh.resample": (alias_kernel, "launch"),
            "alias_mh.resample_many": (alias_kernel, "launch_many")}


def _launch_shape(args) -> tuple:
    """What tells two launches of one entry apart: the shapes and dtypes of
    the ids, counts and totals (the body the kernel picks follows from them)."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in args[:7])


def mesh_counted(fn, tally, run):
    """`fn()` with every mesh wrapper's counts zeroed just before and read
    just after (the device synced): (its result, {name: [launches,
    Philox launches]}); the counts are kept in `tally` under `run` and
    added to its totals. Meanwhile each raw launch is filed by entry and
    shape under `tally["shapes"][run]`, with its mode and the first
    launch's inputs (cloned), so `mesh_launch_checks` can hold the kernel
    at every shape the run gave it; the per-shape counts must add up to
    the wrappers' counts."""
    import torch

    wrappers, launchers = _mesh_wrappers(), _mesh_launchers()
    shapes = tally["shapes"].setdefault(run, {})

    def keeping(name, launch):
        def launch_and_keep(*args, **kw):
            draws = args[7:8] if len(args) == 9 else args[11:14]
            slot = shapes.setdefault((name, _launch_shape(args)), {"launches": [0, 0]})
            if "inputs" not in slot:
                slot["inputs"] = ([a.clone() if isinstance(a, torch.Tensor) else a
                                   for a in args[:-1]],
                                  {k: v.clone() if isinstance(v, torch.Tensor) else v
                                   for k, v in kw.items()})
            slot["launches"][0] += 1
            slot["launches"][1] += draws[0] is None
            return launch(*args, **kw)
        return launch_and_keep

    for f in wrappers.values():
        f.launches = f.launches_philox = 0
    saved = {name: getattr(mod, attr) for name, (mod, attr) in launchers.items()}
    for name, (mod, attr) in launchers.items():
        setattr(mod, attr, keeping(name, saved[name]))
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr) in launchers.items():
            setattr(mod, attr, saved[name])
    counts = {name: [f.launches, f.launches_philox] for name, f in wrappers.items()}
    for name, want in counts.items():
        got = [sum(slot["launches"][i] for (n, _), slot in shapes.items() if n == name)
               for i in (0, 1)]
        if got != want:
            raise SystemExit(f"mesh {run}: {name} counted {want}, its launches by shape {got}")
    tally["by_run"][run] = counts
    for name, (n, n_philox) in counts.items():
        tally["total"][name][0] += n
        tally["total"][name][1] += n_philox
    return out, counts


def zipf_corpus(n, d, seed, v=MESH_V):
    """The reference bench's Zipf corpus on the card: words from a Zipf(1.3)
    law below V, documents sorted, unit weights."""
    import numpy as np
    import torch

    from repro_torch.core.types import Corpus

    r = np.random.default_rng(seed)
    w = r.zipf(1.3, size=4 * n) - 1
    w = w[w < v][:n].astype(np.int32)
    docs = np.sort(r.integers(0, d, n)).astype(np.int32)
    return Corpus(torch.tensor(docs, device="cuda"), torch.tensor(w, device="cuda"),
                  torch.ones(n, device="cuda"))


def planted_corpus(n, d, v, k, seed):
    """The reference bench's planted corpus (claim 4) on the card: 90% of
    each topic's mass on its own vocab block, unit weights."""
    import numpy as np
    import torch

    from repro_torch.core.types import Corpus

    r = np.random.default_rng(seed)
    blk = v // k
    phi = np.full((k, v), 0.1 / v)
    for t in range(k):
        phi[t, t * blk:(t + 1) * blk] += 0.9 * r.dirichlet(np.full(blk, 0.5))
    phi /= phi.sum(1, keepdims=True)
    theta_c = r.dirichlet(np.full(k, 0.3), size=d).cumsum(1)
    docs = r.integers(0, d, n).astype(np.int32)
    zt = (r.random(n)[:, None] > theta_c[docs]).sum(1)
    w = np.empty(n, np.int64)
    for t in range(k):
        m = zt == t
        w[m] = np.searchsorted(phi[t].cumsum(), r.random(m.sum()))
    return Corpus(torch.tensor(docs, device="cuda"),
                  torch.tensor(np.minimum(w, v - 1).astype(np.int32), device="cuda"),
                  torch.ones(n, device="cuda"))


def _clone(gen):
    import torch

    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def _same_state(a, b):
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("z", "n_dt", "n_wt", "n_t"))


def mesh_exactness(tally):
    """(a) One worker on the bench's claim-1 corpus (Zipf 1.3, 4,096
    tokens, 40 docs, V 20,000, K 8, unit weights), 3 sweeps from one
    generator state: `gibbs` against `core.gibbs.run`, `cuda` against the
    `cuda` backend and `mh` against the `alias` backend, bit for bit."""
    import torch

    from repro_torch.api.backends import get_backend
    from repro_torch.core import gibbs
    from repro_torch.core.types import LDAConfig
    from repro_torch.pserver import PServerFit

    cfg = LDAConfig(num_topics=8, vocab_size=MESH_V, num_docs=40)
    corpus = zipf_corpus(4096, 40, 7)
    out = {}
    for local, oracle in (("gibbs", lambda g: gibbs.run(cfg, corpus, g, 3)),
                          ("cuda", lambda g: get_backend("cuda").run(cfg, corpus, g, 3)),
                          ("mh", lambda g: get_backend("alias").run(cfg, corpus, g, 3))):
        # vedalint: disable=generator-hygiene -- the same seed for each engine on purpose: each is
        # held bit for bit against its oracle on a clone
        gen = torch.Generator(device="cuda").manual_seed(3)
        twin = _clone(gen)
        st, counts = mesh_counted(
            lambda: PServerFit(local=local).run(cfg, corpus, gen, 3), tally, f"a_{local}")
        out[local] = {"bit_exact": _same_state(st, oracle(twin)), "launches": counts}
    return out


def _timed_fit(ps, cfg, corpus, sweeps, tally, run):
    """One warm-up sweep (plan, first launches), then `sweeps` timed by the
    host clock around a synchronized run: (seconds, launches of the timed run)."""
    import torch

    ps.run(cfg, corpus, torch.Generator(device="cuda").manual_seed(0), 1)

    def timed():
        t0 = time.perf_counter()
        ps.run(cfg, corpus, torch.Generator(device="cuda").manual_seed(1), sweeps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return mesh_counted(timed, tally, run)


def mesh_bytes_and_scaling(tally):
    """(b) The bench's claim-2/3 corpora (1 x and 4 x 80,000 Zipf tokens,
    50 docs a worker, V 20,000, K 16): the sync bytes of 4 stacked workers
    against the replicated tier's (gate: strictly below), and the stacked
    W = 1 and W = 4 fit times of 8 sweeps on each engine (one card cannot
    measure weak scaling; reported, not gated)."""
    from repro_torch.core.types import LDAConfig
    from repro_torch.pserver import PServerFit
    from repro_torch.pserver.sync import replicated_sync_bytes_per_device, sync_bytes_per_device

    n_per, d_per, k = 80_000, 50, 16
    one, big = zipf_corpus(n_per, d_per, 1), zipf_corpus(4 * n_per, 4 * d_per, 2)
    cfg1 = LDAConfig(num_topics=k, vocab_size=MESH_V, num_docs=d_per)
    cfg4 = LDAConfig(num_topics=k, vocab_size=MESH_V, num_docs=4 * d_per)
    plan = PServerFit(workers=(4, 1)).plan(cfg4, big)
    ps_bytes = sync_bytes_per_device(plan.n_workers, plan.cap, k)
    repl = replicated_sync_bytes_per_device(plan.n_workers, MESH_V, k)
    scaling = {}
    for local in ("gibbs", "cuda"):
        t1, c1 = _timed_fit(PServerFit(local=local), cfg1, one, MESH_SCALING_SWEEPS, tally,
                            f"b_{local}_1worker")
        t4, c4 = _timed_fit(PServerFit(workers=(4, 1), local=local), cfg4, big,
                            MESH_SCALING_SWEEPS, tally, f"b_{local}_4worker")
        scaling[local] = {"t_1worker_s": t1, "t_4worker_4x_s": t4,
                          "launches_1worker": c1, "launches_4worker": c4}
    return {"sync_bytes": {"pserver_per_device": ps_bytes, "replicated_per_device": repl,
                           "support_cap": plan.cap, "vocab": MESH_V, "workers": 4,
                           "saving": repl / max(ps_bytes, 1)},
            "scaling": scaling}


def mesh_popular(exact_ppx, tally):
    """(c) The popular product over the wire on `pserver`: stacked workers
    on (4, 1) and (2, 2), staleness 2, 30 sweeps, on `cuda` then `mh`
    (`w_bits` 8: one single-sweep program a sweep, the reference's rule, so
    one sync a sweep), and once more on (2, 2) with float32 counts on each
    engine (whole staleness-2 windows: 15 syncs, so `mh` accepts against a
    cache up to two sweeps stale). Obs on for the sync counters;
    10 more sweeps timed, and 5 of each (2, 2) `w_bits` run traced by
    `torch.profiler` (device busy ms a sweep, top device ops).
    Returns the runs and, by engine, the (2, 2) handle's server."""
    import torch

    from repro_torch import obs
    from repro_torch.api import VedaliaClient
    from repro_torch.obs import metrics
    from repro_torch.pserver.sync import replicated_sync_bytes_per_device

    corp, _ = popular_reviews()
    runs, servers = {}, {}
    cases = [(grid, local, 8) for local in ("cuda", "mh") for grid in MESH_GRIDS]
    cases += [((2, 2), local, None) for local in ("cuda", "mh")]
    syncs = metrics.REGISTRY.get("vedalia_pserver_syncs_total")
    sent = metrics.REGISTRY.get("vedalia_pserver_sync_bytes_total")
    for grid, local, w_bits in cases:
        name = f"{grid[0]}x{grid[1]}_{local}" + ("_f32" if w_bits is None else "")
        client = VedaliaClient(device="cuda", backend="pserver", backend_opts={"pserver": dict(
            workers=grid, staleness=MESH_STALENESS, local=local)})
        obs.enable()
        try:
            before = (syncs.value(), sent.value())

            def fit(client=client, w_bits=w_bits):
                t0 = time.perf_counter()
                res = client.fit(corp.reviews, num_topics=12, base_vocab=POPULAR["vocab_size"],
                                 w_bits=w_bits, num_sweeps=MESH_SWEEPS, seed=0)
                torch.cuda.synchronize()
                return res, time.perf_counter() - t0

            (res, fit_s), counts = mesh_counted(fit, tally, f"c_{name}")
            n_syncs, n_bytes = syncs.value() - before[0], sent.value() - before[1]
        finally:
            obs.disable()
        service = client.server.service
        _check_invariants(service, res.handle_id)
        handle = service.handles[res.handle_id]
        sampler = service.sampler("pserver")
        cfg, corpus = handle.cfg, handle.model.corpus
        plan = sampler._fit.plan(cfg, corpus)
        # vedalint: disable=generator-hygiene -- the same seed for each grid and engine on
        # purpose: their sweep times are compared on the same draws
        gen = torch.Generator(device="cuda").manual_seed(21)
        state = handle.model.state
        sweep_ms = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state = sampler.sweep(cfg, state, corpus, gen)
            torch.cuda.synchronize()
            sweep_ms.append((time.perf_counter() - t) * 1e3)
        ppx = res.perplexity
        many = "lda_gibbs.resample_many" if local == "cuda" else "alias_mh.resample_many"
        runs[name] = {
            "workers": list(grid), "local": local, "w_bits": w_bits, "tokens": corpus.num_tokens,
            "support_cap": plan.cap, "t_local": plan.t_local, "d_local": plan.d_local,
            "v_pad": plan.v_pad, "fit_30_s": fit_s, "fit_ms_per_sweep": fit_s * 1e3 / MESH_SWEEPS,
            "sweep_ms_median": statistics.median(sweep_ms), "sweep_ms_min": min(sweep_ms),
            "launches": counts, "expected": {many: [MESH_SWEEPS, MESH_SWEEPS]},
            "syncs": n_syncs, "sync_bytes_counter": n_bytes,
            "sync_bytes_per_device": n_bytes / max(n_syncs, 1),
            "replicated_sync_bytes_per_device": replicated_sync_bytes_per_device(
                plan.n_workers, cfg.vocab_size, cfg.num_topics),
            "perplexity": ppx, "exact_perplexity": exact_ppx,
            "rel_gap": abs(ppx - exact_ppx) / exact_ppx,
            "log_gap": abs(math.log(ppx) - math.log(exact_ppx)),
        }
        want_syncs = MESH_SWEEPS // (1 if w_bits is not None else MESH_STALENESS)
        others = {k: v for k, v in counts.items() if k != many and v[0]}
        failed = [msg for bad, msg in (
            (counts[many] != [MESH_SWEEPS, MESH_SWEEPS],
             f"{many} launched {counts[many]}, expected {MESH_SWEEPS}, all Philox"),
            (bool(others), f"other kernels launched: {others}"),
            (n_syncs != want_syncs, f"{n_syncs} syncs counted, expected {want_syncs}"),
            (not math.isfinite(ppx), f"perplexity {ppx}"),
            (local == "cuda" and runs[name]["rel_gap"] > PPX_BAND,
             f"perplexity {ppx} vs the exact fit's {exact_ppx}: over {PPX_BAND:.0%}"),
            (local == "mh" and runs[name]["log_gap"] > LOG_PPX_BAND,
             f"log perplexity {ppx} vs the exact fit's {exact_ppx}: over {LOG_PPX_BAND}"),
        ) if bad]
        if failed:
            raise SystemExit(f"mesh (c) {name}: " + "; ".join(failed))
        if grid == (2, 2) and w_bits is not None:
            servers[local] = (sampler, cfg, corpus, handle.model.state)
            runs[name]["profile_top_device_ms"], runs[name]["device_busy_ms_per_sweep"] = \
                profile_sweeps(sampler, cfg, corpus, handle.model.state)
    return runs, servers


def mesh_heldout(tally):
    """(d) The bench's claim-4 planted corpus (8,000 tokens, 61 docs, V 120,
    K 6; a fifth held out): 60 warm sweeps of `core.gibbs.run`, then 36
    measured in chunks of 6 from that state — (2, 2) at staleness 2 on
    `gibbs` (gated: gap <= 2%), on `cuda` and on `mh` (whole windows on
    float32 counts; reported) against the oracle;
    held-out perplexity averaged over the chunks from 18 sweeps on."""
    import numpy as np
    import torch

    from repro_torch.core import gibbs, perplexity
    from repro_torch.core.types import Corpus, LDAConfig
    from repro_torch.pserver import PServerFit

    h = MESH_HELD
    full = planted_corpus(h["n"], h["d"], h["v"], h["k"], h["seed"])
    cut = h["n"] // 5
    hold, train = (Corpus(*(t[s] for t in (full.docs, full.words, full.weights)))
                   for s in (slice(0, cut), slice(cut, None)))
    cfg = LDAConfig(num_topics=h["k"], vocab_size=h["v"], num_docs=h["d"])
    warm = gibbs.run(cfg, train, torch.Generator(device="cuda").manual_seed(9), h["warm"])

    def avg_heldout(run, seed):
        st, ppxs, gen = warm, [], torch.Generator(device="cuda").manual_seed(seed)
        for i in range(h["measured"] // h["chunk"]):
            st = run(st, gen)
            if (i + 1) * h["chunk"] >= h["measured"] // 2:
                ppxs.append(perplexity.perplexity(cfg, st, hold))
        return float(np.mean(ppxs))

    p_oracle = avg_heldout(lambda st, g: gibbs.run(cfg, train, g, h["chunk"], state=st), 200)
    out = {"oracle": p_oracle}
    for local in ("gibbs", "cuda", "mh"):
        ps = PServerFit(workers=(2, 2), staleness=MESH_STALENESS, local=local)
        p, counts = mesh_counted(lambda ps=ps: avg_heldout(
            lambda st, g: ps.run(cfg, train, g, h["chunk"], state=st), 100), tally, f"d_{local}")
        out[local] = {"pserver_stale2": p, "gap": abs(p - p_oracle) / p_oracle,
                      "launches": counts}
    return out


def mesh_kernels(servers, reps=50):
    """(e) Rows 1 and 4 against their plain versions on worker 0's slab of
    (c)'s (2, 2) support shapes (tokens t_local, doc rows (d_local, K),
    support cache (cap, K)), both noise or draw modes, from each engine's
    fitted state as `PServerFit.worker_inputs` lays it out: the single
    entries at the width a worker of that grid would give them (rows 2 and
    5 are checked at those shapes on their launches' own inputs, by
    `mesh_launch_checks`). Timed and bounded as the other phases' kernels;
    near-ties exempt and counted."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.kernels.lda_gibbs import ops

    out = {}
    for local, (sampler, cfg, corpus, state) in servers.items():
        plan, inp = sampler._fit.worker_inputs(cfg, codec.decode_state(cfg, state), corpus)
        t, k = plan.t_local, cfg.num_topics
        one = tuple(inp[f][0] for f in ("docs", "words", "z", "wts", "n_dt", "cache", "n_t"))
        hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=None)
        live = int((one[3] > 0).sum())
        # vedalint: disable=generator-hygiene -- one fixed seed for each server's kernel check, as
        # every kernel phase draws its inputs: the checks are reproducible
        gen = torch.Generator(device="cuda").manual_seed(123)
        shape = (f"N={t} K={k} D={plan.d_local} V={plan.cap} (support; vocab "
                 f"{cfg.vocab_size}) w_bits=None")
        if local == "cuda":
            out["lda_gibbs.resample"] = {
                "shape": shape + " (worker 0)", "live_tokens": live,
                **_lda_timing(one, ops.gumbel((t, k), gen, "cuda"), PHILOX_TIMING_KEY, hp,
                              False, live, t - live, reps)}
        else:
            mh_steps = sampler._fit.mh_steps
            tables = alias.sweep_tables(cfg, one[4], one[5])
            out["alias_mh.resample"] = {
                "shape": shape + f" S={mh_steps} (worker 0)", "live_tokens": live,
                "body": alias_body(1, t, plan.d_local, plan.cap, k, mh_steps),
                **_alias_timing((*one, *tables), alias.sweep_draws(gen, t, k, mh_steps, "cuda"),
                                hp, ALIAS_TIMING_KEY, mh_steps, False, live, t - live, reps)}
    return out


def mesh_launch_check(name, inputs, kw, reps):
    """One entry held against its plain version in both noise or draw modes,
    and timed and bounded, on the inputs of a launch `mesh_counted` kept:
    the mode it ran in replayed from its key (`ops.philox_noise`,
    `philox_draws`), the other from a fixed key or from that noise."""
    import torch

    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    many = name.endswith("_many")
    scale = kw["scale"]
    w_bits = None if scale == 1.0 else round(-math.log2(scale)) - 1
    hp = dict(alpha=kw["alpha"], beta=kw["beta"], beta_bar=kw["beta_bar"], w_bits=w_bits)
    z, weights, n_t = inputs[2], inputs[3], inputs[6]
    m = z.shape[0] if many else 1
    n, k, d, v = z.shape[-1], n_t.shape[-1], inputs[4].shape[-2], inputs[5].shape[-2]
    live = int((weights > 0).sum())
    other_key = (ops.philox_keys([torch.Generator(device="cuda").manual_seed(123 + i)
                                  for i in range(m)], "cuda") if many else None)
    shape = (f"M={m} " if many else "") + f"N={n} K={k} D={d} V={v} (support rows) w_bits={w_bits}"
    philox = kw.get("philox")
    if name.startswith("lda_gibbs"):
        noise = inputs[7]
        if noise is None:
            noise = ops.philox_noise(z, n_t, philox)
        else:
            philox = other_key if many else PHILOX_TIMING_KEY
        return {"shape": shape, "live_tokens": live,
                **_lda_timing(tuple(inputs[:7]), noise, philox, hp, many, live,
                              z.numel() - live, reps)}
    draws, mh_steps = tuple(inputs[11:14]), kw.get("mh_steps")
    if draws[0] is None:
        draws = alias_ops.philox_draws(z, n_t, philox, mh_steps)
    else:
        mh_steps = draws[0].shape[-2]
        philox = other_key if many else ALIAS_TIMING_KEY
    return {"shape": shape + f" S={mh_steps}", "live_tokens": live,
            "body": alias_body(m, n, d, v, k, mh_steps),
            **_alias_timing(tuple(inputs[:11]), draws, hp, philox, mh_steps, many, live,
                            z.numel() - live, reps)}


def mesh_launch_checks(tally, reps=20):
    """Every shape each run of the phase launched an entry at, checked by
    `mesh_launch_check` on the first such launch's inputs: one row a (run,
    entry, shape) with the launches filed there ([all, Philox]). Emits
    each row; the kept inputs are dropped as they are used."""
    rows = []
    for run, shapes in tally["shapes"].items():
        for (name, _), slot in shapes.items():
            args, kw = slot.pop("inputs")
            r = {"run": run, "name": name, "launches": slot["launches"],
                 **mesh_launch_check(name, args, kw, reps)}
            del args
            emit({"phase": "mesh_kernel", **{key: r[key] for key in (
                "run", "name", "shape", "launches", "mismatch", "max_abs_err")},
                  **{mode: {key: r[mode][key] for key in (
                      "mismatch", "near_tie_flips", "near_ties", "ms", "graph_ms", "plain_ms",
                      "bound_ms", "bound_by")} for mode in ("injected", "philox")}})
            rows.append(r)
    return rows


def _mesh_counted_rows(mesh, name):
    """The kernels line's by-shape rows of one entry from `phase_mesh`: one
    a (run, shape) the phase launched it at, with its check and timing at
    that launch's inputs and its launches there (all modes and Philox)."""
    return [(r, *r["launches"], f"mesh ({r['run']})", {})
            for r in mesh["launch_checks"] if r["name"] == name]


def mesh_max_err(mesh, name):
    """An entry's largest score gap over the phase's checks of it."""
    timing = mesh["kernel_timings"].get(name)
    return max([r["max_abs_err"] for r in mesh["launch_checks"] if r["name"] == name]
               + ([timing["max_abs_err"]] if timing else []))


def phase_mesh(exact_ppx):
    """The mesh fit tiers on the card (`pserver`, its stacked workers on one
    H100): (a) one worker bit for bit against the oracles, (b) sync bytes
    under the replicated tier's and the stacked W = 1 / W = 4 times, (c) the
    popular product over the wire on (4, 1) and (2, 2) — one batched launch
    a sweep —, (d) held-out perplexity at staleness 2 within 2% of the
    oracle, (e) rows 1 and 4 at (c)'s (2, 2) support shapes. Counts zeroed
    just before each run of the tier and read just after; their sums by
    kernel are the phase's launches, and each run's launches are filed by
    shape and checked there (`mesh_launch_checks`)."""
    tally = {"total": {name: [0, 0] for name in _mesh_wrappers()}, "by_run": {}, "shapes": {}}
    exact = mesh_exactness(tally)
    scaling = mesh_bytes_and_scaling(tally)
    popular, servers = mesh_popular(exact_ppx, tally)
    held = mesh_heldout(tally)
    kernels = mesh_kernels(servers)
    checks = mesh_launch_checks(tally)
    out = {"phase": "mesh", "exactness": exact, **scaling, "popular": popular,
           "heldout": held, "launches": tally["total"], "launches_by_run": tally["by_run"],
           "kernels": {name: {key: r[key] for key in ("shape", "mismatch", "max_abs_err")}
                       | {mode: {key: r[mode][key] for key in
                                 ("mismatch", "near_tie_flips", "near_ties", "ms", "graph_ms",
                                  "plain_ms", "bound_ms", "bound_by")}
                          for mode in ("injected", "philox")}
                       for name, r in kernels.items()}}
    emit(out)
    failed = [msg for bad, msg in (
        (not all(r["bit_exact"] for r in exact.values()),
         f"(a) one worker is not the oracle's chain: "
         f"{ {k: r['bit_exact'] for k, r in exact.items()} }"),
        (not scaling["sync_bytes"]["saving"] > 1.0,
         f"(b) sparse sync not below the replicated tier: {scaling['sync_bytes']}"),
        (held["gibbs"]["gap"] > 0.02, f"(d) held-out gap {held['gibbs']['gap']:.2%} > 2%"),
        (any(r["mismatch"] for r in kernels.values()),
         f"(e) a kernel disagrees with its plain version at the support shapes: "
         f"{ {k: r['mismatch'] for k, r in kernels.items()} }"),
        (any(r["mismatch"] for r in checks),
         f"a kernel disagrees with its plain version at a shape a run launched it at: "
         f"{[(r['run'], r['name'], r['shape'], r['mismatch']) for r in checks if r['mismatch']]}"),
    ) if bad]
    if failed:
        raise SystemExit("mesh: " + "; ".join(failed))
    return {**out, "kernel_timings": kernels, "launch_checks": checks}


# -- phase 1b: the transformer zoo's kernels ------------------------------------

ZAMBA2_PREFILL = dict(b=2, s=4096, h=80, dk=64, dv=64)  # one Mamba2 layer's scan, 2 x 4096
RWKV6_SCAN = dict(b=2, s=2048, h=32, dk=64, dv=64)  # rwkv6-1.6b's heads
ZAMBA2_DECODE = dict(b=2, s=4096, hkv=32, g=1, hd=80)  # the shared block's ring cache
# rwkv6-1.6b's served prefill waves (B 2 x 4096, 2 x 512, 1 x 512; H 32, dk = dv 64)
RWKV6_SERVED = [dict(b=b, s=s, h=32, dk=64, dv=64) for b, s in ((2, 4096), (2, 512), (1, 512))]
# decode_attn at each shape the served decode steps give it, with the last
# position a served wave decodes at that shape (its heaviest step, where it is
# timed): the 2 x 4096 waves' 4126, the 512-token waves' 542 (526 for one
# request of 16 new tokens); whisper's 4-token waves' 130 (128 new tokens) and
# its 64-token wave's 126. A cross-attention entry (`_CROSS`) is the static
# encoder or image cache, every slot read: it is checked and timed at `length
# = pos = S`, its one served call. Keyed as `attn_key` files the served calls.
# The MoE archs' waves (`MOE_MIX`): 2 x 4096, one wave of 8 x 512 and 1 x 512,
# so B 2, 8 and 1, at G 7 (Arctic, 56 / 8 heads) and G 5 (Maverick, 40 / 8).
_RING = dict(window=4096, ring=True)
_CROSS = dict(cross=True)
WHISPER_SELF, WHISPER_CROSS = dict(b=2, s=448, hkv=8, g=1, hd=64), dict(b=2, s=1500, hkv=8,
                                                                       g=1, hd=64)
VISION_SELF, VISION_CROSS = dict(b=2, s=2048, hkv=8, g=8, hd=128), dict(b=2, s=1024, hkv=8,
                                                                       g=8, hd=128)
ARCTIC_DECODE = dict(b=2, s=8192, hkv=8, g=7, hd=128)
MAVERICK_DECODE = dict(b=2, s=8192, hkv=8, g=5, hd=128)
SERVED_DECODE = [
    ("zamba2-2.7b", dict(ZAMBA2_DECODE), _RING, 4126),
    ("zamba2-2.7b", dict(ZAMBA2_DECODE, b=1), _RING, 542),
    ("qwen2-7b", dict(b=2, s=8192, hkv=4, g=7, hd=128), {}, 4126),
    ("qwen2-7b", dict(b=1, s=8192, hkv=4, g=7, hd=128), {}, 542),
    ("gemma2-9b local", dict(b=2, s=4096, hkv=8, g=2, hd=256), dict(_RING, cap=50.0), 4126),
    ("gemma2-9b global", dict(b=2, s=8192, hkv=8, g=2, hd=256), dict(cap=50.0), 4126),
    ("gemma2-9b local, gemma2-9b-sw", dict(b=1, s=4096, hkv=8, g=2, hd=256),
     dict(_RING, cap=50.0), 542),
    ("gemma2-9b global", dict(b=1, s=8192, hkv=8, g=2, hd=256), dict(cap=50.0), 542),
    ("gemma-7b", dict(b=1, s=8192, hkv=16, g=1, hd=256), {}, 526),
    ("phi3-medium-14b", dict(b=1, s=8192, hkv=10, g=4, hd=128), {}, 526),
    ("whisper-base self", WHISPER_SELF, {}, 130),
    ("whisper-base self", dict(WHISPER_SELF, b=1), {}, 126),
    ("whisper-base cross", WHISPER_CROSS, _CROSS, 1500),
    ("whisper-base cross", dict(WHISPER_CROSS, b=1), _CROSS, 1500),
    ("llama-3.2-vision-90b self", VISION_SELF, {}, 542),
    ("llama-3.2-vision-90b self", dict(VISION_SELF, b=1), {}, 542),
    ("llama-3.2-vision-90b cross", VISION_CROSS, _CROSS, 1024),
    ("llama-3.2-vision-90b cross", dict(VISION_CROSS, b=1), _CROSS, 1024),
    ("arctic-480b", ARCTIC_DECODE, {}, 4126),
    ("arctic-480b", dict(ARCTIC_DECODE, b=8), {}, 542),
    ("arctic-480b", dict(ARCTIC_DECODE, b=1), {}, 542),
    ("llama4-maverick-400b-a17b", MAVERICK_DECODE, {}, 4126),
    ("llama4-maverick-400b-a17b", dict(MAVERICK_DECODE, b=8), {}, 542),
    ("llama4-maverick-400b-a17b", dict(MAVERICK_DECODE, b=1), {}, 542),
]


def served_call(shape, kw, pos):
    """decode_attn's arguments of a served call at `pos`: a self call reads
    positions up to `pos` (`length = pos + 1`, with the entry's window, ring
    and cap); a cross call (`kw["cross"]`) every slot of its static cache."""
    if kw.get("cross"):
        return dict(length=shape["s"], pos=shape["s"])
    return dict(pos=pos, length=pos + 1, **kw)


def served_key(shape, kw):
    """An entry's shape as `attn_key` files a served call."""
    return (shape["b"], shape["s"], shape["hkv"], shape["g"], shape["hd"],
            kw.get("window", 0), kw.get("ring", False), kw.get("cap", 0.0),
            bool(kw.get("cross", False)))


def _scan_inputs(b, s, h, dk, dv, kdtype, seed, s0=True):
    """chunk_scan's arguments on the card: w in float32 (as Mamba2 makes it),
    k, q, v in `kdtype`, u (h, dk) and s0 (b, h, dk, dv) float32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    w = torch.rand(b, s, h, dk, generator=gen, device=dev) * 0.4 + 0.6
    k, v, q = (torch.randn(b, s, h, d, generator=gen, device=dev).mul_(0.3).to(kdtype)
               for d in (dk, dv, dk))
    u = torch.randn(h, dk, generator=gen, device=dev) * 0.1
    st = torch.randn(b, h, dk, dv, generator=gen, device=dev) * 0.1 if s0 else None
    return w, k, v, q, u, st


def _scan_a_cost(chunk, dk, include_current):
    """(f32 operations, exps) of one chunk's A in its cheapest known form:
    split into sub-chunks of m rows (the m that costs least), a diagonal
    block takes one exp a masked (t, i, d) below its diagonal (a subtract,
    the exp, a multiply and a fused add; the mamba2 diagonal, exp(0), only
    the fused add); a block below them is (qf M) kf^T, one fused add a
    (t, i, d), with the anchored factors qf = q exp(Lq - L[a]) and
    kf = k exp(L[r] - L) at an exp, a subtract and a multiply a (t, d),
    M = exp(L[a] - L[r]) at an exp and a subtract a (sub-chunk pair, d)
    where it is not 1, and qf M at a multiply a (t, pair, d) there."""
    def cost(m):
        sizes = [min(m, chunk - lo) for lo in range(0, chunk, m)]
        n = len(sizes)
        diag = sum(z * (z - 1) // 2 for z in sizes)
        below = sum(z * m * blk for blk, z in enumerate(sizes))
        factor_rows = 2 * chunk - sizes[0] - sizes[-1]  # qf rows and kf rows
        far = max(n - 1, 0) * max(n - 2, 0) // 2        # pairs with M != 1
        qf_m = sum(z * max(blk - 1, 0) for blk, z in enumerate(sizes))
        exps = (diag + factor_rows + far) * dk
        ops = ((4 * diag + 2 * below + 2 * factor_rows + far + qf_m) * dk
               + (2 * chunk * dk if include_current else 0) + exps)
        return ops, exps

    return min(cost(m) for m in range(1, chunk + 1))


def _scan_cost(b, s, h, dk, dv, chunk, itemsize, include_current, s0):
    """(bytes, f32 operations, exps) the chunked scan needs: each input read
    once, each output written once; per (b, h, chunk) A in its cheapest
    known form (`_scan_a_cost`), the two state contractions and y's A @ v."""
    moved = b * s * h * (4 * dk + itemsize * (2 * dk + 2 * dv)) + 4 * b * h * dk * dv * (1 + s0)
    a_ops, a_exps = _scan_a_cost(chunk, dk, include_current)
    per_chunk_exps = a_exps + 2 * chunk * dk + dk
    per_chunk_ops = (a_ops + (0 if include_current else 3 * chunk * dk)
                     + 2 * chunk * dk * dv * 2 + 2 * chunk * (chunk + 1) // 2 * dv
                     + 2 * dk * dv + 3 * chunk * dk + 2 * chunk * dk + dk)
    n = b * h * (s // chunk)
    return moved, n * per_chunk_ops, n * per_chunk_exps


def _scan_cost_mamba2(b, s, h, dk, dv, chunk, itemsize, s0):
    """(bytes, f32 operations, exps) the Mamba2 entry needs: w (B, S, H)
    float32, k and q (B, S, dk), v and y (B, S, H, dv) read or written once,
    the states; q_t . k_i once per (b, chunk) (it is the same for every
    head), and per (b, h, chunk) the decay of the A entries the mask keeps,
    y's two contractions, the state update, the scan of the log decays."""
    moved = (4 * b * s * h + itemsize * (2 * b * s * dk + 2 * b * s * h * dv)
             + 4 * b * h * dk * dv * (1 + s0))
    pairs = chunk * (chunk + 1) // 2
    per_chunk_exps = pairs + 2 * chunk + 1
    per_chunk_ops = (2 * pairs + 2 * chunk * dk * dv + 2 * pairs * dv + 2 * chunk * dv
                     + chunk * dk + 2 * chunk * dk * dv + 2 * dk * dv + 4 * chunk
                     + per_chunk_exps)
    n_chunks = s // chunk
    ops_count = b * h * n_chunks * per_chunk_ops + b * n_chunks * 2 * pairs * dk
    return moved, ops_count, b * h * n_chunks * per_chunk_exps


def _bound(moved, ops_count):
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _bounds(moved, ops_count):
    """Both bounds in ms: bytes over the HBM rate, operations over float32's."""
    return {"bound_bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bound_ops_ms": ops_count / F32_OPS_PER_S * 1e3}


def compare_scan(args, *, include_current, chunk):
    """Kernel vs plain on identical inputs: (max |dy|, max |dS|, within the
    stated tolerance)."""
    import torch

    from repro_torch.kernels.chunk_scan import ops

    kw = dict(include_current=include_current, chunk=chunk, s0=args[5])
    y, st = ops.chunk_scan(*args[:5], **kw)
    torch.cuda.synchronize()
    y_p, st_p = ops.chunk_scan_plain(*args[:5], **kw)
    dy = float((y.float() - y_p.float()).abs().max())
    ds = float((st - st_p).abs().max())
    if y.dtype == torch.bfloat16:  # the reference's bf16 tolerances
        ok = (torch.allclose(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)
              and torch.allclose(st, st_p, atol=2e-2, rtol=2e-2))
    else:  # float32: the state carries over many chunks, so 1e-4 past 1,000 tokens
        tol = 3e-5 if args[1].shape[1] <= 1000 else 1e-4
        ok = torch.allclose(y, y_p, atol=tol, rtol=tol) and torch.allclose(st, st_p, atol=tol,
                                                                            rtol=tol)
    return dy, ds, ok


def scan_timing(shape, kdtype, *, include_current, chunk, reps=20, seed=0, s0=None):
    """The chunk_scan wrapper and its plain version on one call's inputs
    (with a start state unless `s0` is False; by default rwkv6 mode has
    one): mean ms of each (CUDA events; the wrapper also by CUDA graph) and
    the bound from these inputs."""
    import torch

    from repro_torch.kernels.chunk_scan import kernel, ops

    s0 = not include_current if s0 is None else s0
    args = _scan_inputs(**shape, kdtype=kdtype, seed=seed, s0=s0)
    kw = dict(include_current=include_current, chunk=chunk, s0=args[5])
    u = None if include_current else args[4]
    ms = cuda_ms(lambda: ops.chunk_scan(*args[:4], u, **kw), reps)
    # The same calls replayed from a CUDA graph: device time with no host
    # gaps (the graph keeps each call's outputs and scratch until it is freed).
    dev_ms = graph_ms(lambda: ops.chunk_scan(*args[:4], u, **kw), launches=10, reps=5)
    plain_ms = cuda_ms(lambda: ops.chunk_scan_plain(*args[:4], u, **kw), 3, warmup=1)
    item = torch.tensor([], dtype=kdtype).element_size()
    c = ops.chunk_len(shape["s"], chunk)
    moved, ops_count, exps = _scan_cost(**shape, chunk=c, itemsize=item,
                                        include_current=include_current, s0=s0)
    bound_ms, bound_by = _bound(moved, ops_count)
    return {"ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms, "bytes": moved,
            "ops": ops_count, "exps": exps, "bound_ms": bound_ms, "bound_by": bound_by,
            **_bounds(moved, ops_count), "library_ms": None, "dv_block": kernel.dv_block(),
            "scan_blocks": kernel.scan_blocks(shape["b"], shape["h"], shape["dv"]),
            "cuda_launches_per_call": cuda_launches(lambda: ops.chunk_scan(*args[:4], u, **kw)),
            "scratch_bytes": 4 * kernel.scratch_floats(shape["b"], shape["s"], shape["h"],
                                                       shape["dk"], c),
            "smem_bytes": kernel.smem_bytes(c, shape["dk"], item),
            "shape": (f"B={shape['b']} S={shape['s']} H={shape['h']} dk={shape['dk']} "
                      f"dv={shape['dv']} chunk={chunk} k/q/v {str(kdtype)[6:]} w float32 "
                      f"{'mamba2' if include_current else 'rwkv6'}"
                      f"{'' if s0 else ' no s0'}")}


def _mamba2_inputs(b, s, h, dk, dv, kdtype, seed, s0=True):
    """The Mamba2 entry's arguments on the card: w (b, s, h) float32, k and q
    (b, s, dk) and v (b, s, h, dv) in `kdtype`, s0 (b, h, dk, dv) float32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    w = torch.rand(b, s, h, generator=gen, device=dev) * 0.4 + 0.6
    k, q = (torch.randn(b, s, dk, generator=gen, device=dev).mul_(0.3).to(kdtype)
            for _ in range(2))
    v = torch.randn(b, s, h, dv, generator=gen, device=dev).mul_(0.3).to(kdtype)
    st = torch.randn(b, h, dk, dv, generator=gen, device=dev) * 0.1 if s0 else None
    return w, k, q, v, st


def compare_scan_mamba2(args, *, chunk):
    """The Mamba2 entry's kernel vs its plain version on identical inputs,
    at chunk_scan's tolerances: (max |dy|, max |dS|, within them)."""
    import torch

    from repro_torch.kernels.chunk_scan import ops

    y, st = ops.chunk_scan_mamba2(*args[:4], chunk=chunk, s0=args[4])
    torch.cuda.synchronize()
    y_p, st_p = ops.chunk_scan_mamba2_plain(*args[:4], chunk=chunk, s0=args[4])
    dy = float((y.float() - y_p.float()).abs().max())
    ds = float((st - st_p).abs().max())
    if y.dtype == torch.bfloat16:
        ok = (torch.allclose(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)
              and torch.allclose(st, st_p, atol=2e-2, rtol=2e-2))
    else:
        tol = 3e-5 if args[1].shape[1] <= 1000 else 1e-4
        ok = torch.allclose(y, y_p, atol=tol, rtol=tol) and torch.allclose(st, st_p, atol=tol,
                                                                            rtol=tol)
    return dy, ds, ok


def scan_timing_mamba2(shape, kdtype, *, chunk, reps=50, seed=0):
    """The Mamba2 entry and its plain version on one prefill layer's inputs
    (no s0, as a prompt starts): mean ms (CUDA events) and both bounds."""
    import torch

    from repro_torch.kernels.chunk_scan import ops

    args = _mamba2_inputs(**shape, kdtype=kdtype, seed=seed, s0=False)
    ms = cuda_ms(lambda: ops.chunk_scan_mamba2(*args[:4], chunk=chunk), reps)
    plain_ms = cuda_ms(lambda: ops.chunk_scan_mamba2_plain(*args[:4], chunk=chunk), 3,
                       warmup=1)
    item = torch.tensor([], dtype=kdtype).element_size()
    moved, ops_count, exps = _scan_cost_mamba2(**shape, chunk=ops.chunk_len(shape["s"], chunk),
                                               itemsize=item, s0=False)
    bound_ms, bound_by = _bound(moved, ops_count)
    return {"ms": ms, "plain_ms": plain_ms, "bytes": moved, "ops": ops_count, "exps": exps,
            "bound_ms": bound_ms, "bound_by": bound_by, **_bounds(moved, ops_count),
            "library_ms": None,
            "dv_block": ops.dv_block(shape["b"], shape["h"], shape["dv"]),
            "shape": (f"B={shape['b']} S={shape['s']} H={shape['h']} dk={shape['dk']} "
                      f"dv={shape['dv']} chunk={chunk} k/q/v {str(kdtype)[6:]} w (B,S,H) "
                      f"float32 mamba2 entry")}


def phase_chunk_scan_kernel():
    import torch

    from repro_torch.kernels.chunk_scan import kernel

    cases = []
    grid = [(ZAMBA2_PREFILL, True, 32), (RWKV6_SCAN, False, 64),
            *((shape, False, 32) for shape in RWKV6_SERVED),
            (dict(b=1, s=4096, h=32, dk=64, dv=64), False, 32),  # B 1 over 128 chunks
            (dict(b=2, s=1000, h=4, dk=32, dv=64), True, 32),   # ragged: chunk 25
            (dict(b=1, s=600, h=3, dk=64, dv=128), False, 64),  # ragged: chunk 60, dk != dv
            (dict(b=3, s=96, h=2, dk=128, dv=64), True, 64),
            (dict(b=2, s=64, h=3, dk=20, dv=40), False, 16),    # dk 20, dv 40: a ragged slice
            (dict(b=2, s=64, h=3, dk=20, dv=40), True, 16)]
    for shape, include_current, chunk in grid:
        for kdtype in (torch.float32, torch.bfloat16):
            for s0 in (True, False):
                args = _scan_inputs(**shape, kdtype=kdtype, seed=len(cases), s0=s0)
                dy, ds, ok = compare_scan(args, include_current=include_current, chunk=chunk)
                cases.append({**shape, "chunk": chunk, "mode": "mamba2" if include_current
                              else "rwkv6", "dtype": str(kdtype)[6:], "s0": s0,
                              "max_abs_err_y": dy, "max_abs_err_state": ds, "ok": ok})
    # The Mamba2 entry (w (B, S, H), k and q (B, S, dk)): the served prefill
    # shape, B = 1 (16-column state slices), ragged chunks, dk 128 at chunk 64,
    # and dk 20, dv 48 (three 16-column slices; the entry takes dk % 4 == 0
    # and dv % 16 == 0).
    grid_m2 = [(ZAMBA2_PREFILL, 32), (dict(b=1, s=1024, h=80, dk=64, dv=64), 32),
               (dict(b=2, s=1000, h=4, dk=32, dv=64), 32),   # ragged: chunk 25
               (dict(b=1, s=600, h=3, dk=64, dv=128), 64),   # ragged: chunk 60, dk != dv
               (dict(b=3, s=96, h=2, dk=128, dv=64), 64),
               (dict(b=2, s=64, h=3, dk=20, dv=48), 16)]
    for shape, chunk in grid_m2:
        for kdtype in (torch.float32, torch.bfloat16):
            for s0 in (True, False):
                args = _mamba2_inputs(**shape, kdtype=kdtype, seed=len(cases), s0=s0)
                dy, ds, ok = compare_scan_mamba2(args, chunk=chunk)
                cases.append({**shape, "chunk": chunk, "mode": "mamba2 entry",
                              "dtype": str(kdtype)[6:], "s0": s0, "max_abs_err_y": dy,
                              "max_abs_err_state": ds, "ok": ok})
    timing = scan_timing(ZAMBA2_PREFILL, torch.bfloat16, include_current=True, chunk=32)
    timing_rwkv = scan_timing(RWKV6_SCAN, torch.bfloat16, include_current=False, chunk=64)
    timing_m2 = scan_timing_mamba2(ZAMBA2_PREFILL, torch.bfloat16, chunk=32)
    # rwkv6-1.6b's served prefill scans (general entry, rwkv6 mode, chunk 32,
    # no start state), keyed as `scan_key` files the served calls.
    served = {scan_key(*_scan_inputs(**shape, kdtype=torch.bfloat16, seed=0, s0=False)[:5],
                       include_current=False, chunk=32):
              scan_timing(shape, torch.bfloat16, include_current=False, chunk=32, s0=False)
              for shape in RWKV6_SERVED}

    def max_err(entry):  # over the general entry's cases or the Mamba2 entry's
        return max(max(c["max_abs_err_y"], c["max_abs_err_state"]) for c in cases
                   if (c["mode"] == "mamba2 entry") == (entry == "mamba2"))

    out = {"phase": "kernels", "kernels": ["chunk_scan", "chunk_scan_mamba2"],
           "failed": sum(not c["ok"] for c in cases),
           "max_abs_err": max_err("general"), "max_abs_err_mamba2": max_err("mamba2"),
           "smem_bytes_rwkv6_chunk32": kernel.smem_bytes(32, 64, 2),
           "smem_bytes_limit": kernel.MAX_SMEM_BYTES,
           "kernel_mamba2": timing_m2, "kernel": timing, "kernel_rwkv6": timing_rwkv,
           "served_rwkv6": [{"key": list(k), **v} for k, v in served.items()],
           "cases": cases}
    emit(out)
    if out["failed"]:
        raise SystemExit(f"chunk_scan kernel disagrees with its plain version in "
                         f"{out['failed']} cases")
    return {**out, "served": served}


def _attn_inputs(b, s, hkv, g, hd, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((b, hkv * g, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


def compare_attn(args, **kw):
    import torch

    from repro_torch.kernels.decode_attn import ops

    out = ops.decode_attention(*args, **kw)
    torch.cuda.synchronize()
    want = ops.decode_attention_plain(*args, **kw)
    err = float((out.float() - want.float()).abs().max())
    if out.dtype == torch.bfloat16:
        # Both sides round a float32 result to bf16 once, so they differ by at
        # most one bf16 unit in the last place (2^-7 of the value): rtol 1e-2.
        return err, torch.allclose(out.float(), want.float(), atol=1e-5, rtol=1e-2)
    return err, torch.allclose(out, want, atol=2e-5, rtol=2e-5)


def attn_timing(shape, dtype, reps=200, **kw):
    """The decode_attn wrapper, its plain version and the masked
    `F.scaled_dot_product_attention` (the yardstick: the port never calls
    it) on one step's inputs: mean ms of each and the bound from the
    positions this step reads."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import ops

    q, k, v = _attn_inputs(**shape, dtype=dtype, seed=1)
    b, s, hkv, hd = k.shape
    valid = ops.valid_positions(s, device="cuda", **{k_: v_ for k_, v_ in kw.items()
                                                     if k_ != "cap"})
    ms = cuda_ms(lambda: ops.decode_attention(q, k, v, **kw), reps)
    # Split and merge when the plan has P > 1.
    launches_per_call = cuda_launches(lambda: ops.decode_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: ops.decode_attention_plain(q, k, v, **kw), 20)
    g = q.shape[1] // hkv
    # SDPA on (B, Hq, 1, hd) against (B, Hq, S, hd) with the slot mask; GQA by
    # repeating the kv heads (outside the timed call).
    qs = q[:, :, None]
    ks = k.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
    vs = v.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
    mask = valid[None, None, None, :]
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)[:, :, 0]
    lib_err = float((lib_out.float() - ops.decode_attention_plain(q, k, v, **kw).float())
                    .abs().max())
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                         reps)
    n_valid = int(valid.sum())
    item = q.element_size()
    moved = 2 * b * n_valid * hkv * hd * item + 2 * q.numel() * item
    ops_count = b * hkv * g * n_valid * (4 * hd + 6)
    bound_ms, bound_by = _bound(moved, ops_count)
    plan = ops.plan(b, s, hkv, hd, item)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "valid_positions": n_valid, "bytes": moved,
            "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan._asdict(),
            "cuda_launches_per_call": launches_per_call,
            "shape": (f"B={b} S={s} Hkv={hkv} G={g} hd={hd} {str(dtype)[6:]} "
                      + " ".join(f"{k_}={v_}" for k_, v_ in kw.items()))}


def compare_merge(b, s, hkv, g, hd, dtype, seed, **kw):
    """The merge kernel alone against `merge_partials`, on plain partials of
    the split that `plan` makes for this shape (with these positions, some
    partitions may hold no valid slot)."""
    import torch

    from repro_torch.kernels.decode_attn import kernel, ops

    q, k, v = _attn_inputs(b, s, hkv, g, hd, torch.float32, seed)
    plan = ops.plan(b, s, hkv, hd, torch.tensor([], dtype=dtype).element_size())
    m, l, acc = ops.partials_plain(q, k, v, parts=plan.parts,
                                   slots_per_part=plan.tiles_per_part * plan.tile, **kw)
    ws = torch.cat([acc, m[..., None], l[..., None]], -1).contiguous()
    out = torch.empty(b, hkv * g, hd, device="cuda", dtype=dtype)
    kernel.launch_merge(ws, out)
    torch.cuda.synchronize()
    want = ops.merge_partials(m, l, acc)
    err = float((out.float() - want).abs().max())
    if dtype == torch.bfloat16:
        ok = torch.allclose(out.float(), want.to(dtype).float(), atol=1e-5, rtol=1e-2)
    else:
        ok = torch.allclose(out, want, atol=2e-5, rtol=2e-5)
    return {"b": b, "s": s, "hkv": hkv, "g": g, "hd": hd, "dtype": str(dtype)[6:], **kw,
            "parts": plan.parts, "empty_parts": int((l == 0).any(0).any(0).sum()),
            "max_abs_err": err, "ok": bool(ok and torch.isfinite(out.float()).all())}


def phase_decode_attn_kernel():
    import torch

    from repro_torch.kernels.decode_attn import ops

    z = ZAMBA2_DECODE
    ring = dict(window=4096, ring=True)
    grid = [(z, torch.bfloat16, dict(pos=p, length=p + 1, **ring))
            for p in (1000, 4094, 4095, 4096, 5000)]  # before, at and past the wrap
    grid += [(dict(b=2, s=8192, hkv=4, g=7, hd=128), dt, dict(pos=8191, length=8192))
             for dt in (torch.bfloat16, torch.float32)]  # qwen2-like GQA, 8192 long
    grid += [(dict(b=2, s=2048, hkv=8, g=2, hd=128), torch.float32,
              dict(pos=2000, length=2001, window=1024, cap=50.0))]
    grid += [(dict(b=2, s=1024, hkv=2, g=g, hd=hd), torch.float32,
              dict(pos=900, length=901, cap=50.0 if g % 2 else 0.0))
             for hd in (32, 64, 80, 128, 256) for g in (1, 2, 4, 7, 8)]
    # The split (P > 1 at every shape below): a ring written into its first
    # partition only, so the later ones are all masked; S not divisible by
    # P * T, flat and ring; a float32 Zamba2 ring past its wrap.
    grid += [(z, dt, dict(pos=100, length=101, **ring)) for dt in (torch.bfloat16, torch.float32)]
    # B = 1, as the served 1 x 512 wave decodes (its own split: P = 10, the
    # last partition one tile): inside the ring and past its wrap.
    grid += [(dict(z, b=1), torch.bfloat16, dict(pos=p, length=p + 1, **ring))
             for p in (512, 5000)]
    grid += [(dict(b=2, s=1000, hkv=32, g=1, hd=80), torch.bfloat16, dict(pos=990, length=991)),
             (dict(b=1, s=3001, hkv=4, g=7, hd=128), torch.bfloat16,
              dict(pos=5000, length=5001, window=3001, ring=True)),
             (z, torch.float32, dict(pos=5000, length=5001, **ring))]
    cases = []
    for i, (shape, dtype, kw) in enumerate(grid):
        err, ok = compare_attn(_attn_inputs(**shape, dtype=dtype, seed=i), **kw)
        plan = ops.plan(shape["b"], shape["s"], shape["hkv"], shape["hd"],
                        torch.tensor([], dtype=dtype).element_size())
        cases.append({**shape, "dtype": str(dtype)[6:], **kw, "parts": plan.parts,
                      "max_abs_err": err, "ok": ok})
    merges = [compare_merge(**z, dtype=torch.bfloat16, seed=1, pos=100, length=101, **ring),
              compare_merge(**z, dtype=torch.bfloat16, seed=2, pos=5000, length=5001, **ring),
              compare_merge(b=2, s=8192, hkv=4, g=7, hd=128, dtype=torch.bfloat16, seed=3,
                            pos=3000, length=3001),
              compare_merge(b=2, s=8192, hkv=4, g=7, hd=128, dtype=torch.float32, seed=4,
                            pos=8191, length=8192)]
    # Every served shape: held against the plain version before, at and past
    # its ring's wrap or across its flat cache (a cross entry: at its one
    # call, every slot), in bf16 (as served), then timed at its heaviest
    # served step.
    served = {}
    for label, shape, kw, last in SERVED_DECODE:
        for p in sorted({100, 542, 4095, 4096, 4126, 5000, last}):
            if p != last if kw.get("cross") else p >= shape["s"] and not kw.get("ring"):
                continue
            call = served_call(shape, kw, p)
            err, ok = compare_attn(_attn_inputs(**shape, dtype=torch.bfloat16, seed=len(cases)),
                                   **call)
            plan = ops.plan(shape["b"], shape["s"], shape["hkv"], shape["hd"], 2)
            cases.append({**shape, "dtype": "bfloat16", **kw, **call, "parts": plan.parts,
                          "served": label, "max_abs_err": err, "ok": ok})
        if label.startswith("gemma2"):  # its consistency gate runs in float32 too
            call = served_call(shape, kw, last)
            err, ok = compare_attn(_attn_inputs(**shape, dtype=torch.float32, seed=len(cases)),
                                   **call)
            cases.append({**shape, "dtype": "float32", **kw, **call,
                          "served": label, "max_abs_err": err, "ok": ok})
        served[served_key(shape, kw)] = {
            "served": label, **attn_timing(shape, torch.bfloat16, **served_call(shape, kw, last))}
    timing = attn_timing(z, torch.bfloat16, pos=4096, length=4097, **ring)
    timing_gqa = attn_timing(dict(b=2, s=8192, hkv=4, g=7, hd=128), torch.bfloat16,
                             pos=8191, length=8192)
    out = {"phase": "kernels", "kernels": ["decode_attn"],
           "failed": sum(not c["ok"] for c in cases + merges),
           "max_abs_err": max(c["max_abs_err"] for c in cases + merges),
           "kernel": timing, "kernel_gqa": timing_gqa,
           "served": [{"key": list(k), **v} for k, v in served.items()],
           "merge_cases": merges, "cases": cases}
    emit(out)
    if out["failed"]:
        raise SystemExit(f"decode_attn kernel disagrees with its plain version in "
                         f"{out['failed']} cases")
    return {**out, "served_by_key": served}


# -- phase 10: the transformer serving path --------------------------------------

SERVE = dict(cache_len=8192, max_batch=2, max_new=32, seed=0)
RING_PROMPT = 4102  # past the 4096 window and not a multiple of it (s % w = 6)
# Teacher-forced decode steps after it. A tail left unrolled (slot i holding
# position s - w + i) keeps a position the window has dropped and loses one
# it holds, two keys a step more until 2 (s % w) are wrong; with random
# weights the attention is near uniform over 4096 keys, so the first step
# alone moves the logits little.
RING_STEPS = 12


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


SERVE_MIX = ((4096, 0.0), (4096, 0.0), (512, 0.0), (512, 0.0), (512, 0.8))


def _serve_requests(vocab, spec=SERVE_MIX, max_new=SERVE["max_new"]):
    """The zamba2 mix by default: two 4096-token prompts (the 4096-slot ring
    is full after prefill, so the first decode step wraps it), two of 512,
    greedy, and one of 512 at temperature 0.8: three waves."""
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(SERVE["seed"])
    return [Request(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=max_new, temperature=t)
            for i, (n, t) in enumerate(spec)]


@contextlib.contextmanager
def calls_by_shape(module, attr, key):
    """While open, every call of `module.<attr>` (a kernel wrapper the model
    calls through its module) is filed under `key(*args, **kw)`: {key:
    {"calls": n, "positions": [first, last] pos}}; the wrapper itself runs
    and counts its own launches on itself, as always."""
    real = getattr(module, attr)
    filed = {}

    def filing(*args, **kw):
        slot = filed.setdefault(key(*args, **kw), {"calls": 0, "positions": None})
        slot["calls"] += 1
        if "pos" in kw:
            pos = int(kw["pos"])
            slot["positions"] = [pos, pos] if slot["positions"] is None else [
                min(slot["positions"][0], pos), max(slot["positions"][1], pos)]
        return real(*args, **kw)

    setattr(module, attr, filing)
    try:
        yield filed
    finally:
        setattr(module, attr, real)


def attn_key(q, k_cache, *_, length, pos, window=0, ring=False, cap=0.0, **__):
    """A decode_attn call's shape: (B, S, Hkv, G, hd, window, ring, cap,
    cross). A cross-attention call reads its whole static cache (`length =
    pos`, where a self call has `length = pos + 1`)."""
    b, s, hkv, hd = k_cache.shape
    return (b, s, hkv, q.shape[1] // hkv, hd, int(window), bool(ring), float(cap),
            int(length) == int(pos))


def scan_key(_w, k, v, *_, include_current, chunk, **__):
    """A general chunk_scan call's shape: (B, S, H, dk, dv, chunk, mode)."""
    from repro_torch.kernels.chunk_scan import ops

    b, s, h, dk = k.shape
    return (b, s, h, dk, v.shape[-1], ops.chunk_len(s, chunk),
            "mamba2" if include_current else "rwkv6")


def engine_run(cfg, params, requests, cache_len=SERVE["cache_len"],
               max_batch=SERVE["max_batch"]):
    """The served main path: `Engine(cache_len=8192, max_batch=2)` (or
    `cache_len`, `max_batch`) over `requests`, every kernel count zeroed
    just before `run` and read just after, the general chunk_scan and
    decode_attn calls filed by shape.
    Returns (results, {"waves", "run_s", "peak_mem_bytes", "launches",
    "by_shape"})."""
    import torch

    from repro_torch.kernels.chunk_scan import ops as cs_ops
    from repro_torch.kernels.decode_attn import ops as da_ops
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, cache_len=cache_len, max_batch=max_batch,
                 seed=SERVE["seed"], device="cuda")
    for r in requests:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats()
    cs_ops.chunk_scan.launches = 0
    da_ops.decode_attention.launches = 0
    torch.cuda.synchronize()
    with calls_by_shape(da_ops, "decode_attention", attn_key) as attn_calls, \
            calls_by_shape(cs_ops, "chunk_scan", scan_key) as scan_calls:
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = {"chunk_scan": cs_ops.chunk_scan.launches,
                "decode_attn": da_ops.decode_attention.launches}
    if sum(slot["calls"] for slot in attn_calls.values()) != launches["decode_attn"]:
        raise SystemExit(f"{cfg.name}: decode_attn launched {launches['decode_attn']} times, "
                         f"its calls by shape {attn_calls}")
    peak = torch.cuda.max_memory_allocated()
    waves = {}
    for r in results:
        req = requests[r.uid]
        w = waves.setdefault(r.wave_id, {"batch": 0, "prompt": len(req.prompt),
                                         "temperature": req.temperature,
                                         "new_tokens": req.max_new_tokens,
                                         "prefill_ms": r.prefill_s * 1e3,
                                         "decode_s": r.decode_s})
        w["batch"] += 1
    for w in waves.values():
        steps = w["new_tokens"] - 1  # decode steps a wave (the first token comes from prefill)
        w["decode_ms_per_step"] = w["decode_s"] * 1e3 / steps
        w["decode_tokens_per_s"] = w["batch"] * w["new_tokens"] / w.pop("decode_s")
    if len(results) != len(requests) or any(len(r.tokens) != requests[r.uid].max_new_tokens
                                            for r in results):
        raise SystemExit(f"{cfg.name}: a request was not served in full")
    return results, {
        "waves": waves, "run_s": run_s, "peak_mem_bytes": peak, "launches": launches,
        "decode_steps": sum(w["new_tokens"] - 1 for w in waves.values()),
        "decode_tokens_per_s": sum(len(r.tokens) for r in results)
        / sum({r.wave_id: r.decode_s for r in results}.values()),
        "by_shape": {name: [{"key": list(k), **slot} for k, slot in filed.items()]
                     for name, filed in (("decode_attn", attn_calls), ("chunk_scan", scan_calls))}}


def phase_hybrid_serve():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import layers, params as plib
    from repro_torch.models import model as M

    cfg = configs.get("zamba2-2.7b")
    groups = cfg.num_layers // cfg.hybrid_attn_every
    t0 = time.perf_counter()
    params = M.init_model(cfg, seed=SERVE["seed"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = _serve_requests(cfg.vocab_size)
    # The main path: the counts are zeroed just before the run and read just after.
    results, run = engine_run(cfg, params, requests)
    launches, waves = run["launches"], run["waves"]

    # Gates on logits: prefill/decode consistency at full width (the
    # reference's rel < 0.02), and finite logits at the 4096-token wrap.
    tok = torch.tensor(np.append(requests[2].prompt, 7), dtype=torch.int32,
                       device="cuda")[None]
    with torch.inference_mode():
        cache, pre_logits = M.prefill(params, cfg, {"tokens": tok[:, :512]}, 1024)
        _, dec_logits = M.decode_step(params, cfg, cache, tok[:, 512], 512)
        h, _, _ = M.forward_hidden(params, cfg, {"tokens": tok})
        full = layers.logits_last(h[:, -1], M.unembed_table(params, cfg), cfg.final_softcap)
        consistency = _rel(dec_logits, full)
        # A prompt longer than the ring window and not a multiple of it: the
        # prefill's ring tail must put position p in slot p mod w. Each
        # decode step's logits against the prefill of the tokens up to it
        # (one causal forward over them all).
        rtok = torch.tensor(np.random.default_rng(SERVE["seed"] + 1).integers(
            0, cfg.vocab_size, RING_PROMPT + RING_STEPS), dtype=torch.int32,
            device="cuda")[None]
        cache, _ = M.prefill(params, cfg, {"tokens": rtok[:, :RING_PROMPT]},
                             SERVE["cache_len"])
        # The fault the gate is there to catch: the tail unrolled into slots
        # 0..w-1 (the reference's layout; decode_step writes the cache in
        # place, so this copy is made first). It must read past the limit.
        shift = -(RING_PROMPT % cache["ak"].shape[-3])
        unrolled = {key: torch.roll(t, shift, dims=-3) if key in ("ak", "av") else t.clone()
                    for key, t in cache.items()}
        h, _, _ = M.forward_hidden(params, cfg, {"tokens": rtok})
        table = M.unembed_table(params, cfg)
        ring_rels, ring_rels_unrolled = [], []
        for pos in range(RING_PROMPT, RING_PROMPT + RING_STEPS):
            full = layers.logits_last(h[:, pos], table, cfg.final_softcap)
            _, dec_logits = M.decode_step(params, cfg, cache, rtok[:, pos], pos)
            ring_rels.append(_rel(dec_logits, full))
            _, dec_logits = M.decode_step(params, cfg, unrolled, rtok[:, pos], pos)
            ring_rels_unrolled.append(_rel(dec_logits, full))
        ring_rel, ring_rel_unrolled = max(ring_rels), max(ring_rels_unrolled)
        del cache, unrolled, h
        long = torch.tensor(requests[0].prompt[None], device="cuda").repeat(2, 1)
        # Where a 2 x 4096 prefill's device time goes (torch.profiler).
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cache, logits = M.prefill(params, cfg, {"tokens": long}, SERVE["cache_len"])
            torch.cuda.synchronize()
            prefill_traced_ms = (time.perf_counter() - t0) * 1e3
        prefill_top, prefill_busy_ms = device_summary(prof, 1, unit="prefill")
        finite = bool(torch.isfinite(pre_logits).all()) and bool(torch.isfinite(logits).all())
        nxt = torch.argmax(logits, -1).to(torch.int32)

        # The device's share of a few decode steps past the wrap (torch.profiler).
        for i in range(2):
            cache, logits = M.decode_step(params, cfg, cache, nxt, 4096 + i)
        finite = finite and bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        prof_steps = 4
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(prof_steps):
                cache, logits = M.decode_step(params, cfg, cache, nxt, 4098 + i)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / prof_steps
        top, busy_ms = device_summary(prof, prof_steps, unit="step")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(prof_steps):
            cache, logits = M.decode_step(params, cfg, cache, nxt, 4102 + i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / prof_steps

    out = {
        "phase": "hybrid_serve", "arch": cfg.name, "params": plib.count_params(params),
        "param_bytes": plib.tree_bytes(params), "init_s": round(init_s, 3),
        "requests": len(requests), "waves": waves, "run_s": run["run_s"],
        "decode_tokens_per_s": run["decode_tokens_per_s"],
        "peak_mem_bytes": run["peak_mem_bytes"], "launches": launches,
        "by_shape": run["by_shape"],
        "launches_expected": {"chunk_scan": cfg.num_layers * len(waves),
                              "decode_attn": groups * run["decode_steps"]},
        "prefill_decode_rel": consistency, "ring_prompt": RING_PROMPT,
        "ring_steps": RING_STEPS, "ring_prefill_decode_rel": ring_rel,
        "ring_prefill_decode_rel_unrolled": ring_rel_unrolled,
        "ring_prefill_decode_rel_by_step": ring_rels,
        "ring_prefill_decode_rel_unrolled_by_step": ring_rels_unrolled,
        "finite_logits": finite,
        "decode_step_ms_untraced": step_ms, "decode_step_ms_traced": traced_ms,
        "device_busy_ms_per_step": busy_ms,
        # The tracer slows the host, not the device: the share of an
        # untraced step is the device's busy time over that step's time.
        "device_busy_share": busy_ms / step_ms, "device_busy_share_traced": busy_ms / traced_ms,
        "profile_top_device_ms": top,
        "prefill_4096x2_ms_traced": prefill_traced_ms, "prefill_device_busy_ms": prefill_busy_ms,
        "prefill_profile_top_device_ms": prefill_top,
    }
    emit(out)
    if launches != out["launches_expected"]:
        raise SystemExit(f"hybrid_serve launches {launches}, expected "
                         f"{out['launches_expected']}")
    if not finite or consistency >= 0.02 or ring_rel >= 0.02 or ring_rel_unrolled < 0.02:
        raise SystemExit(f"hybrid_serve logits: finite={finite}, prefill/decode rel "
                         f"{consistency}, {RING_STEPS} steps after {RING_PROMPT} tokens "
                         f"{ring_rel} (limit 0.02; the unrolled tail read "
                         f"{ring_rel_unrolled}, must read past it)")
    return out


def phase_hybrid_parity():
    """The card (both kernels) against the port on the CPU (their plain
    versions) at full width and one group's depth (6 Mamba2 layers and the
    shared block): prefill logits, two teacher-forced decode steps and the
    caches within 4%."""
    return _parity_phase("hybrid_parity", ("zamba2-2.7b",), layers=6)


# -- phases 14-17: the dense and ssm serving paths ------------------------------

DENSE_MIX = ("qwen2-7b", "gemma2-9b")  # served on the zamba2 mix
DENSE_ONE = ("gemma-7b", "gemma2-9b-sw", "phi3-medium-14b")  # one 512-token request each
# Prefill/decode consistency limits (rel, every step). The served bf16 path is
# gated at 0.02, but the gemma2 family at 0.03: with random weights its 42
# post-normed bf16 layers put its bf16 prefill and its bf16 decode each about
# 2% from the float32 forward, growing with depth (0.004, 0.008, 0.013, 0.020
# at 2, 6, 14, 42 layers; the plain attention the same), and it reads
# 0.016-0.021. So the family is also gated on a float32 copy of its weights,
# where sound steps read about 4e-6 and every step of the unrolled tail
# 0.0195 or more: limit 1e-4, which the fault must read past at every step.
BF16_LIMIT = {"gemma2-9b": 0.03, "gemma2-9b-sw": 0.03}
FLOAT32_CONSISTENCY, FLOAT32_LIMIT = ("gemma2-9b", "gemma2-9b-sw"), 1e-4
PRECISION_DEPTHS = (2, 6, 14)  # the gemma2 family's bf16 gap at these depths too
ONE_REQUEST, ONE_NEW = ((512, 0.0),), 16
CONSISTENCY_PROMPT, CONSISTENCY_STEPS = 512, 2
PROFILE_STEPS = 4


def free_cuda():
    """Drop what the card caches of freed tensors, so the next model's
    weights find the memory (each full model is loaded after the last is
    freed)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def prefill_decode_rels(params, cfg, toks, prompt, *, unroll=(), extra=None,
                        cache_len=SERVE["cache_len"], capacity_factor=None):
    """Prefill toks[:, :prompt] (cache 8192, or `cache_len`; `extra`: the
    frames or patches beside the tokens), then teacher-force the rest one
    decode step each: every step's logits against one causal forward over
    all of `toks` at that position (rel a step). With `unroll` (the cache's
    ring keys), the same steps from a copy whose ring tails are unrolled into
    slots 0..w-1 (the reference's layout past the window: the fault the gate
    is there to catch) give a second list. `capacity_factor`: a MoE model's
    prefill and full forward at that factor (the served 2.0 if None)."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import model as M

    extra = extra or {}
    cf = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    cache, _ = M.prefill(params, cfg, {"tokens": toks[:, :prompt], **extra}, cache_len, **cf)
    faulty = None
    if unroll:  # decode_step writes the cache in place, so the copy is made first
        faulty = {key: torch.roll(t, -(prompt % t.shape[-3]), dims=-3) if key in unroll
                  else t.clone() for key, t in cache.items()}
    h, _, _ = M.forward_hidden(params, cfg, {"tokens": toks, **extra}, **cf)
    table = M.unembed_table(params, cfg)
    rels, rels_faulty = [], []
    for pos in range(prompt, toks.shape[1]):
        full = layers.logits_last(h[:, pos], table, cfg.final_softcap)
        _, dec = M.decode_step(params, cfg, cache, toks[:, pos], pos)
        rels.append(_rel(dec, full))
        if faulty is not None:
            _, dec = M.decode_step(params, cfg, faulty, toks[:, pos], pos)
            rels_faulty.append(_rel(dec, full))
    return rels, rels_faulty


def _rand_tokens(cfg, n, seed):
    import numpy as np
    import torch

    return torch.tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, n),
                        dtype=torch.int32, device="cuda")[None]


def profile_serving(params, cfg, prompt, *, extra=None, cache_len=SERVE["cache_len"]):
    """Where the time goes (`torch.profiler`): one traced 2 x len(prompt)
    prefill (`extra`: its frames or patches), then `PROFILE_STEPS` traced
    decode steps and as many untraced (host clock around a synchronize): the
    top device ops and the device's busy ms of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    long = torch.tensor(prompt[None], device="cuda").repeat(2, 1)
    s = long.shape[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cache, logits = M.prefill(params, cfg, {"tokens": long, **(extra or {})}, cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_top, prefill_busy = device_summary(prof, 1, unit="prefill")
    nxt = torch.argmax(logits, -1).to(torch.int32)
    for i in range(2):
        cache, logits = M.decode_step(params, cfg, cache, nxt, s + i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            cache, logits = M.decode_step(params, cfg, cache, nxt, s + 2 + i)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    top, busy = device_summary(prof, PROFILE_STEPS, unit="step")
    t0 = time.perf_counter()
    for i in range(PROFILE_STEPS):
        cache, logits = M.decode_step(params, cfg, cache, nxt, s + 2 + PROFILE_STEPS + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    return {f"prefill_2x{s}_ms_traced": prefill_ms, "prefill_device_busy_ms": prefill_busy,
            "prefill_profile_top_device_ms": prefill_top,
            "decode_step_ms_untraced": step_ms, "decode_step_ms_traced": traced_ms,
            "device_busy_ms_per_step": busy, "device_busy_share": busy / step_ms,
            "profile_top_device_ms": top,
            "finite_logits": bool(torch.isfinite(logits).all())}


def logits_last_timing(params, cfg, reps=20):
    """`layers.logits_last` at the model's vocabulary (B = 2) against the
    parent's form, the whole table widened to float32 (`h.float() @
    table.float().T`), on one input: ms of each (CUDA events) and their
    largest gap over the logits' scale."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import model as M

    table = M.unembed_table(params, cfg)
    h = torch.randn(2, cfg.d_model, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda").to(table.dtype)
    new = layers.logits_last(h, table)
    widened = h.float() @ table.float().T
    out = {"vocab": table.shape[0], "ms": cuda_ms(lambda: layers.logits_last(h, table), reps),
           "widened_table_ms": cuda_ms(lambda: h.float() @ table.float().T, reps),
           "rel": _rel(new, widened)}
    del widened
    return out


def consistency(params, cfg, prompts, ring):
    """Prefill/decode consistency of one model in its weights' type: two
    steps after each of `prompts` tokens ({str(n): rels}), and with `ring` 12
    after the 4102-token prompt (the local rings past the window) beside
    their faulty unrolled twin."""
    from repro_torch.models import model as M

    out = {"prefill_decode_rel": {
        str(n): prefill_decode_rels(params, cfg, _rand_tokens(
            cfg, n + CONSISTENCY_STEPS, SERVE["seed"] + 2), n)[0] for n in prompts}}
    if ring:
        rings = [k for k in M._cache_desc(cfg, 1, 8)
                 if "local" in k or cfg.attn_pattern == "local"]
        ring_rels, faulty = prefill_decode_rels(
            params, cfg, _rand_tokens(cfg, RING_PROMPT + RING_STEPS, SERVE["seed"] + 1),
            RING_PROMPT, unroll=rings)
        out.update(ring_prefill_decode_rel_by_step=ring_rels,
                   ring_prefill_decode_rel_unrolled_by_step=faulty)
    return out


def last_logits(params, cfg, toks, positions):
    """One causal forward over `toks`: the logits at each of `positions`."""
    from repro_torch.models import layers
    from repro_torch.models import model as M

    h, _, _ = M.forward_hidden(params, cfg, {"tokens": toks})
    table = M.unembed_table(params, cfg)
    return [layers.logits_last(h[:, p], table, cfg.final_softcap) for p in positions]


def bf16_precision(params, cfg):
    """Where the bf16 prefill/decode gap comes from, for a model gated in
    float32: the same 512-token steps with decode_attn's plain version in
    the kernel's place (`bf16_plain`), and the gap of the same config cut
    to `PRECISION_DEPTHS` layers (its own seed-0 weights; `by_depth`)."""
    import torch

    from repro_torch.kernels.decode_attn import ops as da_ops
    from repro_torch.models import model as M

    toks = _rand_tokens(cfg, CONSISTENCY_PROMPT + CONSISTENCY_STEPS, SERVE["seed"] + 2)
    real = da_ops.decode_attention
    da_ops.decode_attention = da_ops.decode_attention_plain
    try:
        out = {"bf16_plain": prefill_decode_rels(params, cfg, toks, CONSISTENCY_PROMPT)[0]}
    finally:
        da_ops.decode_attention = real
    out["by_depth"] = {}
    for n in PRECISION_DEPTHS:
        cut = dataclasses.replace(cfg, num_layers=n)
        p = M.init_model(cut, seed=SERVE["seed"], device="cuda")
        out["by_depth"][str(n)] = prefill_decode_rels(p, cut, toks, CONSISTENCY_PROMPT)[0]
        del p
        free_cuda()
    torch.cuda.synchronize()
    return out


def widen_(tree):
    """Every weight of a parameter tree widened to float32, leaf by leaf in
    place (the bf16 leaf is freed as its float32 copy lands)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            widen_(v)
        else:
            tree[k] = v.float()


def serve_arch(name, spec, max_new, *, prompts=(CONSISTENCY_PROMPT,), ring=False,
               profile_it=False):
    """One dense or ssm arch at its published widths (weights from seed 0)
    through `engine_run`, then prefill/decode consistency in bf16
    (`consistency`), with `profile_it` where the time goes. The gemma2
    family's consistency is gated in float32 too (`FLOAT32_CONSISTENCY`):
    after the bf16 work (and `bf16_precision`) the weights are widened and
    it runs again, and the bf16 forward's logits are held against the
    float32 forward's (`bf16_vs_float32`). Returns the run with its gates'
    failures (`failed`); frees the model first."""
    import torch

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import params as plib

    cfg = configs.get(name)
    t0 = time.perf_counter()
    params = M.init_model(cfg, seed=SERVE["seed"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = _serve_requests(cfg.vocab_size, spec, max_new)
    results, run = engine_run(cfg, params, requests)
    if cfg.arch_type == "ssm":  # one general chunk_scan a layer a prefill wave
        expected = {"chunk_scan": cfg.num_layers * len(run["waves"]), "decode_attn": 0}
    else:  # one decode_attn a layer a decode step
        expected = {"chunk_scan": 0, "decode_attn": cfg.num_layers * run["decode_steps"]}
    out = {"arch": name, "params": plib.count_params(params),
           "param_bytes": plib.tree_bytes(params), "init_s": round(init_s, 3),
           "requests": len(requests), **run, "launches_expected": expected,
           "decode_attn_calls_per_step": run["launches"]["decode_attn"] / run["decode_steps"]}
    with torch.inference_mode():
        out["bfloat16"] = consistency(params, cfg, prompts, ring)
        if profile_it:
            out["profile"] = profile_serving(params, cfg, requests[0].prompt)
            out["logits_last"] = logits_last_timing(params, cfg)
        out["limits"] = {"bfloat16": BF16_LIMIT.get(name, 0.02)}
        if name in FLOAT32_CONSISTENCY:
            out.update(bf16_precision(params, cfg))
            toks = _rand_tokens(cfg, CONSISTENCY_PROMPT + CONSISTENCY_STEPS, SERVE["seed"] + 2)
            positions = range(CONSISTENCY_PROMPT, CONSISTENCY_PROMPT + CONSISTENCY_STEPS)
            narrow = last_logits(params, cfg, toks, positions)
            widen_(params)
            free_cuda()
            out["float32"] = consistency(params, cfg, prompts, ring)
            out["bf16_vs_float32"] = [_rel(a, b) for a, b in
                                      zip(narrow, last_logits(params, cfg, toks, positions))]
            out["limits"]["float32"] = FLOAT32_LIMIT
            del narrow
    del params, results
    free_cuda()
    gates = []
    for dtype, limit in out["limits"].items():
        rels = [x for v in out[dtype]["prefill_decode_rel"].values() for x in v]
        rels += out[dtype].get("ring_prefill_decode_rel_by_step", [])
        gates.append((max(rels) >= limit,
                      f"prefill/decode rel in {dtype} {rels} (limit {limit})"))
    if ring:  # the unrolled tail must fail the strictest gate at every step
        dtype, limit = min(out["limits"].items(), key=lambda kv: kv[1])
        faulty = out[dtype]["ring_prefill_decode_rel_unrolled_by_step"]
        gates.append((min(faulty) < limit, f"the unrolled tail read {faulty} in {dtype}, "
                      f"must read past {limit} at every step"))
    filed = sum(row["calls"] for row in run["by_shape"]["chunk_scan"])
    out["failed"] = [msg for bad, msg in (
        (run["launches"] != expected, f"launches {run['launches']}, expected {expected}"),
        (filed != run["launches"]["chunk_scan"],
         f"chunk_scan launched {run['launches']['chunk_scan']}, filed {filed}"),
        *gates,
        (not out.get("profile", {}).get("finite_logits", True), "logits not finite"),
    ) if bad]
    return out


def phase_dense_serve():
    """The dense family at published widths: `qwen2-7b` and `gemma2-9b` on the
    zamba2 mix (gemma2 also past its window), `gemma-7b`, `gemma2-9b-sw` and
    `phi3-medium-14b` one 512-token request each. Gates (`serve_arch`):
    decode_attn called num_layers times a decode step, no chunk_scan
    launch, finite logits, prefill/decode within 2% (past gemma2's window
    too, where the unrolled tail must read past it)."""
    t0 = time.perf_counter()
    runs = [serve_arch(name, SERVE_MIX, SERVE["max_new"], ring=name == "gemma2-9b",
                       profile_it=True) for name in DENSE_MIX]
    runs += [serve_arch(name, ONE_REQUEST, ONE_NEW) for name in DENSE_ONE]
    out = {"phase": "dense_serve", "runs": runs, "phase_s": time.perf_counter() - t0}
    emit(out)
    failed = [f"{r['arch']}: {msg}" for r in runs for msg in r["failed"]]
    if failed:
        raise SystemExit("dense_serve: " + "; ".join(failed))
    return out


def phase_rwkv_serve():
    """`rwkv6-1.6b` at published widths on the zamba2 mix: 24 general-entry
    chunk_scan launches (rwkv6 mode, chunk 32) a prefill wave, no
    decode_attn, prefill/decode within 2% after 512 and 4096 tokens, and
    where the time goes."""
    t0 = time.perf_counter()
    run = serve_arch("rwkv6-1.6b", SERVE_MIX, SERVE["max_new"],
                     prompts=(CONSISTENCY_PROMPT, 4096), profile_it=True)
    out = {"phase": "rwkv_serve", **run, "phase_s": time.perf_counter() - t0}
    emit(out)
    if run["failed"]:
        raise SystemExit("rwkv_serve: " + "; ".join(run["failed"]))
    return out


def card_vs_cpu(cfg, seed, prompt=16, steps=2, check=None):
    """The card (the kernels) against the port on the CPU (their plain
    versions) on one model drawn on the card from `seed` and copied: prefill
    logits and `steps` teacher-forced decode steps (rel each), and the
    largest cache gap after them. An audio or VLM model gets random frames
    or patches (`frontend`), a VLM's cross blocks nonzero gates
    (`open_gates`). `check(params, cpu_params, cfg)`, if given, runs on both
    copies before they are freed; its dict joins the result."""
    import numpy as np
    import torch

    from repro_torch.models import model as M

    params = M.init_model(cfg, seed=seed, device="cuda")
    open_gates(params)
    extra = frontend(cfg, 1, seed)
    cpu = {}

    def to_cpu(tree, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                to_cpu(v, out.setdefault(k, {}))
            else:
                out[k] = v.cpu()

    to_cpu(params, cpu)
    toks = torch.tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                             (1, prompt + steps)),
                        dtype=torch.int32)
    prev = torch.get_num_threads()
    torch.set_num_threads(8)
    cache_len = max(64, prompt + steps)
    try:
        with torch.inference_mode():
            cache, lg = M.prefill(params, cfg, {"tokens": toks[:, :prompt].cuda(), **extra},
                                  cache_len)
            t0 = time.perf_counter()
            cache_c, lg_c = M.prefill(cpu, cfg, {"tokens": toks[:, :prompt],
                                                 **{k: t.cpu() for k, t in extra.items()}},
                                      cache_len)
            rels = [_rel(lg.cpu(), lg_c)]
            for i in range(steps):
                pos = prompt + i
                cache, lg = M.decode_step(params, cfg, cache, toks[:, pos].cuda(), pos)
                cache_c, lg_c = M.decode_step(cpu, cfg, cache_c, toks[:, pos], pos)
                rels.append(_rel(lg.cpu(), lg_c))
            cpu_s = time.perf_counter() - t0
            cache_rel = {k: _rel(cache[k].cpu(), cache_c[k]) for k in cache}
            checked = check(params, cpu, cfg) if check else {}
    finally:
        torch.set_num_threads(prev)
    del params, cpu, cache
    free_cuda()
    return {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "prompt": prompt, "logits_rel": rels, "cache_rel": cache_rel,
            "cpu_side_s": round(cpu_s, 3), **checked}


def _parity_phase(phase, names, layers=2, seed=1, cuts=None, share=None, prompt=16,
                  check=None):
    """`card_vs_cpu` for each arch at its published widths cut to `layers`
    layers (two: one local/global pair for gemma2; `cuts`: other fields cut
    by arch; `share`: (shard, shards) of a MoE arch's experts), limit 0.04 on
    logits and caches; `check` as `card_vs_cpu`'s, its `failed` gating too."""
    from repro_torch import configs

    t0 = time.perf_counter()
    cuts = cuts or {}
    runs = []
    for n in names:
        cfg = configs.get(n)
        if share:
            cfg = configs.expert_share(cfg, *share)
        runs.append(card_vs_cpu(dataclasses.replace(cfg, num_layers=layers, **cuts.get(n, {})),
                                seed, prompt=prompt, check=check))
    out = {"phase": phase, "runs": runs, "limit": 0.04, "phase_s": time.perf_counter() - t0}
    emit(out)
    bad = [(r["arch"], r["logits_rel"], r["cache_rel"], r.get("failed")) for r in runs
           if max(r["logits_rel"]) >= 0.04 or max(r["cache_rel"].values()) >= 0.04
           or r.get("failed")]
    if bad:
        raise SystemExit(f"{phase}: card vs CPU past 0.04 or a check failed: {bad}")
    return out


def phase_dense_parity():
    return _parity_phase("dense_parity", DENSE_MIX + DENSE_ONE)


def phase_rwkv_parity():
    return _parity_phase("rwkv_parity", ("rwkv6-1.6b",))


# -- phases 18-19: the cross-attention serving families --------------------------

CROSS_GATE = 0.5  # every VLM cross block's gate_attn and gate_mlp on the card
VISION_LAYERS = 20  # 4 groups of 4 self + 1 gated cross layer: 19.2 B parameters
# Each arch's cache, depth and mix: (prompt tokens, temperature, new tokens) a
# request. whisper-base: speech to text of a 30 s clip (1,500 encoder
# frames), 2 x the 4-token start-of-transcript prefix greedy for 128 tokens
# and 1 x a 64-token previous-text prompt sampled for 64, in Whisper's
# 448-token decoder context. llama-3.2-vision-90b: image + question chat over
# 1,024 patches, 2 x 512 greedy and 1 x 512 sampled, 32 new tokens each.
CROSS_SERVE = {
    "whisper-base": dict(cache_len=448, layers=None, consistency_prompt=64,
                         mix=((4, 0.0, 128), (4, 0.0, 128), (64, 0.8, 64))),
    "llama-3.2-vision-90b": dict(cache_len=2048, layers=VISION_LAYERS, consistency_prompt=512,
                                 mix=((512, 0.0, 32), (512, 0.0, 32), (512, 0.8, 32))),
}
CROSS_STEPS, CROSS_LIMIT = 12, 0.02  # teacher-forced steps of the consistency gate, bf16


def open_gates(params):
    """A VLM's cross-block gates set to `CROSS_GATE` in place (zero at init,
    they would make every cross block add nothing): the weights change, not
    the model. No-op for other families."""
    if "xblk" in params:
        for gate in ("gate_attn", "gate_mlp"):
            params["xblk"][gate].fill_(CROSS_GATE)


def frontend(cfg, b, seed):
    """The frontend stub's output on the card, bf16: random frames (audio)
    or patches (VLM) x 0.02 from a numpy seed, as the reference's
    `real_batch` draws them; {} for the other families."""
    import numpy as np
    import torch

    name, n = {"audio": ("frames", cfg.encoder_tokens),
               "vlm": ("patches", cfg.num_frontend_tokens)}.get(cfg.arch_type, (None, 0))
    if name is None:
        return {}
    a = np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)) * 0.02
    return {name: torch.tensor(a, dtype=torch.float32, device="cuda").to(torch.bfloat16)}


def cross_serve_arch(name):
    """One cross-attention arch at its published widths (the VLM cut in
    depth to `VISION_LAYERS`), weights from seed 0 with open gates, through
    `engine_run` on its mix (zero frames or patches, as the engine feeds
    them): decode_attn calls a step, self and cross, by shape; then
    prefill/decode consistency over `CROSS_STEPS` teacher-forced steps on
    random frames or patches, and where the time goes. Frees the model."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import params as plib
    from repro_torch.serving.engine import Request

    spec = CROSS_SERVE[name]
    cfg = configs.get(name)
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    free_cuda()
    t0 = time.perf_counter()
    params = M.init_model(cfg, seed=SERVE["seed"], device="cuda")
    open_gates(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SERVE["seed"])
    requests = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=new, temperature=t)
                for i, (n, t, new) in enumerate(spec["mix"])]
    results, run = engine_run(cfg, params, requests, cache_len=spec["cache_len"])
    if cfg.arch_type == "audio":  # each decoder layer: its self cache, then the encoder's
        per_step = {"self": cfg.num_layers, "cross": cfg.num_layers}
    else:  # each group: its self layers, then its cross layer over the patches
        groups = M.n_cross(cfg)
        per_step = {"self": groups * (cfg.cross_attn_every - 1), "cross": groups}
    calls = {kind: sum(row["calls"] for row in run["by_shape"]["decode_attn"]
                       if row["key"][-1] == (kind == "cross")) for kind in per_step}
    steps = run["decode_steps"]
    expected = {"chunk_scan": 0, "decode_attn": sum(per_step.values()) * steps}
    out = {"arch": name, "layers": cfg.num_layers, "params": plib.count_params(params),
           "param_bytes": plib.tree_bytes(params), "init_s": round(init_s, 3),
           "cache_len": spec["cache_len"], "requests": len(requests), **run,
           "launches_expected": expected, "decode_attn_calls_per_step": per_step,
           "decode_attn_calls": calls}
    with torch.inference_mode():
        n = spec["consistency_prompt"]
        toks = _rand_tokens(cfg, n + CROSS_STEPS, SERVE["seed"] + 2)
        out["prefill_decode_rel"] = prefill_decode_rels(
            params, cfg, toks, n, extra=frontend(cfg, 1, SERVE["seed"] + 3),
            cache_len=spec["cache_len"])[0]
        out["limit"] = CROSS_LIMIT
        out["profile"] = profile_serving(params, cfg, requests[0].prompt,
                                         extra=frontend(cfg, 2, SERVE["seed"] + 4),
                                         cache_len=spec["cache_len"])
    del params, results
    free_cuda()
    out["failed"] = [msg for bad, msg in (
        (run["launches"] != expected, f"launches {run['launches']}, expected {expected}"),
        (calls != {kind: k * steps for kind, k in per_step.items()},
         f"decode_attn calls {calls}, expected {per_step} a step over {steps} steps"),
        (max(out["prefill_decode_rel"]) >= CROSS_LIMIT,
         f"prefill/decode rel {out['prefill_decode_rel']} (limit {CROSS_LIMIT})"),
        (not out["profile"]["finite_logits"], "logits not finite"),
    ) if bad]
    return out


def phase_cross_serve():
    """The audio and VLM families: `whisper-base` whole and
    `llama-3.2-vision-90b` at full width and 20 layers, each through
    `Engine` on its mix (`CROSS_SERVE`); every decode step calls decode_attn
    once a self layer and once a cross layer (12 and 20 a step); prefill and
    decode ms, the profile, and prefill/decode within 2% over 12 steps."""
    t0 = time.perf_counter()
    runs = [cross_serve_arch(name) for name in CROSS_SERVE]
    out = {"phase": "cross_serve", "runs": runs, "phase_s": time.perf_counter() - t0}
    emit(out)
    failed = [f"{r['arch']}: {msg}" for r in runs for msg in r["failed"]]
    if failed:
        raise SystemExit("cross_serve: " + "; ".join(failed))
    return out


def phase_cross_parity():
    """The card against the port on the CPU at published widths and two
    layers: whisper 2 encoder + 2 decoder layers, llama-3.2-vision 1 self +
    1 gated cross layer (gates open), on random frames or patches."""
    return _parity_phase("cross_parity", tuple(CROSS_SERVE), cuts={
        "whisper-base": dict(encoder_layers=2), "llama-3.2-vision-90b": dict(cross_attn_every=2)})


# -- phases 20-21: the MoE serving family ---------------------------------------

# Each MoE arch at its published widths, cut in depth, holding expert shard 0
# of 8 (16 of 128 experts a MoE layer: one card of an 8-card node serving the
# model expert parallel 8 ways; the cut layers would lie on further nodes, as
# pipeline stages). The router keeps its 128 outputs and its top-k. Arctic: 10
# of 35 layers (each MoE + dense residual), 19.4 B parameters, 38.9 GB;
# Maverick: 12 of 48 layers (6 dense / MoE pairs), 17.2 B, 34.4 GB, the
# 202,048-row vocabulary whole.
MOE_SERVE = {"arctic-480b": dict(layers=10, share=(0, 8)),
             "llama4-maverick-400b-a17b": dict(layers=12, share=(0, 8))}
# 2 x 4096 greedy, one wave of 8 x 512 greedy (8 tokens a decode step on the
# experts: 16 pairs for Arctic's top-2) and 1 x 512 at 0.8, 32 new tokens each.
MOE_MIX = ((4096, 0.0),) * 2 + ((512, 0.0),) * 8 + ((512, 0.8),)
MOE_MAX_BATCH = 8
MOE_PROMPT, MOE_STEPS, MOE_LIMIT = 512, 12, 0.02  # the consistency gate, bf16
MOE_PARITY_PROMPT = 128
# Decode-shaped (8, 1, D) inputs `moe_layer_check` holds: 128 tokens, so the
# 16 held experts of 128 get pairs (4 draws gave Maverick's top-1 none).
MOE_DECODE_DRAWS = 16


def routing_spread(p, x, cfg):
    """Why a prefill's pairs crowd onto few experts: over the tokens of x (B,
    S, D), the router logits' standard deviation across positions (the mean
    over experts), the standard deviation across experts of their mean
    logit, the share of the hidden state's energy common to all positions
    (|mean x|^2 / mean |x|^2), and the busiest expert's share of the pairs
    and the experts that get any. 0-d device tensors (no sync)."""
    import torch

    from repro_torch.models import moe

    xt = x.reshape(-1, x.shape[-1]).float()
    probs, logits = moe.router_probs(xt, p["router"])
    _, idx = moe.route(probs, cfg.experts_per_token)
    load = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    return {"logit_sd_positions": logits.std(dim=0).mean(),
            "logit_sd_experts": logits.mean(dim=0).std(),
            "common_share": xt.mean(dim=0).pow(2).sum() / xt.pow(2).sum(dim=1).mean(),
            "top_expert_share": load.max() / idx.numel(),
            "experts_hit": (load > 0).sum()}


@contextlib.contextmanager
def moe_drops():
    """While open, every `moe.moe_layer` call files (tokens a sequence, the
    capacity factor, its dropped pairs as a device tensor, its
    `routing_spread` over 2+ tokens a sequence); read with `.item()` after the work (no sync inside
    it)."""
    from repro_torch.models import moe

    real = moe.moe_layer
    filed = []

    def filing(p, x, cfg, **kw):
        out, aux = real(p, x, cfg, **kw)
        spread = routing_spread(p, x, cfg) if x.shape[1] > 1 else None
        filed.append((x.shape[1], kw.get("capacity_factor"), aux["dropped"], spread))
        return out, aux

    moe.moe_layer = filing
    try:
        yield filed
    finally:
        moe.moe_layer = real


def _drops_by_length(filed):
    """{tokens a sequence: [dropped pairs a MoE layer call]} of `moe_drops`."""
    out = {}
    for n, _, dropped, _ in filed:
        out.setdefault(str(n), []).append(int(dropped.item()))
    return out


def _spread_of_prompt(filed, n):
    """`routing_spread` of each MoE layer call over `n` tokens a sequence."""
    return [{key: float(v) for key, v in spread.items()}
            for length, _, _, spread in filed if length == n]


def moe_consistency(params, cfg):
    """Prefill `MOE_PROMPT` tokens and teacher-force `MOE_STEPS` decode steps
    (no drop: cf = E) against the full forward at each position, twice: at
    the served capacity (prefill and full forward at cf 2.0) and at no-drop
    capacity (both at cf = E). The dropped pairs a MoE layer of each forward
    are filed, and each MoE layer's `routing_spread` in the served prefill.
    Where the served prefill and full forward drop nothing, the served
    comparison gates; else the no-drop one (the drops are the reference's
    semantics, not a fault)."""
    toks = _rand_tokens(cfg, MOE_PROMPT + MOE_STEPS, SERVE["seed"] + 2)
    out = {}
    for label, cf in (("served", None), ("no_drop", float(cfg.num_experts))):
        with moe_drops() as filed:
            rels = prefill_decode_rels(params, cfg, toks, MOE_PROMPT, capacity_factor=cf)[0]
        out[label] = {"prefill_decode_rel_by_step": rels,
                      "dropped_by_tokens": _drops_by_length(filed)}
        if label == "served":
            out["routing_by_layer"] = _spread_of_prompt(filed, MOE_PROMPT)
    drops = out["served"]["dropped_by_tokens"]
    served_dropped = sum(sum(drops[str(n)]) for n in (MOE_PROMPT, MOE_PROMPT + MOE_STEPS))
    out["gating"] = "served" if served_dropped == 0 else "no_drop"
    out["limit"] = MOE_LIMIT
    out["failed"] = [msg for bad, msg in (
        (max(out[out["gating"]]["prefill_decode_rel_by_step"]) >= MOE_LIMIT,
         f"prefill/decode rel ({out['gating']}) "
         f"{out[out['gating']]['prefill_decode_rel_by_step']} (limit {MOE_LIMIT})"),
        (any(sum(v) for v in out["no_drop"]["dropped_by_tokens"].values()),
         f"no-drop capacity dropped {out['no_drop']['dropped_by_tokens']}"),
        (any(d for label in ("served", "no_drop")
             for d in out[label]["dropped_by_tokens"].get("1", [])),
         "a decode step dropped a pair"),
    ) if bad]
    return out


def moe_serve_arch(name):
    """One MoE arch at its published widths, cut and shared as `MOE_SERVE`
    says, weights from seed 0, through `engine_run` (`Engine(cache_len=8192,
    max_batch=8)`) on `MOE_MIX`: decode_attn num_layers calls a decode step,
    no chunk_scan; the prefill/decode consistency gate (`moe_consistency`)
    and where the time goes. Frees the model."""
    import torch

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import params as plib

    spec = MOE_SERVE[name]
    cfg = dataclasses.replace(configs.expert_share(configs.get(name), *spec["share"]),
                              num_layers=spec["layers"])
    free_cuda()
    t0 = time.perf_counter()
    params = M.init_model(cfg, seed=SERVE["seed"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = _serve_requests(cfg.vocab_size, MOE_MIX)
    results, run = engine_run(cfg, params, requests, max_batch=MOE_MAX_BATCH)
    expected = {"chunk_scan": 0, "decode_attn": cfg.num_layers * run["decode_steps"]}
    lo, hi = cfg.expert_slice
    out = {"arch": name, "layers": cfg.num_layers, "experts_held": [lo, hi],
           "experts": cfg.num_experts, "experts_per_token": cfg.experts_per_token,
           "params": plib.count_params(params), "param_bytes": plib.tree_bytes(params),
           "init_s": round(init_s, 3), "requests": len(requests), **run,
           "launches_expected": expected,
           "decode_attn_calls_per_step": run["launches"]["decode_attn"] / run["decode_steps"]}
    with torch.inference_mode():
        out["consistency"] = moe_consistency(params, cfg)
        out["profile"] = profile_serving(params, cfg, requests[0].prompt)
    del params, results
    free_cuda()
    out["failed"] = [msg for bad, msg in (
        (run["launches"] != expected, f"launches {run['launches']}, expected {expected}"),
        *((True, msg) for msg in out["consistency"]["failed"]),
        (not out["profile"]["finite_logits"], "logits not finite"),
    ) if bad]
    return out


def phase_moe_serve():
    """The MoE family: `arctic-480b` and `llama4-maverick-400b-a17b` at
    published widths, cut in depth, expert shard 0 of 8, each through
    `Engine` on `MOE_MIX` and freed before the next (`moe_serve_arch`)."""
    t0 = time.perf_counter()
    runs = [moe_serve_arch(name) for name in MOE_SERVE]
    out = {"phase": "moe_serve", "runs": runs, "phase_s": time.perf_counter() - t0}
    emit(out)
    failed = [f"{r['arch']}: {msg}" for r in runs for msg in r["failed"]]
    if failed:
        raise SystemExit("moe_serve: " + "; ".join(failed))
    return out


def _first_moe_layer(tree):
    stack = tree["moe_blk"] if "moe_blk" in tree else tree["blk"]
    return {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
            for k, v in stack["moe"].items()}


def _moe_layer_case(lp, lp_c, cfg, xs_c, cf, limit):
    """`moe_layer` card against CPU on the bf16 inputs `xs_c` (each (B, S,
    D), one call a side each) at capacity factor `cf`; see
    `moe_layer_check`."""
    import torch

    from repro_torch.models import moe

    k, e = cfg.experts_per_token, cfg.num_experts
    lo, hi = cfg.expert_slice
    routed = dataclasses.replace(cfg, moe_dense_ff=0)
    tally = dict(picks_differ=0, near_ties=0, picks_differ_not_near_tie=0,
                 tokens_compared=0, held_pairs=0, dropped=0, dropped_cpu=0)
    probs_err = 0.0
    outs = {"out": ([], []), "routed": ([], [])}
    for x_c in xs_c:
        x, n = x_c.cuda(), x_c.shape[0] * x_c.shape[1]
        probs, _ = moe.router_probs(x.reshape(n, -1), lp["router"])
        probs_c, _ = moe.router_probs(x_c.reshape(n, -1), lp_c["router"])
        _, idx = moe.route(probs, k)
        _, idx_c = moe.route(probs_c, k)
        top = torch.sort(probs_c, dim=-1, descending=True).values[:, :k + 1]
        near = (top[:, :-1] - top[:, 1:]).min(dim=-1).values < NEAR_TIE
        differ = (idx.cpu() != idx_c).any(dim=-1)
        cap = moe.capacity(n, k, cf, e)
        _, keep = moe.slots(idx.reshape(-1), e, cap)
        _, keep_c = moe.slots(idx_c.reshape(-1), e, cap)
        same = ~differ & (keep.cpu() == keep_c).reshape(n, k).all(dim=-1)
        held = ((keep_c & (idx_c.reshape(-1) >= lo) & (idx_c.reshape(-1) < hi)).reshape(n, k)
                & same[:, None])  # compared tokens' pairs on the held experts
        probs_err = max(probs_err, float((probs.cpu() - probs_c).abs().max()))
        for key, v in (("picks_differ", differ), ("near_ties", near),
                       ("picks_differ_not_near_tie", differ & ~near),
                       ("tokens_compared", same), ("held_pairs", held)):
            tally[key] += int(v.sum())
        for label, c in (("out", cfg), ("routed", routed)):
            out, aux = moe.moe_layer(lp, x, c, capacity_factor=cf)
            out_c, aux_c = moe.moe_layer(lp_c, x_c, c, capacity_factor=cf)
            outs[label][0].append(out.cpu().reshape(n, -1)[same])
            outs[label][1].append(out_c.reshape(n, -1)[same])
        tally["dropped"] += int(aux["dropped"])
        tally["dropped_cpu"] += int(aux_c["dropped"])
    result = {"inputs": f"{len(xs_c)} x {tuple(xs_c[0].shape[:2])}", "cf": cf, "cap": cap,
              "probs_max_abs_err": probs_err, **tally, "limit": limit}
    for label, (got, want) in outs.items():
        got, want = torch.cat(got), torch.cat(want)
        result[f"{label}_rms"] = float(want.float().pow(2).mean().sqrt())
        result[f"{label}_rel"] = _rel(got, want) if want.abs().max() > 0 else None
    result["failed"] = [msg for bad, msg in (
        (result["picks_differ_not_near_tie"] > 0,
         f"{result['picks_differ_not_near_tie']} tokens' picks differ away from a near-tie"),
        (result["held_pairs"] == 0, "no pair on a held expert: the routed part is untested"),
        (result["held_pairs"] and max(result["out_rel"], result["routed_rel"]) >= limit,
         f"moe_layer card vs CPU {result['out_rel']} / routed {result['routed_rel']} "
         f"(limit {limit})"),
    ) if bad]
    return result


def moe_layer_check(params, cpu, cfg, seed=7, limit=0.01):
    """`moe_layer` alone, card against CPU, on the first MoE layer's weights,
    at the prefill's shape (one bf16 input of `MOE_PARITY_PROMPT` tokens at
    the served prefill capacity, cf 2.0) and at the decode step's
    (`MOE_DECODE_DRAWS` inputs of 8 sequences x 1 token at cf = E, no drop):
    the routing probabilities' largest gap (the float32 router: TF32 off),
    the (token, choice) picks equal but at near-ties (top k+1 margin under
    `NEAR_TIE` in probability, counted), the drops, the pairs on the held
    experts (none fails: the routed part would go untested), and the output
    within `limit` of its scale on every token whose picks and slots agree,
    whole and its routed part alone (the layer without its dense branch: at
    these random weights the routed part is small beside the dense one, so
    the whole output alone would hide it)."""
    import torch

    from repro_torch.models.model import PREFILL_CAPACITY

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("moe_parity: TF32 is on; the router must be float32")
    lp, lp_c = _first_moe_layer(params), _first_moe_layer(cpu)
    gen = torch.Generator().manual_seed(seed)

    def draw(b, s):
        return torch.randn(b, s, cfg.d_model, generator=gen).to(torch.bfloat16)

    result = {
        "prefill": _moe_layer_case(lp, lp_c, cfg, [draw(1, MOE_PARITY_PROMPT)],
                                   PREFILL_CAPACITY, limit),
        "decode": _moe_layer_case(lp, lp_c, cfg,
                                  [draw(MOE_MAX_BATCH, 1) for _ in range(MOE_DECODE_DRAWS)],
                                  float(cfg.num_experts), limit),
    }
    failed = [f"{shape}: {msg}" for shape, r in result.items() for msg in r["failed"]]
    return {"moe_layer": result, "failed": failed}


def phase_moe_parity():
    """The card against the port on the CPU at published widths and two
    layers at the served share (Arctic 2 MoE layers, Maverick one dense / MoE
    pair), a `MOE_PARITY_PROMPT`-token prompt: prefill logits, two decode
    steps and caches within 4%; and `moe_layer` alone (`moe_layer_check`)."""
    return _parity_phase("moe_parity", tuple(MOE_SERVE), share=MOE_SERVE["arctic-480b"]["share"],
                         prompt=MOE_PARITY_PROMPT, check=moe_layer_check)


# -- phase 22: training ----------------------------------------------------------

# (a) every registered arch reduced: one AdamW step on the card against the
# port on the CPU, bf16 weights from seed 0, one (2, 64) bigram batch.
TRAIN_LOSS_TOL, TRAIN_GRAD_REL, TRAIN_GRAD_COS = 2e-3, 0.1, 0.998
TRAIN_NORM_REL = 1e-2  # grad_norm, card against CPU
TRAIN_OPT_LR, TRAIN_OPT_DECAY = 3e-4, 0.01  # (a)'s AdamW step: OptConfig's defaults
TRAIN_TIE = 1e-2  # top-k margin under which bf16 noise may flip a pick (the CPU tests')
# (b)-(d) published widths on bigram data, AdamW with 5 warmup steps (cosine
# to 0.1x over the run): qwen2-7b cut to TRAIN_QWEN_LAYERS of 28 layers (the
# deepest cut whose peak stays at or under TRAIN_PEAK_GB: 14 layers 63.7 GB, 16
# layers 70.9 GB on an H100 80GB HBM3 at 700 W, this phase's `train_run`),
# rwkv6-1.6b and whisper-base whole. rwkv6 takes 6 steps: its plain scans make
# a step ~13 s of host-bound launches on that card.
TRAIN_QWEN_LAYERS = 14
TRAIN_PEAK_GB = 70.0
TRAIN_WARMUP = 5
# The learning rates: 3e-4, but qwen2-7b's loss rose at it (11.94 -> 11.96
# over 20 steps, a spike to 12.01 after the first full-rate step) and fell at
# 1e-4 (-> 11.92); whisper-base's spiked at 1e-3 (the same card, PERF.md §6).
TRAIN_RUNS = {  # arch: layers (None: all), sequence length, global batch, lr, steps
    "qwen2-7b": dict(layers=TRAIN_QWEN_LAYERS, seq_len=4096, batch=2, lr=1e-4, steps=20),
    # its traced step is not profiled: a step is ~300,000 launches, whose
    # trace takes minutes to read back
    "rwkv6-1.6b": dict(layers=None, seq_len=4096, batch=2, lr=3e-4, steps=6, profile_it=False),
    # the decoder's 448-token context, 1,500 stub frames; 16 sequences
    # (7,168 tokens, near the others' 8,192)
    "whisper-base": dict(layers=None, seq_len=448, batch=16, lr=3e-4, steps=20),
}


class _FilingOptimizer:
    """Stands in for the optimizer in `make_train_step`: files the
    gradients it is given (float32 copies on the CPU), then updates."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, step):
        from repro_torch.models.params import leaves

        self.grads = {path: g.float().cpu() for path, g in leaves(grads)}
        return self.opt.update(grads, state, params, step)


@contextlib.contextmanager
def _routing(picks=None):
    """Files each MoE layer's router probabilities (the CPU copy, in call
    order) while it runs; `picks` {layer: {token: expert ids}} are taken in
    place of the layer's own at those tokens (gates renormalized over them,
    as `moe.route` does)."""
    import torch

    from repro_torch.models import moe

    probs, orig = [], moe.route

    def route(pr, k):
        gates, idx = orig(pr, k)
        forced = (picks or {}).get(len(probs), {})
        probs.append(pr.detach().float().cpu())
        if forced:
            idx = idx.clone()
            for tok, ids in forced.items():
                idx[tok] = torch.as_tensor(ids, device=idx.device)
            g = pr.gather(-1, idx)
            gates = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
        return gates, idx

    moe.route = route
    try:
        yield probs
    finally:
        moe.route = orig


def train_step_once(cfg, params, batch, device, picks=None):
    """One `make_train_step` step (AdamW for every arch, warmup 1: its first
    step is bounded, lr x (sign(g) + decay x p)) of a copy of `params`
    on `device`: loss, grad_norm, the gradients, the updated parameters
    (float32 on the CPU, by path) and the MoE layers' router probabilities."""
    import torch

    from repro_torch.models.params import leaves
    from repro_torch.train.optim import OptConfig, make_optimizer
    from repro_torch.train.step import make_train_step

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v.to(device, copy=True)
                for k, v in tree.items()}

    p = copy(params)
    opt = _FilingOptimizer(make_optimizer(OptConfig(
        lr=TRAIN_OPT_LR, weight_decay=TRAIN_OPT_DECAY, warmup_steps=1)))
    with _routing(picks) as probs:
        p, _, metrics = make_train_step(cfg, opt)(
            p, opt.init(p), {k: torch.as_tensor(v, device=device) for k, v in batch.items()},
            0)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "grads": opt.grads, "params": {path: t.float().cpu() for path, t in leaves(p)},
            "probs": probs}


def _rel_cos(got, want):
    """Largest gap over want's largest entry, and the cosine."""
    got, want = got.double(), want.double()
    scale = max(float(want.abs().max()), 1e-30)
    norms = max(float((got * got).sum() * (want * want).sum()), 1e-120) ** 0.5
    return float((got - want).abs().max()) / scale, float((got * want).sum()) / norms


def _differing_picks(probs_a, probs_b, k):
    """{layer: {token: a's expert ids}} where a's and b's top-k picks
    differ, and the b margins there (k-th minus (k+1)-th probability)."""
    import torch

    out, margins = {}, []
    for layer, (a, b) in enumerate(zip(probs_a, probs_b)):
        ids_a = torch.topk(a, k, dim=-1).indices
        top_b = torch.topk(b, min(k + 1, b.shape[-1]), dim=-1)
        ids_b = top_b.indices[:, :k]
        differ = (ids_a.sort(-1).values != ids_b.sort(-1).values).any(-1).nonzero()[:, 0]
        if len(differ):
            out[layer] = {int(t): ids_a[t].tolist() for t in differ}
            vals = top_b.values
            margins += [float(vals[t, k - 1] - vals[t, k]) for t in differ]
    return out, margins


def card_vs_cpu_train(name, seed=0):
    """One AdamW step of the reduced `name` on the card against the port on
    the CPU: the loss within TRAIN_LOSS_TOL, grad_norm within TRAIN_NORM_REL;
    each gradient within TRAIN_GRAD_REL of its scale and cosine
    TRAIN_GRAD_COS (the CPU parity tests' bounds); each updated parameter
    equal up to rounding where the gradient is past TRAIN_GRAD_REL of its
    leaf's largest, and within two AdamW steps elsewhere (a first step is
    lr x the gradient's sign, which noise may flip where it is small). A gradient leaf past them
    passes only where bf16 noise is past them on the CPU too (the CPU's bf16
    gradient against the CPU's float32 one) and the card's bf16 gradient is
    within twice that noise of the float32 one. MoE: picks that differ
    between the two must be near-ties (TRAIN_TIE); the CPU step then runs
    again with the card's picks there."""
    import torch

    from repro_torch import configs
    from repro_torch.data.lm import batches_for
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves

    t0 = time.perf_counter()
    cfg = configs.get(name).reduced()
    params = M.init_model(cfg, seed=seed, device="cpu")
    if "xblk" in params:  # nonzero gates, so that the cross blocks count
        for gate in ("gate_attn", "gate_mlp"):
            params["xblk"][gate].fill_(CROSS_GATE)
    batch = next(batches_for(cfg, 64, 2, seed=seed))
    card = train_step_once(cfg, params, batch, "cuda")
    cpu = train_step_once(cfg, params, batch, "cpu")
    forced, margins = _differing_picks(card["probs"], cpu["probs"], cfg.experts_per_token or 1)
    if forced:
        cpu = train_step_once(cfg, params, batch, "cpu", picks=forced)
    failed, noisy = [], []
    if any(m >= TRAIN_TIE for m in margins):
        failed.append(f"picks differ past a near-tie: margins {margins}")
    if abs(card["loss"] - cpu["loss"]) > TRAIN_LOSS_TOL:
        failed.append(f"loss {card['loss']} vs {cpu['loss']}")
    gn_rel = abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    if gn_rel > TRAIN_NORM_REL:
        failed.append(f"grad_norm {card['grad_norm']} vs {cpu['grad_norm']}")
    f32 = None
    worst_g, worst_p = (0.0, 1.0, ""), (0.0, 1.0, "")
    for path, want in cpu["grads"].items():
        r, c = _rel_cos(card["grads"][path], want)
        worst_g = max(worst_g, (r, c, "/".join(path)))
        if r <= TRAIN_GRAD_REL and c >= TRAIN_GRAD_COS:
            continue
        if f32 is None:  # the same weights in float32 on the CPU: the yardstick
            f32 = train_step_once(cfg, _widen(params), batch, "cpu", picks=forced)["grads"]
        r_cpu, c_cpu = _rel_cos(want, f32[path])
        r_card, c_card = _rel_cos(card["grads"][path], f32[path])
        noisy.append(("/".join(path), r, c, r_cpu, c_cpu, r_card, c_card))
        if (r_cpu <= TRAIN_GRAD_REL and c_cpu >= TRAIN_GRAD_COS) or r_card > 2 * r_cpu \
                or 1 - c_card > 2 * (1 - c_cpu):
            failed.append(f"gradient {'/'.join(path)}: rel {r:.4f} cos {c:.6f} "
                          f"(against float32: cpu {r_cpu:.4f} / {c_cpu:.6f}, "
                          f"card {r_card:.4f} / {c_card:.6f})")
    # AdamW's first step moves an entry by lr * (sign(g) + decay * p): where
    # the gradient is past the gradient bound of its leaf's scale both sides
    # step alike (equal up to the rounding to the leaf's type); elsewhere a
    # sign may flip, two steps apart at most.
    before = dict(leaves(params))
    step_off = 0
    for path, want in cpu["params"].items():
        got, g = card["params"][path], cpu["grads"][path].abs()
        p0 = before[path].float()
        # an ulp of the leaf's type at the larger of the two results bounds
        # both roundings together
        ulp = torch.maximum(got.abs(), want.abs()) * (
            2.0 ** -7 if before[path].dtype == torch.bfloat16 else 2.0 ** -23)
        d = (got - want).abs()
        span = 2 * TRAIN_OPT_LR * (1 + TRAIN_OPT_DECAY * p0.abs()) + ulp
        firm = g > TRAIN_GRAD_REL * g.max()
        step_off += int((d > ulp + 1e-3 * TRAIN_OPT_LR).sum())
        worst_p = max(worst_p, (float((d / span).max()), float(firm.float().mean()),
                                "/".join(path)))
        if (d > span).any() or (d[firm] > 2 * ulp[firm] + 1e-3 * TRAIN_OPT_LR).any():
            failed.append(f"updated {'/'.join(path)}: {int((d > span).sum())} entries past two "
                          f"steps, {int((d[firm] > 2 * ulp[firm]).sum())} firm ones apart")
    return {"arch": name, "loss": card["loss"], "cpu_loss": cpu["loss"],
            "grad_norm": card["grad_norm"], "cpu_grad_norm": cpu["grad_norm"],
            "grad_norm_rel": gn_rel, "worst_grad": worst_g,
            "worst_update_gap_over_two_steps": worst_p, "updated_entries_apart": step_off,
            "s": time.perf_counter() - t0,
            "grads_past_bounds_bf16_noise": noisy, "forced_picks": sum(map(len, forced.values())),
            "forced_margins": margins, "failed": failed}


def _widen(tree):
    import torch

    return {k: _widen(v) if isinstance(v, dict) else
            (v.float() if v.dtype == torch.bfloat16 else v) for k, v in tree.items()}


def train_run(name, *, layers, seq_len, batch, lr, steps, profile_it=True):
    """`steps` AdamW steps of `name` at its published widths (cut to `layers`
    layers if given) on `batches_for` data: the loss at every step, step ms
    (median of steps 3 onward, host clock after a synchronize), tokens/s,
    the peak memory; then one traced step (`torch.profiler`): its top
    device ops and busy share. Gates: the first loss within 0.5 of ln V, the
    last below the first, finite, the peak at most TRAIN_PEAK_GB, no
    chunk_scan kernel launched (the training path takes the plain scans)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.data.lm import batches_for
    from repro_torch.kernels.chunk_scan import ops as cs_ops
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    from repro_torch.train.optim import OptConfig, make_optimizer
    from repro_torch.train.step import make_train_step

    cfg = configs.get(name)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_model(cfg, seed=0, device="cuda")
    opt = make_optimizer(OptConfig(lr=lr, warmup_steps=TRAIN_WARMUP,
                                   decay_steps=steps + 1))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    data = batches_for(cfg, seq_len, batch, seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
               for _ in range(steps + 1)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = cs_ops.chunk_scan.launches
    losses, step_ms = [], []
    for i in range(steps):
        t1 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batches[i], i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof_out = {}
    if profile_it:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batches[steps], steps)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t1) * 1e3
        top, busy = device_summary(prof, 1, top=10, unit="step")
        prof_out = {"step_ms_traced": traced_ms, "device_busy_ms_per_step": busy,
                    "device_busy_share": busy / traced_ms, "profile_top_device_ms": top}
    ms = statistics.median(step_ms[2:])
    ln_v = math.log(cfg.vocab_size)
    out = {"arch": name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params_b": count_params(params) / 1e9, "seq_len": seq_len, "batch": batch,
           "optimizer": "adamw", "lr": lr, "warmup": TRAIN_WARMUP, "steps": steps,
           "setup_s": setup_s, "step_ms_median_3_on": ms, "step_ms": step_ms,
           "tokens_per_s": batch * seq_len / (ms / 1e3), "peak_gb": peak,
           "ln_vocab": ln_v, "losses": losses,
           "chunk_scan_launches": cs_ops.chunk_scan.launches - launches, **prof_out}
    failed = []
    if not np.all(np.isfinite(losses)):
        failed.append("a loss is not finite")
    if abs(losses[0] - ln_v) > 0.5:
        failed.append(f"first loss {losses[0]} not within 0.5 of ln V {ln_v}")
    if not losses[-1] < losses[0]:
        failed.append(f"last loss {losses[-1]} not below the first {losses[0]}")
    if peak > TRAIN_PEAK_GB:
        failed.append(f"peak {peak:.2f} GB past {TRAIN_PEAK_GB}")
    if out["chunk_scan_launches"]:
        failed.append(f"{out['chunk_scan_launches']} chunk_scan launches in training")
    out["failed"] = failed
    del params, state, batches
    free_cuda()
    return out


def scan_guard():
    """Both chunk_scan entries on CUDA inputs that require grad, under grad
    mode: each must raise (the kernels have no backward); under
    `torch.no_grad` the same inputs launch and match the plain version."""
    import torch

    from repro_torch.kernels.chunk_scan import ops as cs_ops

    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, dk = 1, 64, 2, 32

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    w, k, v, q = rand(b, s, h, dk) * 0.5 + 0.5, rand(b, s, h, dk), rand(b, s, h, dk), rand(b, s, h, dk)
    u = rand(h, dk)
    wm, km, qm = rand(b, s, h) * 0.5 + 0.5, rand(b, s, dk), rand(b, s, dk)
    calls = {"chunk_scan": lambda: cs_ops.chunk_scan(w, k, v, q, u, include_current=False,
                                                     chunk=32),
             "chunk_scan_mamba2": lambda: cs_ops.chunk_scan_mamba2(wm, km, qm, v, chunk=32)}
    plains = {"chunk_scan": lambda: cs_ops.chunk_scan_plain(w, k, v, q, u,
                                                            include_current=False, chunk=32),
              "chunk_scan_mamba2": lambda: cs_ops.chunk_scan_mamba2_plain(wm, km, qm, v,
                                                                          chunk=32)}
    out, failed = {}, []
    v.requires_grad_(True)
    for name, call in calls.items():
        try:
            call()
            failed.append(f"{name} returned under grad mode with an input that requires grad")
            out[name] = "returned"
        except RuntimeError as e:
            out[name] = f"raised: {e}"[:120]
        with torch.no_grad():
            y, st = call()
            y_p, st_p = plains[name]()
        out[f"{name}_no_grad_max_abs_err"] = max(float((y - y_p).abs().max()),
                                                 float((st - st_p).abs().max()))
        if out[f"{name}_no_grad_max_abs_err"] > 1e-4:
            failed.append(f"{name} under no_grad disagrees with its plain version")
    out["failed"] = failed
    return out


def phase_train():
    """Training on the card: (a) every registered arch reduced, card against
    CPU; (b)-(d) qwen2-7b cut in depth, rwkv6-1.6b and whisper-base whole at
    published widths (`TRAIN_RUNS`); (e) the chunk_scan kernels refusing a
    gradient."""
    import torch

    from repro_torch.configs.base import REFERENCE_ARCHS

    t0 = time.perf_counter()
    prev = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        parity = [card_vs_cpu_train(n) for n in REFERENCE_ARCHS]
    finally:
        torch.set_num_threads(prev)
    runs = [train_run(n, **spec) for n, spec in TRAIN_RUNS.items()]
    guard = scan_guard()
    out = {"phase": "train", "parity": parity, "runs": runs, "scan_guard": guard,
           "phase_s": time.perf_counter() - t0}
    emit(out)
    failed = ([(r["arch"], f) for r in parity + runs for f in r["failed"]]
              + [("scan_guard", f) for f in guard["failed"]])
    if failed:
        raise SystemExit(f"train: {failed}")
    return out


# -- phase 23: dryrun ------------------------------------------------------------

# The paper's production RLDA sweep (`launch.dryrun_rlda`: K 256, V 250,000,
# D 200,000, `w_bits` 8, 16,777,216 tokens, blocks of 8,192), token-parallel
# and client-server at W 16 and 32 (the pod meshes' data axes), one sync a
# sweep; row 1 at its shapes; the one-card estimate (`launch.dryrun`)
# against the train phase's measured peaks.
DRYRUN_TOKENS = 16_777_216
DRYRUN_BLOCK = 8192
DRYRUN_WORKERS = (16, 32)
DRYRUN_SLICE = 1 << 17  # the plain version's (N, K) scores fit at this slice, not at N
DRYRUN_KEY = (2 ** 64 - 777, 40)
# The estimate against the train phase's measured peak: a design target (the
# estimate runs the same code on `meta`; it misses the allocator's rounding
# and cuBLAS workspaces), not a tolerance to widen.
ESTIMATE_REL = 0.10
EXTRAPOLATION_SLACK = 4096  # bytes: the depth extrapolation against a full-depth run


def _rlda_run(label, **kw):
    """One `dryrun_rlda.run_one` on the card, its launches counted from 0,
    then one more sweep traced: the record's numbers, the busy share and
    the top device ops; and the live result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun_rlda
    from repro_torch.kernels.lda_gibbs import ops

    free_cuda()
    ops.resample.launches = ops.resample.launches_philox = 0
    ops.resample.tokens = 0
    rec = dryrun_rlda.run_one(False, num_tokens=DRYRUN_TOKENS, block=DRYRUN_BLOCK,
                              device="cuda", tag=label, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec["step"]()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    # 5 sweeps: a warm-up, 3 timed, 1 traced
    launches, tokens = ops.resample.launches, ops.resample.tokens
    top, busy = device_summary(prof, 1, top=8)
    out = {k: rec[k] for k in ("mode", "setup_s", "sweep_ms", "sweep_ms_all",
                               "launches_per_sweep", "bound", "invariants", "counts",
                               "static_per_device", "static_card_bytes", "peak_bytes")}
    out.update({k: rec[k] for k in ("workers", "sync_bytes_per_device",
                                    "sync_bytes_all_workers", "bound_with_noise")
                if k in rec},
               label=label, peak_gb=rec["peak_bytes"] / 1e9, launches=launches,
               launches_philox=ops.resample.launches_philox,
               tokens_per_launch=tokens / max(launches, 1),
               traced_sweep_ms=traced_ms, device_busy_ms_per_sweep=busy,
               device_busy_share=busy / traced_ms, profile_top_device_ms=top)
    return out, rec


def rlda_kernel_checks(cfg, corpus, state, reps=20):
    """Row 1 at the production shapes: against `resample_plain` on the
    sweep's own first, middle and last (8,192, K 256) blocks (its decoded
    float32 tables, injected noise) and on the first 2^17 tokens with the
    stored int32 tables in both noise modes; the (8,192, K 256) block timed
    in both modes (`_lda_timing`); one Philox launch over all the tokens,
    the `cuda` backend's route at this shape, timed by CUDA events over raw
    launches and by graph, against its bound."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import kernel, ops

    n, k, b = corpus.num_tokens, cfg.num_topics, DRYRUN_BLOCK
    decoded = codec.decode_counts(cfg, state)
    ids = (corpus.docs, corpus.words, state.z, corpus.weights)
    hp_real = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=None)
    hp_fixed = dict(hp_real, w_bits=cfg.w_bits)
    gen = torch.Generator(device="cuda").manual_seed(17)
    blocks = {}
    for name, lo in (("first", 0), ("middle", n // 2 // b * b), ("last", n - b)):
        args = (*(t[lo:lo + b] for t in ids), *decoded)
        bad, flips, near, gap = compare((*args, ops.gumbel((b, k), gen, "cuda")), **hp_real)
        blocks[name] = {"start": lo, "mismatch": bad, "near_tie_flips": flips,
                        "near_ties": near, "max_abs_err": gap}
    sl = (*(t[:DRYRUN_SLICE] for t in ids), state.n_dt, state.n_wt, state.n_t)
    noise = ops.gumbel((DRYRUN_SLICE, k), gen, "cuda")
    sliced = {}
    for mode, key in (("injected", None), ("philox", DRYRUN_KEY)):
        bad, flips, near, gap = compare((*sl, noise), philox=key, **hp_fixed)
        sliced[mode] = {"mismatch": bad, "near_tie_flips": flips, "near_ties": near,
                        "max_abs_err": gap}
    sliced["plain_ms_philox"] = cuda_ms(
        lambda: ops.resample_plain(*sl, ops.philox_noise(sl[2], sl[6], DRYRUN_KEY),
                                   **hp_fixed), 3, warmup=1)
    first = (*(t[:b] for t in ids), *decoded)
    block = _lda_timing(first, ops.gumbel((b, k), gen, "cuda"), DRYRUN_KEY, hp_real,
                        False, b, 0, reps)
    # A block reads only its tokens' rows of the tables: its bound counts
    # those rows (`_lda_timing` counts whole tables, a sweep's need).
    rows = int(first[0].unique().numel() + first[1].unique().numel())
    for mode in ("injected", "philox"):
        t = block[mode]
        t["bound_ms_whole_tables"] = t["bound_ms"]
        t["bytes"], t["bound_ms"], t["bound_by"] = lda_bound(b, 0, k, (rows + 1) * k * 4,
                                                             mode == "philox")
    block["rows_read"] = rows
    full = (*ids, state.n_dt, state.n_wt, state.n_t)
    z_out = torch.empty_like(state.z)

    def raw():
        kernel.launch(*full, None, z_out, alpha=cfg.alpha, beta=cfg.beta,
                      beta_bar=cfg.beta_bar, scale=2.0 ** -(cfg.w_bits + 1), philox=DRYRUN_KEY)

    rows = int(corpus.docs.unique().numel() + corpus.words.unique().numel())
    moved, bound_ms, bound_by = lda_bound(n, 0, k, (rows + 1) * k * 4, True)
    whole = {"ms": cuda_ms(raw, 5, warmup=1), "graph_ms": graph_ms(raw, launches=2, reps=3),
             "plain_ms": None, "bytes": moved, "bound_ms": bound_ms, "bound_by": bound_by,
             "rows_read": rows,
             "plain_ms_note": f"the plain version cannot hold (N, K) scores at N={n}; "
                              f"its ms on the first {DRYRUN_SLICE} tokens: "
                              f"{sliced['plain_ms_philox']}"}
    mismatch = (sum(r["mismatch"] for r in blocks.values())
                + sliced["injected"]["mismatch"] + sliced["philox"]["mismatch"]
                + block["mismatch"])
    max_err = max([r["max_abs_err"] for r in blocks.values()]
                  + [sliced[m]["max_abs_err"] for m in ("injected", "philox")]
                  + [block["max_abs_err"]])
    return {"blocks": blocks, "slice": sliced,
            "block_shape": f"N={b} K={k} D={cfg.num_docs} V={cfg.vocab_size} float tables",
            "block": block, "whole_shape": f"N={n} K={k} D={cfg.num_docs} V={cfg.vocab_size} "
                                           f"w_bits={cfg.w_bits}",
            "whole": whole, "mismatch": mismatch, "max_abs_err": max_err}


def _batch_bytes(cfg, b, s):
    """(bytes of the estimate's own batch: `abstract_batch`, bf16 frontend
    stub; bytes of one batch as `train_run` holds it: `batches_for`'s arrays,
    whose stub is float32)."""
    from repro_torch.data.lm import batches_for
    from repro_torch.models import model as M

    stub = sum(t.numel() * t.element_size()
               for t in M.abstract_batch(cfg, "train", b, s).values())
    return stub, sum(a.nbytes for a in next(batches_for(cfg, s, b, seed=0)).values())


def estimate_checks(train_runs):
    """`launch.dryrun`'s card estimate of each `TRAIN_RUNS` run at its own
    depth, batch and length (the step's peak on `meta`, its own batch
    swapped for the `steps + 1` batches `train_run` makes up front, in
    their own types: whisper's stub frames are float32 there, and the
    step's bf16 cast of them, 0.4% of its peak, is not counted) against the
    peak the train phase measured; the depth extrapolation against a
    full-depth `meta` run of qwen2-7b at `train_4k`; and the static verdict
    (`fits_card`) of every arch and shape on the card mesh."""
    from repro_torch import configs
    from repro_torch.configs import shapes as shapes_lib
    from repro_torch.configs.base import REFERENCE_ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    runs = []
    for r in train_runs:
        spec = TRAIN_RUNS[r["arch"]]
        cfg = configs.get(r["arch"])
        if spec["layers"]:
            cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
        t0 = time.perf_counter()
        est = dryrun.estimate(cfg, "train", r["batch"], r["seq_len"])
        stub, held = _batch_bytes(cfg, r["batch"], r["seq_len"])
        extra = (spec["steps"] + 1) * held - stub
        predicted = est["peak_bytes"] + extra
        measured = r["peak_gb"] * 1e9
        runs.append({"arch": r["arch"], "layers": cfg.num_layers, "batch": r["batch"],
                     "seq_len": r["seq_len"], "estimate_step_peak_gb": est["peak_bytes"] / 1e9,
                     "held_batches_gb": extra / 1e9, "estimate_gb": predicted / 1e9,
                     "measured_gb": r["peak_gb"], "rel_err": (predicted - measured) / measured,
                     "flops": est["flops"], "depth": {k: est[k] for k in (
                         "groups", "group_layers", "extrapolated")},
                     "estimate_s": time.perf_counter() - t0})
    cfg = configs.get("qwen2-7b")
    shp = shapes_lib.get("train_4k")
    t0 = time.perf_counter()
    est = dryrun.estimate(cfg, "train", shp.global_batch, shp.seq_len)
    full = dryrun.measure_step(cfg, "train", shp.global_batch, shp.seq_len)
    depth = {"arch": "qwen2-7b", "shape": "train_4k", "estimate": est, "full_depth": full,
             "peak_diff_bytes": est["peak_bytes"] - full["peak_bytes"],
             "seconds": time.perf_counter() - t0}
    card = mesh_lib.make_card_mesh()
    t0 = time.perf_counter()
    grid = {}
    for arch in REFERENCE_ARCHS:
        grid[arch] = {}
        for shape_name in shapes_lib.SHAPES:
            rec = dryrun.record(arch, shape_name, card, activations=False)
            grid[arch][shape_name] = ("skipped" if "skipped" in rec else
                                      {"fits_card": rec["fits_card"],
                                       "static_gb": rec["memory"]["total_bytes"] / 1e9})
    return {"runs": runs, "depth_check": depth, "static_grid": grid,
            "card_bytes": rec["memory"]["card_bytes"] if "memory" in rec else None,
            "grid_s": time.perf_counter() - t0}


def phase_dryrun(train):
    """The production RLDA sweep on the card, token-parallel (a) and
    client-server at W 16 and 32 (b); row 1 at its shapes (c); the
    estimate against the train phase (d). Launch counts are zeroed just
    before each run and read just after."""
    import torch

    from repro_torch.core import codec
    from repro_torch.launch import dryrun_rlda
    from repro_torch.kernels.lda_gibbs import ops

    t0 = time.perf_counter()
    tp, rec = _rlda_run("token_parallel")
    cfg = dryrun_rlda.production_lda_config()
    corpus, state = rec["corpus"], rec["result"]
    kernels = rlda_kernel_checks(cfg, corpus, state)
    # The `cuda` backend's route at this shape: one sweep, one Philox launch.
    ops.resample.launches = ops.resample.launches_philox = 0
    cuda_state = ops.sweep(cfg, state, corpus, torch.Generator(device="cuda").manual_seed(3))
    cuda_route = {"launches": ops.resample.launches,
                  "launches_philox": ops.resample.launches_philox,
                  "invariants": dryrun_rlda.check_counts(cfg, corpus, cuda_state.z,
                                                         *codec.decode_counts(cfg, cuda_state))}
    del rec, corpus, state, cuda_state
    cs = [_rlda_run(f"client_server_w{w}", client_server=True, workers=w, sync_every=1)[0]
          for w in DRYRUN_WORKERS]
    est = estimate_checks(train["runs"])
    out = {"phase": "dryrun", "config": {"num_topics": cfg.num_topics,
                                         "vocab_size": cfg.vocab_size,
                                         "num_docs": cfg.num_docs, "w_bits": cfg.w_bits,
                                         "tokens": DRYRUN_TOKENS, "block": DRYRUN_BLOCK},
           "token_parallel": tp, "client_server": cs, "cuda_route": cuda_route,
           "kernel": kernels, "estimate": est, "phase_s": time.perf_counter() - t0}
    emit(out)
    failed = []
    expect = DRYRUN_TOKENS // DRYRUN_BLOCK
    if tp["launches_per_sweep"] != expect or tp["launches"] != 5 * expect:
        failed.append(f"token-parallel launches: {tp['launches_per_sweep']} a sweep, "
                      f"{tp['launches']} in 5 sweeps (want {expect} and {5 * expect})")
    for r in [tp] + cs:
        if not r["invariants"]["ok"]:
            failed.append(f"{r['label']}: invariants {r['invariants']}")
    for r in cs:
        if r["peak_gb"] > TRAIN_PEAK_GB:
            failed.append(f"{r['label']}: peak {r['peak_gb']:.2f} GB past {TRAIN_PEAK_GB}")
    if cuda_route["launches_philox"] != 1 or not cuda_route["invariants"]["ok"]:
        failed.append(f"cuda route: {cuda_route}")
    if kernels["mismatch"]:
        failed.append(f"row 1 disagrees with its plain version: {kernels['mismatch']} tokens")
    for r in est["runs"]:
        if abs(r["rel_err"]) > ESTIMATE_REL:
            failed.append(f"{r['arch']}: estimate {r['estimate_gb']:.3f} GB against "
                          f"{r['measured_gb']:.3f} measured ({r['rel_err']:+.3f})")
    d = est["depth_check"]
    if (d["estimate"]["flops"] != d["full_depth"]["flops"]
            or abs(d["peak_diff_bytes"]) > EXTRAPOLATION_SLACK):
        failed.append(f"depth extrapolation: {d['estimate']} against {d['full_depth']}")
    if failed:
        raise SystemExit(f"dryrun: {failed}")
    return out


def served_rows(runs, name, timings):
    """The kernels line's by-shape rows of a served kernel: one a (arch,
    shape) a serving run called it at, with its calls there and the
    positions they spanned, and the kernel phase's time, plain time, bound
    and library time at that shape (which must have been checked there)."""
    rows = []
    for arch, run in runs:
        for row in run["by_shape"][name]:
            timing = timings.get(tuple(row["key"]))
            if timing is None:
                raise SystemExit(f"{name}: {arch} called it at {row['key']}, a shape the "
                                 f"kernel phase did not check")
            rows.append({"arch": arch, "key": row["key"], "launches": row["calls"],
                         "positions": row["positions"],
                         **{key: timing[key] for key in ("shape", "ms", "graph_ms", "plain_ms",
                                                         "bound_ms", "bound_by", "library_ms")
                            if key in timing}})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_setup()
    analysis = phase_analysis()
    kern = phase_kernels()
    alias_kern = phase_alias_kernel()
    batched_kern = phase_batched_kernels()
    quant_kern = phase_quant_kernel()
    scan_kern = phase_chunk_scan_kernel()
    attn_kern = phase_decode_attn_kernel()
    main_out, handle = phase_main_path("jnp")
    block_timing = first_block_timing(handle)
    emit({"phase": "main_path_kernel", "kernel": block_timing})
    alias_main, alias_handle = phase_main_path("alias")
    # The alias path's own shape: all of the case study's tokens, one sweep's
    # tables and draws from its fitted state.
    from repro_torch.api.backends import get_backend

    ah = alias_handle
    alias_block = alias_kernel_timing(ah.cfg, ah.model.corpus, ah.model.state,
                                      get_backend("alias").mh_steps, reps=200)
    alias_block["bodies"] = alias_bodies_at(ah.cfg, ah.model.corpus, ah.model.state,
                                            get_backend("alias").mh_steps)
    emit({"phase": "main_path_alias_kernel", "kernel": alias_block})
    if alias_block["bodies"]["injected_differ"] or alias_block["bodies"]["philox_differ"]:
        raise SystemExit(f"the alias_mh bodies disagree at the case study: "
                         f"{alias_block['bodies']}")
    if alias_block["mismatch"]:
        raise SystemExit(f"alias_mh kernel disagrees with its plain version at the alias "
                         f"main-path shape: {alias_block['mismatch']} tokens")
    scale = phase_scale()
    large = phase_large_fit(scale["perplexity"])
    t0 = time.perf_counter()
    sets = zoo_review_sets()
    emit({"phase": "zoo_data", "products": len(sets),
          "reviews": sum(len(rs) for rs in sets), "generate_s": round(time.perf_counter() - t0, 3)})
    zoo = phase_zoo(sets)
    zoo_alias = phase_zoo_alias(sets)
    packed = phase_packed()
    case_study = phase_packed_case_study()
    phase_stream()
    _, offload_replays = phase_offload()
    offload = offload_kernels(offload_replays)
    del offload_replays
    mesh = phase_mesh(scale["perplexity"])
    serve = phase_hybrid_serve()
    phase_hybrid_parity()
    dense = phase_dense_serve()
    rwkv = phase_rwkv_serve()
    phase_dense_parity()
    phase_rwkv_parity()
    cross = phase_cross_serve()
    phase_cross_parity()
    moe = phase_moe_serve()
    phase_moe_parity()
    train = phase_train()
    dry = phase_dryrun(train)
    scan_general = scan_kern["served"][(2, 4096, 32, 64, 64, 32, "rwkv6")]
    t = scale["kernel"]
    errs = [kern["max_abs_err"], block_timing["max_abs_err"], t["max_abs_err"],
            *(r[key]["max_abs_err"] for r in offload.values()
              for key in ("first_block", "typical_block")),
            mesh_max_err(mesh, "lda_gibbs.resample"), dry["kernel"]["max_abs_err"],
            *(r["max_abs_err"] for r in analysis["k_limit"]["single"].values())]
    if block_timing["mismatch"]:
        raise SystemExit("kernel disagrees with its plain version at the main-path shape")
    a = large["kernel"]
    timed = ("ms", "graph_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")
    # Launches by shape and noise mode, as the wrapper counted them: the case
    # study's blocks on `torch` (the main path: ⌈N/4096⌉ a sweep, the last
    # one N mod 4096 tokens), the popular product's single launches on
    # `cuda` (`scale` and `packed`'s exact run), and each offload case's
    # `torch`-route blocks over its replays (servers' fits, updates of the
    # new reviews, spot checks and fallback refines, and the `torch`
    # fleet's fits: blocks of up to 4096 tokens), timed at the case's
    # largest product's first block and at a block of its mean tokens a
    # launch.
    cuda_exact = packed["runs"]["cuda_exact"]
    counted = (
        (block_timing, main_out["launches"]["lda_gibbs.resample"],
         main_out["launches_philox"]["lda_gibbs.resample"], "main_path", {}),
        (t, scale["fit_launches"] + cuda_exact["launches"]["lda_gibbs.resample"],
         scale["fit_launches_philox"] + cuda_exact["launches_philox"]["lda_gibbs.resample"],
         "scale, packed", {}),
        *((r["first_block"], sum(r["resample"]["launches"].values()),
           r["resample"]["launches_philox"], name,
           {"launches_by_run": r["resample"]["launches"],
            "tokens_per_launch": r["resample"]["tokens_per_launch"],
            "corpora_tokens": r["resample"]["corpora_tokens"],
            "typical_block": {"shape": r["typical_block"]["shape"],
                              **{mode: {key: r["typical_block"][mode][key] for key in timed}
                                 for mode in ("injected", "philox")}}})
          for name, r in offload.items()),
        *_mesh_counted_rows(mesh, "lda_gibbs.resample"))
    by_shape = [{"shape": timing["shape"], "phases": phases,
                 "launches_injected": n - n_philox, "launches_philox": n_philox, **extra,
                 **{mode: {key: timing[mode][key] for key in timed}
                    for mode in ("injected", "philox")}}
                for timing, n, n_philox, phases, extra in counted]
    # The production RLDA sweep (`dryrun`): its (8,192, K 256) blocks, all
    # injected (token-parallel, and the client-server workers' blocks of up
    # to 8,192), and the `cuda` route's one Philox launch over all tokens.
    dk, dry_runs = dry["kernel"], [dry["token_parallel"]] + dry["client_server"]
    by_shape += [
        {"shape": dk["block_shape"], "phases": "dryrun",
         "launches_injected": sum(r["launches"] for r in dry_runs), "launches_philox": 0,
         "launches_by_run": {r["label"]: r["launches"] for r in dry_runs},
         "tokens_per_launch": {r["label"]: r["tokens_per_launch"] for r in dry_runs},
         **{mode: {key: dk["block"][mode][key] for key in timed}
            for mode in ("injected", "philox")}},
        {"shape": dk["whole_shape"], "phases": "dryrun (the cuda route)",
         "launches_injected": 0, "launches_philox": dry["cuda_route"]["launches_philox"],
         "philox": dk["whole"]}]
    # Row 1's K > 32 body near the top of its K range (`analysis` (c)):
    # checks, not launches of a path.
    k_rows = [{"shape": r["shape"], "phases": "analysis (K limit check)",
               "launches_injected": 0, "launches_philox": 0, "smem_bytes": r["smem_bytes"],
               **{mode: {key: r[mode][key] for key in timed}
                  for mode in ("injected", "philox")}}
              for entry in ("single", "batched") for r in analysis["k_limit"][entry].values()]
    by_shape += k_rows[:len(K_LIMIT["ks"])]
    # lda_gibbs.resample_many by shape: the zoo's larger bucket (its main
    # path, `zoo`), and each offload case's server-only replay, whose
    # coalesced refit windows go to `refine_batch`, timed at its largest
    # window's stack.
    zk = zoo["kernel"]
    many_counted = [(zk, zoo["launches"]["lda_gibbs.resample_many"],
                     zoo["launches_philox"]["lda_gibbs.resample_many"], "zoo", {})]
    many_counted += [(r["many"], sum(r["resample_many"]["launches"].values()),
                      r["resample_many"]["launches_philox"], f"{name} (server-only replay)",
                      {"launches_by_run": r["resample_many"]["launches"]})
                     for name, r in offload.items()]
    many_counted += _mesh_counted_rows(mesh, "lda_gibbs.resample_many")
    many_by_shape = [{"shape": timing["shape"], "phases": phases,
                      "launches_injected": n - n_philox, "launches_philox": n_philox, **extra,
                      **{mode: {key: timing[mode][key] for key in timed}
                         for mode in ("injected", "philox")}}
                     for timing, n, n_philox, phases, extra in many_counted]
    many_by_shape += k_rows[len(K_LIMIT["ks"]):]
    # alias_mh.resample by shape and draw mode: the case study on `alias`
    # (the main path), the popular product's int32 tables (`large_fit` and
    # `packed`'s exact `alias` run) and its packed int8 tables (`packed`).
    # And each mesh entry at every shape a run of the `mesh` phase launched
    # it at, checked and timed on that launch's inputs (`mesh_launch_checks`).
    runs = packed["runs"]
    alias_counted = (
        (alias_block, alias_main["launches"]["alias_mh.resample"],
         alias_main["launches_philox"]["alias_mh.resample"], "main_path_alias", {}),
        (a, large["launches"]["alias_mh.resample"] + runs["alias_exact"]["launches"][
            "alias_mh.resample"],
         large["launches_philox"]["alias_mh.resample"] + runs["alias_exact"][
             "launches_philox"]["alias_mh.resample"], "large_fit, packed", {}),
        (packed["alias_kernel"], runs["alias_int8"]["launches"]["alias_mh.resample"],
         runs["alias_int8"]["launches_philox"]["alias_mh.resample"], "packed (int8)", {}),
        *_mesh_counted_rows(mesh, "alias_mh.resample"))
    alias_by_shape = [{"shape": timing["shape"], "body": timing["body"], "phases": phases,
                       "launches_injected": n - n_philox, "launches_philox": n_philox, **extra,
                       **{mode: {key: timing[mode][key] for key in timed}
                          for mode in ("injected", "philox")}}
                      for timing, n, n_philox, phases, extra in alias_counted]
    alias_many_by_shape = [{"shape": timing["shape"], "body": timing["body"], "phases": phases,
                            "launches_injected": n - n_philox, "launches_philox": n_philox,
                            **extra, **{mode: {key: timing[mode][key] for key in timed}
                                        for mode in ("injected", "philox")}}
                           for timing, n, n_philox, phases, extra in (
                               (zoo_alias["kernel"],
                                zoo_alias["launches"]["alias_mh.resample_many"],
                                zoo_alias["launches_philox"]["alias_mh.resample_many"],
                                "zoo_alias", {}),
                               *_mesh_counted_rows(mesh, "alias_mh.resample_many"))]
    mesh_err = {name: mesh_max_err(mesh, name) for name in _mesh_wrappers()}
    zak = zoo_alias["kernel"]
    # lda_gibbs.resample_quant and the pack kernel by shape: the popular
    # product's packed `cuda` runs (`packed`, 30 sweeps each) and the case
    # study's (`packed_case_study`, 100 each), one quant launch (and one
    # pack launch) a sweep.
    quant_counted = [(packed["kernel"][m], packed["pack_kernel"][m], runs[f"cuda_{m}"]["launches"])
                     for m in ("int8", "int4")]
    quant_counted += [(r["kernel"], r["pack_kernel"],
                       {"lda_gibbs.resample_quant": r["cuda"]["launches"],
                        "lda_gibbs.pack_word_table": r["cuda"]["pack_launches"]})
                      for r in case_study["runs"].values()]
    quant_philox = [runs[f"cuda_{m}"]["launches_philox"]["lda_gibbs.resample_quant"]
                    for m in ("int8", "int4")]
    quant_philox += [r["cuda"]["launches_philox"] for r in case_study["runs"].values()]
    quant_by_shape = [{"shape": timing["shape"],
                       "launches_injected": n["lda_gibbs.resample_quant"] - n_philox,
                       "launches_philox": n_philox,
                       **{mode: {key: timing[mode][key] for key in timed}
                          for mode in ("injected", "philox")}}
                      for (timing, _, n), n_philox in zip(quant_counted, quant_philox)]
    pack_by_shape = [{"shape": p["shape"], "launches": n["lda_gibbs.pack_word_table"],
                      **{key: p[key] for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                                 "bound_by")}}
                     for _, p, n in quant_counted]
    q, pk = packed["kernel"]["int8"], packed["pack_kernel"]["int8"]
    emit({"phase": "total", "script_s": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "lda_gibbs.resample",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lda_gibbs/csrc/lda_gibbs.cu",
        "replaces": "src/repro/kernels/lda_gibbs/kernel.py:233",
        "launches": main_out["launches"]["lda_gibbs.resample"],
        "launches_philox": main_out["launches_philox"]["lda_gibbs.resample"],
        "max_abs_err": max(errs),
        **{key: block_timing["injected"][key]
           for key in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": block_timing["shape"] + " noise=injected",
        "by_shape": by_shape,
    }, {
        "name": "alias_mh.resample",
        "route": "cuda",
        "source": "src/repro_torch/kernels/alias_mh/csrc/alias_mh.cu",
        "replaces": "src/repro/kernels/alias_mh/kernel.py:206",
        "launches": sum(row[1] for row in alias_counted),
        "launches_philox": sum(row[2] for row in alias_counted),
        "max_abs_err": max(alias_kern["max_abs_err"], alias_block["max_abs_err"],
                           a["max_abs_err"], packed["alias_kernel"]["max_abs_err"],
                           mesh_err["alias_mh.resample"]),
        **{key: a["philox"][key] for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                             "bound_by")},
        "library_ms": None,
        "shape": a["shape"] + " draws=philox",
        "by_shape": alias_by_shape,
    }, {
        "name": "alias_mh.resample_many",
        "route": "cuda",
        "source": "src/repro_torch/kernels/alias_mh/csrc/alias_mh.cu",
        "replaces": "src/repro/kernels/alias_mh/kernel.py:269",
        "launches": zoo_alias["launches"]["alias_mh.resample_many"],
        "launches_philox": zoo_alias["launches_philox"]["alias_mh.resample_many"],
        "max_abs_err": max(batched_kern["alias_mh.resample_many"]["max_abs_err"],
                           zak["max_abs_err"], mesh_err["alias_mh.resample_many"]),
        **{key: zak["philox"][key]
           for key in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": zak["shape"] + " draws=philox",
        "injected": {key: zak["injected"][key] for key in timed},
        "philox": {key: zak["philox"][key] for key in timed},
        "by_shape": alias_many_by_shape,
    }, {
        "name": "lda_gibbs.resample_many",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lda_gibbs/csrc/lda_gibbs.cu",
        "replaces": "src/repro/kernels/lda_gibbs/kernel.py:276",
        "launches": zoo["launches"]["lda_gibbs.resample_many"],
        "launches_philox": zoo["launches_philox"]["lda_gibbs.resample_many"],
        "max_abs_err": max(batched_kern["lda_gibbs.resample_many"]["max_abs_err"],
                           *(timing["max_abs_err"] for timing, *_ in many_counted),
                           *(r["max_abs_err"] for r in analysis["k_limit"]["batched"].values())),
        **{key: zk["philox"][key]
           for key in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": zk["shape"] + " noise=philox",
        "injected": {key: zk["injected"][key] for key in timed},
        "philox": {key: zk["philox"][key] for key in timed},
        "by_shape": many_by_shape,
    }, {
        "name": "lda_gibbs.resample_quant",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lda_gibbs/csrc/lda_gibbs.cu",
        "replaces": "src/repro/kernels/lda_gibbs/kernel.py:183",
        "launches": sum(n["lda_gibbs.resample_quant"] for _, _, n in quant_counted),
        "launches_philox": sum(quant_philox),
        "max_abs_err": max(quant_kern["max_abs_err"],
                           *(t["max_abs_err"] for t, _, _ in quant_counted)),
        **{key: q["philox"][key] for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                             "bound_by")},
        "library_ms": None,
        "shape": q["shape"] + " noise=philox",
        "by_shape": quant_by_shape,
    }, {
        # Not a TPU kernel: the reference quantizes the stale table with jnp
        # (`quantize_rows_jnp`, `pack_nibbles_jnp`) before its Pallas call.
        "name": "lda_gibbs.pack_word_table",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lda_gibbs/csrc/lda_gibbs.cu",
        "replaces": "src/repro/core/quant.py:233",
        "launches": sum(n["lda_gibbs.pack_word_table"] for _, _, n in quant_counted),
        "max_abs_err": max([float(quant_kern["pack_differ"])]
                           + [p["max_abs_err"] for _, p, _ in quant_counted]),
        **{key: pk[key] for key in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": pk["shape"],
        "by_shape": pack_by_shape,
    }, {
        # The Mamba2 entry: the served zamba2 prefill runs it.
        "name": "chunk_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/chunk_scan/csrc/chunk_scan_mamba2.cu",
        "replaces": "src/repro/kernels/chunk_scan/kernel.py:105",
        "launches": serve["launches"]["chunk_scan"],
        "max_abs_err": scan_kern["max_abs_err_mamba2"],
        **{key: scan_kern["kernel_mamba2"][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
    }, {
        # The general entry: rwkv6-1.6b's served prefill runs it (rwkv6 mode).
        "name": "chunk_scan.general",
        "route": "cuda",
        "source": "src/repro_torch/kernels/chunk_scan/csrc/chunk_scan.cu",
        "replaces": "src/repro/kernels/chunk_scan/kernel.py:105",
        "launches": rwkv["launches"]["chunk_scan"],
        "max_abs_err": scan_kern["max_abs_err"],
        **{key: scan_general[key] for key in
           ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dv_block", "cuda_launches_per_call")},
        "by_shape": served_rows([("rwkv6-1.6b", rwkv)], "chunk_scan", scan_kern["served"]),
    }, {
        "name": "decode_attn",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/kernel.py:99",
        "launches": serve["launches"]["decode_attn"]
        + sum(r["launches"]["decode_attn"] for r in dense["runs"] + cross["runs"]
              + moe["runs"]),
        "max_abs_err": attn_kern["max_abs_err"],
        **{key: attn_kern["kernel"][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "by_shape": served_rows([("zamba2-2.7b", serve)]
                                + [(r["arch"], r) for r in dense["runs"] + cross["runs"]
                                   + moe["runs"]],
                                "decode_attn", attn_kern["served_by_key"]),
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
