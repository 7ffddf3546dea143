#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build: compile the Hopper kernels from ``src/repro_torch/csrc`` with
   nvcc (sm_90a, one nvcc per source, in parallel): nm_spmv.cu (gather
   and onehot bodies), nm_xwt.cu (nm_xwt with int8 or bit-packed indices,
   and nm_spmm), one paged attention kernel per family, which its decode
   (span S = 1) and verify wrappers share, and flash_attention.cu; print
   the card's name and power limit from nvidia-smi.
2. Kernel vs plain: hold each kernel against its plain torch version on the
   card, in float32 and bfloat16, at the shapes the paths give it, and time
   it beside its bound, the plain version and one PyTorch call that
   computes the same function (the yardstick; the port never calls it);
   the N:M linears', the paged attention kernels' and flash attention's
   times are CUDA events around the wrapper calls and also device time
   (every kernel launched, from torch.profiler), for the kernel and for
   its library call:
   nm_spmv / nm_xwt at one llama3.2-1b layer's and one deepseek-v2-lite
   MoE layer's linears (plus the dense first layer's and the latent
   up-projections' shapes, checked), paged_gqa_decode at the llama serving
   shape, paged_mla_decode at the deepseek one.  The speculative path's
   operands: nm_spmv / nm_xwt at 1:4 (the rerank draft's format) at the
   llama layer shapes, nm_xwt at the 32 rows of a verify span (8 slots x
   4), and paged_gqa_verify / paged_mla_verify at 8 slots x S 4, each also
   against S launches of its decode wrapper, and again at a long context
   (``LONG_LENS``: up to 2100 positions, so a row's view spans several
   chunks of the tensor-core bodies and their cross-CTA fold runs) against
   the plain version, against decode bit for bit, and launched twice on
   the same inputs, bit-equal.  The variants: packed nm_xwt
   bit-equal to int8 nm_xwt at the llama layer, onehot nm_spmv against its
   plain version, the tensor-core bodies (onehot B 8, nm_xwt S 32 and
   128, packed S 128) launched twice on the same inputs at each llama
   layer shape, bit-equal, and the gather nm_spmv body launched twice at
   every checked shape (llama and deepseek at 2:4, llama at 1:4),
   bit-equal; nm_spmm over 1:4 / 2:4 / 2:8 at the
   reference's ragged (130, 96, 520) and CNN GEMMs; flash_attention
   against its plain version and chunked_attention at llama prefill (BH
   8 x 32, S 128, d 64), a
   gemma2-9b local layer (d 256, window 4096, softcap 50, S 8192, BH 2),
   deepseek's MLA prefill (d 192, dv 128) and a q_off slice, then one
   launch per case through the entry point with the counts zeroed.
   gemma2-9b: nm_spmv / nm_xwt at one gemma2 layer's seven linears (K
   3584 / 14336), and paged_gqa_decode and paged_gqa_verify (S 4) at its
   serving shape (8 slots, KVH 8, G 2, d 256, block 16, window 4096,
   softcap 50, kv_len up to 4160: two rows past the window), f32 and
   bf16 against their plain versions, verify against decode bit for bit;
   SDPA, the yardstick, runs under the same window mask without the
   softcap (it has none).  falcon-mamba-7b and zamba2-7b: nm_spmv /
   nm_xwt at one falcon layer's four linears (x_proj's 288 rows,
   dt_proj's K 256) and one zamba2 Mamba2 layer's two (in_proj's 14576
   rows), checked with the shared block's shapes, and paged_gqa_decode at
   zamba2's shared block (KVH 32, G 1, d 112, window 4096, no softcap);
   ``[scan]`` times the plain-torch recurrence of one layer of each.
   whisper-small and qwen2-vl-7b: nm_spmv at one whisper decoder layer's
   nine linears (K 768; B 8) and nm_xwt at one encoder layer's seven at
   its 1500 frames (a ragged last row tile), nm_spmv / nm_xwt at one
   qwen2-vl layer's seven (k / v 512 rows, wd's K 18944), the q / k / v
   projections with a nonzero bias through ``linear_apply`` (kernel
   route against plain route), and paged_gqa_decode at whisper's decoder
   (KVH 12, G 1, d 64) and paged_gqa_decode / paged_gqa_verify at
   qwen2-vl's (KVH 4, G 7, d 128), no window, kv_len up to 2100.
Every serve phase (3-6, 8) runs the engine as a user would on the card:
each entry point (decode, prefill per bucket, propose, verify) captured as
CUDA graphs before the first admission (``prewarm=True``), any mid-serve
capture an error (``strict_prewarm=True``); a replay adds what its graph
captured to each kernel's launch count.  Each phase also runs the eager
engine (``graphs=False``) on the same trace: tokens and counters are
compared with the graphed run's (a flip is printed with its top-2
margin), and a ``[graph]`` line gives tokens/s in the order eager,
graphed, graphed (, eager: phases 3 and 4), the prewarm, the first and
steady tick and the graph pool's bytes.

3. Serve llama3.2-1b: full width (16 layers, d 2048, 32/8 heads, d_ff
   8192, vocab 128256, bf16, 2:4 compressed; random weights from a seed)
   through ``ServeEngine(kv="paged", attn="fused", compressed=True)``: 8
   slots, 16 requests of 128 prompt tokens, generation mix 16/32, block
   size 16.  Each kernel of the path must have launched during the run
   (nm_spmv decode steps x 16 layers x 7 times), and a second engine over
   the same trace must emit the same tokens and counters (as in phases
   4-6).  Then the same prefills and first decode steps run through the
   kernel route and through the reference route (``impl="ref"``,
   ``attn="gather"``) and the logits are compared; traced eager and
   graphed runs give the busy share (``[profile]``), and ``[coldstart]``
   compares a lazy graphed engine (shapes captured at first use) with a
   prewarmed one.
   Phase 3b: the same trace under ``SparsityConfig(spmv_mode="onehot")``:
   the onehot launcher must serve every decode linear (decode steps x 16
   layers x 7) and the gather one none; tokens compared with phase 3's;
   hard check: full width, 4 layers, float32, 2 slots: onehot tokens
   exactly equal to gather tokens, and each equal to its eager engine's.
4. Serve deepseek-v2-lite-16b: full width at ``DEEPSEEK_SERVE_LAYERS``
   (5) of its 27 layers (1 dense + 4 MoE; cut to keep the run's time
   with phases 11 and 12), d 2048, 16 heads, MLA kv_lora 512 / rope 64 / v 128,
   64 routed experts top-6 + 2 shared of hidden 1408, dense d_ff 10944,
   vocab 102400, bf16, 2:4 compressed at init, random weights from a
   seed; the same engine and trace.  nm_spmv, nm_xwt and paged_mla_decode must launch, the
   latter once per layer per decode tick.  The reference-route check runs
   at full width and reduced depth (1 dense + 3 MoE layers) in float32,
   where no bf16 near-tie can flip a router between the routes, and also
   reports how many router top-k sets agree.
5. Speculative llama3.2-1b (run after phase 3, on its model): the same
   trace through ``ServeEngine(spec=SpecConfig(k=3, draft="rerank"))``,
   fused.  paged_gqa_verify must launch once per layer per verify pass
   (a pass is one call of the engine's verify entry point).  The
   tokens are compared with phase 3's (bf16 decode and verify sum in other
   orders, so a near-tie may flip; the first divergence of each request is
   printed with the plain model's top-2 logit margin there).  Hard check:
   full width, 4 layers, float32, 2 slots: the speculative tokens equal
   the plain engine's exactly, and each equals its eager engine's.
6. Speculative deepseek-v2-lite-16b (after phase 4, on its model):
   ``SpecConfig(k=3, draft="skip", stride=2)``; paged_mla_verify once per
   layer per verify pass; the same comparisons, and the same float32 hard
   check (1 dense + 3 MoE layers, 2 slots: a verify batch of 8 tokens stays
   under the expert-capacity floor of 8, so no route drops).
7. CNN, the paper's domain, at full published shapes: the 15 layers of
   ``CNN_LAYER_CONVS`` (ResNet50, DenseNet121, InceptionV3) as real
   convolutions, f32, at 1:4 and 2:4, batch 1 and 32, through
   ``conv2d_sparse`` (nm_xwt), the paper's orientation ``ops.nm_spmm(W,
   cols^T)`` and dense F.conv2d (TF32 off); both sparse routes within
   1e-4 of F.conv2d, packed nm_xwt bit-equal to int8 where the reference
   accepts the packing; per-layer and per-net times (the card's Fig 11
   analogue); nm_xwt and nm_spmm must have launched; then
   ``repro_torch.launch.cnn`` on the card.
8. Prefix caching and suspend-to-host preemption (run after phase 5, on
   phase 3's model and engine settings): the shared-prefix trace (16
   requests, one of two 120-token system prompts + an 8-token suffix, gen
   16/32; 120 is not a multiple of the block size, so a hit ends
   mid-block and copies on write).  8a, full pool: the non-sharing engine
   against ``prefix_cache=True``; hard checks: exactly the 6 hits the
   schedule gives (weights do not move it), prefills + hits = 16, COW
   copies > 0, nm_spmv launched decode steps x 16 x 7 times; the tokens
   against the non-sharing run are printed (a hit's suffix goes through
   decode, a miss's through prefill, so a bf16 near-tie may flip).  8b, a
   pool of 72 blocks, where both runs preempt: the prefix cache with
   ``preempt="replay"`` against ``"suspend"``; hard checks: preemptions in
   both, swap-outs = swap-ins = preemptions, nothing left on the host,
   suspend ticks <= replay ticks.  Every engine graphed, prewarmed and
   strict, against its eager engine (tokens and counters equal), the pool
   invariants after each run and the index pinning exactly the used
   blocks.  ``[prefix]`` and ``[suspend]`` lines (swap ms: CUDA events
   around ``swap_out`` / ``swap_in`` in the eager suspend engine).  Hard
   check, after phases 5 and 6: full width, 4 layers, float32, 2 slots,
   for llama and deepseek: non-sharing, prefix and prefix + suspend tokens
   exactly equal, each equal to its eager engine's; for deepseek no decode
   route over expert capacity.
9. The slotted layout, the sequential oracle and ``forward`` / ``loss_fn``
   (run after phase 8, on phase 3's model; every slotted engine graphed,
   prewarmed with its trace's prompt lengths, strict, and against its
   eager engine, a flip failing the phase).  9a (the reference's
   BENCH_2 question, phase 3's trace): ``serve_sequential`` (fixed
   batches over slotted rows, each forward a graph) against the
   continuous paged fused engine, tokens/s in the order sequential,
   continuous, continuous, sequential, decode steps and occupancy of
   each; hard: 62 sequential decode steps (2 batches x 31), the oracle
   graphed = eager.
   9b (BENCH_4): paged against slotted at equal usable KV bytes (the
   benchmark's rule at full width: 16 short ragged requests spanning 64
   positions, a budget of 8 requests' blocks, slotted rows of 256 that it
   holds 2 of); hard: paged in fewer ticks.  9c (BENCH_3): the slotted
   engine over dense against compressed weights, decode steps against 9a's
   oracle; hard: the 0.5625 stream ratio.  9d (BENCH_5): 9b's paged
   trace with the gather read against the fused kernel.  Then ``forward``
   on [2, 128] tokens, compressed: the kernel route (nm_xwt) within 0.25
   of the reference route, ``loss_fn``'s loss for both.  The sequential,
   slotted and forward paths' launch counts (nm_spmv decode steps x 16 x
   7, nm_xwt prefills x 16 x 7, paged_gqa_decode none).  Hard check, for
   llama and deepseek after their phases: full width, 4 layers, float32,
   2 slots: slotted = paged = sequential tokens, each graphed = eager,
   ``forward`` within 1e-3 of the reference route.
10. gemma2-9b at full width and ``GEMMA_SERVE_LAYERS`` (8) of its 42
   layers (4 local (window 4096) / global pairs; cut to keep the run's
   time with phase 11), d 3584, 16 / 8 heads of 256, d_ff 14336, vocab
   256000 tied, softcaps 50 / 30, bf16, 2:4 compressed as drawn.  10a:
   phase 3's trace on the paged fused engine, graphed and prewarmed, the
   eager engine beside it; hard: nm_spmv launched decode ticks x 8 x 7
   and paged_gqa_decode ticks x 8 times; the steady tick against its byte
   floor and the ``[profile]`` line.  10c: the same trace with
   ``SpecConfig(k=3, draft="rerank")``.  10b, the window bites: 2
   requests of prompt 4160 + gen 32 (max_len 4224) through the paged
   fused, paged gather and slotted (local rings of 4096) engines and the
   sequential oracle, graphed; tokens/s, KV bytes, bf16 flips with their
   top-2 margins.  10d, hard, float32, 4 layers, 2 slots, prompts 4160
   and 128: slotted = paged = sequential tokens, each graphed = eager;
   ``forward`` at position 4160 against ``prefill`` + ``decode_step`` on
   the slotted rings and the paged pool, a verify span of 4 against 4
   decode steps (equal greedy tokens), and the kernel route against the
   plain route, all within 1e-3.  Then deepseek-67b and
   mistral-large-123b at 2 layers and arctic-480b at 1 MoE layer (with
   its dense residual), full width, bf16: eager prefill [1, 128] + 4
   decode steps, the kernel route within 0.25 of the plain route.
11. The SSM and hybrid families at full width and ``SSM_SERVE_LAYERS``
   depth (cut when phase 12 came, to keep the run's time), bf16, 2:4
   compressed as drawn: 11a falcon-mamba-7b (32 of its 64 Mamba1 layers,
   d 4096, d_inner 8192, state 16, vocab 65024), 11b zamba2-7b (27 of its
   81 Mamba2 layers: 4 of its 13 groups of 6, each followed by the one
   shared attention + MLP block (32 heads of 112, window 4096, d_ff
   14336), and the tail of 3; state 64, 112 heads, vocab 32000).  Each: phase 3's trace on the paged fused
   engine, graphed and prewarmed, the eager engine beside it, a second
   run; hard: nm_spmv launched ticks x the tick's linears (falcon 64 x 4,
   zamba2 81 x 2 + 13 x 7) and paged_gqa_decode ticks x 13; the steady
   tick against its byte floor (the shared block counted at each
   application, the state read and written), ``[profile]``; the same
   trace on paged gather (zamba2), slotted and the sequential oracle; a
   41-block pool, replay against suspend (the state rows swapped with the
   blocks); zamba2's window trace (2 x prompt 4160 + 32) on paged fused /
   gather, slotted and sequential.  11c, hard, float32 (falcon 4 layers,
   zamba2 13: 2 groups and a tail), 2 slots, prompts 37 and 2 (below the
   smallest bucket: replayed from the zero state; zamba2 also 4160):
   slotted = paged = sequential, suspend = replay, each graphed = eager;
   ``forward`` against ``prefill`` + ``decode_step`` (slotted and paged
   fused) within 1e-3, and the kernel route against the plain route
   within 1e-3, end to end for falcon and block by block for zamba2 (its
   15 blocks amplify float32 rounding past 1e-3 end to end; the line
   prints that floor).
12. The last two families at full width (whisper at full depth, qwen2-vl
   at ``ENCDEC_SERVE_LAYERS``, cut for the run's time), bf16, 2:4 compressed
   as drawn, qkv biases drawn nonzero (N(0, 0.5^2); the models zero
   them, as the reference does): 12a whisper-small (12 encoder + 12
   decoder layers, d 768, 12 heads of 64, d_ff 3072 gelu, vocab 51865;
   each request 128 tokens + 1500 encoder frames), 12b qwen2-vl-7b (14
   of its 28 layers, d 3584, 28 / 4 heads of 128, d_ff 18944, vocab 152064;
   embeddings prompts of one drawn length in 100-128 per fixed batch of
   8, padded up to the 128 bucket).  Each: phase 3's trace on the paged
   fused engine, graphed and prewarmed, the eager engine beside it, a
   second run; hard: nm_spmv launched ticks x the tick's linears (whisper
   12 x 9: no cross wk / wv; qwen2-vl 14 x 7), paged_gqa_decode ticks x
   layers, nm_xwt admissions x every linear (whisper 216, qwen2-vl 98);
   the steady tick against its byte floor (whisper's counts every slot's
   cross K/V), ``[profile]``; the same trace on paged gather, slotted,
   the sequential oracle and ``prefix_cache=True`` (hard: no hit); a
   41-block pool, replay against suspend (whisper's cross K/V rows
   swapped with the blocks); qwen2-vl's rerank speculation, whisper's
   ``spec=`` raising ``ValueError``.  12c, hard, float32 (whisper at full
   depth, qwen2-vl 4 layers), 2 slots, prompts 37 and 2 (padded up:
   whisper's 2, both of qwen2-vl's): slotted = paged = sequential,
   suspend = replay (qwen2-vl: spec = plain), each graphed = eager;
   ``forward`` against ``prefill`` + ``decode_step`` (slotted and paged
   fused) and the kernel route against the plain route, within 1e-3.
13. Training (SR-STE, the dense family; no new kernel: the step is plain
   PyTorch).  13a, the reference CLI's defaults at full width and depth:
   llama3.2-1b bf16, srste 2:4, batch 8 x 128, grad_accum 4, remat on,
   AdamW with f32 masters, base_lr 3e-4, warmup 100, 10 steps of
   ``train_loop`` checkpointing into a temp dir: median ms a step after
   step 2, tokens/s, peak memory, first and last loss, the model-FLOP
   share of the dense bf16 peak (6 x parameters x tokens), a ``[profile]``
   of one step (GEMMs, the N:M mask + STE, the accumulation, AdamW,
   other).  13b, the reference's learnable mapping (label = token + 1,
   tokens from the first 32 ids, batch 8 x 128) at full width and depth,
   60 steps at base_lr 3e-3, warmup 5: the last five losses' mean below
   the first five's less 1.0, and below ln 32 - 1.0 (the loss that
   knowing only the labels' range gives, less 1.0).  13c, full width at
   2 layers: 6 steps
   straight against 3, a checkpoint, a fresh ``train_loop`` that
   restores and 3 more (losses within rtol 2e-4, atol 2e-5; the largest
   parameter difference).  13d, f32 at 2 layers: one step on the card
   and on the CPU from the same weights and batch (loss within 1e-5
   relative, every gradient and updated parameter within 1e-4); the bf16
   LM head's hand-written backward at 13a's shape against f32 autograd
   (within one bf16 rounding step of each gradient's largest value).  13e:
   f32 at 4 layers, 3 steps, ``convert_to_compressed``, phase 3's trace
   through the graphed paged fused engine, token for token against
   greedy decode by the trained srste model's ``forward``; then 13b's
   model compressed in bf16 on the same engine (tokens/s); their
   launches are the ``train_serve`` path.
14. Training of the other families (SR-STE; no new kernel), for
   deepseek-v2-lite-16b, gemma2-9b, falcon-mamba-7b, zamba2-7b,
   whisper-small and qwen2-vl-7b.  14a, full width at cut depth
   (``cut_depth``: deepseek 2 = its dense layer and one MoE layer of 64
   experts, gemma2 one local / global pair, falcon 4, zamba2 one group of
   6 and the shared block, whisper whole 12 + 12, qwen2-vl 2): bf16,
   srste 2:4, batch 8 x 128, each config's grad_accum / remat /
   remat_group, AdamW with f32 masters, 6 ``make_train_step`` steps:
   median ms a step after step 2, tokens/s, the model-FLOP share (MoE:
   active parameters; whisper's encoder over its frames), the byte floor
   as 13a's, peak memory, the losses; hard: finite losses and every
   parameter's master moving at every step; a ``[profile]`` of one more
   step for deepseek (expert views under STE) and falcon (the scan under
   autograd).  14b, each reduced f32 config, 2 steps, each on the card
   and on the CPU from the CPU's state: loss within 1e-5 relative,
   gradients and parameters within 1e-4 (an element whose Adam update is
   ill-conditioned within 2 lr).  14c, train -> compress -> serve: f32 at
   full width (2 layers; falcon 4, zamba2 6, whisper 2 + 2), 3 srste
   steps, ``convert_to_compressed``, 4 requests of 64 + 8 through the
   graphed paged fused engine (deepseek at a capacity factor of E, so no
   route drops): tokens equal greedy ``forward`` of the trained model,
   launches equal ticks x the tick's linears / attention layers and
   prefills x the prefill's linears; the ``train_serve_<arch>`` paths.
15. Tensor-parallel serving (``ServeEngine(mesh=)``; no new kernel: the
   kernels run on shards, under the whole shape's launch plan).  15a,
   NCCL at world size 1 in this process: llama3.2-1b at full width and
   depth, compressed, paged, fused, graphed and prewarmed strict (the
   graphs capture the NCCL all-gathers), on phase 3's trace: tokens equal
   phase 3's engine's; the ``tp_nccl`` path.  15b, gloo at world size 2
   on the one card (two child processes, both on cuda:0, their
   collectives staged through host memory, eager): llama3.2-1b bf16 at
   full width and depth, compressed, paged, fused, under
   ``tp_collective="ring"`` and ``"gspmd"``, 4 requests of 64 prompt
   tokens, 8 generated, 4 slots, block 16: every request's tokens equal
   the single-rank engine's on the same trace; the ring bytes the
   transport counted per decode tick, summed over the ranks, equal
   ``serve_ring_traffic_bytes``' (llama's rows fill whole index words:
   no padding); launches per rank nm_spmv = ticks x 112 x 2 (ring) or
   ticks x 112 (gspmd), nm_xwt = prefills x 112, paged_gqa_decode = ticks
   x 16; each rank keeps the whole model on the host and moves only its
   shard to the card (``init_model(store="cpu")``, as ``launch.serve
   --tp`` does): its peak card allocation over engine init and serve
   stays below the whole model's bytes; the tick's ms (one card, two
   processes, gloo through host memory: not a multi-card figure); the
   ``tp_ring`` / ``tp_gspmd`` paths.  15c, f32 at world size 2 over gloo, ring: llama at 4 layers
   and deepseek-v2-lite-16b at 2 (its dense layer and an MoE layer):
   tokens equal the single-rank engine's; the ``tp_f32`` path.
16. Summary: a ``{"kernels": [...]}`` line for all ten launchers, then the
   device line last.  The total time is printed on the ``[done]`` line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
# dense, no sparsity: bf16 and TF32 tensor cores, f32 CUDA cores.  An f32
# N:M product's operations term is the lesser of its N/M MACs on the CUDA
# cores and three TF32 passes over its dense MACs on the tensor cores (the
# split-TF32 body keeps f32 accuracy with three passes), so no f32 N:M
# kernel can read past 100% of its bound (``nm_f32_bound_ms``).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
# one llama3.2-1b decode layer's seven linears (out, in): wq, wk, wv, wo,
# wg, wu, wd
LAYER_SHAPES = [(2048, 2048), (512, 2048), (512, 2048), (2048, 2048),
                (8192, 2048), (8192, 2048), (2048, 8192)]
CHECK_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
# one deepseek-v2-lite MoE layer's linears that the kernels run: wq, wdkv,
# wo and the shared experts' wg, wu, wd in decode (wuk / wuv are read as a
# dense view there), plus wuk and wuv (K = kv_lora 512) in prefill
DS_DECODE_SHAPES = [(3072, 2048), (576, 2048), (2048, 2048),
                    (2816, 2048), (2816, 2048), (2048, 2816)]
DS_PREFILL_SHAPES = DS_DECODE_SHAPES + [(2048, 512), (2048, 512)]
DS_CHECK_SHAPES = [(3072, 2048), (576, 2048), (2048, 512), (2048, 2048),
                   (2816, 2048), (2048, 2816), (10944, 2048), (2048, 10944)]
N, M = 2, 4
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
ATTN_TOL = 2e-4
# Reference-route check (phase 3): logits are O(1) (unit-RMS final state
# against a table with d^-0.5 rows).  The two routes round every linear's
# output to bf16 at different points and 16 layers compound it, so logits
# may move by a few bf16 steps of the residual; 0.25 bounds that with room
# while still failing on any wrong kernel (those move logits by O(1)).
LOGIT_ATOL = 0.25
# Reference-route check (phase 4), float32 over 4 layers: the routes differ
# only by f32 summation order (~1e-7 relative per sum over K <= 10944), so
# logits agree to ~1e-5; 1e-3 leaves room and still fails on any wrong
# kernel or a flipped router top-k set (those move logits by O(0.1)).
LOGIT_ATOL_F32 = 1e-3
# phases 4 and 6: 1 dense + 4 of deepseek-v2-lite's 26 MoE layers (widths
# as published), cut from 27 to 9 when phase 11 came and to 5 when phase
# 12 came, to keep the run's time
DEEPSEEK_SERVE_LAYERS = 5
LLAMA_PATH = ("nm_spmv", "nm_xwt", "paged_gqa_decode")
DEEPSEEK_PATH = ("nm_spmv", "nm_xwt", "paged_mla_decode")
LLAMA_SPEC_PATH = LLAMA_PATH + ("paged_gqa_verify",)
DEEPSEEK_SPEC_PATH = DEEPSEEK_PATH + ("paged_mla_verify",)
SPAN = 4                         # k + 1 of SpecConfig(k=3)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls: int = 10, match: str = "",
              names: bool = False):
    """Device milliseconds per call of ``fn``: the summed time of every
    kernel it launched whose name holds ``match``, from ``torch.profiler``
    over ``calls`` calls (at a few microseconds per linear, the events time
    of ``time_ms`` can read the wrappers' host dispatch rather than the
    kernels).  With ``names``, also {kernel name: launches in the trace}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):     # a trace that comes back empty is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, seen = 0.0, {}
        for ev in prof.key_averages():
            if match not in ev.key or \
                    "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            t = getattr(ev, "self_device_time_total", None) or \
                getattr(ev, "self_cuda_time_total", 0.0)
            if t > 0:
                us += t
                seen[ev.key] = seen.get(ev.key, 0) + ev.count
        if us > 0:
            break
    if us <= 0:
        raise SystemExit("device_ms: the trace recorded no device time")
    ms = us / 1e3 / calls
    return (ms, seen) if names else ms


def max_err(torch, got, want, rtol: float, atol: float):
    """(max |got - want|, whether every element is within atol+rtol|want|)."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), False
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= atol + rtol * w.abs()).all())


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nm_f32_bound_ms(nbytes: float, cols: int, rows: int, k: int, nnz: int):
    """``bound_ms`` of an f32 N:M product of ``cols`` dense columns against
    ``rows`` compressed rows of K (``nnz`` values in all), its operations
    term the faster of the N/M MACs at the f32 CUDA-core rate and three
    TF32 passes over the dense MACs at the tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(2.0 * cols * nnz / PEAK_FLOPS["float32"],
                3 * 2.0 * cols * rows * k / PEAK_FLOPS["tf32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gib(nbytes: float) -> str:
    return f"{nbytes / 2 ** 30:.2f} GiB"


def mib(nbytes: float) -> str:
    return f"{nbytes / 2 ** 20:.1f} MiB"


# ------------------------------------------------------------------ phase 1

def phase_build(torch):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] nvcc {build.nvcc_path()} built {built or 'nothing (cached)'}"
        f" in {time.perf_counter() - t0:.1f}s")
    for name in built:
        for line in build.BUILD_LOG[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)                   # nvidia-smi's own "name, power.limit" line
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return card


# ------------------------------------------------------------------ phase 2

def _compressed(torch, o, k, dtype, gen, n=N):
    """A weight drawn as ``linear_init`` draws it (scale k^-0.5), so the
    products are O(1) as in the model; unscaled, an f32 sum over 8192
    terms of size ~64 carries ~1e-3 of rounding noise in either order."""
    from repro_torch.core.sparsity import compress
    w = (torch.randn(o, k, generator=gen, device="cuda") * k ** -0.5).to(dtype)
    return compress(w, n, M)


def phase_matmuls(torch, F, model: str, check_shapes, spmv_layer,
                  xwt_layer, seed: int, n: int = N, xwt_rows: int = 128):
    """nm_spmv (decode) and nm_xwt (prefill) against their plain versions
    at ``check_shapes`` (nm_xwt at S 4, 32, 128 and ``xwt_rows``); timings
    over one layer's linears in bf16 (``spmv_layer`` at B 8, ``xwt_layer``
    at S ``xwt_rows``), at ``n``:4.  A layer's compressed weights are tens
    of MB, near or above the 50 MB L2."""
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import nm_spmm, nm_spmv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {"nm_spmv": 0.0, "nm_xwt": 0.0}
    ok = True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        rtol, atol = TOL[dname]
        for o, k in check_shapes:
            sp = _compressed(torch, o, k, dtype, gen, n)
            for b in (1, 8):
                x = torch.randn(b, k, generator=gen, device="cuda").to(dtype)
                y = nm_spmv.nm_spmv(x, sp.values, sp.indices, n, M)
                # the gather body's split sums are added in a fixed order:
                # the same inputs give the same bits on a second launch
                same = bool(torch.equal(y, nm_spmv.nm_spmv(
                    x, sp.values, sp.indices, n, M)))
                e, good = max_err(torch, y,
                                  nm_spmv.nm_spmv_plain(x, sp.values, sp.indices, n, M),
                                  rtol, atol)
                errs["nm_spmv"] = max(errs["nm_spmv"], e)
                ok &= good and same
                log(f"[check] nm_spmv {n}:{M} {dname} B={b} (O,K)=({o},{k}) "
                    f"max_abs_err {e:.3e} tol {atol}+{rtol}|ref| "
                    f"{'same bits twice' if same else 'OTHER BITS twice'} "
                    f"{'ok' if good and same else 'FAIL'}")
            # 32: the verify span; whisper's encoder runs its 1500 frames
            for s in sorted({4, 32, 128, xwt_rows}):
                x = torch.randn(s, k, generator=gen, device="cuda").to(dtype)
                e, good = max_err(torch, nm_spmm.nm_xwt(x, sp.values, sp.indices, n, M),
                                  nm_spmm.nm_xwt_plain(x, sp.values, sp.indices, n, M),
                                  rtol, atol)
                errs["nm_xwt"] = max(errs["nm_xwt"], e)
                ok &= good
                log(f"[check] nm_xwt  {n}:{M} {dname} S={s} (O,K)=({o},{k}) "
                    f"max_abs_err {e:.3e} tol {atol}+{rtol}|ref| "
                    f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 2: a matmul kernel disagrees with its plain "
                         f"version at {model} shapes ({n}:{M}), or the gather "
                         f"body gave other bits on a second launch")

    rows = {}
    for name, fn, plain, b, shapes in (
            ("nm_spmv", nm_spmv.nm_spmv, nm_spmv.nm_spmv_plain, 8,
             spmv_layer),
            ("nm_xwt", nm_spmm.nm_xwt, nm_spmm.nm_xwt_plain, xwt_rows,
             xwt_layer)):
        layer = [_compressed(torch, o, k, torch.bfloat16, gen, n)
                 for o, k in shapes]
        dense = [decompress(sp) for sp in layer]
        xs = {k: torch.randn(b, k, generator=gen, device="cuda").to(
            torch.bfloat16) for k in {k for _, k in shapes}}

        def run(f):
            return lambda: [f(xs[sp.dense_shape[1]], sp.values, sp.indices,
                              n, M) for sp in layer]

        nbytes = sum(b * sp.dense_shape[1] * 2 + sp.values.numel() * 3
                     + b * sp.dense_shape[0] * 2 for sp in layer)
        flops = sum(2.0 * b * sp.values.numel() for sp in layer)
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        ms = time_ms(torch, run(fn))
        dev = device_ms(torch, run(fn))
        plain_ms = time_ms(torch, run(plain), iters=5)

        def lib():
            return [F.linear(xs[w.shape[1]], w) for w in dense]
        lib_ms, lib_dev = time_ms(torch, lib), device_ms(torch, lib)
        rows[name] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                          bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                          library_device_ms=lib_dev, max_abs_err=errs[name])
        log(f"[time] {name} one {model} layer ({len(shapes)} linears, "
            f"{n}:{M}, bf16, "
            f"{'B' if name == 'nm_spmv' else 'S'}={b}): kernel {ms:.4f} ms "
            f"(device {dev:.4f} ms), "
            f"bound {bnd:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), plain {plain_ms:.4f} ms, "
            f"F.linear on the decompressed weight {lib_ms:.4f} ms (device "
            f"{lib_dev:.4f} ms)")
        del layer, dense
    return rows


def time_verify_linears(torch, F):
    """What the verify span costs in the linears: a [8, 4, d] span is not
    decode-shaped, so the engine's policy runs one llama layer's seven
    linears through nm_xwt at 32 rows, where a decode tick runs nm_spmv at
    8 rows (2:4, bf16); with nm_xwt's bound and F.linear at 32 rows."""
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import nm_spmm, nm_spmv
    gen = torch.Generator(device="cuda").manual_seed(6)
    layer = [_compressed(torch, o, k, torch.bfloat16, gen)
             for o, k in LAYER_SHAPES]
    dense = [decompress(sp) for sp in layer]
    xs = {rows: {k: torch.randn(rows, k, generator=gen, device="cuda").to(
        torch.bfloat16) for _, k in LAYER_SHAPES} for rows in (8, 32)}

    def run(f, rows):
        return lambda: [f(xs[rows][sp.dense_shape[1]], sp.values, sp.indices,
                          N, M) for sp in layer]
    xwt32 = time_ms(torch, run(nm_spmm.nm_xwt, 32))
    xwt32_dev = device_ms(torch, run(nm_spmm.nm_xwt, 32))
    spmv8 = time_ms(torch, run(nm_spmv.nm_spmv, 8))

    def lib():
        return [F.linear(xs[32][w.shape[1]], w) for w in dense]
    lib32, lib32_dev = time_ms(torch, lib), device_ms(torch, lib)
    nbytes = sum(32 * sp.dense_shape[1] * 2 + sp.values.numel() * 3
                 + 32 * sp.dense_shape[0] * 2 for sp in layer)
    bnd, by = bound_ms(nbytes, sum(2.0 * 32 * sp.values.numel()
                                   for sp in layer), "bfloat16")
    log(f"[time] verify linears: one llama layer through nm_xwt at 32 rows "
        f"(8 slots x span {SPAN}) {xwt32:.4f} ms (device {xwt32_dev:.4f} ms; "
        f"bound {bnd:.4f} ms, {by}; F.linear on the decompressed weights "
        f"{lib32:.4f} ms, device {lib32_dev:.4f} ms), against nm_spmv at 8 "
        f"rows (one decode tick) {spmv8:.4f} ms; {SPAN} decode ticks "
        f"{SPAN * spmv8:.4f} ms")
    return dict(xwt_32_rows_ms=xwt32, xwt_32_rows_device_ms=xwt32_dev,
                spmv_8_rows_ms=spmv8, xwt_32_rows_bound_ms=bnd,
                xwt_32_rows_library_ms=lib32,
                xwt_32_rows_library_device_ms=lib32_dev)


def _row(ms, plain_ms, bnd, by, lib_ms, err):
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms, max_abs_err=err)


def phase_packed_and_onehot(torch, F):
    """The two variants of the serving kernels at one llama3.2-1b layer
    (2:4): nm_xwt with the bit-packed index stream, bit-equal to the int8
    kernel (f32 and bf16, S 4, 32 and 128) and timed at S 128 in bf16 from
    pre-packed words; the onehot nm_spmv body against its plain version
    (B 1 and 8) and timed at B 8 in bf16."""
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import nm_spmm, nm_spmv, ops
    gen = torch.Generator(device="cuda").manual_seed(8)
    ok, e_pk, e_oh = True, 0.0, 0.0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        rtol, atol = TOL[dname]
        for o, k in LAYER_SHAPES:
            sp = _compressed(torch, o, k, dtype, gen)
            for s in (4, 32, 128):
                x = torch.randn(s, k, generator=gen, device="cuda").to(dtype)
                y = ops.nm_xwt(x, sp.values, sp.indices, N, M, packed=True)
                same = bool(torch.equal(y, nm_spmm.nm_xwt(
                    x, sp.values, sp.indices, N, M)))
                e, good = max_err(torch, y, nm_spmm.nm_xwt_plain(
                    x, sp.values, sp.indices, N, M), rtol, atol)
                e_pk, ok = max(e_pk, e), ok and good and same
                log(f"[check] nm_xwt_packed {N}:{M} {dname} S={s} (O,K)=({o},"
                    f"{k}) {'bit-equal' if same else 'NOT bit-equal'} to int8 "
                    f"nm_xwt, max_abs_err {e:.3e} {'ok' if good and same else 'FAIL'}")
            for b in (1, 8):
                x = torch.randn(b, k, generator=gen, device="cuda").to(dtype)
                e, good = max_err(torch, nm_spmv.nm_spmv(
                    x, sp.values, sp.indices, N, M, mode="onehot"),
                    nm_spmv.nm_spmv_onehot_plain(x, sp.values, sp.indices, N,
                                                 M), rtol, atol)
                e_oh, ok = max(e_oh, e), ok and good
                log(f"[check] nm_spmv_onehot {N}:{M} {dname} B={b} (O,K)=({o},"
                    f"{k}) max_abs_err {e:.3e} tol {atol}+{rtol}|ref| "
                    f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2: packed nm_xwt or onehot nm_spmv disagrees")
    layer = [_compressed(torch, o, k, torch.bfloat16, gen)
             for o, k in LAYER_SHAPES]
    # the packed kernel is timed from words packed once, as stored
    words = [ops.pack_block_indices(sp.indices, N, M, (128, 128, 512))
             for sp in layer]
    dense = [decompress(sp) for sp in layer]
    onehot = functools.partial(nm_spmv.nm_spmv, mode="onehot")
    rows = {}
    for name, b, fn, plain, idx in (
            ("nm_xwt_packed", 128, nm_spmm.nm_xwt_packed,
             nm_spmm.nm_xwt_packed_plain, words),
            ("nm_spmv_onehot", 8, onehot, nm_spmv.nm_spmv_onehot_plain,
             [sp.indices for sp in layer])):
        xs = {k: torch.randn(b, k, generator=gen, device="cuda").to(
            torch.bfloat16) for k in {k for _, k in LAYER_SHAPES}}

        def run(f):
            return lambda: [f(xs[sp.dense_shape[1]], sp.values, i, N, M)
                            for sp, i in zip(layer, idx)]
        if name == "nm_xwt_packed":
            flops = sum(2.0 * b * sp.values.numel() for sp in layer)
            err = e_pk
        else:   # the onehot body does the dense MACs (bf16 tensor cores)
            flops = sum(2.0 * b * sp.dense_shape[0] * sp.dense_shape[1]
                        for sp in layer)
            err = e_oh
        peak = "bfloat16"
        nbytes = sum(b * sp.dense_shape[1] * 2 + sp.values.numel() * 2
                     + b * sp.dense_shape[0] * 2 + i.numel() * i.element_size()
                     for sp, i in zip(layer, idx))
        bnd, by = bound_ms(nbytes, flops, peak)
        ms, dev = time_ms(torch, run(fn)), device_ms(torch, run(fn))
        plain_ms = time_ms(torch, run(plain), iters=5)

        def lib():
            return [F.linear(xs[w.shape[1]], w) for w in dense]
        lib_ms, lib_dev = time_ms(torch, lib), device_ms(torch, lib)
        rows[name] = dict(_row(ms, plain_ms, bnd, by, lib_ms, err),
                          device_ms=dev, library_device_ms=lib_dev)
        log(f"[time] {name} one llama3.2-1b layer (7 linears, {N}:{M}, bf16, "
            f"{'S' if name == 'nm_xwt_packed' else 'B'}={b}): kernel "
            f"{ms:.4f} ms (device {dev:.4f} ms), bound {bnd:.4f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the {peak} "
            f"rate), plain {plain_ms:.4f} ms, F.linear on the decompressed "
            f"weight {lib_ms:.4f} ms (device {lib_dev:.4f} ms)")
    check_same_bits_twice(torch, layer, words, gen)
    return rows


def check_same_bits_twice(torch, layer, words, gen) -> None:
    """The tensor-core bodies' split sums are added in a fixed order: the
    same inputs give the same bits on a second launch (onehot at B 8,
    nm_xwt int8 at S 32 and 128, packed at S 128; bf16, one llama
    layer)."""
    from repro_torch.kernels import nm_spmm, nm_spmv
    cases = (("nm_spmv_onehot B=8", 8, lambda x, sp, w: nm_spmv.nm_spmv(
                 x, sp.values, sp.indices, N, M, mode="onehot")),
             ("nm_xwt S=32", 32, lambda x, sp, w: nm_spmm.nm_xwt(
                 x, sp.values, sp.indices, N, M)),
             ("nm_xwt S=128", 128, lambda x, sp, w: nm_spmm.nm_xwt(
                 x, sp.values, sp.indices, N, M)),
             ("nm_xwt_packed S=128", 128, lambda x, sp, w:
              nm_spmm.nm_xwt_packed(x, sp.values, w, N, M)))
    ok = True
    for label, rows, f in cases:
        same = 0
        for sp, w in zip(layer, words):
            x = torch.randn(rows, sp.dense_shape[1], generator=gen,
                            device="cuda").to(torch.bfloat16)
            same += bool(torch.equal(f(x, sp, w), f(x, sp, w)))
        ok &= same == len(layer)
        log(f"[check] {label}: same inputs twice, {same}/{len(layer)} layer "
            f"shapes bit-equal {'ok' if same == len(layer) else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2: a tensor-core body gave other bits on a "
                         "second launch of the same inputs")


def phase_spmm_check(torch):
    """nm_spmm against nm_spmm_plain over 1:4 / 2:4 / 2:8 in f32 and bf16 at
    the reference's ragged (130, 96, 520) and three CNN GEMMs (R, C, K):
    densenet121 L1 at batch 1, and resnet50 conv5_3x3 and inceptionv3
    mix7_3x3 at batch 1, whose f32 plans split K.  In f32 the split shapes
    also run twice through nm_spmm and nm_xwt (the same GEMM transposed),
    which must give the same bits."""
    from repro_torch.core.sparsity import compress
    from repro_torch.kernels import nm_spmm
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst, ok = 0.0, True
    sms = nm_spmm.sm_count(torch.device("cuda"))
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        rtol, atol = TOL[dname]
        for n, m in ((1, 4), (2, 4), (2, 8)):
            for r, c, k in ((130, 96, 520), (64, 12544, 152), (512, 49, 4608),
                            (384, 64, 1152)):
                w = (torch.randn(r, k, generator=gen, device="cuda")
                     * k ** -0.5).to(dtype)
                sp = compress(w, n, m)
                b = torch.randn(k, c, generator=gen, device="cuda").to(dtype)
                y = nm_spmm.nm_spmm(sp.values, sp.indices, b, n, m)
                e, good = max_err(torch, y, nm_spmm.nm_spmm_plain(
                    sp.values, sp.indices, b, n, m), rtol, atol)
                worst, ok = max(worst, e), ok and good
                plan = nm_spmm.f32_plan(r, c, k, n, m, sms) \
                    if dtype == torch.float32 else None
                splits = plan.splits if plan else 1
                log(f"[check] nm_spmm {n}:{m} {dname} (R,C,K)=({r},{c},{k}) "
                    f"splits {splits} max_abs_err {e:.3e} tol {atol}+{rtol}"
                    f"|ref| {'ok' if good else 'FAIL'}")
                if splits > 1:
                    x = b.t().contiguous()
                    xw = nm_spmm.nm_xwt(x, sp.values, sp.indices, n, m)
                    same = bool(torch.equal(y, nm_spmm.nm_spmm(
                        sp.values, sp.indices, b, n, m))) and bool(
                        torch.equal(xw, nm_spmm.nm_xwt(x, sp.values,
                                                       sp.indices, n, m)))
                    ok = ok and same
                    log(f"[check] nm_spmm / nm_xwt {n}:{m} f32 split K "
                        f"({splits} splits): same inputs twice, bit-equal "
                        f"{'ok' if same else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2: nm_spmm disagrees with its plain version "
                         "or gave other bits on a second launch")
    return worst


def _live_pairs(torch, sq, sk, causal, window, q_off):
    """(query, key) pairs the mask keeps: the work this input needs."""
    qpos = q_off + torch.arange(sq, device="cuda")[:, None]
    kpos = torch.arange(sk, device="cuda")[None, :]
    live = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        live &= qpos >= kpos
    if window is not None:
        live &= qpos - kpos < window
    return int(live.sum())


# (label, BH, Sq, Sk, d, dv, kwargs): llama prefill (8 sequences x 32 heads),
# gemma2-9b's local layer (d 256, window 4096, softcap 50) at S 8192 with
# BH kept small, deepseek's MLA prefill (8 x 16 heads, d 192, dv 128), and
# a q_off slice (queries 512..639 of 1024 keys)
FLASH_CASES = [
    ("llama prefill", 8 * 32, 128, 128, 64, 64, dict()),
    ("gemma2 local", 2, 8192, 8192, 256, 256, dict(window=4096, cap=50.0)),
    ("mla prefill", 8 * 16, 128, 128, 192, 128, dict()),
    ("q_off slice", 32, 128, 1024, 64, 64, dict(q_off=512)),
]


def phase_flash(torch, F):
    """flash_attention_kernel against flash_attention_plain and the port's
    chunked_attention (the suffix cases; the q_off slice against the rows
    of a full run), f32 and bf16, then timed in bf16 beside its bound, the
    plain version and SDPA (where one SDPA call computes the same function:
    not with a softcap).  Then the entry-point run: counts zeroed, each case
    launched once through ``flash_attention_kernel``, counts read."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import chunked_attention
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst, ok, cases = 0.0, True, {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = 3e-2 if dtype == torch.bfloat16 else ATTN_TOL
        for label, bh, sq, sk, d, dv, kw in FLASH_CASES:
            if label == "gemma2 local" and dtype == torch.float32:
                bh = 1                 # the f32 plain scores are 256 MB/head
            off = kw.get("q_off", sk - sq)
            q_all = torch.randn(bh, sk, d, generator=gen,
                                device="cuda").to(dtype)
            q = q_all[:, off:off + sq].contiguous()
            k = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(bh, sk, dv, generator=gen, device="cuda").to(dtype)
            out = fa.flash_attention_kernel(q, k, v, **kw)
            e, good = max_err(torch, out, fa.flash_attention_plain(
                q, k, v, **kw), tol, tol)
            if "q_off" in kw:
                other = fa.flash_attention_plain(q_all, k, v)[:, off:off + sq]
                what = "rows of a full plain run"
            else:
                other = chunked_attention(
                    q[:, :, None, :], k[:, :, None, :], v[:, :, None, :],
                    causal=kw.get("causal", True), window=kw.get("window"),
                    cap=kw.get("cap"))[:, :, 0, :]
                what = "chunked_attention"
            e2, good2 = max_err(torch, out, other, tol, tol)
            worst, ok = max(worst, e, e2), ok and good and good2
            log(f"[check] flash_attention {label} {dname} BH={bh} Sq={sq} "
                f"Sk={sk} d={d} dv={dv} {kw or ''}: max_abs_err {e:.3e} vs "
                f"plain, {e2:.3e} vs {what}, tol {tol}+{tol}|ref| "
                f"{'ok' if good and good2 else 'FAIL'}")
            if dtype == torch.bfloat16:
                cases[label] = (q, k, v, kw)
    if not ok:
        raise SystemExit("phase 2: flash_attention disagrees with its plain "
                         "version or chunked_attention")
    timings = {}
    for label, bh, sq, sk, d, dv, kw in FLASH_CASES:
        q, k, v, kw = cases[label]
        q_off = kw.get("q_off", sk - sq)
        pairs = bh * _live_pairs(torch, sq, sk, kw.get("causal", True),
                                 kw.get("window"), q_off)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + bh * sq * dv)
        bnd, by = bound_ms(nbytes, 2.0 * pairs * (d + dv), "bfloat16")
        iters = 3 if sq >= 4096 else 20
        ms = time_ms(torch, lambda: fa.flash_attention_kernel(q, k, v, **kw),
                     iters=iters, warmup=1)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, **kw), iters=iters, warmup=1)
        dev = device_ms(torch, lambda: fa.flash_attention_kernel(
            q, k, v, **kw), iters)
        lib_ms = lib_dev = None
        if "cap" not in kw:
            qpos = q_off + torch.arange(sq, device="cuda")[:, None]
            kpos = torch.arange(sk, device="cuda")[None, :]
            mask = qpos >= kpos
            if kw.get("window") is not None:
                mask &= qpos - kpos < kw["window"]
            qq, kk, vv = q[:, None], k[:, None], v[:, None]

            def lib():
                return F.scaled_dot_product_attention(qq, kk, vv,
                                                      attn_mask=mask)
            lib_ms = time_ms(torch, lib, iters=iters, warmup=1)
            lib_dev = device_ms(torch, lib, iters)
        chunk_ms = time_ms(torch, lambda: chunked_attention(
            q[:, :, None, :], k[:, :, None, :], v[:, :, None, :],
            **{a: kw[a] for a in ("window", "cap") if a in kw}),
            iters=iters, warmup=1) if "q_off" not in kw else None
        timings[label] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                              bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                              library_device_ms=lib_dev,
                              chunked_attention_ms=chunk_ms)
        log(f"[time] flash_attention {label} (bf16, BH {bh}, Sq {sq}, Sk "
            f"{sk}, d {d}, dv {dv}{', ' + str(kw) if kw else ''}): kernel "
            f"{ms:.4f} ms (device {dev:.4f} ms), bound {bnd:.4f} ms ({by}, "
            f"{pairs / 1e6:.1f} M live pairs, {nbytes / 1e6:.1f} MB), plain "
            f"{plain_ms:.4f} ms, SDPA "
            f"{'n/a (no softcap in SDPA)' if lib_ms is None else f'{lib_ms:.4f} ms (device {lib_dev:.4f} ms)'}"
            f", chunked_attention "
            f"{'n/a' if chunk_ms is None else f'{chunk_ms:.4f} ms'}")
    kernels.reset_launch_counts()
    for label in cases:
        q, k, v, kw = cases[label]
        fa.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    launches = {kk.name: kk.launches for kk in kernels.all_kernels()}
    if launches["flash_attention"] != len(cases):
        raise SystemExit(f"phase 2: flash_attention entry point launched "
                         f"{launches['flash_attention']} times for "
                         f"{len(cases)} calls")
    log(f"[flash] entry-point run: {len(cases)} calls, launches {launches}")
    row = dict(timings["llama prefill"], max_abs_err=worst,
               at_cases={k: v for k, v in timings.items()})
    return row, {"flash entry point": launches}


def _paged_table(torch, gen, lens, bs):
    """A shuffled table: slot r owns ceil(lens[r] / bs) distinct blocks
    >= 1; the rest of its row names trash block 0."""
    b = len(lens)
    tw = -(-max(lens) // bs)
    nb = b * tw + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tbl = torch.zeros(b, tw, dtype=torch.int32, device="cuda")
    for r, n in enumerate(lens):
        own = -(-n // bs)
        tbl[r, :own] = perm[r * tw:r * tw + own]
    return tbl, nb


def _paged_inputs(torch, dtype, gen, lens, kvh=8, g=4, d=64, bs=16):
    b = len(lens)
    tbl, nb = _paged_table(torch, gen, lens, bs)
    kp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    kp[0] = 1e4                 # hot trash block: the mask must zero it
    vp[0] = 1e4
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tbl, kv_len


SERVE_LENS = [1, 16, 17, 64, 100, 128, 145, 160]   # ragged kv_len, 8 slots


def phase_attention(torch, F):
    """paged_gqa_decode at the llama serving shape: 8 slots, KVH 8, G 4,
    d 64, block 16, ragged kv_len, shuffled table."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    lens = SERVE_LENS
    worst, ok = 0.0, True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        args = _paged_inputs(torch, dtype, gen, lens)
        for case in (dict(), dict(window=48, cap=30.0)):
            e, good = max_err(torch, fa.paged_gqa_decode(*args, scale=0.125, **case),
                              fa.paged_gqa_decode_plain(*args, scale=0.125, **case),
                              ATTN_TOL, ATTN_TOL)
            worst, ok = max(worst, e), ok and good
            log(f"[check] paged_gqa_decode {dname} {case or 'plain mask'} "
                f"max_abs_err {e:.3e} tol {ATTN_TOL}+{ATTN_TOL}|ref| "
                f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2: paged_gqa_decode disagrees with its plain "
                         "version")
    q, kp, vp, tbl, kv_len = _paged_inputs(torch, torch.bfloat16, gen, lens)
    b, kvh, g, d = q.shape
    length = tbl.shape[1] * kp.shape[1]
    ms = time_ms(torch, lambda: fa.paged_gqa_decode(q, kp, vp, tbl, kv_len,
                                                    scale=0.125), iters=50)
    plain_ms = time_ms(torch, lambda: fa.paged_gqa_decode_plain(
        q, kp, vp, tbl, kv_len, scale=0.125), iters=20)
    # yardstick: SDPA over the K/V gathered into position order (gather and
    # head expansion outside the timed call)
    kr = kp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
    vr = vp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
    kr, vr = kr.transpose(1, 2).contiguous(), vr.transpose(1, 2).contiguous()
    qq = q.reshape(b, kvh * g, 1, d)
    mask = (torch.arange(length, device="cuda")[None, :]
            < kv_len[:, None].long())[:, None, None, :]
    def lib():
        return F.scaled_dot_product_attention(qq, kr, vr, attn_mask=mask,
                                              scale=0.125)
    lib_ms = time_ms(torch, lib, iters=50)
    dev = device_ms(torch, lambda: fa.paged_gqa_decode(
        q, kp, vp, tbl, kv_len, scale=0.125), 50)
    lib_dev = device_ms(torch, lib, 50)
    pos = sum(lens)
    nbytes = (q.numel() * 2 + pos * kvh * 2 * d * 2 + tbl.numel() * 4
              + b * 4 + b * kvh * g * d * 4)
    flops = 2.0 * pos * kvh * g * 2 * d
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"[time] paged_gqa_decode one launch (bf16, 8 slots, kv_len {lens}): "
        f"kernel {ms:.4f} ms (device {dev:.4f} ms), bound {bnd:.5f} ms ({by},"
        f" {nbytes / 1e6:.2f} MB), plain {plain_ms:.4f} ms, SDPA on gathered "
        f"K/V {lib_ms:.4f} ms (device {lib_dev:.4f} ms)")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev,
                max_abs_err=worst)


# paged GQA at 8 slots, each model's serving shape.  Windowed: two rows
# past the window, one at it, short ones (row 0, the masked row of a span
# table, reads trash only).  gemma2-9b: KVH 8, G 2, d 256, window 4096,
# softcap 50, decode and verify; zamba2-7b's shared block: KVH 32, G 1
# (multi-head), d 112, window 4096, no softcap, decode only (its family
# takes no speculation).  No window, ``LONG_LENS`` (up to 2100): whisper-
# small's decoder self-attention (KVH 12, G 1, d 64, decode only: no
# speculation) and qwen2-vl-7b's (KVH 4, G 7: 7 of an mma tile's 16 rows,
# 28 rows a kv head at span 4; d 128), decode and verify
WINDOW_LENS = [1, 4160, 4100, 4096, 17, 700, 64, 2]
GEMMA_WINDOW, GEMMA_CAP = 4096, 50.0
LONG_LENS = [1, 2100, 1000, 17, 16, 15, 64, 65]
ATTN_SHAPES = {"gemma2-9b": dict(kvh=8, g=2, d=256, cap=GEMMA_CAP,
                                 spans=(1, SPAN), window=GEMMA_WINDOW,
                                 lens=WINDOW_LENS),
               "zamba2-7b": dict(kvh=32, g=1, d=112, cap=None, spans=(1,),
                                 window=GEMMA_WINDOW, lens=WINDOW_LENS),
               "whisper-small": dict(kvh=12, g=1, d=64, cap=None, spans=(1,),
                                     window=None, lens=LONG_LENS),
               "qwen2-vl-7b": dict(kvh=4, g=7, d=128, cap=None,
                                   spans=(1, SPAN), window=None,
                                   lens=LONG_LENS)}


def _window_mask(torch, kv_len, s, length, window):
    """[B, 1, S, length] mask of a span (under a window): offset i sees
    positions (kv_len + i - 1 - window, kv_len + i - 1]."""
    top = kv_len.long()[:, None] + torch.arange(s, device="cuda")
    idx = torch.arange(length, device="cuda")[None, None, :]
    mask = idx < top[:, :, None]
    if window is not None:
        mask &= idx >= top[:, :, None] - window
    return mask[:, None]


def phase_window_attention(torch, F, model):
    """paged_gqa_decode (S 1) and, where the model speculates,
    paged_gqa_verify (S 4) at ``model``'s serving shape (``ATTN_SHAPES``):
    8 slots, block 16, its window (or none) and kv_len; f32 (the first
    body) and bf16 (the tensor-core body) against the plain versions,
    verify also against S decode launches bit for bit.  bf16 timed beside
    the bound (the positions each row's window reads) and SDPA over the
    gathered K/V under the same mask; SDPA has no softcap, so with one it
    computes the uncapped function.  Returns the decode (and verify)
    rows."""
    from repro_torch.kernels import flash_attention as fa
    shape = ATTN_SHAPES[model]
    gen = torch.Generator(device="cuda").manual_seed(12)
    lens, bs = shape["lens"], 16
    b = len(lens)
    kvh, g, d, cap = shape["kvh"], shape["g"], shape["d"], shape["cap"]
    win, scale = shape["window"], d ** -0.5
    what = (f"KVH {kvh}, G {g}, d {d}, "
            + (f"window {win}" if win is not None else "no window")
            + (f", cap {cap}" if cap is not None else ", no cap"))
    kw = dict(scale=scale, window=win, cap=cap)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    inputs, worst, ok = {}, {s: 0.0 for s in shape["spans"]}, True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for s in shape["spans"]:
            tbl, nb = _span_table(torch, gen, lens, s, bs)
            kp = torch.randn(nb, bs, kvh, d, generator=gen,
                             device="cuda").to(dtype)
            vp = torch.randn(nb, bs, kvh, d, generator=gen,
                             device="cuda").to(dtype)
            kp[0] = 1e4
            vp[0] = 1e4
            q = torch.randn(b, s, kvh, g, d, generator=gen,
                            device="cuda").to(dtype)
            inputs[dname, s] = (q, kp, vp, tbl)
            plan = fa.gqa_plan(b, s, kvh, g, d, d, bs, tbl.shape[1], dtype)
            if s == 1:
                name = "paged_gqa_decode"
                out = fa.paged_gqa_decode(q[:, 0].contiguous(), kp, vp, tbl,
                                          kv_len, **kw)
                want = fa.paged_gqa_decode_plain(q[:, 0].contiguous(), kp,
                                                 vp, tbl, kv_len, **kw)
                same = True
            else:
                name = "paged_gqa_verify"
                out = fa.paged_gqa_verify(q, kp, vp, tbl, kv_len, **kw)
                want = fa.paged_gqa_verify_plain(q, kp, vp, tbl, kv_len, **kw)
                dec = torch.stack([fa.paged_gqa_decode(
                    q[:, i].contiguous(), kp, vp, tbl, kv_len + i, **kw)
                    for i in range(s)], 1)
                same = bool(torch.equal(out, dec))
            e, good = max_err(torch, out, want, ATTN_TOL, ATTN_TOL)
            worst[s], ok = max(worst[s], e), ok and good and same
            log(f"[check] {name} {model} {dname} ({what}, kv_len {lens}, "
                f"{plan.body} body, {plan.smem} B shared memory of "
                f"{fa.SMEM_LIMIT}) max_abs_err {e:.3e} tol "
                f"{ATTN_TOL}+{ATTN_TOL}|ref|"
                + ("" if s == 1 else
                   f", offsets vs decode at kv_len + i "
                   f"{'bitwise equal' if same else 'NOT bitwise'}")
                + f" {'ok' if good and same else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 2: paged GQA attention disagrees with its "
                         f"plain version at {model}'s shape")
    rows = {}
    for s in shape["spans"]:
        name = "paged_gqa_decode" if s == 1 else "paged_gqa_verify"
        q, kp, vp, tbl = inputs["bfloat16", s]
        if s == 1:
            q1 = q[:, 0].contiguous()

            def run():
                return fa.paged_gqa_decode(q1, kp, vp, tbl, kv_len, **kw)

            def plain():
                return fa.paged_gqa_decode_plain(q1, kp, vp, tbl, kv_len,
                                                 **kw)
        else:
            def run():
                return fa.paged_gqa_verify(q, kp, vp, tbl, kv_len, **kw)

            def plain():
                return fa.paged_gqa_verify_plain(q, kp, vp, tbl, kv_len,
                                                 **kw)
        length = tbl.shape[1] * bs
        kr = kp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
        vr = vp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
        kr = kr.transpose(1, 2).contiguous()
        vr = vr.transpose(1, 2).contiguous()
        qq = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, d)
        mask = _window_mask(torch, kv_len, s, length, win)

        def lib():
            return F.scaled_dot_product_attention(qq, kr, vr, attn_mask=mask,
                                                  scale=scale)
        ms, dev = time_ms(torch, run, iters=50), device_ms(torch, run, 50)
        plain_ms = time_ms(torch, plain, iters=5)
        lib_ms, lib_dev = time_ms(torch, lib, iters=20), device_ms(torch,
                                                                   lib, 20)
        # each row reads its span's window once; offset i scores min(n + i,
        # window) positions
        lim = win if win is not None else max(lens) + s
        read = sum(min(n + s - 1, lim + s - 1) for n in lens)
        seen = sum(min(n + i, lim) for n in lens for i in range(s))
        nbytes = (q.numel() * 2 + read * kvh * 2 * d * 2 + tbl.numel() * 4
                  + b * 4 + b * s * kvh * g * d * 4)
        bnd, by = bound_ms(nbytes, 2.0 * seen * kvh * g * 2 * d, "bfloat16")
        sdpa = ("SDPA on the gathered K/V under the same mask"
                + (", without the softcap (SDPA has none)"
                   if cap is not None else ""))
        log(f"[time] {name} one launch at {model}'s shape (bf16, 8 slots x "
            f"span {s}, {what}, kv_len {lens}): kernel {ms:.4f} ms (device "
            f"{dev:.4f} ms), bound {bnd:.5f} ms ({by}, {nbytes / 1e6:.2f} "
            f"MB), plain {plain_ms:.4f} ms, {sdpa} {lib_ms:.4f} ms (device "
            f"{lib_dev:.4f} ms)")
        rows[name] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                          bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                          library_device_ms=lib_dev, max_abs_err=worst[s])
        if cap is not None:
            rows[name]["library_note"] = "SDPA without the softcap"
    return rows


def _mla_inputs(torch, dtype, gen, lens, h=16, r=512, rd=64, bs=16):
    tbl, nb = _paged_table(torch, gen, lens, bs)
    cp = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)
    pp = torch.randn(nb, bs, rd, generator=gen, device="cuda").to(dtype)
    cp[0] = 1e4                 # hot trash block: the mask must zero it
    pp[0] = 1e4
    ql = torch.randn(len(lens), h, r, generator=gen, device="cuda")
    qp = torch.randn(len(lens), h, rd, generator=gen, device="cuda")
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return ql, qp, cp, pp, tbl, kv_len


def phase_mla_attention(torch, F):
    """paged_mla_decode at the deepseek serving shape: 8 slots, 16 heads,
    kv_lora 512, rope 64, block 16, ragged kv_len, shuffled table, f32
    queries against f32 or bf16 pools."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)
    lens = SERVE_LENS
    scale = (128 + 64) ** -0.5          # (qk_nope + qk_rope) ** -0.5
    worst, ok = 0.0, True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        args = _mla_inputs(torch, dtype, gen, lens)
        e, good = max_err(torch, fa.paged_mla_decode(*args, scale=scale),
                          fa.paged_mla_decode_plain(*args, scale=scale),
                          ATTN_TOL, ATTN_TOL)
        worst, ok = max(worst, e), ok and good
        log(f"[check] paged_mla_decode {dname} pools max_abs_err {e:.3e} "
            f"tol {ATTN_TOL}+{ATTN_TOL}|ref| {'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2: paged_mla_decode disagrees with its plain "
                         "version")
    ql, qp, cp, pp, tbl, kv_len = _mla_inputs(torch, torch.bfloat16, gen, lens)
    b, h, r = ql.shape
    rd = qp.shape[-1]
    length = tbl.shape[1] * cp.shape[1]
    ms = time_ms(torch, lambda: fa.paged_mla_decode(
        ql, qp, cp, pp, tbl, kv_len, scale=scale), iters=50)
    plain_ms = time_ms(torch, lambda: fa.paged_mla_decode_plain(
        ql, qp, cp, pp, tbl, kv_len, scale=scale), iters=20)
    # yardstick: SDPA on the latent gathered into position order (outside
    # the timed call), q = [q_lat | q_pe], k = [ckv | kpe], v = ckv, one kv
    # head shared by the 16 query heads
    ck = cp[tbl.long()].reshape(b, 1, length, r)
    kk = torch.cat([ck, pp[tbl.long()].reshape(b, 1, length, rd)], -1)
    kk = kk.expand(b, h, length, r + rd)
    vv = ck.expand(b, h, length, r)
    qq = torch.cat([ql, qp], -1).to(torch.bfloat16).reshape(b, h, 1, r + rd)
    mask = (torch.arange(length, device="cuda")[None, :]
            < kv_len[:, None].long())[:, None, None, :]
    def lib():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              scale=scale)
    lib_ms = time_ms(torch, lib, iters=50)
    dev = device_ms(torch, lambda: fa.paged_mla_decode(
        ql, qp, cp, pp, tbl, kv_len, scale=scale), 50)
    lib_dev = device_ms(torch, lib, 50)
    pos = sum(lens)
    nbytes = (ql.numel() * 4 + qp.numel() * 4 + pos * (r + rd) * 2
              + tbl.numel() * 4 + b * 4 + b * h * r * 4)
    flops = 2.0 * pos * h * (r + rd + r)
    bnd, by = bound_ms(nbytes, flops, "float32")
    log(f"[time] paged_mla_decode one launch (bf16 pools, 8 slots, 16 heads, "
        f"kv_len {lens}): kernel {ms:.4f} ms (device {dev:.4f} ms), bound "
        f"{bnd:.5f} ms ({by}, {nbytes / 1e6:.2f} MB), plain {plain_ms:.4f} "
        f"ms, SDPA on the gathered latent {lib_ms:.4f} ms (device "
        f"{lib_dev:.4f} ms)")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev,
                max_abs_err=worst)


def _span_table(torch, gen, lens, s, bs):
    """A shuffled table backing each slot's whole verify span (kv_len + s - 1
    positions); row 0 is a masked row (all trash), as the engine's."""
    tbl, nb = _paged_table(torch, gen, [n + s - 1 for n in lens], bs)
    tbl[0] = 0
    return tbl, nb


def _span_mask(torch, kv_len, s, length):
    """[B, 1, S, length] offset-causal mask: offset i sees kv_len + i."""
    lens = kv_len.long()[:, None] + torch.arange(s, device="cuda")
    return (torch.arange(length, device="cuda")[None, None, :]
            < lens[:, :, None])[:, None]


def _against_decode(torch, verify, decode, name, dname, case, tol):
    """(max |verify - S decode launches|, within tol, bitwise equal)."""
    e, good = max_err(torch, verify, decode, tol, tol)
    same = bool(torch.equal(verify, decode))
    log(f"[check] {name} {dname} {case or 'plain mask'} vs {SPAN} decode "
        f"launches at kv_len + i: max_abs_err {e:.3e} tol {tol}+{tol}|ref| "
        f"{'bitwise equal' if same else 'not bitwise'} "
        f"{'ok' if good else 'FAIL'}")
    return e, good, same


# views of several 64-position chunks (the cross-CTA fold of the
# tensor-core bodies), chunk edges, and a row of trash blocks only (row 0)
LONG_LENS = [1, 2100, 1000, 17, 16, 15, 64, 65]


def _long_inputs(torch, gen, dtype, kshape, vshape, qshape, bs):
    """Pools of LONG_LENS plus the span behind a span table, hot (1e4)
    trash block; f32 queries of each shape in ``qshape`` (MLA: a list) or
    one query of the pool dtype (GQA)."""
    s = qshape[0][0] if isinstance(qshape, list) else qshape[0]
    tbl, nb = _span_table(torch, gen, LONG_LENS, s, bs)
    kp = torch.randn(nb, bs, *kshape, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, *vshape, generator=gen, device="cuda").to(dtype)
    kp[0] = 1e4
    vp[0] = 1e4
    b = len(LONG_LENS)
    if isinstance(qshape, list):
        q = [torch.randn(b, *sh, generator=gen, device="cuda")
             for sh in qshape]
    else:
        q = torch.randn(b, *qshape, generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(LONG_LENS, dtype=torch.int32, device="cuda")
    return q, kp, vp, tbl, kv_len


def check_long_context(torch, name, what, launch, plain, decode, s):
    """[check] lines at LONG_LENS: the verify wrapper against its plain
    version, a second launch bit for bit, and offset i against the decode
    wrapper at kv_len + i bit for bit.  Returns (max_abs_err, all held)."""
    out = launch()
    e, good = max_err(torch, out, plain(), ATTN_TOL, ATTN_TOL)
    twice = bool(torch.equal(launch(), out))
    same = all(bool(torch.equal(out[:, i], decode(i))) for i in range(s))
    log(f"[check] {name} {what} long context (kv_len {LONG_LENS}, span {s})"
        f" max_abs_err {e:.3e} tol {ATTN_TOL}+{ATTN_TOL}|ref| "
        f"{'ok' if good else 'FAIL'}")
    log(f"[check] {name} {what} long context: second launch "
        f"{'same bits' if twice else 'DIFFERENT bits'}, offsets vs decode at "
        f"kv_len + i {'bitwise equal' if same else 'NOT bitwise'} "
        f"{'ok' if twice and same else 'FAIL'}")
    return e, good and twice and same


def phase_verify_attention(torch, F):
    """paged_gqa_verify at the llama speculative shape: 8 slots x span 4,
    KVH 8, G 4, d 64, block 16, kv_len 1..160 (spans crossing block
    boundaries; row 0 a masked trash row), against its plain version and
    against S decode launches."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(4)
    lens, s, bs, kvh, g, d = SERVE_LENS, SPAN, 16, 8, 4, 64
    b = len(lens)
    worst, worst_dec, ok, bitwise = 0.0, 0.0, True, True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tbl, nb = _span_table(torch, gen, lens, s, bs)
        kp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
        vp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
        kp[0] = 1e4             # hot trash block: the mask must zero it
        vp[0] = 1e4
        q = torch.randn(b, s, kvh, g, d, generator=gen, device="cuda").to(dtype)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (q, kp, vp, tbl, kv_len)
        for case in (dict(), dict(window=48, cap=30.0)):
            out = fa.paged_gqa_verify(q, kp, vp, tbl, kv_len, scale=0.125,
                                      **case)
            e, good = max_err(torch, out, fa.paged_gqa_verify_plain(
                q, kp, vp, tbl, kv_len, scale=0.125, **case),
                ATTN_TOL, ATTN_TOL)
            log(f"[check] paged_gqa_verify {dname} {case or 'plain mask'} "
                f"max_abs_err {e:.3e} tol {ATTN_TOL}+{ATTN_TOL}|ref| "
                f"{'ok' if good else 'FAIL'}")
            dec = torch.stack([fa.paged_gqa_decode(
                q[:, i].contiguous(), kp, vp, tbl, kv_len + i, scale=0.125,
                **case) for i in range(s)], 1)
            ed, goodd, same = _against_decode(torch, out, dec,
                                              "paged_gqa_verify", dname, case,
                                              ATTN_TOL)
            worst, worst_dec = max(worst, e), max(worst_dec, ed)
            ok, bitwise = ok and good and goodd, bitwise and same
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        q, kp, vp, tbl, kv_len = _long_inputs(torch, gen, dtype, (kvh, d),
                                              (kvh, d), (s, kvh, g, d), bs)
        for case in (dict(), dict(window=48, cap=30.0)):
            kw = dict(scale=0.125, **case)
            e, good = check_long_context(
                torch, "paged_gqa_verify", f"{dname} {case or 'plain mask'}",
                lambda: fa.paged_gqa_verify(q, kp, vp, tbl, kv_len, **kw),
                lambda: fa.paged_gqa_verify_plain(q, kp, vp, tbl, kv_len,
                                                  **kw),
                lambda i: fa.paged_gqa_decode(q[:, i].contiguous(), kp, vp,
                                              tbl, kv_len + i, **kw), s)
            worst, ok = max(worst, e), ok and good
    if not ok:
        raise SystemExit("phase 2: paged_gqa_verify disagrees with its plain "
                         "version or with the decode kernel")
    q, kp, vp, tbl, kv_len = args
    length = tbl.shape[1] * bs
    ms = time_ms(torch, lambda: fa.paged_gqa_verify(
        q, kp, vp, tbl, kv_len, scale=0.125), iters=50)
    dec_ms = time_ms(torch, lambda: [fa.paged_gqa_decode(
        q[:, i].contiguous(), kp, vp, tbl, kv_len + i, scale=0.125)
        for i in range(s)], iters=50)
    plain_ms = time_ms(torch, lambda: fa.paged_gqa_verify_plain(
        q, kp, vp, tbl, kv_len, scale=0.125), iters=20)
    # yardstick: SDPA over the K/V gathered into position order (gather and
    # head expansion outside the timed call), offset-causal mask
    kr = kp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
    vr = vp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
    kr, vr = kr.transpose(1, 2).contiguous(), vr.transpose(1, 2).contiguous()
    qq = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, d)
    mask = _span_mask(torch, kv_len, s, length)

    def lib():
        return F.scaled_dot_product_attention(qq, kr, vr, attn_mask=mask,
                                              scale=0.125)
    lib_ms = time_ms(torch, lib, iters=50)
    dev = device_ms(torch, lambda: fa.paged_gqa_verify(
        q, kp, vp, tbl, kv_len, scale=0.125), 50)
    lib_dev = device_ms(torch, lib, 50)
    pos = sum(n + s - 1 for n in lens)        # each slot's span, read once
    seen = sum(n + i for n in lens for i in range(s))
    nbytes = (q.numel() * 2 + pos * kvh * 2 * d * 2 + tbl.numel() * 4
              + b * 4 + b * s * kvh * g * d * 4)
    flops = 2.0 * seen * kvh * g * 2 * d
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"[time] paged_gqa_verify one launch (bf16, 8 slots x span {s}, "
        f"kv_len {lens}): kernel {ms:.4f} ms (device {dev:.4f} ms), bound "
        f"{bnd:.5f} ms ({by}, {nbytes / 1e6:.2f} MB), {s} paged_gqa_decode "
        f"launches {dec_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on gathered"
        f" K/V with the offset-causal mask {lib_ms:.4f} ms (device "
        f"{lib_dev:.4f} ms)")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev,
                max_abs_err=worst,
                decode_launches_ms=dec_ms, max_abs_err_vs_decode=worst_dec,
                bitwise_vs_decode=bitwise)


def phase_mla_verify_attention(torch, F):
    """paged_mla_verify at the deepseek speculative shape: 8 slots x span
    4, 16 heads, kv_lora 512, rope 64, block 16, f32 queries against f32 or
    bf16 pools, against its plain version and S decode launches."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    lens, s, bs, h, r, rd = SERVE_LENS, SPAN, 16, 16, 512, 64
    b = len(lens)
    scale = (128 + 64) ** -0.5          # (qk_nope + qk_rope) ** -0.5
    worst, worst_dec, ok, bitwise = 0.0, 0.0, True, True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tbl, nb = _span_table(torch, gen, lens, s, bs)
        cp = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)
        pp = torch.randn(nb, bs, rd, generator=gen, device="cuda").to(dtype)
        cp[0] = 1e4
        pp[0] = 1e4
        ql = torch.randn(b, s, h, r, generator=gen, device="cuda")
        qp = torch.randn(b, s, h, rd, generator=gen, device="cuda")
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (ql, qp, cp, pp, tbl, kv_len)
        out = fa.paged_mla_verify(ql, qp, cp, pp, tbl, kv_len, scale=scale)
        e, good = max_err(torch, out, fa.paged_mla_verify_plain(
            ql, qp, cp, pp, tbl, kv_len, scale=scale), ATTN_TOL, ATTN_TOL)
        log(f"[check] paged_mla_verify {dname} pools max_abs_err {e:.3e} "
            f"tol {ATTN_TOL}+{ATTN_TOL}|ref| {'ok' if good else 'FAIL'}")
        dec = torch.stack([fa.paged_mla_decode(
            ql[:, i].contiguous(), qp[:, i].contiguous(), cp, pp, tbl,
            kv_len + i, scale=scale) for i in range(s)], 1)
        ed, goodd, same = _against_decode(torch, out, dec, "paged_mla_verify",
                                          dname, {}, ATTN_TOL)
        worst, worst_dec = max(worst, e), max(worst_dec, ed)
        ok, bitwise = ok and good and goodd, bitwise and same
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        (ql, qp), cp, pp, tbl, kv_len = _long_inputs(
            torch, gen, dtype, (r,), (rd,), [(s, h, r), (s, h, rd)], bs)
        e, good = check_long_context(
            torch, "paged_mla_verify", f"{dname} pools",
            lambda: fa.paged_mla_verify(ql, qp, cp, pp, tbl, kv_len,
                                        scale=scale),
            lambda: fa.paged_mla_verify_plain(ql, qp, cp, pp, tbl, kv_len,
                                              scale=scale),
            lambda i: fa.paged_mla_decode(ql[:, i].contiguous(),
                                          qp[:, i].contiguous(), cp, pp, tbl,
                                          kv_len + i, scale=scale), s)
        worst, ok = max(worst, e), ok and good
    if not ok:
        raise SystemExit("phase 2: paged_mla_verify disagrees with its plain "
                         "version or with the decode kernel")
    ql, qp, cp, pp, tbl, kv_len = args
    length = tbl.shape[1] * bs
    ms = time_ms(torch, lambda: fa.paged_mla_verify(
        ql, qp, cp, pp, tbl, kv_len, scale=scale), iters=50)
    qls = [ql[:, i].contiguous() for i in range(s)]
    qps = [qp[:, i].contiguous() for i in range(s)]
    dec_ms = time_ms(torch, lambda: [fa.paged_mla_decode(
        qls[i], qps[i], cp, pp, tbl, kv_len + i, scale=scale)
        for i in range(s)], iters=50)
    plain_ms = time_ms(torch, lambda: fa.paged_mla_verify_plain(
        ql, qp, cp, pp, tbl, kv_len, scale=scale), iters=20)
    # yardstick: SDPA on the latent gathered into position order (outside
    # the timed call), q = [q_lat | q_pe], k = [ckv | kpe], v = ckv
    ck = cp[tbl.long()].reshape(b, 1, length, r)
    kk = torch.cat([ck, pp[tbl.long()].reshape(b, 1, length, rd)], -1)
    kk = kk.expand(b, h, length, r + rd)
    vv = ck.expand(b, h, length, r)
    qq = torch.cat([ql, qp], -1).to(torch.bfloat16).transpose(1, 2)
    mask = _span_mask(torch, kv_len, s, length)

    def lib():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              scale=scale)
    lib_ms = time_ms(torch, lib, iters=50)
    dev = device_ms(torch, lambda: fa.paged_mla_verify(
        ql, qp, cp, pp, tbl, kv_len, scale=scale), 50)
    lib_dev = device_ms(torch, lib, 50)
    pos = sum(n + s - 1 for n in lens)
    seen = sum(n + i for n in lens for i in range(s))
    nbytes = (ql.numel() * 4 + qp.numel() * 4 + pos * (r + rd) * 2
              + tbl.numel() * 4 + b * 4 + b * s * h * r * 4)
    flops = 2.0 * seen * h * (r + rd + r)
    bnd, by = bound_ms(nbytes, flops, "float32")
    log(f"[time] paged_mla_verify one launch (bf16 pools, 8 slots x span "
        f"{s}, 16 heads, kv_len {lens}): kernel {ms:.4f} ms (device "
        f"{dev:.4f} ms), bound {bnd:.5f} ms ({by}, {nbytes / 1e6:.2f} MB), "
        f"{s} paged_mla_decode launches {dec_ms:.4f} ms, plain {plain_ms:.4f}"
        f" ms, SDPA on the gathered latent with the offset-causal mask "
        f"{lib_ms:.4f} ms (device {lib_dev:.4f} ms)")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev,
                max_abs_err=worst,
                decode_launches_ms=dec_ms, max_abs_err_vs_decode=worst_dec,
                bitwise_vs_decode=bitwise)


# ------------------------------------------------------------------ phase 7

CNN_TOL = 1e-4                   # f32 routes against dense F.conv2d (TF32 off)


def phase_cnn(torch, F):
    """The paper's domain at full published shapes: every layer of
    ``CNN_LAYER_CONVS`` (ResNet50, DenseNet121, InceptionV3) as a real
    convolution in f32 at 1:4 and 2:4, batch 1 and 32, through
    ``conv2d_sparse`` (the nm_xwt kernel), the paper's orientation
    ``ops.nm_spmm(W, cols^T)``, and dense F.conv2d on the decompressed
    weights (TF32 off: the check and the yardstick).  The packed nm_xwt
    runs where the reference accepts the layer's packing and must equal
    the int8 kernel bit for bit.  Counts are zeroed before and read after;
    nm_xwt and nm_spmm must have launched.  Timings: the entry point
    (im2col + kernel), each kernel alone on the layer's patches, its plain
    version, and the library calls (F.conv2d for the route; on the dense
    weights torch.mm(W, cols^T) for nm_spmm's GEMM and F.linear(cols, W)
    for nm_xwt's), per layer and per net, the card's Fig 11 analogue."""
    from repro_torch import kernels
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import nm_spmm, ops
    from repro_torch.models.cnn import (CNN_LAYER_CONVS, conv2d_dense,
                                        conv2d_sparse, im2col,
                                        sparse_conv_init)
    gen = torch.Generator(device="cuda").manual_seed(11)

    def counts():
        return {k.name: k.launches for k in kernels.all_kernels()}
    # the phase's path launches: the three routes of every layer run, not
    # the timing loops
    kernels.reset_launch_counts()
    launches = counts()
    worst, ok, packed_ok, packed_rejected = 0.0, True, 0, 0
    totals, bound_by = {}, {}
    for n in (1, 2):
        for batch in (1, 32):
            for net, convs in CNN_LAYER_CONVS.items():
                tot = totals.setdefault((n, batch, net), dict(
                    conv=0.0, xwt=0.0, spmm=0.0, dense=0.0, mm=0.0, lin=0.0,
                    xwt_plain=0.0, spmm_plain=0.0, bound=0.0))
                for name, c_in, c_out, kh, kw, stride, h in convs:
                    w = sparse_conv_init(gen, c_in, c_out, kh, kw, n, M)
                    wd = decompress(w)
                    x = torch.randn(batch, h, h, c_in, generator=gen,
                                    device="cuda")
                    before = counts()
                    y1 = conv2d_sparse(x, w, kh, kw, stride)
                    y3 = conv2d_dense(x, wd, c_in, kh, kw, stride)
                    cols, (ho, wo) = im2col(x, kh, kw, stride)
                    ckp = w.dense_shape[1]
                    cols = F.pad(cols, (0, ckp - cols.shape[1]))
                    colst = cols.t().contiguous()
                    y2 = ops.nm_spmm(w.values, w.indices, colst, n, M)
                    e1, g1 = max_err(torch, y1, y3, CNN_TOL, CNN_TOL)
                    e2, g2 = max_err(torch, y2.t().reshape(y3.shape), y3,
                                     CNN_TOL, CNN_TOL)
                    worst, ok = max(worst, e1, e2), ok and g1 and g2
                    try:
                        yp = ops.nm_xwt(cols, w.values, w.indices, n, M,
                                        packed=True)
                        same = bool(torch.equal(yp, y1.reshape(yp.shape)))
                        packed_ok += same
                        ok = ok and same
                        pk = "packed bit-equal" if same else "packed DIFFERS"
                    except ValueError:
                        packed_rejected += 1
                        pk = "packed rejected (as the reference)"
                    for key, val in counts().items():
                        launches[key] += val - before[key]
                    ms = dict(
                        conv=time_ms(torch, lambda: conv2d_sparse(
                            x, w, kh, kw, stride), iters=5, warmup=1),
                        xwt=time_ms(torch, lambda: nm_spmm.nm_xwt(
                            cols, w.values, w.indices, n, M), iters=5,
                            warmup=1),
                        spmm=time_ms(torch, lambda: nm_spmm.nm_spmm(
                            w.values, w.indices, colst, n, M), iters=5,
                            warmup=1),
                        dense=time_ms(torch, lambda: conv2d_dense(
                            x, wd, c_in, kh, kw, stride), iters=5, warmup=1),
                        mm=time_ms(torch, lambda: torch.mm(wd, colst),
                                   iters=5, warmup=1),
                        lin=time_ms(torch, lambda: F.linear(cols, wd),
                                    iters=5, warmup=1),
                        xwt_plain=time_ms(torch, lambda: nm_spmm.nm_xwt_plain(
                            cols, w.values, w.indices, n, M), iters=3,
                            warmup=1),
                        spmm_plain=time_ms(torch, lambda: nm_spmm.nm_spmm_plain(
                            w.values, w.indices, colst, n, M), iters=3,
                            warmup=1))
                    rows_, k_ = cols.shape
                    # bytes: patches, values + int8 indices, output (f32);
                    # operations: the N/M MACs on the CUDA cores or three
                    # TF32 passes over the dense MACs, the faster
                    nbytes = 4 * (rows_ * k_ + rows_ * c_out) \
                        + w.values.numel() * 5
                    bnd, by = nm_f32_bound_ms(nbytes, rows_, c_out, k_,
                                              w.values.numel())
                    ms["bound"] = bnd
                    for key, val in ms.items():
                        tot[key] += val
                    bound_by[(n, batch, by)] = bound_by.get(
                        (n, batch, by), 0.0) + bnd
                    log(f"[cnn] {n}:{M} B={batch} {net} {name} (C_in {c_in} "
                        f"-> C_out {c_out}, {kh}x{kw}/{stride} on {h}^2; GEMM "
                        f"R {c_out} K {ckp} C {rows_}): conv2d_sparse "
                        f"{ms['conv']:.4f} ms, nm_xwt {ms['xwt']:.4f}, "
                        f"nm_spmm {ms['spmm']:.4f}, F.conv2d {ms['dense']:.4f}"
                        f", torch.mm dense {ms['mm']:.4f}, F.linear "
                        f"{ms['lin']:.4f}; bound "
                        f"{bnd:.4f} ({by}); plain xwt {ms['xwt_plain']:.4f}, "
                        f"spmm {ms['spmm_plain']:.4f}; max_abs_err vs "
                        f"F.conv2d {e1:.2e} / {e2:.2e} (tol {CNN_TOL}+"
                        f"{CNN_TOL}|ref|) {'ok' if g1 and g2 else 'FAIL'}; "
                        f"{pk}")
                    del cols, colst, y1, y2, y3, x
                log(f"[cnn] {n}:{M} B={batch} {net} total over "
                    f"{len(convs)} layers: conv2d_sparse {tot['conv']:.4f} "
                    f"ms, nm_xwt {tot['xwt']:.4f}, nm_spmm {tot['spmm']:.4f}"
                    f", F.conv2d {tot['dense']:.4f}, torch.mm "
                    f"{tot['mm']:.4f}, F.linear {tot['lin']:.4f}, bound "
                    f"{tot['bound']:.4f}; dense / sparse: conv "
                    f"{tot['dense'] / tot['conv']:.3f}x, GEMM "
                    f"{tot['mm'] / tot['spmm']:.3f}x (nm_spmm vs torch.mm) "
                    f"{tot['lin'] / tot['xwt']:.3f}x (nm_xwt vs F.linear)")
    torch.cuda.synchronize()
    log(f"[cnn] kernel launches of the routes: {launches}; packed nm_xwt "
        f"bit-equal on {packed_ok} layer runs, rejected on {packed_rejected} "
        f"(bk/M*N not a whole number of words, as the reference)")
    if not ok:
        raise SystemExit(f"phase 7: a CNN route disagrees with F.conv2d "
                         f"beyond {CNN_TOL} (max {worst:.3e}) or packed "
                         f"nm_xwt differs from int8")
    if min(launches["nm_xwt"], launches["nm_spmm"]) <= 0:
        raise SystemExit(f"phase 7: nm_xwt or nm_spmm never launched: "
                         f"{launches}")
    from repro_torch.launch import cnn as cnn_cli
    log("[cnn] python -m repro_torch.launch.cnn (on the card):")
    cnn_cli.main([])
    agg = {key: sum(t[key] for (n, b, _), t in totals.items()
                    if n == N and b == 32)
           for key in ("conv", "xwt", "spmm", "dense", "mm", "lin",
                       "xwt_plain", "spmm_plain", "bound")}
    # what bounds most of the summed bound time
    by = max(("bytes", "operations"),
             key=lambda b: bound_by.get((N, 32, b), 0.0))
    rows = {
        "nm_spmm": dict(_row(agg["spmm"], agg["spmm_plain"], agg["bound"], by,
                             agg["mm"], worst),
                        at="15 CNN layers, 2:4, f32, batch 32 (sum)"),
        "nm_xwt": dict(ms=agg["xwt"], plain_ms=agg["xwt_plain"],
                       bound_ms=agg["bound"], library_ms=agg["lin"],
                       conv2d_sparse_ms=agg["conv"],
                       f_conv2d_ms=agg["dense"],
                       at="15 CNN layers, 2:4, f32, batch 32 (sum; library "
                          "F.linear(cols, W); the route's yardstick "
                          "F.conv2d)"),
    }
    return rows, {"cnn": launches}


# ------------------------------------------------------------ phases 3 and 4

def graphed(kw):
    """The engine settings of every measured serve run: each entry point
    captured as CUDA graphs (the engine's default on the card) before the
    first admission, a mid-serve capture an error."""
    return dict(kw, prewarm=True, strict_prewarm=True)


def eager(kw):
    """The same engine with every forward run eagerly: the oracle."""
    return dict(kw, graphs=False)


def timed_run(torch, model, cfg, kw, reqs):
    """A fresh engine over ``reqs`` -> (engine, wall seconds of its
    synchronised run; bring-up not included)."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, cfg, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def serve_run(torch, model, cfg, path, kw, phase: str, reqs=None):
    """The measured engine run: 16 requests of 128 prompt tokens, gen mix
    16/32 (or ``reqs``), through the graphed engine ``kw``, with every
    launch count
    zeroed just before and read just after (the prewarm's captures happen
    before: a replay adds what its graph captured).  Before it, the same
    trace through the eager engine, the first run of the eager, graphed,
    graphed, eager order that ``check_graphed`` completes.  Returns
    (engine, requests, launches, wall seconds, (eager engine, its wall))."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine, synthetic_trace
    # warm-up (first-call library set-up), not counted
    ServeEngine(model, cfg, **kw).run(synthetic_trace(
        cfg, n_requests=2, prompt_len=128, gen_lens=[2], seed=99))
    if reqs is None:
        reqs = synthetic_trace(cfg, n_requests=16, prompt_len=128,
                               gen_lens=[16, 32], seed=0)
    first_eager = timed_run(torch, model, cfg, eager(kw), reqs)
    eng = ServeEngine(model, cfg, **kw)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.all_kernels()}
    st = eng.stats()
    log(f"[serve] {cfg.name}: {int(st['tokens'])} tokens in {wall:.3f}s = "
        f"{st['tokens'] / wall:.1f} tokens/s (graphed); "
        f"{int(st['decode_steps'])} decode "
        f"steps, {int(st['prefill_calls'])} prefills, occupancy "
        f"{st['occupancy']:.3f}, weight stream {st['weight_stream_ratio']:.4f}x"
        f" dense ({st['weight_stream_bytes'] / 1e9:.3f} GB/step), "
        f"{int(st['preemptions'])} preemptions")
    log(f"[serve] kernel launches in the run: {launches}")
    if min(launches[name] for name in path) <= 0:
        raise SystemExit(f"{phase}: a kernel of the path never launched: "
                         f"{launches}")
    want = sum(r.max_new_tokens for r in reqs)
    lens_ok = all(len(results[r.rid].tokens) == r.max_new_tokens
                  and not results[r.rid].rejected for r in reqs)
    if st["tokens"] != want or not lens_ok:
        raise SystemExit(f"{phase}: expected {want} tokens over "
                         f"{len(reqs)} requests, got {st['tokens']}")
    if (not eng.graphs or st["mid_serve_compiles"]
            or st["prewarmed_executables"] != st["executables_expected"]
            or st["warm_calls"] != sum(e.calls
                                       for e in eng.entries.values())):
        raise SystemExit(f"{phase}: the engine did not serve from its "
                         f"prewarmed graphs alone (graphs {eng.graphs}, "
                         f"{st['prewarmed_executables']:.0f} of "
                         f"{st['executables_expected']:.0f} prewarmed, "
                         f"{st['mid_serve_compiles']:.0f} mid-serve)")
    return eng, reqs, launches, wall, first_eager


REPEAT_KEYS = ("tokens", "decode_steps", "prefill_calls", "preemptions",
               "draft_steps", "spec_proposed", "spec_accepted",
               "spec_steps_saved")


def moved_counters(a, b):
    keys = [k for k in REPEAT_KEYS if k in a]
    return {k: (a[k], b[k]) for k in keys if a[k] != b[k]}


def check_repeat(torch, model, cfg, kw, reqs, eng, phase: str) -> float:
    """Serving is deterministic: a second engine over the same trace emits
    the same tokens and the same counters.  (In the MoE family the masked
    rows of a forward, which all write the trash block, compete with the
    live rows for expert capacity, so a race between their writes would
    show here.)  Returns the second run's wall seconds."""
    import numpy as np
    again, wall = timed_run(torch, model, cfg, kw, reqs)
    moved = moved_counters(eng.stats(), again.stats())
    same = sum(bool(np.array_equal(eng.results[r.rid].tokens,
                                   again.results[r.rid].tokens))
               for r in reqs)
    log(f"[repeat] {phase} {cfg.name}: a second run gives {same}/{len(reqs)} "
        f"requests identical, counters "
        f"{'equal' if not moved else f'differ {moved}'}")
    if same != len(reqs) or moved:
        raise SystemExit(f"{phase}: serving is not deterministic: a second "
                         f"run differs ({same}/{len(reqs)} requests "
                         f"identical, counters {moved})")
    return wall


def graph_pool_bytes(torch, eng):
    """Bytes the engine's graph memory pool holds (the allocator's segments
    of that pool), or None where the snapshot does not name pools."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    pool = tuple(eng.graph_pool)
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == pool)


def check_graphed(torch, model, cfg, kw, reqs, eng, wall, again_wall,
                  first_eager, phase, last_eager: bool = True,
                  busy=None) -> None:
    """The graphed run against the eager engine on the same trace, then the
    ``[graph]`` line.  The graphs replay the same kernels under the same
    plans, so the same bits are expected: a token flip is printed with the
    top-2 margin where it happened, and counters that differ where every
    token agrees fail the phase.  Tokens/s of the runs in the order eager,
    graphed, graphed (where ``again_wall`` is not None) and (with
    ``last_eager``) eager again; the prewarm's
    seconds and graphs, mid-serve captures, first and steady tick of both
    engines, the graph pool's bytes and (``busy``: the eager and graphed
    ``profile_breakdown`` shares) the traced busy share."""
    runs = [first_eager]
    if last_eager:
        runs.append(timed_run(torch, model, cfg, eager(kw), reqs))
    st = eng.stats()
    for e, _ in runs:
        differ = compare_tokens(torch, e, reqs, eng.results,
                                f"{phase} {cfg.name} eager", "eager",
                                "graphed")
        moved = moved_counters(st, e.stats())
        if moved and not differ:
            raise SystemExit(f"{phase}: the eager engine's counters differ "
                             f"from the graphed one's on the same tokens: "
                             f"{moved}")
        if moved:
            log(f"[graph]   counters differ with the tokens: {moved}")
    rate = [st["tokens"] / w for w in (wall, again_wall) if w is not None]
    erate = [e.stats()["tokens"] / w for e, w in runs]
    order = [erate[0], *rate] + erate[1:]
    es = runs[0][0].stats()
    pool = graph_pool_bytes(torch, eng)
    log(f"[graph] {phase} {cfg.name}: tokens/s eager"
        f"{', graphed' * len(rate)}"
        f"{', eager' if last_eager else ''}: "
        f"{', '.join(f'{r:.1f}' for r in order)} (graphed / eager "
        f"{sum(rate) / sum(erate) * len(erate) / len(rate):.2f}x); prewarm "
        f"{st['prewarm_seconds']:.3f}s for {int(st['prewarmed_executables'])}"
        f" graphs {eng.executable_shapes()['entries']}, mid-serve captures "
        f"{int(st['mid_serve_compiles'])}; tick first {st['first_tick_s'] * 1e3:.2f}"
        f" ms, steady {st['steady_tick_s'] * 1e3:.2f} ms (eager "
        f"{es['first_tick_s'] * 1e3:.2f} / {es['steady_tick_s'] * 1e3:.2f} ms);"
        f" graph pool "
        f"{'not measured' if pool is None else gib(pool)}"
        + ("" if busy is None else "; traced busy " + ", ".join(
            f"{name} {100 * b:.1f}%" for name, b in zip(("eager", "graphed"),
                                                       busy) if b is not None)))


def phase_serve(torch, card, tokens=None):
    """Phases 3-9 on full-width llama3.2-1b; ``tokens`` (a dict) receives
    phase 3's token streams, which phase 15a is held to."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] init {cfg.name}: {cfg.n_layers}L d{cfg.d_model} "
        f"{cfg.n_heads}H/{cfg.n_kv}KV d_ff {cfg.d_ff} vocab {cfg.vocab} "
        f"{cfg.dtype} in {time.perf_counter() - t0:.1f}s")
    kw = graphed(dict(n_slots=8, max_len=128 + 32, compressed=True,
                      kv="paged", attn="fused", block_size=16,
                      device="cuda"))
    eng, reqs, launches, wall, first_eager = serve_run(
        torch, model, cfg, LLAMA_PATH, kw, "phase 3")
    results = eng.results
    want = eng.decode_steps * cfg.n_layers * LINEARS_PER_LAYER
    if launches["nm_spmv"] != want:
        raise SystemExit(f"phase 3: nm_spmv launched {launches['nm_spmv']} "
                         f"times, expected {eng.decode_steps} ticks x "
                         f"{cfg.n_layers} layers x {LINEARS_PER_LAYER}")
    again = check_repeat(torch, model, cfg, kw, reqs, eng, "phase 3")
    busy = (profile_breakdown(torch, model, cfg, eager(kw)),
            profile_breakdown(torch, model, cfg, kw))
    check_graphed(torch, model, cfg, kw, reqs, eng, wall, again,
                  first_eager, "phase 3", busy=busy)
    check_reference_route(torch, eng.model, eng.cfg, reqs[:8], LOGIT_ATOL,
                          "phase 3")
    coldstart(torch, model, cfg, kw)
    onehot_launches = phase_onehot_serve(torch, eng, kw, wall)
    from repro_torch.serve import SpecConfig
    spec = SpecConfig(k=SPAN - 1, draft="rerank")
    spec_launches = phase_spec(torch, eng.model, eng.cfg, kw, spec,
                               LLAMA_SPEC_PATH, "paged_gqa_verify", eng, wall,
                               "phase 5")
    del eng
    prefix_launches = phase_prefix(torch, model, cfg, kw)
    slotted_launches = phase_slotted(torch, model, cfg, kw, card)
    del model
    torch.cuda.empty_cache()
    check_spec_exact(torch, "llama3.2-1b", spec, "paged_gqa_verify",
                     "phase 5")
    check_onehot_exact(torch)
    check_prefix_exact(torch, "llama3.2-1b")
    check_slotted_exact(torch, "llama3.2-1b")
    if tokens is not None:
        tokens.update({rid: r.tokens.copy() for rid, r in results.items()})
    return {"llama3.2-1b": launches, "llama3.2-1b onehot": onehot_launches,
            "llama3.2-1b spec": spec_launches,
            "llama3.2-1b prefix": prefix_launches, **slotted_launches}


def coldstart(torch, model, cfg, kw):
    """``[coldstart]``: a lazy graphed engine (each shape captured at its
    first use, a mid-serve capture) against a prewarmed one, on the traced
    trace (8 requests, 128 prompt tokens, 16 generated): bring-up, the
    capture bill, first tick against steady tick, and the run's wall."""
    from repro_torch.serve import synthetic_trace
    reqs = synthetic_trace(cfg, n_requests=8, prompt_len=128, gen_lens=[16],
                           seed=5)
    parts = []
    for name, k in (("lazy", dict(kw, prewarm=False, strict_prewarm=False)),
                    ("prewarmed", kw)):
        eng, wall = timed_run(torch, model, cfg, k, reqs)
        st = eng.stats()
        parts.append(
            f"{name}: bring-up {st['init_seconds']:.3f}s (prewarm "
            f"{st['prewarm_seconds']:.3f}s, {int(st['prewarmed_executables'])}"
            f" graphs), {int(st['mid_serve_compiles'])} mid-serve captures "
            f"({st['compile_seconds']:.3f}s of captures in all), first tick "
            f"{st['first_tick_s'] * 1e3:.2f} ms against steady "
            f"{st['steady_tick_s'] * 1e3:.2f} ms, run {wall:.3f}s")
    log(f"[coldstart] {cfg.name}: " + "; ".join(parts))


LINEARS_PER_LAYER = 7            # llama: wq, wk, wv, wo, wg, wu, wd


def _onehot(cfg):
    return cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                    spmv_mode="onehot"))


def phase_onehot_serve(torch, base, kw, base_wall):
    """Phase 3b: the phase-3 trace again under ``SparsityConfig(spmv_mode=
    "onehot")`` on the same compressed model.  The onehot launcher must
    have served every decode linear (decode steps x layers x 7) and the
    gather one none; the tokens are compared with phase 3's."""
    cfg = _onehot(base.cfg)
    eng, reqs, launches, wall, first_eager = serve_run(
        torch, base.model, cfg, ("nm_spmv_onehot", "nm_xwt",
                                 "paged_gqa_decode"), kw, "phase 3b")
    again = check_repeat(torch, base.model, cfg, kw, reqs, eng, "phase 3b")
    check_graphed(torch, base.model, cfg, kw, reqs, eng, wall, again,
                  first_eager, "phase 3b", last_eager=False)
    want = eng.decode_steps * cfg.n_layers * LINEARS_PER_LAYER
    log(f"[onehot] {cfg.name} spmv_mode=onehot: "
        f"{eng.stats()['tokens'] / wall:.1f} tokens/s against "
        f"{base.stats()['tokens'] / base_wall:.1f} with the gather body "
        f"(both graphed); nm_spmv_onehot {launches['nm_spmv_onehot']} "
        f"launches (decode linears {want}), nm_spmv {launches['nm_spmv']}")
    if launches["nm_spmv_onehot"] != want or launches["nm_spmv"] != 0:
        raise SystemExit(f"phase 3b: the onehot launcher did not serve every "
                         f"decode linear ({launches['nm_spmv_onehot']} of "
                         f"{want}; gather {launches['nm_spmv']})")
    compare_tokens(torch, eng, reqs, base.results, f"phase 3b {cfg.name}",
                   "onehot", "gather")
    return launches


def check_graphed_exact(torch, model, cfg, kw, reqs, graphed_results,
                        what) -> None:
    """Hard check: the eager engine's tokens equal the graphed engine's,
    token for token."""
    eng, _ = timed_run(torch, model, cfg, eager(kw), reqs)
    differ = compare_tokens(torch, eng, reqs, graphed_results,
                            f"{what} eager", "eager", "graphed")
    if differ:
        raise SystemExit(f"{what}: float32 eager tokens differ from the "
                         f"graphed engine's in {differ} requests")


def check_onehot_exact(torch):
    """Hard check at full width, 4 layers, float32, 2 slots: the onehot
    decode body's tokens equal the gather body's exactly, and each equals
    its eager engine's."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, synthetic_trace
    cfg = get_config("llama3.2-1b")
    cfg = cfg.replace(n_layers=4, dtype="float32", sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=4, prompt_len=37,
                           gen_lens=[12, 9], seed=11)
    kw = graphed(dict(n_slots=2, max_len=37 + 12, compressed=True,
                      kv="paged", attn="fused", block_size=16,
                      device="cuda"))
    want = ServeEngine(model, cfg, **kw).run(reqs)
    kernels.reset_launch_counts()
    eng = ServeEngine(model, _onehot(cfg), **kw)
    eng.run(reqs)
    launched = {k.name: k.launches for k in kernels.all_kernels()}
    log(f"[onehot] llama3.2-1b exact check (4 layers, float32, 2 slots, "
        f"graphed): nm_spmv_onehot {launched['nm_spmv_onehot']} launches, "
        f"nm_spmv {launched['nm_spmv']}")
    differ = compare_tokens(torch, eng, reqs, want, "phase 3b exact check",
                            "onehot", "gather")
    if differ or launched["nm_spmv_onehot"] <= 0 or launched["nm_spmv"]:
        raise SystemExit(f"phase 3b: float32 onehot tokens differ from the "
                         f"gather body's in {differ} requests (or the wrong "
                         f"body served)")
    check_graphed_exact(torch, model, cfg, kw, reqs, want,
                        "phase 3b exact check (gather)")
    check_graphed_exact(torch, model, _onehot(cfg), kw, reqs, eng.results,
                        "phase 3b exact check (onehot)")
    del eng, model
    torch.cuda.empty_cache()


def phase_spec(torch, model, cfg, kw, spec, path, verify_kernel, base,
               base_wall, phase, repeat: bool = True, reqs=None):
    """The phase-3/4 trace through the speculative engine.  A verify pass is
    one call of the engine's verify entry (one graph replay); the verify
    kernel must launch once per layer per pass.  Tokens are compared with
    the plain run ``base`` and with the eager speculative engine, and (with
    ``repeat``) with a second graphed run, and the device busy share read
    from a traced run."""
    skw = dict(kw, spec=spec)
    eng, reqs, launches, wall, first_eager = serve_run(
        torch, model, cfg, path, skw, phase, reqs)
    passes = eng.entries["verify"].calls
    again, busy = None, None
    if repeat:
        again = check_repeat(torch, model, cfg, skw, reqs, eng, phase)
        busy = (None, profile_breakdown(torch, model, cfg, skw))
    check_graphed(torch, model, cfg, skw, reqs, eng, wall, again,
                  first_eager, phase, last_eager=False, busy=busy)
    want = passes * cfg.n_layers
    if launches[verify_kernel] != want:
        raise SystemExit(f"{phase}: {verify_kernel} launched "
                         f"{launches[verify_kernel]} times, expected "
                         f"{passes} verify passes x {cfg.n_layers} "
                         f"layers")
    st = eng.stats()
    base_tps = base.stats()["tokens"] / base_wall
    log(f"[spec] {cfg.name} draft={spec.draft} k={spec.k}: "
        f"{st['tokens'] / wall:.1f} tokens/s against {base_tps:.1f} without "
        f"speculation (both graphed); {int(st['decode_steps'])} target "
        f"passes ({passes} verify, plain run {int(base.decode_steps)}), "
        f"{int(st['draft_steps'])} draft steps, proposed "
        f"{int(st['spec_proposed'])}, accepted {int(st['spec_accepted'])} "
        f"(acceptance {st['spec_acceptance']:.3f}), steps saved "
        f"{int(st['spec_steps_saved'])}, draft stream "
        f"{st['draft_stream_bytes'] / st['weight_stream_bytes']:.3f}x target")
    compare_tokens(torch, eng, reqs, base.results, f"{phase} {cfg.name}")
    return launches


def prompt_batch(torch, model, inputs, extra=()):
    """A request's prompt followed by the tokens ``extra`` as a batch of one
    on the card: the tokens appended to a token prompt, their embeddings
    (the model's table) to an embeddings prompt; encoder frames kept."""
    import numpy as np
    extra = torch.tensor(np.asarray(extra, np.int64), device="cuda")
    batch = {}
    if "tokens" in inputs:
        batch["tokens"] = torch.cat([torch.tensor(
            np.asarray(inputs["tokens"], np.int64), device="cuda"), extra])[None]
    if "embeds" in inputs:
        batch["embeds"] = torch.cat([torch.tensor(
            inputs["embeds"], device="cuda"),
            model.embed.emb[extra].float()])[None]
    if "enc_embeds" in inputs:
        batch["enc_embeds"] = torch.tensor(inputs["enc_embeds"],
                                           device="cuda")[None]
    return batch


def compare_tokens(torch, eng, reqs, base, what, label="with speculation",
                   base_label="plain") -> int:
    """Agreement of ``eng``'s token streams with ``base``; at each request's
    first divergence, the plain model's top-2 logit margin there (from a
    teacher-forced prefill of the prompt and the plain tokens before it).
    Returns the number of requests that differ."""
    import numpy as np
    from repro_torch.models import prefill
    same_tok = total = same_req = 0
    for r in reqs:
        a, b = base[r.rid].tokens, eng.results[r.rid].tokens
        eq = a == b
        same_tok, total = same_tok + int(eq.sum()), total + len(a)
        if eq.all():
            same_req += 1
            continue
        i = int(np.argmin(eq))
        logits, _ = prefill(eng.model, eng.cfg,
                            prompt_batch(torch, eng.model, r.inputs, a[:i]))
        top = torch.topk(logits[0].float(), 2).values
        log(f"[spec]   rid {r.rid}: first divergence at token {i} ({a[i]} "
            f"{base_label}, {b[i]} {label}); plain model's top-2 logit "
            f"margin there {float(top[0] - top[1]):.4g} (teacher-forced "
            f"prefill)")
    log(f"[spec] {what} token agreement with the {base_label} run: "
        f"{same_tok}/{total} tokens, {same_req}/{len(reqs)} requests "
        f"identical")
    return len(reqs) - same_req


def check_spec_exact(torch, arch, spec, verify_kernel, phase):
    """Hard check at full width, 4 layers, float32, 2 slots: the speculative
    engine's tokens equal the plain engine's exactly (prompts of 37 bucket
    down to 32, so prompt catch-up rides the verify span), and each equals
    its eager engine's."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, synthetic_trace
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=4, dtype="float32", sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=4, prompt_len=37,
                           gen_lens=[12, 9], seed=11)
    kw = graphed(dict(n_slots=2, max_len=37 + 12, compressed=True,
                      kv="paged", attn="fused", block_size=16,
                      device="cuda"))
    plain = ServeEngine(model, cfg, **kw)
    want = plain.run(reqs)
    kernels.reset_launch_counts()
    eng = ServeEngine(model, cfg, spec=spec, **kw)
    eng.run(reqs)
    launched = {k.name: k.launches for k in kernels.all_kernels()}
    st = eng.stats()
    log(f"[spec] {arch} exact check (4 layers, float32, 2 slots, draft="
        f"{spec.draft}, graphed): {int(st['decode_steps'])} target passes "
        f"against {plain.decode_steps}, accepted {int(st['spec_accepted'])}/"
        f"{int(st['spec_proposed'])}, {verify_kernel} launches "
        f"{launched[verify_kernel]}")
    differ = compare_tokens(torch, eng, reqs, want, f"{phase} exact check")
    if differ or launched[verify_kernel] <= 0:
        raise SystemExit(f"{phase}: float32 speculative tokens differ from "
                         f"the plain engine's in {differ} requests (or "
                         f"{verify_kernel} never launched)")
    check_graphed_exact(torch, model, cfg, kw, reqs, want,
                        f"{phase} exact check (plain)")
    check_graphed_exact(torch, model, cfg, dict(kw, spec=spec), reqs,
                        eng.results, f"{phase} exact check (spec)")
    del eng, plain, model
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 8

# the schedule does not depend on the weights (every request runs to its
# max_new_tokens, all arrive at tick 0), so these counts are the CPU run's
# of the same trace shape at smoke width: rids 0-7 miss, prefix 0 (even
# rids, gen 16) retires first, so rids 9 and 11 (prefix 1) miss too
PREFIX_TRACE = dict(n_requests=16, prefix_len=120, suffix_len=8,
                    gen_lens=[16, 32], n_prefixes=2, seed=0)
PREFIX_HITS = 6
# 8b's pool: the reference benchmark's n_slots * span_blocks - 4 = 76
# blocks is absorbed by LRU eviction of the index alone down to 73; at 72
# both the replay and the suspend run preempt
PREFIX_CUT_BLOCKS = 72
PREFIX_KEYS = ("tokens", "ticks", "decode_steps", "prefill_calls",
               "preemptions", "prefix_hits", "prefix_hit_tokens",
               "cow_copies", "swap_outs", "swap_ins", "index_evictions",
               "index_blocks", "index_tokens")


def time_swaps(torch, pool):
    """Wrap ``pool.swap_out`` / ``swap_in`` in CUDA events; returns the
    record {"out": [(ms, bytes)], "in": [...]} the calls fill."""
    seen = {"out": [], "in": []}
    for key in seen:
        orig = getattr(pool, f"swap_{key}")

        def wrapped(slot, *a, _orig=orig, _key=key):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _orig(slot, *a)
            end.record()
            end.synchronize()
            swap = out if _key == "out" else a[0]
            seen[_key].append((start.elapsed_time(end), swap.nbytes))
            return out
        setattr(pool, f"swap_{key}", wrapped)
    return seen


def prefix_run(torch, model, cfg, kw, reqs, what, swaps=None):
    """The graphed engine ``kw`` over ``reqs`` with every launch count
    zeroed just before and read just after, then its eager engine on the
    same trace (``swaps``: a dict the eager engine's swap times fill).
    Hard checks: tokens and ``PREFIX_KEYS`` graphed = eager, 0 mid-serve
    captures, the pool invariants (index pins included) after the run,
    and the index still pinning exactly the used blocks once the trace
    drained.  Returns (graphed engine, wall seconds, launches, eager
    engine, eager wall)."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, cfg, **kw)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.all_kernels()}
    ref = ServeEngine(model, cfg, **eager(kw))
    if swaps is not None:
        swaps.update(time_swaps(torch, ref.pool))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.run(reqs)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    st, es = eng.stats(), ref.stats()
    differ = compare_tokens(torch, ref, reqs, eng.results, f"{what} eager",
                            "eager", "graphed")
    moved = {k: (st[k], es[k]) for k in PREFIX_KEYS if st[k] != es[k]}
    for e in (eng, ref):
        e.check_invariants()
    if (differ or moved or st["mid_serve_compiles"]
            or eng.pool.used_blocks != st["index_blocks"]):
        raise SystemExit(f"{what}: graphed and eager differ in {differ} "
                         f"requests, counters {moved}; mid-serve captures "
                         f"{st['mid_serve_compiles']}; used blocks "
                         f"{eng.pool.used_blocks} against index blocks "
                         f"{st['index_blocks']}")
    return eng, wall, launches, ref, ref_wall


def phase_prefix(torch, model, cfg, kw):
    """Phase 8 (on phase 3's model and engine settings): the shared-prefix
    trace (16 requests, a 120-token system prompt of two + an 8-token
    suffix, gen 16/32).  8a, full pool: the non-sharing engine against
    ``prefix_cache=True``.  8b, a pool cut so both runs preempt: the
    prefix cache with ``preempt="replay"`` against ``"suspend"``.  Each
    engine graphed (prewarmed, strict) and against its eager engine."""
    from repro_torch.serve import shared_prefix_trace
    reqs = shared_prefix_trace(cfg, **PREFIX_TRACE)
    plen = PREFIX_TRACE["prefix_len"] + PREFIX_TRACE["suffix_len"]
    pkw = dict(kw, prefix_cache=True)
    base, base_wall, _, base_e, base_ewall = prefix_run(
        torch, model, cfg, kw, reqs, "phase 8a non-sharing")
    eng, wall, launches, ref, ewall = prefix_run(
        torch, model, cfg, pkw, reqs, "phase 8a prefix")
    st = eng.stats()
    want = eng.decode_steps * cfg.n_layers * LINEARS_PER_LAYER
    if (min(launches[name] for name in LLAMA_PATH) <= 0
            or launches["nm_spmv"] != want):
        raise SystemExit(f"phase 8a: a kernel of the path never launched, or "
                         f"nm_spmv not {want} times: {launches}")
    if (st["prefix_hits"] != PREFIX_HITS or st["cow_copies"] <= 0
            or st["prefill_calls"] + st["prefix_hits"] != len(reqs)
            or st["tokens"] != sum(r.max_new_tokens for r in reqs)):
        raise SystemExit(f"phase 8a: expected {PREFIX_HITS} hits, "
                         f"prefills + hits = {len(reqs)} and COW copies, "
                         f"got {st}")
    again, again_wall, _, _, _ = prefix_run(torch, model, cfg, pkw, reqs,
                                            "phase 8a prefix (again)")
    base2, base2_wall, _, _, _ = prefix_run(torch, model, cfg, kw, reqs,
                                            "phase 8a non-sharing (again)")
    if (moved_counters(again.stats(), st)
            or moved_counters(base2.stats(), base.stats())):
        raise SystemExit("phase 8a: a second run moved the counters")
    bs = base.stats()
    rate = [e.stats()["tokens"] / w for e, w in (
        (base, base_wall), (eng, wall), (again, again_wall),
        (base2, base2_wall))]
    log(f"[prefix] {cfg.name}: graphed tokens/s non-sharing, prefix, "
        f"prefix, non-sharing: {', '.join(f'{r:.1f}' for r in rate)} "
        f"(prefix / non-sharing {(rate[1] + rate[2]) / (rate[0] + rate[3]):.3f}"
        f"x; eager {bs['tokens'] / base_ewall:.1f} / "
        f"{st['tokens'] / ewall:.1f}); prefills {int(bs['prefill_calls'])} -> "
        f"{int(st['prefill_calls'])}; hits {int(st['prefix_hits'])} "
        f"({int(st['prefix_hit_tokens'])} tokens); COW copies "
        f"{int(st['cow_copies'])}; catch-up decode positions "
        f"{int(st['prefix_hits']) * plen - int(st['prefix_hit_tokens'])}; "
        f"decode steps {int(bs['decode_steps'])} -> "
        f"{int(st['decode_steps'])}; steady tick "
        f"{bs['steady_tick_s'] * 1e3:.2f} -> {st['steady_tick_s'] * 1e3:.2f} "
        f"ms; index {int(st['index_blocks'])} blocks "
        f"({st['index_blocks'] * st['kv_block_bytes'] / 2 ** 20:.1f} MiB), "
        f"{int(st['index_tokens'])} tokens, {int(st['index_evictions'])} "
        f"evictions")
    compare_tokens(torch, eng, reqs, base.results, f"phase 8a {cfg.name}",
                   "prefix", "non-sharing")

    ckw = dict(pkw, n_blocks=PREFIX_CUT_BLOCKS)
    rep, rep_wall, _, _, _ = prefix_run(torch, model, cfg, ckw, reqs,
                                        "phase 8b replay")
    swaps = {}
    sus, sus_wall, _, _, _ = prefix_run(
        torch, model, cfg, dict(ckw, preempt="suspend"), reqs,
        "phase 8b suspend", swaps=swaps)
    rs, ss = rep.stats(), sus.stats()
    if (rs["preemptions"] <= 0 or ss["preemptions"] <= 0
            or not ss["swap_outs"] == ss["swap_ins"] == ss["preemptions"]
            or ss["swap_bytes_resident"] or ss["ticks"] > rs["ticks"]):
        raise SystemExit(f"phase 8b: expected preemptions in both runs, "
                         f"swap-outs = swap-ins = preemptions, nothing left "
                         f"on the host and suspend ticks <= replay ticks; "
                         f"replay {rs}, suspend {ss}")
    out_ms, out_b = zip(*swaps["out"])
    in_ms, in_b = zip(*swaps["in"])
    pool = sus.pool
    log(f"[suspend] {cfg.name}: pool {PREFIX_CUT_BLOCKS} blocks "
        f"({pool.usable_blocks} usable, "
        f"{pool.usable_blocks * pool.bytes_per_block / 2 ** 20:.1f} MiB); "
        f"preemptions replay {int(rs['preemptions'])} / suspend "
        f"{int(ss['preemptions'])}; swap-outs {int(ss['swap_outs'])}, "
        f"swap-ins {int(ss['swap_ins'])}; moved {sum(out_b) / 2 ** 20:.1f} "
        f"MiB out, {sum(in_b) / 2 ** 20:.1f} MiB in; swap_out {sum(out_ms) / len(out_ms):.3f} ms "
        f"mean ({sum(out_ms):.2f} ms in all), swap_in "
        f"{sum(in_ms) / len(in_ms):.3f} ms mean ({sum(in_ms):.2f} ms) (CUDA "
        f"events, eager engine); prefills replay "
        f"{int(rs['prefill_calls'])} / suspend {int(ss['prefill_calls'])}; "
        f"ticks replay {int(rs['ticks'])} / suspend {int(ss['ticks'])}; "
        f"graphed tokens/s replay {rs['tokens'] / rep_wall:.1f} / suspend "
        f"{ss['tokens'] / sus_wall:.1f}; index evictions "
        f"{int(rs['index_evictions'])} / {int(ss['index_evictions'])}")
    for name, e in (("replay", rep), ("suspend", sus)):
        compare_tokens(torch, e, reqs, base.results,
                       f"phase 8b {cfg.name} {name}", name, "non-sharing")
    return launches


def _drop_log(ffn, cfg):
    """Wrap ``ffn.moe_route`` to count, per call, the routes over expert
    capacity (the dispatch drops them); returns (log list of (tokens,
    dropped), restore function).  Eager engines only: it reads back."""
    seen, orig = [], ffn.moe_route

    def wrapped(router, xt, k):
        out = orig(router, xt, k)
        t = xt.shape[0]
        cap = ffn._capacity(t, cfg.n_experts, k, cfg.capacity_factor)
        counts = ffn.expert_counts(out[2].reshape(-1), cfg.n_experts)
        seen.append((t, int((counts - cap).clamp_min(0).sum())))
        return out
    ffn.moe_route = wrapped
    return seen, lambda: setattr(ffn, "moe_route", orig)


def check_prefix_exact(torch, arch):
    """Hard check at full width, 4 layers, float32, 2 slots, one shared
    36-token prefix + 4 (prompts of 40 prefill 32 and catch up 8 through
    decode, so every run computes each position by the same route): the
    non-sharing engine, ``prefix_cache=True`` and the prefix cache with
    ``preempt="suspend"`` on a pool of 8 blocks emit the same tokens, and
    each equals its eager engine's (``debug_invariants=True`` throughout).
    For deepseek the eager runs count the routes over expert capacity: a
    decode batch of 2 stays under the floor of 8, so decode drops none."""
    from repro_torch.configs import get_config
    from repro_torch.models import ffn, init_model
    from repro_torch.serve import shared_prefix_trace
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=4, dtype="float32", sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    reqs = shared_prefix_trace(cfg, n_requests=6, prefix_len=36,
                               suffix_len=4, gen_lens=[12, 9], n_prefixes=1,
                               seed=11)
    kw = graphed(dict(n_slots=2, max_len=40 + 12, compressed=True,
                      kv="paged", attn="fused", block_size=16,
                      debug_invariants=True, device="cuda"))
    runs = {"non-sharing": kw, "prefix": dict(kw, prefix_cache=True),
            "suspend": dict(kw, prefix_cache=True, preempt="suspend",
                            n_blocks=8)}
    engines, line, drops = {}, [], []
    moe = cfg.n_experts > 0
    for name, k in runs.items():
        eng, _ = timed_run(torch, model, cfg, k, reqs)
        seen, restore = _drop_log(ffn, cfg) if moe else ([], lambda: None)
        try:
            ref, _ = timed_run(torch, model, cfg, eager(k), reqs)
        finally:
            restore()
        drops += seen
        for e in (eng, ref):
            e.check_invariants()
        if compare_tokens(torch, ref, reqs, eng.results,
                          f"phase 8 exact check {arch} {name} eager",
                          "eager", "graphed"):
            raise SystemExit(f"phase 8: float32 eager tokens differ from the "
                             f"graphed engine's ({arch} {name})")
        engines[name] = eng
        st = eng.stats()
        line.append(f"{name}: hits {int(st['prefix_hits'])}, COW "
                    f"{int(st['cow_copies'])}, preemptions "
                    f"{int(st['preemptions'])}, swap-outs "
                    f"{int(st['swap_outs'])}, ticks {int(st['ticks'])}")
    decode_drops = sum(d for t, d in drops if t == 2)
    log(f"[prefix] {arch} exact check (4 layers, float32, 2 slots, graphed "
        f"= eager): " + "; ".join(line)
        + (f"; routes over capacity: decode {decode_drops}, prefill "
           f"{sum(d for t, d in drops if t != 2)} (eager runs)" if moe
           else ""))
    base = engines["non-sharing"].results
    differ = sum(compare_tokens(torch, engines[name], reqs, base,
                                f"phase 8 exact check {arch} {name}", name,
                                "non-sharing")
                 for name in ("prefix", "suspend"))
    st = engines["suspend"].stats()
    if (differ or decode_drops or st["prefix_hits"] <= 0
            or st["swap_outs"] <= 0):
        raise SystemExit(f"phase 8: float32 tokens with the prefix cache or "
                         f"suspend differ from the non-sharing engine's in "
                         f"{differ} requests (decode routes dropped: "
                         f"{decode_drops}; the suspend run's hits "
                         f"{st['prefix_hits']}, swap-outs {st['swap_outs']})")
    del engines, model
    torch.cuda.empty_cache()


def phase_serve_deepseek(torch):
    """Full-width deepseek-v2-lite-16b at ``DEEPSEEK_SERVE_LAYERS`` of its
    27 layers, compressed as it is drawn (the dense bf16 model, ~31 GB at
    full depth, never exists at once)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models.config import param_count
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(n_layers=DEEPSEEK_SERVE_LAYERS,
                      sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] init {cfg.name}: {cfg.n_layers}L ({cfg.first_dense_layers} "
        f"dense) d{cfg.d_model} {cfg.n_heads}H MLA kv_lora {cfg.kv_lora} "
        f"rope {cfg.qk_rope_dim} v {cfg.v_head_dim}, {cfg.n_experts} experts "
        f"top-{cfg.top_k} + {cfg.n_shared_experts} shared (hidden "
        f"{cfg.moe_dff}), dense d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, {param_count(cfg) / 1e9:.2f} B params "
        f"({param_count(cfg, active_only=True) / 1e9:.2f} B active) in "
        f"{time.perf_counter() - t0:.1f}s; resident "
        f"{gib(torch.cuda.memory_allocated())}, peak "
        f"{gib(torch.cuda.max_memory_allocated())}")
    kw = graphed(dict(n_slots=8, max_len=128 + 32, compressed=True,
                      kv="paged", attn="fused", block_size=16,
                      device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, launches, wall, first_eager = serve_run(
        torch, model, cfg, DEEPSEEK_PATH, kw, "phase 4")
    log(f"[serve] {cfg.name} peak device memory in the runs "
        f"{gib(torch.cuda.max_memory_allocated())}")
    want = eng.decode_steps * cfg.n_layers
    if launches["paged_mla_decode"] != want:
        raise SystemExit(f"phase 4: paged_mla_decode launched "
                         f"{launches['paged_mla_decode']} times, expected "
                         f"{eng.decode_steps} ticks x {cfg.n_layers} layers")
    again = check_repeat(torch, model, cfg, kw, reqs, eng, "phase 4")
    busy = (profile_breakdown(torch, model, cfg, eager(kw)),
            profile_breakdown(torch, model, cfg, kw, time_calls=True))
    check_graphed(torch, model, cfg, kw, reqs, eng, wall, again,
                  first_eager, "phase 4", busy=busy)
    decompress_share(torch, model, cfg, eng, wall)
    from repro_torch.serve import SpecConfig
    spec = SpecConfig(k=SPAN - 1, draft="skip", stride=2)
    spec_launches = phase_spec(torch, model, cfg, kw, spec,
                               DEEPSEEK_SPEC_PATH, "paged_mla_verify", eng,
                               wall, "phase 6")
    del eng, model
    torch.cuda.empty_cache()
    check_deepseek_reference_route(torch)
    check_spec_exact(torch, "deepseek-v2-lite-16b", spec, "paged_mla_verify",
                     "phase 6")
    check_prefix_exact(torch, "deepseek-v2-lite-16b")
    check_slotted_exact(torch, "deepseek-v2-lite-16b")
    return {"deepseek-v2-lite-16b": launches,
            "deepseek-v2-lite-16b spec": spec_launches}


def decompress_share(torch, model, cfg, eng, wall):
    """What the faithful MoE costs: every decode tick and every prefill
    decompresses all E experts of all three stacks of every MoE layer to a
    dense view before the batched products."""
    from repro_torch.models import ffn
    moe = model.layers[0].moe
    sp = cfg.sparsity

    def views():
        return [ffn._stacked_dense_view(s, sp) for s in (moe.wg, moe.wu,
                                                          moe.wd)]
    ms = time_ms(torch, views, iters=5, warmup=1)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    dense_bytes = sum(s.w_vals.numel() * s.w_vals.element_size() * sp.m
                      // sp.n for s in (moe.wg, moe.wu, moe.wd))
    calls = eng.decode_steps + eng.prefill_calls
    total = ms * n_moe * calls / 1e3
    log(f"[moe] decompressing one MoE layer's experts (3 stacks, "
        f"{gib(dense_bytes)} of bf16 written) takes {ms:.3f} ms; x {n_moe} "
        f"layers = {ms * n_moe:.1f} ms per decode tick or prefill; "
        f"{calls} such calls in the graphed run = {total:.2f} s of its "
        f"{wall:.2f} s wall ({100 * total / wall:.1f}%)")


def _route_log(ffn):
    """Wrap ``ffn.moe_route`` to record every call's expert ids; returns
    (log list, restore function)."""
    seen, orig = [], ffn.moe_route

    def wrapped(router, xt, k):
        out = orig(router, xt, k)
        seen.append(out[2].sort(-1).values.cpu())
        return out
    ffn.moe_route = wrapped
    return seen, lambda: setattr(ffn, "moe_route", orig)


def check_deepseek_reference_route(torch):
    """Full width, reduced depth (1 dense + 3 MoE layers), float32: the
    kernel route against the reference route, router top-k sets compared
    call by call."""
    from repro_torch.configs import get_config
    from repro_torch.models import ffn, init_model
    from repro_torch.serve import synthetic_trace
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(n_layers=4, dtype="float32", sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=4, prompt_len=32, gen_lens=[4],
                           seed=7)
    seen, restore = _route_log(ffn)
    try:
        check_reference_route(torch, model, cfg, reqs, LOGIT_ATOL_F32,
                              "phase 4", routing=seen)
    finally:
        restore()


def check_reference_route(torch, model, cfg, reqs, tol, phase,
                          n_steps: int = 4, routing=None):
    """The engine's prefills and first decode steps through the kernel
    route and through the reference route (impl='ref' decompress + f32
    product, attn='gather'), both teacher-forced with the kernel route's
    greedy tokens; logits must agree within ``tol``.  With ``routing`` (the
    list ``_route_log`` fills), the router top-k sets of the two routes are
    compared call by call and their agreement printed."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import BlockPool
    ref_cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                       impl="ref"))
    n = len(reqs)
    plen = reqs[0].prompt_len
    pools = {r: BlockPool(cfg, n, plen + n_steps, 16, device="cuda")
             for r in ("kernel", "ref")}
    routed = {"kernel": [], "ref": []}

    def take_routing(route):
        if routing is not None:
            routed[route].extend(routing)
            routing.clear()

    worst, agree, total = 0.0, 0, 0
    first = []
    for slot, req in enumerate(reqs):
        batch = prompt_batch(torch, model, req.inputs)
        out = {}
        for route, c in (("kernel", cfg), ("ref", ref_cfg)):
            pool = pools[route]
            pool.alloc(slot, pool.blocks_for(plen))
            out[route], pf = prefill(model, c, batch)
            pool.seed(slot, pf, plen)
            take_routing(route)
        worst = max(worst, float((out["kernel"] - out["ref"]).abs().max()))
        agree += int(out["kernel"].argmax() == out["ref"].argmax())
        total += 1
        first.append(int(out["kernel"].argmax()))
        if not bool(torch.isfinite(out["kernel"]).all()):
            raise SystemExit(f"{phase}: non-finite prefill logits")
    tok = torch.tensor(first, dtype=torch.long, device="cuda")
    pos = torch.full((n,), plen, dtype=torch.int32, device="cuda")
    for _ in range(n_steps):
        logits = {}
        for route, c, attn in (("kernel", cfg, "fused"),
                               ("ref", ref_cfg, "gather")):
            pool = pools[route]
            for slot in range(n):
                pool.ensure(slot, int(pos[slot]))
            logits[route], _ = decode_step(model, c, pool.caches, tok, pos,
                                           pool.device_table(),
                                           attn_impl=attn)
            take_routing(route)
        lk, lr = logits["kernel"], logits["ref"]
        if (tuple(lk.shape) != (n, cfg.vocab)
                or not bool(torch.isfinite(lk).all())):
            raise SystemExit(f"{phase}: bad decode logits {tuple(lk.shape)}")
        worst = max(worst, float((lk - lr).abs().max()))
        agree += int((lk.argmax(-1) == lr.argmax(-1)).sum())
        total += n
        tok = lk.argmax(-1)
        pos += 1
    extra = ""
    if routing is not None:
        sets = sum(a.shape[0] for a in routed["kernel"])
        same = sum(int((a == b).all(-1).sum())
                   for a, b in zip(routed["kernel"], routed["ref"]))
        extra = (f", router top-{cfg.top_k} sets agreeing {same}/{sets} "
                 f"({100 * same / max(sets, 1):.2f}%) over "
                 f"{len(routed['kernel'])} MoE calls")
    log(f"[ref] {cfg.name} ({cfg.n_layers}L, {cfg.dtype}) kernel route vs "
        f"reference route (impl=ref, attn=gather) over {n} prefills + "
        f"{n_steps} decode steps: max |dlogit| {worst:.3e} (tol {tol}), "
        f"greedy-token agreement {agree}/{total}{extra}")
    if worst > tol:
        raise SystemExit(f"{phase}: kernel route disagrees with the reference "
                         f"route beyond tolerance")


# ------------------------------------------------------------------ phase 9

# 9b's trace, the shape of ``benchmarks/serve_paged.py`` at full width:
# short ragged requests that all span 64 positions (4 blocks of 16), a
# budget of 8 such requests' blocks, and slotted rows of max_len 256 (16
# blocks) that the same bytes hold only 2 of
PAGED_PROMPTS = (40, 44, 48, 52)
PAGED_GENS = (25, 21, 17, 13)
PAGED_MAX_LEN = 256
PAGED_SLOTS = 8
SEQ_PATH = ("nm_spmv", "nm_xwt")


def slotted_run(torch, model, cfg, kw, reqs, what):
    """The slotted engine ``kw`` as every slotted run is measured: graphed,
    prewarmed with the trace's prompt lengths, strict; launch counts
    zeroed just before the run and read just after; then its eager engine
    on the same trace, tokens and counters compared (hard: a flip fails).
    Returns (engine, wall, launches, eager engine, eager wall)."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    out = []
    for ekw in (dict(kw, strict_prewarm=True), eager(kw)):
        eng = ServeEngine(model, cfg, **ekw)
        eng.prewarm(prompt_lens=sorted({r.prompt_len for r in reqs}))
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        out += [eng, time.perf_counter() - t0,
                {k.name: k.launches for k in kernels.all_kernels()}]
    eng, wall, launches, ref, ref_wall, _ = out
    st = eng.stats()
    differ = compare_tokens(torch, ref, reqs, eng.results, f"{what} eager",
                            "eager", "graphed")
    moved = moved_counters(st, ref.stats())
    if (differ or moved or not eng.graphs or st["mid_serve_compiles"]
            or eng.kv != "slotted"):
        raise SystemExit(f"{what}: the graphed slotted engine differs from "
                         f"its eager engine in {differ} requests, counters "
                         f"{moved}, or captured mid-serve "
                         f"({st['mid_serve_compiles']:.0f})")
    return eng, wall, launches, ref, ref_wall


def sequential_run(torch, runner, reqs, n_slots, max_len):
    """``FixedBatch.serve_sequential`` timed, synchronised -> (results,
    stats, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, st = runner.serve_sequential(reqs, n_slots, max_len)
    torch.cuda.synchronize()
    return res, st, time.perf_counter() - t0


def check_path(launches, path, what, **exact):
    """Every kernel of ``path`` launched in the run, and each of ``exact``
    exactly that many times."""
    bad = [k for k in path if launches[k] <= 0]
    bad += [f"{k} {launches[k]} != {n}" for k, n in exact.items()
            if launches[k] != n]
    if bad:
        raise SystemExit(f"{what}: path kernels that never launched or "
                         f"launched off count: {bad} ({launches})")


def seq_occupancy(reqs, n_slots, steps):
    """The fixed batch's mean occupancy: a request of budget g is a live
    row for g - 1 of its batch's decode steps (the benchmark's rule)."""
    return sum(r.max_new_tokens - 1 for r in reqs) / max(n_slots * steps, 1)


def phase_slotted(torch, model, cfg, kw, card):
    """Phase 9 on phase 3's full-width llama3.2-1b (bf16; compressed 2:4
    at engine init, or once up front for the oracle and ``forward``)."""
    from repro_torch import kernels
    from repro_torch.models import convert_to_compressed, forward, loss_fn
    from repro_torch.serve import ServeEngine, synthetic_request, \
        synthetic_trace
    from repro_torch.serve.sequential import FixedBatch
    import math

    import numpy as np
    t_phase = time.perf_counter()
    log(f"[phase 9] slotted layout, sequential oracle, forward / loss_fn: "
        f"{cfg.name} full width on {card}")
    ccfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                    mode="compressed"))
    cmodel = convert_to_compressed(model, cfg)
    path = {}

    # ---- 9a serve_throughput: the sequential oracle against the engine
    reqs = synthetic_trace(cfg, n_requests=16, prompt_len=128,
                           gen_lens=[16, 32], seed=0)
    n, max_len = kw["n_slots"], kw["max_len"]
    runner = FixedBatch(cmodel, ccfg, device="cuda")
    runner.serve_sequential(reqs[:n], n, max_len)   # captures, not counted
    kernels.reset_launch_counts()
    seq, sst, seq_wall = sequential_run(torch, runner, reqs, n, max_len)
    path["sequential"] = {k.name: k.launches for k in kernels.all_kernels()}
    steps = int(sst["decode_steps"])
    check_path(path["sequential"], SEQ_PATH, "phase 9a sequential",
               nm_spmv=steps * cfg.n_layers * LINEARS_PER_LAYER,
               nm_xwt=2 * cfg.n_layers * LINEARS_PER_LAYER,
               paged_gqa_decode=0)
    eager_seq, _, eager_wall = sequential_run(
        torch, FixedBatch(cmodel, ccfg, device="cuda", graphs=False), reqs,
        n, max_len)
    if compare_tokens(torch, _Results(eager_seq, cmodel, ccfg), reqs, seq,
                      "phase 9a sequential eager", "eager", "graphed"):
        raise SystemExit("phase 9a: the graphed oracle's tokens differ from "
                         "its eager run's")
    cont, cont_wall = timed_run(torch, model, cfg, kw, reqs)
    cont2, cont2_wall = timed_run(torch, model, cfg, kw, reqs)
    _, sst2, seq2_wall = sequential_run(torch, runner, reqs, n, max_len)
    cs = cont.stats()
    tokens = sum(r.max_new_tokens for r in reqs)
    if steps != 62 or cs["tokens"] != tokens:
        raise SystemExit(f"phase 9a: expected 62 sequential decode steps "
                         f"and {tokens} tokens, got {steps} / {cs['tokens']}")
    log(f"[9a serve_throughput] {cfg.name}, 16 x 128 prompt, gen 16/32, "
        f"{n} slots, graphed: sequential (slotted, fixed batches) "
        f"{tokens / seq_wall:.1f} / {tokens / seq2_wall:.1f} tokens/s, "
        f"{steps} decode steps, occupancy "
        f"{seq_occupancy(reqs, n, steps):.3f} (eager {tokens / eager_wall:.1f}"
        f" tokens/s, {sst['graphs']:.0f} graphs); continuous (paged, fused) "
        f"{tokens / cont_wall:.1f} / {tokens / cont2_wall:.1f} tokens/s, "
        f"{int(cs['decode_steps'])} decode steps, occupancy "
        f"{cs['occupancy']:.3f}; continuous / sequential "
        f"{(seq_wall + seq2_wall) / (cont_wall + cont2_wall):.2f}x tokens/s,"
        f" {steps / cs['decode_steps']:.2f}x fewer steps (order: sequential, "
        f"continuous, continuous, sequential)")
    compare_tokens(torch, cont, reqs, seq, f"phase 9a {cfg.name}",
                   "continuous", "sequential")

    # ---- 9b serve_paged: paged against slotted at equal usable KV bytes
    rng = np.random.default_rng(0)
    preqs = [synthetic_request(cfg, rng, rid=i,
                               prompt_len=PAGED_PROMPTS[i % 4],
                               max_new_tokens=PAGED_GENS[i % 4])
             for i in range(16)]
    bsz = kw["block_size"]
    span = max(p + g - 1 for p, g in zip(PAGED_PROMPTS, PAGED_GENS))
    budget = PAGED_SLOTS * -(-span // bsz)
    rows = budget // -(-PAGED_MAX_LEN // bsz)
    skw = dict(n_slots=rows, max_len=PAGED_MAX_LEN, compressed=True,
               device="cuda")
    sl, sl_wall, path["slotted"], _, sl_ewall = slotted_run(
        torch, model, cfg, skw, preqs, "phase 9b slotted")
    check_path(path["slotted"], SEQ_PATH, "phase 9b slotted",
               nm_spmv=sl.decode_steps * cfg.n_layers * LINEARS_PER_LAYER,
               nm_xwt=len(preqs) * cfg.n_layers * LINEARS_PER_LAYER,
               paged_gqa_decode=0)
    pkw = dict(kw, n_slots=PAGED_SLOTS, max_len=PAGED_MAX_LEN,
               n_blocks=budget + 1)
    pg, pg_wall, _, _, pg_ewall = prefix_run(torch, model, cfg, pkw, preqs,
                                             "phase 9b paged")
    ss, ps = sl.stats(), pg.stats()
    log(f"[9b serve_paged] {cfg.name}, 16 requests of prompt "
        f"{PAGED_PROMPTS} / gen {PAGED_GENS} (span {span}), equal usable KV "
        f"{budget} blocks of {bsz} = {budget * bsz} positions: slotted "
        f"{rows} rows x {PAGED_MAX_LEN}, ticks {int(ss['ticks'])}, peak KV "
        f"{mib(ss['kv_bytes_resident'])} (preallocated), prefill lengths "
        f"{sorted(sl.prefill_lengths)}, occupancy {ss['occupancy']:.3f}, "
        f"{ss['tokens'] / sl_wall:.1f} tokens/s (eager "
        f"{ss['tokens'] / sl_ewall:.1f}); paged {PAGED_SLOTS} slots, ticks "
        f"{int(ps['ticks'])}, peak KV {mib(ps['kv_bytes_peak'])} of "
        f"{mib(ps['kv_bytes_capacity'])}, prefill lengths "
        f"{sorted(pg.prefill_lengths)} (buckets {pg.prefill_buckets}), "
        f"preemptions {int(ps['preemptions'])}, occupancy "
        f"{ps['occupancy']:.3f}, {ps['tokens'] / pg_wall:.1f} tokens/s "
        f"(eager {ps['tokens'] / pg_ewall:.1f}); paged / slotted ticks "
        f"{ps['ticks'] / ss['ticks']:.3f}")
    if ps["ticks"] >= ss["ticks"] or ss["kv_bytes_resident"] != \
            ps["kv_bytes_capacity"]:
        raise SystemExit(f"phase 9b: paged should finish in fewer ticks at "
                         f"equal KV bytes: {ps} against {ss}")
    compare_tokens(torch, pg, preqs, sl.results, f"phase 9b {cfg.name}",
                   "paged", "slotted")

    # ---- 9c serve_compressed: dense against compressed weights, slotted
    runs = {}
    for name, comp in (("dense", False), ("compressed", True)):
        runs[name] = slotted_run(
            torch, model, cfg, dict(kw, kv="slotted", attn="gather",
                                    compressed=comp, prewarm=False,
                                    strict_prewarm=False), reqs,
            f"phase 9c {name}")
    (de, de_wall), (ce, ce_wall) = ((runs[k][0], runs[k][1])
                                    for k in ("dense", "compressed"))
    ds, cst = de.stats(), ce.stats()
    ratio = cst["weight_stream_bytes"] / ds["weight_stream_bytes"]
    # N/M of the values plus ceil(log2 M) index bits per kept value
    sp = cfg.sparsity
    want = sp.n / sp.m * (1 + (sp.m - 1).bit_length()
                          / torch.finfo(cfg.tdtype()).bits)
    log(f"[9c serve_compressed] {cfg.name}, 9a's trace, slotted engine, "
        f"graphed: weight stream per decode step dense "
        f"{ds['weight_stream_bytes'] / 1e9:.4f} GB, compressed "
        f"{cst['weight_stream_bytes'] / 1e9:.4f} GB (ratio {ratio:.4f}, "
        f"N:M formula {want:.4f}); "
        f"tokens/s dense {ds['tokens'] / de_wall:.1f}, compressed "
        f"{cst['tokens'] / ce_wall:.1f}; decode steps "
        f"{int(ds['decode_steps'])} / {int(cst['decode_steps'])} against the "
        f"sequential oracle's {steps}; nm_spmv launches dense "
        f"{runs['dense'][2]['nm_spmv']}, compressed "
        f"{runs['compressed'][2]['nm_spmv']}")
    if abs(ratio - want) > 1e-9 or runs["compressed"][2]["nm_spmv"] <= 0:
        raise SystemExit(f"phase 9c: expected the {want} stream ratio and "
                         f"the compressed engine on nm_spmv: {cst}")
    compare_tokens(torch, ce, reqs, de.results, f"phase 9c {cfg.name}",
                   "compressed", "dense")

    # ---- 9d serve_paged_attn: the gather read against the fused kernel
    gt, gt_wall, glaunch, _, _ = prefix_run(
        torch, model, cfg, dict(pkw, attn="gather"), preqs,
        "phase 9d gather")
    log(f"[9d serve_paged_attn] {cfg.name}, 9b's paged trace, graphed: "
        f"fused {ps['tokens'] / pg_wall:.1f} tokens/s, gather "
        f"{gt.stats()['tokens'] / gt_wall:.1f} tokens/s (gather / fused "
        f"{pg_wall / gt_wall:.3f}x); paged_gqa_decode launches with gather "
        f"{glaunch['paged_gqa_decode']}")
    if glaunch["paged_gqa_decode"]:
        raise SystemExit("phase 9d: the gather read launched the fused "
                         "kernel")
    compare_tokens(torch, gt, preqs, pg.results, f"phase 9d {cfg.name}",
                   "gather", "fused")

    # ---- forward / loss_fn at full width, kernel route against reference
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 128), generator=gen,
                         device="cuda")
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    ref_cfg = ccfg.replace(sparsity=dataclasses.replace(ccfg.sparsity,
                                                        impl="ref"))
    kernels.reset_launch_counts()
    logits, _ = forward(cmodel, ccfg, batch)
    torch.cuda.synchronize()
    path["forward"] = {k.name: k.launches for k in kernels.all_kernels()}
    check_path(path["forward"], ("nm_xwt",), "phase 9 forward",
               nm_xwt=cfg.n_layers * LINEARS_PER_LAYER, nm_spmv=0)
    want, _ = forward(cmodel, ref_cfg, batch)
    worst = float((logits - want).abs().max())
    loss_k, loss_r = (float(loss_fn(cmodel, c, batch)[1]["loss"])
                      for c in (ccfg, ref_cfg))
    log(f"[forward] {cfg.name} forward [2, 128] compressed: logits "
        f"{tuple(logits.shape)} {str(logits.dtype).replace('torch.', '')}, "
        f"kernel route (nm_xwt) vs reference route (impl=ref) max |dlogit| "
        f"{worst:.3e} (tol {LOGIT_ATOL}); loss_fn loss {loss_k:.6f} / "
        f"{loss_r:.6f} (ln vocab {math.log(cfg.vocab):.3f})")
    if (worst > LOGIT_ATOL or not bool(torch.isfinite(logits).all())
            or not math.isfinite(loss_k)):
        raise SystemExit("phase 9: forward's kernel route disagrees with the "
                         "reference route beyond tolerance")
    del logits, want, cmodel, runner
    log(f"[time] phase 9 {time.perf_counter() - t_phase:.1f}s")
    return {f"{cfg.name} {p}": c for p, c in path.items()}


class _Results:
    """The oracle's results dressed as an engine for ``compare_tokens``."""

    def __init__(self, results, model, cfg):
        self.results, self.model, self.cfg = results, model, cfg


def check_slotted_exact(torch, arch):
    """Hard check at full width, 4 layers, float32, 2 slots: the slotted
    engine, the paged engine and the sequential oracle emit the same
    tokens, each equal to its eager run's, and ``forward``'s kernel route
    is within 1e-3 of the reference route.  Prompts are a prefill bucket
    (the paged engine prefills them whole, as the others do).  deepseek:
    equal budgets (every run batches the same rows) and prompts of 4, so
    no batch can route more than the expert-capacity floor of 8 to one
    expert and no route drops anywhere."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model
    from repro_torch.serve import synthetic_trace
    from repro_torch.serve.sequential import FixedBatch
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=4, dtype="float32", sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    moe = cfg.n_experts > 0
    plen, gens = (4, [12]) if moe else (32, [12, 9])
    reqs = synthetic_trace(cfg, n_requests=4, prompt_len=plen,
                           gen_lens=gens, seed=11)
    max_len = plen + 12
    sl, _, _, _, _ = slotted_run(torch, model, cfg, dict(
        n_slots=2, max_len=max_len, compressed=True, device="cuda"), reqs,
        f"phase 9 exact check {arch} slotted")
    pg, _, _, _, _ = prefix_run(torch, model, cfg, graphed(dict(
        n_slots=2, max_len=max_len, compressed=True, kv="paged",
        attn="fused", block_size=16, device="cuda")), reqs,
        f"phase 9 exact check {arch} paged")
    seq = {}
    for graphs in (True, False):
        seq[graphs], _ = FixedBatch(model, cfg, device="cuda",
                                    graphs=graphs).serve_sequential(
            reqs, 2, max_len)
    differ = (compare_tokens(torch, pg, reqs, sl.results,
                             f"phase 9 exact check {arch}", "paged",
                             "slotted")
              + compare_tokens(torch, _Results(seq[True], model, cfg), reqs,
                               sl.results, f"phase 9 exact check {arch}",
                               "sequential", "slotted")
              + compare_tokens(torch, _Results(seq[False], model, cfg), reqs,
                               seq[True], f"phase 9 exact check {arch}",
                               "sequential eager", "sequential graphed"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                                     device="cuda")}
    ref_cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                       impl="ref"))
    (lk, aux_k), (lr, aux_r) = (forward(model, c, batch)
                                for c in (cfg, ref_cfg))
    worst = float((lk - lr).abs().max())
    log(f"[slotted] {arch} exact check (4 layers, float32, 2 slots, "
        f"prompt {plen}, gen {gens}): slotted = paged = sequential tokens in "
        f"{len(reqs) * 3 - differ}/{len(reqs) * 3} comparisons, each graphed "
        f"= eager; forward [2, 32] kernel vs reference route max |dlogit| "
        f"{worst:.3e} (tol {LOGIT_ATOL_F32}), moe_aux {float(aux_k):.6f} / "
        f"{float(aux_r):.6f}")
    if differ or worst > LOGIT_ATOL_F32:
        raise SystemExit(f"phase 9: float32 slotted, paged and sequential "
                         f"tokens differ in {differ} requests, or forward "
                         f"is off by {worst:.3e} ({arch})")
    del sl, pg, model
    torch.cuda.empty_cache()


# device kernel symbol -> label (first match wins); each family's one
# attention kernel runs its decode (S = 1) and verify (S = k + 1)
# launches; nm_xwt.cu's bf16 tensor-core body and its split reduction
# are nm_xwt_*; its first bf16 body and its f32 split-TF32 body are
# templated on the orientation (false: nm_xwt, int8 or packed; true:
# nm_spmm), the f32 split sums are nm_tf32_reduce
PROFILE_LABELS = (("nm_spmv_onehot", "nm_spmv onehot"), ("nm_spmv", "nm_spmv"),
                  ("nm_xwt_", "nm_xwt"),
                  ("nm_bf16_kernel<false", "nm_xwt"),
                  ("nm_tf32_kernel<2, false", "nm_xwt"),
                  ("nm_tf32_kernel<4, false", "nm_xwt"),
                  ("nm_bf16_kernel<true", "nm_spmm"),
                  ("nm_tf32_kernel<2, true", "nm_spmm"),
                  ("nm_tf32_kernel<4, true", "nm_spmm"),
                  ("nm_tf32_reduce", "nm_xwt / nm_spmm f32 split sums"),
                  ("paged_gqa_verify", "paged GQA attention (decode+verify)"),
                  ("paged_mla_verify", "paged MLA attention (decode+verify)"))


def device_events(prof, skip=()) -> list:
    """(device us, launches, name) of each kernel, copy and fill that a
    ``torch.profiler`` trace recorded on the card, the events whose names
    start with ``skip`` left out.  Raises where it recorded no device
    time."""
    out = []
    for ev in prof.key_averages():
        if ("CUDA" not in str(getattr(ev, "device_type", ""))
                or ev.key.startswith(skip)):
            continue            # host ops: their kernels are counted here
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            out.append((us, ev.count, ev.key))
    if not out:
        raise SystemExit("profile: the trace recorded no device time")
    return out


def is_gemm(name: str) -> bool:
    """cuBLAS's products (on Hopper it names its gemms nvjet_*)."""
    low = name.lower()
    return any(s in low for s in ("gemm", "cutlass", "nvjet"))


def profile_breakdown(torch, model, cfg, kw, time_calls: bool = False):
    """Where the time goes: device time by kernel over a traced engine run
    (8 requests, 128 prompt tokens, 16 generated), against its wall time,
    for the graphed engine or the eager one (``kw``; the prewarm happens
    before the trace).  The trace itself slows the host, so the wall here
    is not the rate.  With ``time_calls`` a second, untraced run of the
    same trace times each decode tick and each prefill (one call of the
    entry point: a graph replay or an eager forward) on the host clock,
    synchronised.  Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeEngine, synthetic_trace
    from repro_torch.serve.prewarm import GraphEntry
    reqs = synthetic_trace(cfg, n_requests=8, prompt_len=128, gen_lens=[16],
                           seed=5)
    eng = ServeEngine(model, cfg, **kw)
    mode = "graphed" if eng.graphs else "eager"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, kernels = {}, []
    for us, count, name in device_events(prof):
        label = next((v for k, v in PROFILE_LABELS if k in name), None)
        if label is None:
            if is_gemm(name):
                label = "cuBLAS gemm"
            elif "scatter" in name.lower():
                label = "scatter (decompress)"
            else:
                label = "other"
        groups[label] = groups.get(label, 0.0) + us / 1e3
        kernels.append((us / 1e3, count, name[:60]))
    busy = sum(groups.values())
    parts = ", ".join(f"{k} {v:.2f} ms" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    share = busy / (wall * 1e3)
    log(f"[profile] {cfg.name} {mode} traced run "
        f"({eng.stats()['decode_steps']:.0f} "
        f"decode steps, {eng.prefill_calls} prefills): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * share:.1f}%): {parts}")
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        log(f"[profile]   {ms:9.2f} ms  {count:6d}x  {name}")
    if not time_calls:
        return share
    spent = {"decode": [], "prefill": []}
    orig = GraphEntry.__call__

    def timed(self, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(self, *a)
        torch.cuda.synchronize()
        if self.name in spent:
            spent[self.name].append(time.perf_counter() - t)
        return out
    again = ServeEngine(model, cfg, **kw)
    GraphEntry.__call__ = timed
    try:
        again.run(reqs)
    finally:
        GraphEntry.__call__ = orig
    for name, ts in spent.items():
        log(f"[profile] {cfg.name} {mode} {name}: {len(ts)} calls, mean "
            f"{1e3 * sum(ts) / len(ts):.2f} ms, min {1e3 * min(ts):.2f} ms "
            f"(host clock, synchronised)")
    return share


# ----------------------------------------------------------------- phase 10

# one gemma2-9b layer's seven linears (out, in): wq, wk, wv, wo, wg, wu, wd
GEMMA_LAYER_SHAPES = [(4096, 3584), (2048, 3584), (2048, 3584), (3584, 4096),
                      (14336, 3584), (14336, 3584), (3584, 14336)]
GEMMA_CHECK_SHAPES = [(4096, 3584), (2048, 3584), (3584, 4096),
                      (14336, 3584), (3584, 14336)]
# phase 10's depth: 4 of gemma2-9b's 21 local / global pairs (widths as
# published), cut from 42 layers when phase 11 came, to keep the run's time
GEMMA_SERVE_LAYERS = 8
# 10b: prompts past the window (4096) by 64, not a multiple of it
WINDOW_PROMPT, WINDOW_GEN, WINDOW_MAX_LEN = 4160, 32, 4224
GEMMA_EXACT_PROMPTS = (4160, 4160, 128, 128)
GEMMA_EXACT_GENS = (12, 9, 12, 9)


def drawn_params(model, cfg) -> int:
    """Elements of the tensors ``init_model`` drew (a compressed linear
    counted at its dense shape): the model's real size, where
    ``param_count`` keeps the reference's formula (a gelu MLP as 2 d d_ff,
    though the MLP is gated)."""
    from repro_torch.core.layers import SparseLinear
    sp = cfg.sparsity
    n = 0
    for mod in model.modules():
        if isinstance(mod, SparseLinear):
            n += (mod.w_vals.numel() * sp.m // sp.n if mod.compressed
                  else mod.w.numel())
        else:
            n += sum(t.numel() for t in (*mod.parameters(recurse=False),
                                         *mod.buffers(recurse=False)))
    return n


def tick_floor_ms(st, cfg, kv_positions):
    """Byte floor of one decode tick: the weight stream, the tied LM head's
    table and the K/V the slots' windows read, over the memory rate."""
    head = cfg.vocab * cfg.d_model * 2
    kv = kv_positions * cfg.n_kv * cfg.hd() * 2 * 2
    return (st["weight_stream_bytes"] + head + kv) / HBM_BYTES_PER_S * 1e3


def phase_gemma2(torch, card):
    """Phase 10: full-width gemma2-9b at ``GEMMA_SERVE_LAYERS`` of its 42
    layers (local (window 4096) / global pairs, d 3584, 16 heads over 8 KV
    heads of 256, d_ff 14336, vocab 256000 tied, softcaps 50 / 30, bf16,
    2:4 compressed as drawn)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models.config import param_count
    from repro_torch.serve import ServeEngine, SpecConfig, synthetic_trace
    from repro_torch.serve.sequential import FixedBatch
    t_phase = time.perf_counter()
    cfg = get_config("gemma2-9b")
    cfg = cfg.replace(n_layers=GEMMA_SERVE_LAYERS,
                      sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[phase 10] init {cfg.name}: {cfg.n_layers}L ({cfg.n_layers // 2} "
        f"local / global pairs, window {cfg.window}) d{cfg.d_model} "
        f"{cfg.n_heads}H/{cfg.n_kv}KV hd {cfg.hd()} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab} tied, softcaps {cfg.softcap_attn} / "
        f"{cfg.softcap_final}, {cfg.dtype}, 2:4 compressed as drawn: "
        f"{drawn_params(model, cfg) / 1e9:.3f} B drawn parameters "
        f"(param_count's formula {param_count(cfg) / 1e9:.3f} B) in "
        f"{time.perf_counter() - t0:.1f}s; resident "
        f"{gib(torch.cuda.memory_allocated())}, peak "
        f"{gib(torch.cuda.max_memory_allocated())} on {card}")
    path = {}

    # ---- 10a: phase 3's trace on the paged fused engine
    kw = graphed(dict(n_slots=8, max_len=128 + 32, compressed=True,
                      kv="paged", attn="fused", block_size=16,
                      device="cuda"))
    eng, reqs, launches, wall, first_eager = serve_run(
        torch, model, cfg, LLAMA_PATH, kw, "phase 10a")
    path[cfg.name] = launches
    ticks = eng.decode_steps
    check_path(launches, LLAMA_PATH, "phase 10a",
               nm_spmv=ticks * cfg.n_layers * LINEARS_PER_LAYER,
               paged_gqa_decode=ticks * cfg.n_layers)
    again = check_repeat(torch, model, cfg, kw, reqs, eng, "phase 10a")
    busy = profile_breakdown(torch, model, cfg, kw)
    check_graphed(torch, model, cfg, kw, reqs, eng, wall, again,
                  first_eager, "phase 10a", last_eager=False,
                  busy=(None, busy))
    st = eng.stats()
    # a steady tick of 8 slots reads at most 8 x 160 positions per layer
    floor = tick_floor_ms(st, cfg, 8 * 160 * cfg.n_layers)
    log(f"[10a] {cfg.name}: {st['tokens'] / wall:.1f} tokens/s graphed, "
        f"steady tick {st['steady_tick_s'] * 1e3:.2f} ms against a byte "
        f"floor of {floor:.2f} ms (weight stream "
        f"{st['weight_stream_bytes'] / 1e9:.3f} GB + LM head "
        f"{cfg.vocab * cfg.d_model * 2 / 1e9:.3f} GB + K/V, at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); launches nm_spmv "
        f"{launches['nm_spmv']} = {ticks} ticks x {cfg.n_layers} x "
        f"{LINEARS_PER_LAYER}, paged_gqa_decode "
        f"{launches['paged_gqa_decode']} = {ticks} x {cfg.n_layers}, "
        f"nm_xwt {launches['nm_xwt']}")

    log(f"[time] phase 10a {time.perf_counter() - t_phase:.1f}s")

    # ---- 10c: the same trace with rerank speculation
    spec = SpecConfig(k=SPAN - 1, draft="rerank")
    # 10a already checked a second run and traced the tick
    path[f"{cfg.name} spec"] = phase_spec(
        torch, eng.model, eng.cfg, kw, spec, LLAMA_SPEC_PATH,
        "paged_gqa_verify", eng, wall, "phase 10c", repeat=False)
    err, same = verify_vs_decode(torch, eng.model, eng.cfg,
                                 reqs[0].inputs["tokens"], seed=22)
    log(f"[10c] {cfg.name} bf16, {cfg.n_layers} layers: a verify span of "
        f"{SPAN} after a 128-token prompt against {SPAN} decode steps on the "
        f"same pool: "
        f"max |dlogit| {err:.3e}, greedy tokens "
        f"{'equal' if same else 'differ'} (the linears run nm_xwt in the "
        f"span and nm_spmv in decode, each rounding to bf16)")
    del eng, first_eager
    free_card(torch)
    log(f"[time] phase 10c {time.perf_counter() - t_phase:.1f}s")

    # ---- 10b: the window bites (prompts of 4160 past the 4096 window)
    wreqs = synthetic_trace(cfg, n_requests=2, prompt_len=WINDOW_PROMPT,
                            gen_lens=[WINDOW_GEN], seed=21)
    base = dict(n_slots=2, max_len=WINDOW_MAX_LEN, compressed=True,
                device="cuda")
    results, parts = {}, []
    for name, k in (("paged fused", graphed(dict(
                        base, kv="paged", attn="fused", block_size=16,
                        prefill_buckets=(WINDOW_PROMPT,)))),
                    ("paged gather", graphed(dict(
                        base, kv="paged", attn="gather", block_size=16,
                        prefill_buckets=(WINDOW_PROMPT,)))),
                    ("slotted", dict(base, strict_prewarm=True))):
        e = ServeEngine(model, cfg, **k)
        if e.kv == "slotted":
            e.prewarm(prompt_lens=[WINDOW_PROMPT])
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.run(wreqs)
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        launched = {kk.name: kk.launches for kk in kernels.all_kernels()}
        es = e.stats()
        if es["mid_serve_compiles"] or es["tokens"] != 2 * WINDOW_GEN:
            raise SystemExit(f"phase 10b {name}: {es['tokens']} tokens, "
                             f"{es['mid_serve_compiles']} mid-serve "
                             f"captures")
        kv = (es["kv_bytes_resident"] if e.kv == "slotted"
              else es["kv_bytes_peak"])
        parts.append(f"{name} {es['tokens'] / w:.1f} tokens/s, KV {mib(kv)} "
                     f"({'preallocated rows' if e.kv == 'slotted' else 'peak blocks'}), "
                     f"paged_gqa_decode {launched['paged_gqa_decode']}, "
                     f"graph pool {gib(graph_pool_bytes(torch, e) or 0)}")
        results[name] = e.results
        path[f"{cfg.name} window {name}"] = launched
        ccfg = e.cfg
        del e
        free_card(torch)
    runner = FixedBatch(model, ccfg, device="cuda")
    runner.serve_sequential(wreqs, 2, WINDOW_MAX_LEN)    # captures
    kernels.reset_launch_counts()
    results["sequential"], _, seq_wall = sequential_run(
        torch, runner, wreqs, 2, WINDOW_MAX_LEN)
    path[f"{cfg.name} window sequential"] = {
        kk.name: kk.launches for kk in kernels.all_kernels()}
    parts.append(f"sequential {2 * WINDOW_GEN / seq_wall:.1f} tokens/s")
    del runner
    free_card(torch)
    log(f"[10b window] {cfg.name}, 2 requests of prompt {WINDOW_PROMPT} "
        f"(window {cfg.window}) + gen {WINDOW_GEN}, max_len "
        f"{WINDOW_MAX_LEN}, graphed: " + "; ".join(parts))
    fused = _Results(results["paged fused"], model, ccfg)
    for name in ("paged gather", "slotted", "sequential"):
        compare_tokens(torch, _Results(results[name], model, ccfg), wreqs,
                       fused.results, f"phase 10b {cfg.name}", name,
                       "paged fused")
    del fused, model
    free_card(torch)
    log(f"[time] phase 10b {time.perf_counter() - t_phase:.1f}s")
    check_gemma2_exact(torch)
    log(f"[time] phase 10 {time.perf_counter() - t_phase:.1f}s")
    return path


def free_card(torch):
    """Drop what the engines left behind (their graph pools go with them)
    and hand the cached blocks back, so the next engine finds the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def verify_vs_decode(torch, model, cfg, prompt, seed: int):
    """Prefill ``prompt`` into a one-slot paged pool, then score a verify
    span of SPAN random tokens at the prompt's end against SPAN decode
    steps of the same tokens (the pool restored in between), both through
    the fused kernels -> (max |dlogit|, greedy tokens equal)."""
    import numpy as np
    from repro_torch.models import decode_step, prefill, verify_step
    from repro_torch.serve import BlockPool
    p = len(prompt)
    toks = torch.tensor(np.asarray(prompt)[None], dtype=torch.long,
                        device="cuda")
    _, pf = prefill(model, cfg, {"tokens": toks})
    pool = BlockPool(cfg, 1, p + SPAN, 16, device="cuda")
    pool.alloc(0, pool.blocks_for(p + SPAN))
    pool.seed(0, pf, p)
    gen = np.random.default_rng(seed)
    span = torch.tensor(gen.integers(0, cfg.vocab, (1, SPAN)),
                        dtype=torch.long, device="cuda")
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")
    saved = {n: t.clone() for n, t in pool.caches.items()}
    lv, _ = verify_step(model, cfg, pool.caches, span, pos,
                        pool.device_table(), attn_impl="fused")
    for n, t in pool.caches.items():
        t.copy_(saved[n])
    ld = torch.stack([decode_step(model, cfg, pool.caches, span[:, i],
                                  pos + i, pool.device_table(),
                                  attn_impl="fused")[0]
                      for i in range(SPAN)], 1)
    return (float((lv - ld).abs().max()),
            bool(torch.equal(lv.argmax(-1), ld.argmax(-1))))


def check_gemma2_exact(torch):
    """Phase 10d, float32 at full width and 4 layers (2 pairs), 2 slots,
    prompts of 4160 (past the window) and 128: slotted = paged = sequential
    tokens, each graphed = eager; ``forward``'s logits at position 4160
    against ``prefill`` + ``decode_step`` on the slotted rings and on the
    paged pool (fused kernel); a verify span of 4 against 4 decode steps
    (within 1e-3, equal greedy tokens); the kernel route against the
    plain route over prefills and 4 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_caches,
                                    init_model, prefill)
    from repro_torch.serve import (BlockPool, seed_decode_caches,
                                   synthetic_request)
    from repro_torch.serve.sequential import FixedBatch
    import numpy as np
    cfg = get_config("gemma2-9b")
    cfg = cfg.replace(n_layers=4, dtype="float32", sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(11)
    reqs = [synthetic_request(cfg, rng, rid=i, prompt_len=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(GEMMA_EXACT_PROMPTS,
                                           GEMMA_EXACT_GENS))]
    max_len = max(GEMMA_EXACT_PROMPTS) + max(GEMMA_EXACT_GENS)
    sl, _, _, _, _ = slotted_run(torch, model, cfg, dict(
        n_slots=2, max_len=max_len, compressed=True, device="cuda"), reqs,
        "phase 10d slotted")
    sl = _Results(sl.results, model, cfg)
    free_card(torch)
    pg, _, _, _, _ = prefix_run(torch, model, cfg, graphed(dict(
        n_slots=2, max_len=max_len, compressed=True, kv="paged",
        attn="fused", block_size=16, prefill_buckets=(128, 4160),
        device="cuda")), reqs, "phase 10d paged")
    pg = _Results(pg.results, model, cfg)
    free_card(torch)
    seq = {}
    for graphs in (True, False):
        seq[graphs], _ = FixedBatch(model, cfg, device="cuda",
                                    graphs=graphs).serve_sequential(
            reqs, 2, max_len)
        free_card(torch)
    differ = (compare_tokens(torch, pg, reqs, sl.results,
                             "phase 10d", "paged", "slotted")
              + compare_tokens(torch, _Results(seq[True], model, cfg), reqs,
                               sl.results, "phase 10d", "sequential",
                               "slotted")
              + compare_tokens(torch, _Results(seq[False], model, cfg), reqs,
                               seq[True], "phase 10d", "sequential eager",
                               "sequential graphed"))

    # forward at position P against prefill + one decode step
    p = GEMMA_EXACT_PROMPTS[0]
    toks = torch.tensor(np.concatenate([reqs[0].inputs["tokens"],
                                        sl.results[0].tokens[:1]])[None],
                        dtype=torch.long, device="cuda")
    want = forward(model, cfg, {"tokens": toks})[0][:, -1]
    _, pf = prefill(model, cfg, {"tokens": toks[:, :p]})
    rings = seed_decode_caches(cfg, init_caches(cfg, 1, max_len,
                                                device="cuda"), pf)
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")
    got_slotted, _ = decode_step(model, cfg, rings, toks[:, p], pos)
    pool = BlockPool(cfg, 1, max_len, 16, device="cuda")
    pool.alloc(0, pool.blocks_for(p + 1))
    pool.seed(0, pf, p)
    got_paged, _ = decode_step(model, cfg, pool.caches, toks[:, p], pos,
                               pool.device_table(), attn_impl="fused")
    fwd_err = max(float((got_slotted - want).abs().max()),
                  float((got_paged - want).abs().max()))
    del want, pf, rings, pool
    free_card(torch)
    ver_err, ver_same = verify_vs_decode(torch, model, cfg,
                                         reqs[0].inputs["tokens"], seed=12)
    log(f"[10d exact] {cfg.name} (4 layers, float32, 2 slots, prompts "
        f"{GEMMA_EXACT_PROMPTS}, gen {GEMMA_EXACT_GENS}): slotted = paged = "
        f"sequential tokens in {len(reqs) * 3 - differ}/{len(reqs) * 3} "
        f"comparisons, each graphed = eager; forward at position {p} vs "
        f"prefill + decode_step (slotted rings, paged fused) max |dlogit| "
        f"{fwd_err:.3e}; verify span {SPAN} vs {SPAN} decode steps max "
        f"|dlogit| {ver_err:.3e}, greedy tokens "
        f"{'equal' if ver_same else 'DIFFER'} (tol {LOGIT_ATOL_F32})")
    if (differ or fwd_err > LOGIT_ATOL_F32 or ver_err > LOGIT_ATOL_F32
            or not ver_same):
        raise SystemExit("phase 10d: float32 gemma2 paths disagree")
    check_reference_route(torch, model, cfg, reqs[:2], LOGIT_ATOL_F32,
                          "phase 10d")
    del model
    free_card(torch)


# the remaining dense / MoE configs, full width, cut depth (none fits one
# card at full depth): (arch, layers kept)
OTHER_CONFIGS = (("deepseek-67b", 2), ("mistral-large-123b", 2),
                 ("arctic-480b", 1))


def check_other_configs(torch):
    """deepseek-67b and mistral-large-123b (llama-architecture dense) at 2
    layers and arctic-480b at 1 MoE layer (128 experts top-2 with the
    dense-residual MLP), full width, bf16, 2:4 compressed as drawn (an
    expert stack is drawn, compressed and dropped one at a time): eager
    prefill [1, 128] + 4 decode steps, the kernel route against the plain
    route within 0.25 (``check_reference_route``; arctic also prints its
    router agreement)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ffn, init_model
    from repro_torch.serve import synthetic_trace
    for arch, layers in OTHER_CONFIGS:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = full.replace(n_layers=layers, sparsity=dataclasses.replace(
            full.sparsity, mode="compressed"))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = init_model(cfg, seed=2, device="cuda")
        torch.cuda.synchronize()
        log(f"[config] {arch}: d{cfg.d_model} {cfg.n_heads}H/{cfg.n_kv}KV "
            f"hd {cfg.hd()} d_ff {cfg.d_ff} vocab {cfg.vocab}"
            + (f", {cfg.n_experts} experts top-{cfg.top_k} + dense residual"
               if cfg.n_experts else "")
            + f", {cfg.dtype}; reduced: {full.n_layers} -> {layers} layers "
            f"(full depth does not fit one card), widths as published; "
            f"{drawn_params(model, cfg) / 1e9:.3f} B drawn parameters, init "
            f"{time.perf_counter() - t0:.1f}s, peak "
            f"{gib(torch.cuda.max_memory_allocated())}")
        reqs = synthetic_trace(cfg, n_requests=1, prompt_len=128,
                               gen_lens=[4], seed=3)
        seen, restore = _route_log(ffn) if cfg.n_experts else (None, None)
        try:
            check_reference_route(torch, model, cfg, reqs, LOGIT_ATOL,
                                  f"config {arch}", routing=seen)
        finally:
            if restore is not None:
                restore()
        del model
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 11

# one falcon-mamba-7b layer's linears (out, in): in_proj, x_proj (dt_rank +
# 2 state = 288 rows), dt_proj (K = dt_rank 256, with a bias), out_proj
FALCON_LAYER_SHAPES = [(16384, 4096), (288, 8192), (8192, 256), (4096, 8192)]
# one zamba2-7b Mamba2 layer's in_proj (2 d_inner + 2 state + 112 heads =
# 14576 rows) and out_proj; checked with the shared block's linears
ZAMBA_LAYER_SHAPES = [(14576, 3584), (3584, 7168)]
ZAMBA_CHECK_SHAPES = ZAMBA_LAYER_SHAPES + [(3584, 3584), (14336, 3584),
                                           (3584, 14336)]
SSM_PATH = ("nm_spmv", "nm_xwt")
HYBRID_PATH = ("nm_spmv", "nm_xwt", "paged_gqa_decode")
# 11c: f32 at full width; prompts 37 (bucket 32 + catch-up) and 2 (no
# prefill: the zero state), in fixed batches of 2; zamba2 also 4160, past
# its shared block's window
SSM_EXACT_PROMPTS = {"falcon-mamba-7b": (37, 37, 2, 2),
                     "zamba2-7b": (4160, 4160, 37, 37, 2, 2)}
SSM_EXACT_GENS = (12, 9)
SSM_EXACT_LAYERS = {"falcon-mamba-7b": 4, "zamba2-7b": 13}
# 11a / 11b: falcon 32 of 64 layers, zamba2 27 of 81 (4 of 13 groups of 6
# + the tail of 3), widths as published; cut from full depth when phase 12
# came, to keep the run's time
SSM_SERVE_LAYERS = {"falcon-mamba-7b": 32, "zamba2-7b": 27}


def ssm_linears_per_tick(model) -> int:
    """N:M linears a decode tick runs: each Mamba block's (Mamba1 four,
    Mamba2 two), and the shared block's seven at each application."""
    from repro_torch.core.layers import SparseLinear
    from repro_torch.models.ssm import Mamba1, Mamba2
    mixers = [m for m in model.modules() if isinstance(m, (Mamba1, Mamba2))]
    per = sum(1 for m in mixers[0].modules() if isinstance(m, SparseLinear))
    shared = getattr(model, "shared", None)
    uses = len(getattr(model, "groups", ()))
    return len(mixers) * per + (uses * LINEARS_PER_LAYER if shared else 0)


def ssm_tick_floor(eng, cfg, kv_positions):
    """Byte floor of one decode tick (ms, and its parts in bytes): the
    weight stream with the hybrid's shared block read at each application
    (``weight_stream_bytes`` counts it once), the tied LM head's table, the
    recurrent state read and written (f32 ``h`` and the conv tails of
    every slot) and the shared block's K/V over ``kv_positions``."""
    from repro_torch.models import weight_stream_bytes
    st = eng.stats()
    weights = st["weight_stream_bytes"]
    shared = getattr(eng.model, "shared", None)
    if shared is not None:
        weights += ((len(eng.model.groups) - 1)
                    * weight_stream_bytes(shared, eng.cfg)["stream_bytes"])
    head = cfg.vocab * cfg.d_model * 2
    state = 2 * st["kv_state_bytes"]
    kv = kv_positions * cfg.n_kv * cfg.hd() * 2 * 2 if shared is not None \
        else 0
    parts = dict(weights=weights, head=head, state=state, kv=kv)
    return sum(parts.values()) / HBM_BYTES_PER_S * 1e3, parts


def time_scan(torch, cfg):
    """``[scan]``: device ms of the plain-torch recurrence at ``cfg``'s full
    width, one layer: the prefill scan (Mamba1's chunked log-depth scan /
    Mamba2's SSD chunks) at S 128 for one prompt (the engine's admission)
    and a batch of 8 (the oracle), and one decode step of 8 slots (the
    state read and written in place), with the bytes a step must move."""
    from repro_torch.models import ssm
    gen = torch.Generator(device="cuda").manual_seed(14)
    di, st = cfg.dinner(), cfg.ssm_state
    f32 = dict(device="cuda", dtype=torch.float32)
    out = {}
    for b, s in ((1, 128), (8, 128)) + (((1, 4160),)
                                        if cfg.mamba_version == 2 else ()):
        dt = torch.rand(b, s, di if cfg.mamba_version == 1
                        else cfg.nheads_ssm(), generator=gen, **f32) * 0.1
        bm = torch.randn(b, s, st, generator=gen, **f32)
        cm = torch.randn(b, s, st, generator=gen, **f32)
        if cfg.mamba_version == 1:
            xs = torch.randn(b, s, di, generator=gen, **f32)
            a = -torch.rand(di, st, generator=gen, **f32)

            def run():
                return ssm.mamba1_scan(dt, bm, cm, xs, a, cfg.ssm_chunk)
        else:
            nh = cfg.nheads_ssm()
            xs = torch.randn(b, s, nh, di // nh, generator=gen, **f32)
            a = -torch.rand(nh, generator=gen, **f32)

            def run():
                return ssm.mamba2_ssd(xs, dt, bm, cm, a, cfg.ssm_chunk)
        out[f"prefill B{b} S{s}"] = device_ms(torch, run, 5)
    b = 8
    if cfg.mamba_version == 1:
        h = torch.zeros(b, di, st, **f32)
        args = (torch.rand(b, di, generator=gen, **f32) * 0.1,
                torch.randn(b, di, generator=gen, **f32),
                torch.randn(b, st, generator=gen, **f32),
                torch.randn(b, st, generator=gen, **f32),
                -torch.rand(di, st, generator=gen, **f32))
        step = ssm.mamba1_step
    else:
        nh = cfg.nheads_ssm()
        h = torch.zeros(b, nh, di // nh, st, **f32)
        args = (torch.rand(b, nh, generator=gen, **f32) * 0.1,
                torch.randn(b, nh, di // nh, generator=gen, **f32),
                torch.randn(b, st, generator=gen, **f32),
                torch.randn(b, st, generator=gen, **f32),
                -torch.rand(nh, generator=gen, **f32))
        step = ssm.mamba2_step
    out["decode step B8"] = device_ms(torch, lambda: step(h, *args), 20)
    bnd, _ = bound_ms(2 * h.numel() * 4, 0, "float32")
    log(f"[scan] {cfg.name} one layer's recurrence (plain torch, f32, d_inner"
        f" {di}, state {st}, chunk {cfg.ssm_chunk}), device ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
        + f"; the decode step's bound (h read and written, "
          f"{2 * h.numel() * 4 / 1e6:.1f} MB) {bnd:.4f} ms")


def serve_state_family(torch, card, arch, phase):
    """Phase 11a (falcon-mamba-7b) / 11b (zamba2-7b) at full width and
    ``SSM_SERVE_LAYERS`` depth, bf16, 2:4 compressed as drawn: phase 3's trace on the paged
    fused engine (graphed, prewarmed, the eager engine beside it, a second
    graphed run for determinism, the traced busy share); hard: nm_spmv
    launched ticks x the tick's linears, paged_gqa_decode ticks x the
    shared block's applications.  The same trace on the paged gather
    engine (zamba2), the slotted engine and the sequential oracle; a
    small pool under ``preempt="suspend"`` against ``"replay"``; for
    zamba2 the window trace (2 x prompt 4160 + 32) on paged fused /
    gather, slotted and sequential.  These other paths run graphed only
    (11c holds each graphed = eager in float32); bf16 flips are printed
    with their top-2 margins."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models.config import param_count
    from repro_torch.serve import synthetic_trace
    from repro_torch.serve.sequential import FixedBatch
    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(n_layers=SSM_SERVE_LAYERS[arch],
                       sparsity=dataclasses.replace(full.sparsity,
                                                    mode="compressed"))
    hybrid = cfg.family == "hybrid"
    path_kernels = HYBRID_PATH if hybrid else SSM_PATH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    shape = (f"Mamba1 d_inner {cfg.dinner()} state {cfg.ssm_state} dt_rank "
             f"{cfg.dtrank()}" if not hybrid else
             f"{len(model.groups)} groups of {cfg.attn_period} Mamba2 + tail "
             f"{len(model.tail)} (d_inner {cfg.dinner()}, state "
             f"{cfg.ssm_state}, {cfg.nheads_ssm()} heads), one shared "
             f"attention + MLP block ({cfg.n_heads}H/{cfg.n_kv}KV of "
             f"{cfg.hd()}, d_ff {cfg.d_ff}, window {cfg.window})")
    log(f"[phase {phase}] init {cfg.name}: {cfg.n_layers}L (of "
        f"{full.n_layers}) d{cfg.d_model} "
        f"{shape}, conv {cfg.conv_kernel}, chunk {cfg.ssm_chunk}, vocab "
        f"{cfg.vocab}, {cfg.dtype}, 2:4 compressed as drawn: "
        f"{drawn_params(model, cfg) / 1e9:.3f} B drawn parameters "
        f"(param_count {param_count(cfg) / 1e9:.3f} B) in "
        f"{time.perf_counter() - t0:.1f}s; resident "
        f"{gib(torch.cuda.memory_allocated())}, peak "
        f"{gib(torch.cuda.max_memory_allocated())} on {card}")
    time_scan(torch, cfg)
    per_tick = ssm_linears_per_tick(model)
    uses = len(getattr(model, "groups", ()))
    path = {}

    # ---- phase 3's trace on the paged fused engine
    base = dict(n_slots=8, max_len=128 + 32, compressed=True, device="cuda")
    kw = graphed(dict(base, kv="paged", attn="fused", block_size=16))
    eng, reqs, launches, wall, first_eager = serve_run(
        torch, model, cfg, path_kernels, kw, f"phase {phase}")
    path[cfg.name] = launches
    ticks = eng.decode_steps
    exact = dict(nm_spmv=ticks * per_tick)
    if hybrid:
        exact["paged_gqa_decode"] = ticks * uses
    check_path(launches, path_kernels, f"phase {phase}", **exact)
    again = check_repeat(torch, model, cfg, kw, reqs, eng, f"phase {phase}")
    busy = profile_breakdown(torch, model, cfg, kw)
    check_graphed(torch, model, cfg, kw, reqs, eng, wall, again,
                  first_eager, f"phase {phase}", last_eager=False,
                  busy=(None, busy))
    st = eng.stats()
    floor, parts = ssm_tick_floor(eng, cfg, 8 * 160 * uses)
    log(f"[{phase}] {cfg.name}: {st['tokens'] / wall:.1f} tokens/s graphed, "
        f"steady tick {st['steady_tick_s'] * 1e3:.2f} ms against a byte "
        f"floor of {floor:.2f} ms ("
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in parts.items())
        + f", at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); launches nm_spmv "
        f"{launches['nm_spmv']} = {ticks} ticks x {per_tick}"
        + (f", paged_gqa_decode {launches['paged_gqa_decode']} = {ticks} x "
           f"{uses}" if hybrid else "")
        + f", nm_xwt {launches['nm_xwt']}; state "
        f"{mib(st['kv_state_bytes'])}, KV peak {mib(st['kv_bytes_peak'])}")
    log(f"[time] phase {phase} paged {time.perf_counter() - t_phase:.1f}s")
    results = {"paged fused": eng.results}
    ccfg = eng.cfg
    del eng, first_eager
    free_card(torch)

    # ---- the same trace: paged gather (hybrid), slotted, sequential
    rates = [f"paged fused {st['tokens'] / wall:.1f}"]
    if hybrid:
        g, gwall, glaunch = graphed_run(torch, model, cfg,
                                        dict(kw, attn="gather"), reqs,
                                        f"phase {phase} gather")
        results["paged gather"] = g.results
        path[f"{cfg.name} gather"] = glaunch
        rates.append(f"paged gather {g.stats()['tokens'] / gwall:.1f}")
        del g
    sl, swall, slaunch = graphed_run(
        torch, model, cfg, dict(base, strict_prewarm=True), reqs,
        f"phase {phase} slotted")
    results["slotted"] = sl.results
    path[f"{cfg.name} slotted"] = slaunch
    rates.append(f"slotted {sl.stats()['tokens'] / swall:.1f}")
    del sl
    free_card(torch)
    runner = FixedBatch(model, ccfg, device="cuda")
    runner.serve_sequential(reqs, 8, base["max_len"])      # captures
    kernels.reset_launch_counts()
    results["sequential"], sst, seq_wall = sequential_run(
        torch, runner, reqs, 8, base["max_len"])
    path[f"{cfg.name} sequential"] = {
        k.name: k.launches for k in kernels.all_kernels()}
    seq_tokens = sum(len(r.tokens) for r in results["sequential"].values())
    rates.append(f"sequential {seq_tokens / seq_wall:.1f}")
    del runner
    free_card(torch)
    log(f"[{phase} paths] {cfg.name}, phase 3's trace, graphed tokens/s: "
        + "; ".join(rates))
    fused = _Results(results["paged fused"], model, ccfg)
    for name in results:
        if name != "paged fused":
            compare_tokens(torch, _Results(results[name], model, ccfg), reqs,
                           fused.results, f"phase {phase} {cfg.name}", name,
                           "paged fused")
    log(f"[time] phase {phase} paths {time.perf_counter() - t_phase:.1f}s")

    # ---- a small pool: replay against suspend (the state rows swapped)
    skw = dict(kw, n_blocks=41)
    rep, rep_wall, _ = graphed_run(torch, model, cfg, skw, reqs,
                                   f"phase {phase} replay")
    swaps = {}
    sus, sus_wall, _ = graphed_run(torch, model, cfg,
                                   dict(skw, preempt="suspend"), reqs,
                                   f"phase {phase} suspend", swaps=swaps)
    rs, ss = rep.stats(), sus.stats()
    if (rs["preemptions"] <= 0 or ss["preemptions"] <= 0
            or not ss["swap_outs"] == ss["swap_ins"] == ss["preemptions"]
            or ss["swap_bytes_resident"] or ss["ticks"] > rs["ticks"]):
        raise SystemExit(f"phase {phase}: expected preemptions in both runs,"
                         f" swap-outs = swap-ins = preemptions, nothing left"
                         f" on the host and suspend ticks <= replay ticks; "
                         f"replay {rs}, suspend {ss}")
    out_ms, out_b = zip(*swaps["out"])
    in_ms, _ = zip(*swaps["in"])
    log(f"[{phase} suspend] {cfg.name}: pool 41 blocks of 16; preemptions "
        f"replay {int(rs['preemptions'])} / suspend {int(ss['preemptions'])};"
        f" swap_out {sum(out_ms) / len(out_ms):.3f} ms mean for "
        f"{sum(out_b) / len(out_b) / 2 ** 20:.1f} MiB (state rows + blocks),"
        f" swap_in {sum(in_ms) / len(in_ms):.3f} ms mean (CUDA events "
        f"between replays); ticks replay {int(rs['ticks'])} / suspend "
        f"{int(ss['ticks'])}; graphed tokens/s replay "
        f"{rs['tokens'] / rep_wall:.1f} / suspend "
        f"{ss['tokens'] / sus_wall:.1f}")
    compare_tokens(torch, sus, reqs, rep.results,
                   f"phase {phase} {cfg.name}", "suspend", "replay")
    compare_tokens(torch, rep, reqs, fused.results,
                   f"phase {phase} {cfg.name}", "replay", "paged fused")
    del rep, sus, fused
    free_card(torch)
    log(f"[time] phase {phase} suspend {time.perf_counter() - t_phase:.1f}s")
    if hybrid:
        path.update(window_paths(torch, model, ccfg, f"phase {phase}"))
    del model
    free_card(torch)
    log(f"[time] phase {phase} {time.perf_counter() - t_phase:.1f}s")
    return path


def graphed_run(torch, model, cfg, kw, reqs, what, swaps=None):
    """The graphed engine ``kw`` over ``reqs`` alone (no eager twin: the
    float32 checks of 11c hold these paths graphed = eager), launch counts
    zeroed just before and read just after (``swaps``: a dict its swap
    times fill).  Hard: no mid-serve capture, every request served, the
    pool's invariants and every block back.  Returns (engine, wall,
    launches)."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, cfg, **kw)
    if eng.pool is None:        # slotted: prefill shapes are the prompts'
        eng.prewarm(prompt_lens=sorted({r.prompt_len for r in reqs}))
    if swaps is not None:
        swaps.update(time_swaps(torch, eng.pool))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.all_kernels()}
    st = eng.stats()
    used = 0
    if eng.pool is not None:
        eng.check_invariants()
        used = eng.pool.used_blocks
    if (st["mid_serve_compiles"] or used or not eng.graphs
            or st["tokens"] != sum(r.max_new_tokens for r in reqs)):
        raise SystemExit(f"{what}: {st['mid_serve_compiles']:.0f} mid-serve "
                         f"captures, {used} blocks still used, "
                         f"{st['tokens']:.0f} tokens")
    return eng, wall, launches


def window_paths(torch, model, cfg, phase):
    """2 requests of prompt 4160 (past the 4096 window) + gen 32 through
    the paged fused and gather engines, the slotted engine (rings of the
    window) and the sequential oracle, graphed; tokens/s, KV bytes,
    paged_gqa_decode launches, flips printed with their margins."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine, synthetic_trace
    from repro_torch.serve.sequential import FixedBatch
    wreqs = synthetic_trace(cfg, n_requests=2, prompt_len=WINDOW_PROMPT,
                            gen_lens=[WINDOW_GEN], seed=21)
    base = dict(n_slots=2, max_len=WINDOW_MAX_LEN, compressed=True,
                device="cuda")
    results, parts, path = {}, [], {}
    for name, k in (("paged fused", graphed(dict(
                        base, kv="paged", attn="fused", block_size=16,
                        prefill_buckets=(WINDOW_PROMPT,)))),
                    ("paged gather", graphed(dict(
                        base, kv="paged", attn="gather", block_size=16,
                        prefill_buckets=(WINDOW_PROMPT,)))),
                    ("slotted", dict(base, strict_prewarm=True))):
        e = ServeEngine(model, cfg, **k)
        if e.kv == "slotted":
            e.prewarm(prompt_lens=[WINDOW_PROMPT])
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.run(wreqs)
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        launched = {kk.name: kk.launches for kk in kernels.all_kernels()}
        es = e.stats()
        if es["mid_serve_compiles"] or es["tokens"] != 2 * WINDOW_GEN:
            raise SystemExit(f"{phase} window {name}: {es['tokens']} tokens,"
                             f" {es['mid_serve_compiles']} mid-serve "
                             f"captures")
        kv = (es["kv_bytes_resident"] if e.kv == "slotted"
              else es["kv_bytes_peak"])
        parts.append(f"{name} {es['tokens'] / w:.1f} tokens/s, KV {mib(kv)} "
                     f"+ state {mib(es['kv_state_bytes'])}, paged_gqa_decode"
                     f" {launched['paged_gqa_decode']}")
        results[name] = e.results
        path[f"{cfg.name} window {name}"] = launched
        del e
        free_card(torch)
    runner = FixedBatch(model, cfg, device="cuda")
    runner.serve_sequential(wreqs, 2, WINDOW_MAX_LEN)    # captures
    kernels.reset_launch_counts()
    results["sequential"], _, seq_wall = sequential_run(
        torch, runner, wreqs, 2, WINDOW_MAX_LEN)
    path[f"{cfg.name} window sequential"] = {
        kk.name: kk.launches for kk in kernels.all_kernels()}
    parts.append(f"sequential {2 * WINDOW_GEN / seq_wall:.1f} tokens/s")
    del runner
    free_card(torch)
    log(f"[{phase.split()[-1]} window] {cfg.name}, 2 requests of prompt "
        f"{WINDOW_PROMPT} (window {cfg.window}) + gen {WINDOW_GEN}, max_len "
        f"{WINDOW_MAX_LEN}, graphed: " + "; ".join(parts))
    for name in ("paged gather", "slotted", "sequential"):
        compare_tokens(torch, _Results(results[name], model, cfg), wreqs,
                       results["paged fused"], f"{phase} window {cfg.name}",
                       name, "paged fused")
    return path


def state_blocks(model):
    """(kind, block) of an SSM or hybrid model in depth order: its Mamba
    blocks, and the shared block at each of its applications."""
    from repro_torch.models import SSMLM
    if isinstance(model, SSMLM):
        return [("mamba", b) for b in model.layers]
    out = []
    for group in model.groups:
        out += [("mamba", b) for b in group] + [("shared", model.shared)]
    return out + [("mamba", b) for b in model.tail]


def check_block_route(torch, model, cfg, prompt, tol, phase):
    """The kernel route against the plain route (impl='ref') block by block
    over one prompt: each block of the kernel route runs on the plain
    route's input to it, and its output must be within ``tol`` of the plain
    route's.  Then both routes free-running, and the plain route again on
    an input moved by 1e-7 relative: how far the model's own float32
    rounding moves its logits, the floor under any end-to-end comparison.
    (A deep hybrid amplifies a block's rounding through its decay
    cumsums; ``check_reference_route`` compares end to end.)"""
    from repro_torch.models import transformer
    from repro_torch.models.common import lm_head_apply
    ref = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity, impl="ref"))
    toks = torch.tensor(prompt[None], dtype=torch.long, device="cuda")
    pos = torch.arange(toks.shape[1], device="cuda")[None]

    def apply(kind, block, x, c):
        if kind == "mamba":
            return transformer._ssm_block_apply(block, x, c)[0]
        return transformer._dense_block_apply(block, x, c, positions=pos,
                                              window=c.window)[0]

    def logits(x):
        return lm_head_apply(model.embed, transformer._norm(
            model.lnf, x[:, -1:], cfg))

    x0 = model.embed.emb[toks]
    gen = torch.Generator(device="cuda").manual_seed(3)
    moved = x0 * (1 + 1e-7 * torch.randn(x0.shape, generator=gen,
                                         device="cuda"))
    xk = xr = x0
    local = []
    for kind, block in state_blocks(model):
        out = apply(kind, block, xr, ref)
        local.append(float((apply(kind, block, xr, cfg) - out).abs().max()))
        xk, xr = apply(kind, block, xk, cfg), out
        moved = apply(kind, block, moved, ref)
    free = float((logits(xk) - logits(xr)).abs().max())
    floor = float((logits(moved) - logits(xr)).abs().max())
    log(f"[ref] {cfg.name} ({cfg.n_layers}L, {cfg.dtype}, prompt "
        f"{toks.shape[1]}) kernel route vs plain route block by block "
        f"(each on the plain route's input): max |dx| {max(local):.3e} "
        f"(tol {tol}) over {len(local)} blocks; free-running logits "
        f"{free:.3e}, the plain route's own under a 1e-7 relative input "
        f"move {floor:.3e}")
    if max(local) > tol:
        raise SystemExit(f"{phase}: a block of the kernel route disagrees "
                         f"with the plain route beyond tolerance")


def check_ssm_exact(torch, arch):
    """Phase 11c, float32 at full width and cut depth (falcon 4 layers,
    zamba2 13: 2 groups and a tail of 1), 2 slots: slotted = paged =
    sequential tokens, each graphed = eager, suspend = replay on a pool
    that preempts; ``forward``'s logits at the first prompt's end against
    ``prefill`` + ``decode_step`` on the slotted caches and on the paged
    pool (fused kernel); the kernel route against the plain route over
    prefills and 4 decode steps (falcon), or block by block over the 4160
    prompt (zamba2, whose 15 blocks amplify float32 rounding past 1e-3
    end to end: ``check_block_route``); all within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_caches,
                                    init_model, prefill)
    from repro_torch.serve import (BlockPool, seed_decode_caches,
                                   synthetic_request)
    from repro_torch.serve.sequential import FixedBatch
    import numpy as np
    t0 = time.perf_counter()
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=SSM_EXACT_LAYERS[arch], dtype="float32",
                      sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    prompts = SSM_EXACT_PROMPTS[arch]
    rng = np.random.default_rng(11)
    reqs = [synthetic_request(cfg, rng, rid=i, prompt_len=p,
                              max_new_tokens=SSM_EXACT_GENS[i % 2])
            for i, p in enumerate(prompts)]
    max_len = max(prompts) + max(SSM_EXACT_GENS)
    buckets = tuple(sorted({32, 128} | ({4160} if max(prompts) > 128
                                         else set())))
    base = dict(n_slots=2, max_len=max_len, compressed=True, device="cuda")
    sl, _, _, _, _ = slotted_run(torch, model, cfg, base, reqs,
                                 f"phase 11c {arch} slotted")
    sl = _Results(sl.results, model, cfg)
    free_card(torch)
    pkw = graphed(dict(base, kv="paged", attn="fused", block_size=16,
                       prefill_buckets=buckets))
    pg, _, _, _, _ = prefix_run(torch, model, cfg, pkw, reqs,
                                f"phase 11c {arch} paged")
    pg = _Results(pg.results, model, cfg)
    free_card(torch)
    seq = {}
    for graphs in (True, False):
        seq[graphs], _ = FixedBatch(model, cfg, device="cuda",
                                    graphs=graphs).serve_sequential(
            reqs, 2, max_len)
        free_card(torch)
    # replay against suspend on a pool too small for two requests of 37 +
    # 12 (3 blocks each at the end, 2 at admission; 4 usable)
    small = [r for r in reqs if r.prompt_len < 128]
    skw = dict(pkw, max_len=49, n_blocks=5, prefill_buckets=(4, 32))
    rep, _, _, _, _ = prefix_run(torch, model, cfg, skw, small,
                                 f"phase 11c {arch} replay")
    sus, _, _, _, _ = prefix_run(torch, model, cfg,
                                 dict(skw, preempt="suspend"), small,
                                 f"phase 11c {arch} suspend")
    preempted = (rep.stats()["preemptions"], sus.stats()["preemptions"])
    differ = (compare_tokens(torch, pg, reqs, sl.results, "phase 11c",
                             "paged", "slotted")
              + compare_tokens(torch, _Results(seq[True], model, cfg), reqs,
                               sl.results, "phase 11c", "sequential",
                               "slotted")
              + compare_tokens(torch, _Results(seq[False], model, cfg), reqs,
                               seq[True], "phase 11c", "sequential eager",
                               "sequential graphed")
              + compare_tokens(torch, sus, small, rep.results, "phase 11c",
                               "suspend", "replay")
              + compare_tokens(torch, rep, small, sl.results, "phase 11c",
                               "replay", "slotted"))
    del rep, sus
    free_card(torch)

    # forward at the first prompt's end against prefill + one decode step
    p = prompts[0]
    toks = torch.tensor(np.concatenate([reqs[0].inputs["tokens"],
                                        sl.results[0].tokens[:1]])[None],
                        dtype=torch.long, device="cuda")
    want = forward(model, cfg, {"tokens": toks})[0][:, -1]
    _, pf = prefill(model, cfg, {"tokens": toks[:, :p]})
    slotted = seed_decode_caches(cfg, init_caches(cfg, 1, max_len,
                                                  device="cuda"), pf)
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")
    got_slotted, _ = decode_step(model, cfg, slotted, toks[:, p], pos)
    pool = BlockPool(cfg, 1, max_len, 16, device="cuda")
    pool.alloc(0, pool.blocks_for(p + 1))
    pool.seed(0, pf, p)
    got_paged, _ = decode_step(model, cfg, pool.caches, toks[:, p], pos,
                               pool.device_table(), attn_impl="fused")
    fwd_err = max(float((got_slotted - want).abs().max()),
                  float((got_paged - want).abs().max()))
    del want, pf, slotted, pool
    free_card(torch)
    n = len(reqs) * 3 + len(small) * 2
    log(f"[11c exact] {arch} ({cfg.n_layers} layers, float32, 2 slots, "
        f"prompts {prompts}, gen {SSM_EXACT_GENS}): slotted = paged = "
        f"sequential, suspend = replay = slotted tokens in {n - differ}/{n} "
        f"comparisons (preemptions replay / suspend {preempted}), each "
        f"graphed = eager; forward at position {p} vs prefill + decode_step "
        f"(slotted, paged fused) max |dlogit| {fwd_err:.3e} (tol "
        f"{LOGIT_ATOL_F32}); {time.perf_counter() - t0:.1f}s")
    if differ or fwd_err > LOGIT_ATOL_F32 or min(preempted) <= 0:
        raise SystemExit(f"phase 11c: float32 {arch} paths disagree (or the "
                         f"small pool did not preempt)")
    if cfg.family == "ssm":
        check_reference_route(torch, model, cfg, reqs[:2], LOGIT_ATOL_F32,
                              "phase 11c")
    else:
        check_block_route(torch, model, cfg, reqs[0].inputs["tokens"],
                          LOGIT_ATOL_F32, "phase 11c")
    del model
    free_card(torch)


def phase_ssm(torch, card):
    """Phase 11: falcon-mamba-7b (11a) and zamba2-7b (11b) at full width
    and ``SSM_SERVE_LAYERS`` depth, then the float32 checks (11c).
    Returns the launches by path."""
    t0 = time.perf_counter()
    path = {}
    for arch, phase in (("falcon-mamba-7b", "11a"), ("zamba2-7b", "11b")):
        path.update(serve_state_family(torch, card, arch, phase))
    for arch in ("falcon-mamba-7b", "zamba2-7b"):
        check_ssm_exact(torch, arch)
    log(f"[time] phase 11 {time.perf_counter() - t0:.1f}s")
    return path


# ----------------------------------------------------------------- phase 12

# one whisper-small decoder layer's linears a decode tick runs (out, in):
# self wq, wk, wv, wo, cross wq, wo, the MLP's wg, wu, wd; one encoder
# layer's seven, which prefill runs at the encoder's 1500 frames (as it
# runs the cross wk / wv); qwen2-vl-7b's seven (k / v 512 rows, wd's K
# 18944)
WHISPER_DEC_SHAPES = [(768, 768)] * 6 + [(3072, 768), (3072, 768),
                                         (768, 3072)]
WHISPER_ENC_SHAPES = [(768, 768)] * 4 + [(3072, 768), (3072, 768),
                                         (768, 3072)]
WHISPER_CHECK_SHAPES = [(768, 768), (3072, 768), (768, 3072)]
ENC_FRAMES = 1500
QWEN_LAYER_SHAPES = [(3584, 3584), (512, 3584), (512, 3584), (3584, 3584),
                     (18944, 3584), (18944, 3584), (3584, 18944)]
QWEN_CHECK_SHAPES = [(3584, 3584), (512, 3584), (18944, 3584),
                     (3584, 18944)]
ENCDEC_PATH = ("nm_spmv", "nm_xwt", "paged_gqa_decode")
# 12b: embeddings prompts of a length drawn from 100-128 for each fixed
# batch of 8 (the oracle's joint prefill is rectangular), so most pad up
# to the 128 bucket
VLM_PROMPTS = (100, 128)
BIAS_SCALE = 0.5
# 12c, float32 at full width: prompts 37 (whisper: bucket 32 + catch-up;
# qwen2-vl: padded up to 49) and 2 (padded up to 4), in fixed batches of 2
ENCDEC_EXACT_PROMPTS = (37, 37, 2, 2)
ENCDEC_EXACT_GENS = (12, 9)
ENCDEC_EXACT_LAYERS = {"whisper-small": 12, "qwen2-vl-7b": 4}
# phase 12b at 14 of qwen2-vl's 28 layers (cut for the run's time, with
# phase 14 beside it; whisper stays whole)
ENCDEC_SERVE_LAYERS = {"qwen2-vl-7b": 14}


def draw_biases(torch, model, seed: int) -> int:
    """Every bias of ``model`` (the qkv biases) drawn from N(0, 0.5^2) in
    place: ``init_model`` zeroes them, as the reference does, and a dropped
    or misplaced bias would then not show.  Returns how many."""
    from repro_torch.core.layers import SparseLinear
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = 0
    for m in model.modules():
        if isinstance(m, SparseLinear) and m.has("b"):
            m.b.copy_(torch.randn(m.b.shape, generator=gen, device="cuda")
                      * BIAS_SCALE)
            n += 1
    return n


def check_biased_linears(torch, model: str, shapes, rows: int) -> float:
    """The q / k / v projections of ``model`` with a nonzero bias through
    ``linear_apply``: the kernel route (nm_spmv at B 8, nm_xwt at S
    ``rows``) against the plain route (impl='ref'), f32 and bf16."""
    from repro_torch.core.layers import SparseLinear, linear_apply
    from repro_torch.core.sparse_matmul import SparsityConfig
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst, ok = 0.0, True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        rtol, atol = TOL[dname]
        for o, k in shapes:
            sp = _compressed(torch, o, k, dtype, gen)
            b = (torch.randn(o, generator=gen, device="cuda")
                 * BIAS_SCALE).to(dtype)
            lin = SparseLinear(w_vals=sp.values, w_idx=sp.indices, b=b)
            for r in (8, rows):
                x = torch.randn(r, k, generator=gen, device="cuda").to(dtype)
                got = linear_apply(lin, x, SparsityConfig(
                    n=N, m=M, mode="compressed"))
                want = linear_apply(lin, x, SparsityConfig(
                    n=N, m=M, mode="compressed", impl="ref"))
                e, good = max_err(torch, got, want, rtol, atol)
                worst, ok = max(worst, e), ok and good
    log(f"[check] biased q/k/v linears of {model} ({shapes}, bias "
        f"N(0, {BIAS_SCALE}^2)) kernel route vs plain route at B 8 and S "
        f"{rows}, f32 and bf16: max_abs_err {worst:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 2: a biased linear of {model} disagrees "
                         f"with its plain route")
    return worst


def tick_linears(model):
    """The N:M linears one decode tick runs: every decoder block's, less
    the audio family's cross ``wk`` / ``wv`` (prefill runs those once per
    request, over the encoder's frames)."""
    from repro_torch.core.layers import SparseLinear
    out = []
    for blk in model.layers:
        skip = ({id(blk.cross.wk), id(blk.cross.wv)}
                if hasattr(blk, "cross") else set())
        out += [m for m in blk.modules()
                if isinstance(m, SparseLinear) and id(m) not in skip]
    return out


def encdec_tick_floor(model, cfg, n_slots, positions):
    """Byte floor of one decode tick (ms, and its parts in bytes): the
    linears the tick runs, the LM head's table, the self K/V over
    ``positions`` a slot and, for the audio family, every slot's cross K/V
    (enc_seq positions a layer), at the memory rate."""
    from repro_torch.models.common import linear_weight_bytes
    weights = sum(linear_weight_bytes(m, cfg.sparsity)[1]
                  for m in tick_linears(model))
    per_pos = cfg.n_layers * cfg.n_kv * cfg.hd() * 2 * 2
    parts = dict(weights=weights, head=cfg.vocab * cfg.d_model * 2,
                 kv=n_slots * positions * per_pos)
    if cfg.family == "audio":
        parts["cross"] = n_slots * cfg.enc_seq * per_pos
    return sum(parts.values()) / HBM_BYTES_PER_S * 1e3, parts


def vlm_trace(cfg, n_requests=16, gen_lens=(16, 32), seed=0, batch=8):
    """Phase 3's trace shape with embeddings prompts: one length drawn from
    ``VLM_PROMPTS`` for each fixed batch of ``batch`` requests."""
    import numpy as np
    from repro_torch.serve import synthetic_request
    rng = np.random.default_rng(seed)
    lens = rng.integers(VLM_PROMPTS[0], VLM_PROMPTS[1] + 1,
                        -(-n_requests // batch))
    return [synthetic_request(cfg, rng, rid=i, prompt_len=int(lens[i // batch]),
                              max_new_tokens=gen_lens[i % len(gen_lens)])
            for i in range(n_requests)]


def serve_encdec_vlm(torch, card, arch, phase):
    """Phase 12a (whisper-small) / 12b (qwen2-vl-7b) at full width and
    depth, bf16, 2:4 compressed as drawn, qkv biases drawn nonzero: the
    trace (phase 3's; 12b with embeddings prompts of 100-128, padded up)
    on the paged fused engine (graphed, prewarmed, the eager engine beside
    it, a second graphed run for determinism, the traced busy share);
    hard: nm_spmv launched ticks x the tick's linears, paged_gqa_decode
    ticks x layers, nm_xwt admissions x the prefill's linears.  The same
    trace on the paged gather engine, the slotted engine and the
    sequential oracle; a small pool under ``preempt="suspend"`` against
    ``"replay"``; ``prefix_cache=True`` (hard: no hit); for qwen2-vl rerank
    speculation (``SpecConfig(k=3)``), for whisper ``spec=`` raising
    ``ValueError``.  These other paths run graphed only (12c holds each
    graphed = eager in float32); bf16 flips are printed with their top-2
    margins."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.layers import SparseLinear
    from repro_torch.models import init_model
    from repro_torch.models.config import param_count
    from repro_torch.serve import ServeEngine, SpecConfig
    from repro_torch.serve.sequential import FixedBatch
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=ENCDEC_SERVE_LAYERS.get(arch, cfg.n_layers),
                      sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    audio = cfg.family == "audio"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    biases = draw_biases(torch, model, seed=1)
    torch.cuda.synchronize()
    shape = (f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder layers, "
             f"enc_seq {cfg.enc_seq}" if audio else f"{cfg.n_layers}L")
    log(f"[phase {phase}] init {cfg.name}: {shape}, d{cfg.d_model} "
        f"{cfg.n_heads}H/{cfg.n_kv}KV of {cfg.hd()}, d_ff {cfg.d_ff} "
        f"({cfg.act}), vocab {cfg.vocab}, rope theta {cfg.rope_theta:g}, "
        f"input {cfg.input_mode}, {cfg.dtype}, 2:4 compressed as drawn, "
        f"{biases} qkv biases drawn N(0, {BIAS_SCALE}^2): "
        f"{drawn_params(model, cfg) / 1e9:.3f} B drawn parameters "
        f"(param_count {param_count(cfg) / 1e9:.3f} B) in "
        f"{time.perf_counter() - t0:.1f}s; resident "
        f"{gib(torch.cuda.memory_allocated())}, peak "
        f"{gib(torch.cuda.max_memory_allocated())} on {card}")
    per_tick = len(tick_linears(model))
    per_adm = sum(1 for m in model.modules() if isinstance(m, SparseLinear))
    path = {}
    reqs = None if audio else vlm_trace(cfg)

    # ---- the trace on the paged fused engine
    base = dict(n_slots=8, max_len=128 + 32, compressed=True, device="cuda")
    kw = graphed(dict(base, kv="paged", attn="fused", block_size=16))
    eng, reqs, launches, wall, first_eager = serve_run(
        torch, model, cfg, ENCDEC_PATH, kw, f"phase {phase}", reqs)
    path[cfg.name] = launches
    st = eng.stats()
    ticks, adm = eng.decode_steps, int(st["prefill_calls"])
    check_path(launches, ENCDEC_PATH, f"phase {phase}",
               nm_spmv=ticks * per_tick,
               paged_gqa_decode=ticks * cfg.n_layers,
               nm_xwt=adm * per_adm)
    again = check_repeat(torch, model, cfg, kw, reqs, eng, f"phase {phase}")
    busy = profile_breakdown(torch, model, cfg, kw)
    check_graphed(torch, model, cfg, kw, reqs, eng, wall, again,
                  first_eager, f"phase {phase}", last_eager=False,
                  busy=(None, busy))
    floor, parts = encdec_tick_floor(eng.model, cfg, 8, 160)
    plens = sorted({r.prompt_len for r in reqs})
    log(f"[{phase}] {cfg.name}: {st['tokens'] / wall:.1f} tokens/s graphed "
        f"(prompts {plens} -> prefill lengths {sorted(eng.prefill_lengths)}"
        f"), steady tick {st['steady_tick_s'] * 1e3:.2f} ms against a byte "
        f"floor of {floor:.2f} ms ("
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in parts.items())
        + f", at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); busy {100 * busy:.1f}%;"
        f" launches nm_spmv {launches['nm_spmv']} = {ticks} ticks x "
        f"{per_tick}, paged_gqa_decode {launches['paged_gqa_decode']} = "
        f"{ticks} x {cfg.n_layers}, nm_xwt {launches['nm_xwt']} = {adm} "
        f"admissions x {per_adm}; KV peak {mib(st['kv_bytes_peak'])}, "
        f"slot-indexed state {mib(st['kv_state_bytes'])}")
    log(f"[time] phase {phase} paged {time.perf_counter() - t_phase:.1f}s")
    results = {"paged fused": eng.results}
    ccfg = eng.cfg
    if audio:
        try:
            ServeEngine(eng.model, ccfg, spec=SpecConfig(k=SPAN - 1),
                        **dict(kw, prewarm=False))
        except ValueError as e:
            log(f"[{phase} spec] {cfg.name}: spec= raises ValueError ({e})")
        else:
            raise SystemExit(f"phase {phase}: spec= did not raise for "
                             f"{cfg.name}")
    else:
        path[f"{cfg.name} spec"] = phase_spec(
            torch, eng.model, ccfg, kw, SpecConfig(k=SPAN - 1,
                                                   draft="rerank"),
            ENCDEC_PATH + ("paged_gqa_verify",), "paged_gqa_verify", eng,
            wall, f"phase {phase} spec", repeat=False, reqs=reqs)
    del eng, first_eager
    free_card(torch)

    # ---- the same trace: paged gather, slotted, sequential, prefix cache
    rates = [f"paged fused {st['tokens'] / wall:.1f}"]
    for name, k in (("paged gather", dict(kw, attn="gather")),
                    ("slotted", dict(base, strict_prewarm=True)),
                    ("prefix cache", dict(kw, prefix_cache=True))):
        e, w, launched = graphed_run(torch, model, cfg, k, reqs,
                                     f"phase {phase} {name}")
        results[name] = e.results
        path[f"{cfg.name} {name}"] = launched
        rates.append(f"{name} {e.stats()['tokens'] / w:.1f}")
        if name == "prefix cache" and (e.prefix_hits
                                       or e.stats()["index_blocks"]):
            raise SystemExit(f"phase {phase}: the prefix cache took "
                             f"{e.prefix_hits} hits for {cfg.name}")
        del e
        free_card(torch)
    runner = FixedBatch(model, ccfg, device="cuda")
    runner.serve_sequential(reqs, 8, base["max_len"])      # captures
    kernels.reset_launch_counts()
    results["sequential"], _, seq_wall = sequential_run(
        torch, runner, reqs, 8, base["max_len"])
    path[f"{cfg.name} sequential"] = {
        k.name: k.launches for k in kernels.all_kernels()}
    seq_tokens = sum(len(r.tokens) for r in results["sequential"].values())
    rates.append(f"sequential {seq_tokens / seq_wall:.1f}")
    del runner
    free_card(torch)
    log(f"[{phase} paths] {cfg.name}, graphed tokens/s: " + "; ".join(rates)
        + "; prefix cache hits 0")
    fused = _Results(results["paged fused"], model, ccfg)
    for name in results:
        if name != "paged fused":
            compare_tokens(torch, _Results(results[name], model, ccfg), reqs,
                           fused.results, f"phase {phase} {cfg.name}", name,
                           "paged fused")
    log(f"[time] phase {phase} paths {time.perf_counter() - t_phase:.1f}s")

    # ---- a small pool: replay against suspend (whisper's cross K/V rows
    # swapped with the blocks)
    skw = dict(kw, n_blocks=41)
    rep, rep_wall, _ = graphed_run(torch, model, cfg, skw, reqs,
                                   f"phase {phase} replay")
    swaps = {}
    sus, sus_wall, _ = graphed_run(torch, model, cfg,
                                   dict(skw, preempt="suspend"), reqs,
                                   f"phase {phase} suspend", swaps=swaps)
    rs, ss = rep.stats(), sus.stats()
    if (rs["preemptions"] <= 0 or ss["preemptions"] <= 0
            or not ss["swap_outs"] == ss["swap_ins"] == ss["preemptions"]
            or ss["swap_bytes_resident"] or ss["ticks"] > rs["ticks"]):
        raise SystemExit(f"phase {phase}: expected preemptions in both runs,"
                         f" swap-outs = swap-ins = preemptions, nothing left"
                         f" on the host and suspend ticks <= replay ticks; "
                         f"replay {rs}, suspend {ss}")
    out_ms, out_b = zip(*swaps["out"])
    in_ms, _ = zip(*swaps["in"])
    log(f"[{phase} suspend] {cfg.name}: pool 41 blocks of 16; preemptions "
        f"replay {int(rs['preemptions'])} / suspend {int(ss['preemptions'])};"
        f" swap_out {sum(out_ms) / len(out_ms):.3f} ms mean for "
        f"{sum(out_b) / len(out_b) / 2 ** 20:.1f} MiB"
        + (" (cross K/V rows + blocks)" if audio else " (blocks)")
        + f", swap_in {sum(in_ms) / len(in_ms):.3f} ms mean (CUDA events "
        f"between replays); ticks replay {int(rs['ticks'])} / suspend "
        f"{int(ss['ticks'])}; graphed tokens/s replay "
        f"{rs['tokens'] / rep_wall:.1f} / suspend "
        f"{ss['tokens'] / sus_wall:.1f}")
    compare_tokens(torch, sus, reqs, rep.results,
                   f"phase {phase} {cfg.name}", "suspend", "replay")
    compare_tokens(torch, rep, reqs, fused.results,
                   f"phase {phase} {cfg.name}", "replay", "paged fused")
    del rep, sus, fused, model
    free_card(torch)
    log(f"[time] phase {phase} {time.perf_counter() - t_phase:.1f}s")
    return path


def check_encdec_vlm_exact(torch, arch):
    """Phase 12c, float32 at full width (whisper at full depth, qwen2-vl
    at 4 layers), qkv biases drawn nonzero, 2 slots, prompts 37 and 2
    (pad-up: whisper's 2, both qwen2-vl's): slotted = paged = sequential
    tokens, each graphed = eager, suspend = replay on a pool that preempts,
    qwen2-vl's rerank speculation = plain; ``forward``'s logits at the
    first prompt's end against ``prefill`` + ``decode_step`` on the slotted
    caches and on the paged pool (fused kernel); the kernel route against
    the plain route over prefills and 4 decode steps; all within 1e-3."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_caches,
                                    init_model, prefill)
    from repro_torch.serve import (BlockPool, SpecConfig, seed_decode_caches,
                                   synthetic_request)
    from repro_torch.serve.sequential import FixedBatch
    t0 = time.perf_counter()
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=ENCDEC_EXACT_LAYERS[arch], dtype="float32",
                      sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    draw_biases(torch, model, seed=2)
    rng = np.random.default_rng(11)
    reqs = [synthetic_request(cfg, rng, rid=i, prompt_len=p,
                              max_new_tokens=ENCDEC_EXACT_GENS[i % 2])
            for i, p in enumerate(ENCDEC_EXACT_PROMPTS)]
    max_len = max(ENCDEC_EXACT_PROMPTS) + max(ENCDEC_EXACT_GENS)
    base = dict(n_slots=2, max_len=max_len, compressed=True, device="cuda")
    sl, _, _, _, _ = slotted_run(torch, model, cfg, base, reqs,
                                 f"phase 12c {arch} slotted")
    sl = _Results(sl.results, model, cfg)
    free_card(torch)
    pkw = graphed(dict(base, kv="paged", attn="fused", block_size=16,
                       prefill_buckets=(4, 32)))
    pg, _, _, _, _ = prefix_run(torch, model, cfg, pkw, reqs,
                                f"phase 12c {arch} paged")
    pads = sorted(pg.prefill_lengths)
    pg = _Results(pg.results, model, cfg)
    free_card(torch)
    seq = {}
    for graphs in (True, False):
        seq[graphs], _ = FixedBatch(model, cfg, device="cuda",
                                    graphs=graphs).serve_sequential(
            reqs, 2, max_len)
        free_card(torch)
    # replay against suspend: 2 requests of 20 + 14 (2 blocks each at
    # admission, a third at position 32) over 4 usable blocks
    small = [synthetic_request(cfg, rng, rid=10 + i, prompt_len=20,
                               max_new_tokens=14) for i in range(2)]
    skw = dict(pkw, max_len=34, n_blocks=5)
    rep, _, _, _, _ = prefix_run(torch, model, cfg, skw, small,
                                 f"phase 12c {arch} replay")
    sus, _, _, _, _ = prefix_run(torch, model, cfg,
                                 dict(skw, preempt="suspend"), small,
                                 f"phase 12c {arch} suspend")
    preempted = (rep.stats()["preemptions"], sus.stats()["preemptions"])
    differ = (compare_tokens(torch, pg, reqs, sl.results, "phase 12c",
                             "paged", "slotted")
              + compare_tokens(torch, _Results(seq[True], model, cfg), reqs,
                               sl.results, "phase 12c", "sequential",
                               "slotted")
              + compare_tokens(torch, _Results(seq[False], model, cfg), reqs,
                               seq[True], "phase 12c", "sequential eager",
                               "sequential graphed")
              + compare_tokens(torch, sus, small, rep.results, "phase 12c",
                               "suspend", "replay"))
    n = len(reqs) * 3 + len(small)
    del rep, sus
    free_card(torch)
    if cfg.family == "vlm":
        sp, _, _, _, _ = prefix_run(
            torch, model, cfg, dict(pkw, spec=SpecConfig(k=SPAN - 1)), reqs,
            f"phase 12c {arch} spec")
        differ += compare_tokens(torch, sp, reqs, pg.results, "phase 12c",
                                 "spec", "plain")
        n += len(reqs)
        del sp
        free_card(torch)

    # forward at the first prompt's end against prefill + one decode step
    p = ENCDEC_EXACT_PROMPTS[0]
    tok = int(sl.results[0].tokens[0])
    want = forward(model, cfg, prompt_batch(torch, model, reqs[0].inputs,
                                            [tok]))[0][:, -1]
    _, pf = prefill(model, cfg, prompt_batch(torch, model, reqs[0].inputs))
    slotted = seed_decode_caches(cfg, init_caches(cfg, 1, max_len,
                                                  device="cuda"), pf)
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")
    tokt = torch.tensor([tok], dtype=torch.long, device="cuda")
    got_slotted, _ = decode_step(model, cfg, slotted, tokt, pos)
    pool = BlockPool(cfg, 1, max_len, 16, device="cuda")
    pool.alloc(0, pool.blocks_for(p + 1))
    pool.seed(0, pf, p)
    got_paged, _ = decode_step(model, cfg, pool.caches, tokt, pos,
                               pool.device_table(), attn_impl="fused")
    fwd_err = max(float((got_slotted - want).abs().max()),
                  float((got_paged - want).abs().max()))
    del want, pf, slotted, pool
    free_card(torch)
    log(f"[12c exact] {arch} ({cfg.n_layers} layers"
        + (f" + {cfg.enc_layers} encoder" if cfg.enc_layers else "")
        + f", float32, qkv biases nonzero, 2 slots, prompts "
        f"{ENCDEC_EXACT_PROMPTS} (paged prefill lengths {pads}), gen "
        f"{ENCDEC_EXACT_GENS}): slotted = paged = sequential, suspend = "
        f"replay" + (", spec = plain" if cfg.family == "vlm" else "")
        + f" tokens in {n - differ}/{n} comparisons (preemptions replay / "
        f"suspend {preempted}), each graphed = eager; forward at position "
        f"{p} vs prefill + decode_step (slotted, paged fused) max |dlogit| "
        f"{fwd_err:.3e} (tol {LOGIT_ATOL_F32}); "
        f"{time.perf_counter() - t0:.1f}s")
    if differ or fwd_err > LOGIT_ATOL_F32 or min(preempted) <= 0:
        raise SystemExit(f"phase 12c: float32 {arch} paths disagree (or the "
                         f"small pool did not preempt)")
    check_reference_route(torch, model, cfg, reqs[:2], LOGIT_ATOL_F32,
                          "phase 12c")
    del model
    free_card(torch)


def phase_encdec_vlm(torch, card):
    """Phase 12: whisper-small (12a) and qwen2-vl-7b (12b) at full width
    and depth, then the float32 checks (12c).  Returns the launches by
    path."""
    t0 = time.perf_counter()
    path = {}
    for arch, phase in (("whisper-small", "12a"), ("qwen2-vl-7b", "12b")):
        path.update(serve_encdec_vlm(torch, card, arch, phase))
    for arch in ("whisper-small", "qwen2-vl-7b"):
        check_encdec_vlm_exact(torch, arch)
    log(f"[time] phase 12 {time.perf_counter() - t0:.1f}s")
    return path


# ----------------------------------------------------------------- phase 13

TRAIN_ARCH = "llama3.2-1b"
# 13a: 10 steps (cut from 20 for the run's time)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 8, 128
# 13b draws its tokens from the first 32 ids, 13a's batch of 1024 tokens
# a step (each id about 32 times), for 60 steps: 16 layers at full width
# learn the mapping there, and the gate below can tell it from the label
# range (the reference's 40 steps of 256 tokens over a smoke model's 512
# ids leave a 16-layer model at the range's ln 512)
MAP_STEPS, MAP_BATCH, MAP_SEQ = 60, 8, 128
MAP_IDS = 32
TRAIN_LAYERS = 4                 # 13e: full width, cut in depth
# 13d: 2 layers (cut from 4 for the run's time: its CPU step was most
# of it)
CARD_CPU_LAYERS = 2
# 13c: 2 layers (cut from 4 for the run's time: its checkpoints,
# 6 GB each, are most of it)
RESUME_LAYERS = 2
RESUME_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = 1e-4
TRAIN_SERVE_PATH = ("nm_spmv", "nm_xwt", "paged_gqa_decode")
TRAIN_PROFILE = (("ste_sparsify.", "N:M mask + STE"),
                 ("train.accumulate", "accumulation"),
                 ("train.adamw", "AdamW"))
TRAIN_RANGES = ("ste_sparsify.", "train.")     # the trainer's range labels


def _median(xs):
    xs = sorted(xs)
    return 0.5 * (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2])


def _range_device_us(ev) -> float:
    """Device microseconds of the kernels launched inside a host event and
    the events nested in it."""
    return (sum(k.duration for k in ev.kernels)
            + sum(_range_device_us(c) for c in ev.cpu_children))


def train_profile(torch, step_fn, model, opt, batch, step) -> str:
    """One traced training step: device ms split into GEMMs (by kernel
    name), the ranges ``TRAIN_PROFILE`` names (the mask and STE of every
    linear, forward, recompute and backward; the f32 gradient sums; the
    optimizer), and the rest; against the step's wall."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(model, opt, batch, step)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the ranges' own device spans (``gpu_user_annotation``) overlap the
    # kernels they hold and are left out
    kernels = [(us, n, name[:70]) for us, n, name in
               device_events(prof, skip=TRAIN_RANGES)]
    total = sum(us for us, _, _ in kernels)
    launches = sum(n for _, n, _ in kernels)
    # ops dispatched from Python or from the autograd engine's nodes (an
    # aten op inside another is that op's own work)
    ops = sum(1 for ev in prof.events() if ev.name.startswith("aten::") and (
        ev.cpu_parent is None or not ev.cpu_parent.name.startswith("aten::")))
    parts = {"GEMMs": sum(us for us, _, name in kernels if is_gemm(name))}
    for prefix, label in TRAIN_PROFILE:
        parts[label] = sum(_range_device_us(ev) for ev in prof.events()
                           if ev.name.startswith(prefix))
    parts["other"] = total - sum(parts.values())
    top = "; ".join(f"{us / 1e3:.1f} ms {n}x {name}" for us, n, name in
                    sorted(kernels, reverse=True)[:6])
    return (f"wall {wall:.1f} ms, device busy {total / 1e3:.1f} ms "
            f"({100 * total / 1e3 / wall:.1f}%), {launches} device "
            f"events, {ops} top-level aten ops: " + ", ".join(
                f"{k} {v / 1e3:.1f} ms ({100 * v / total:.1f}%)"
                for k, v in parts.items()) + f"; top: {top}")


def phase_train_full(torch, card):
    """13a: ``train_loop`` at the reference CLI's defaults, full width and
    depth, checkpointing into a temp dir."""
    import tempfile
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import param_count
    from repro_torch.optim import AdamWConfig
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="train_13a_") as ck:
        t0 = time.perf_counter()
        run = train_loop(TRAIN_ARCH, False, TRAIN_STEPS, TRAIN_BATCH,
                         TRAIN_SEQ, ck, ckpt_every=TRAIN_STEPS, log_every=10,
                         device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, files in os.walk(ck) for f in files)
        committed = os.path.exists(os.path.join(
            ck, f"step_{TRAIN_STEPS:010d}", "COMMIT"))
    peak = torch.cuda.max_memory_allocated()
    cfg, losses = run.cfg, run.losses
    if (len(losses) != TRAIN_STEPS or not committed
            or not all(abs(x) < 1e3 for x in losses)):
        raise SystemExit(f"phase 13a: {len(losses)} steps, checkpoint "
                         f"committed {committed}, losses {losses}")
    ms = _median(run.step_seconds[2:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = param_count(cfg)
    flops = 6 * n_params * tokens
    # each parameter: bf16 weight read and written, f32 master / mu / nu
    # read and written, the f32 gradient sum written and read
    state_bytes = n_params * (2 * 2 + 3 * 8 + 8)
    floor, by = bound_ms(state_bytes, flops, "bfloat16")
    log(f"[13a train] {card}: {cfg.name} {cfg.n_layers}L d{cfg.d_model} "
        f"{cfg.dtype} srste {cfg.sparsity.n}:{cfg.sparsity.m}, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, grad_accum {cfg.grad_accum}, remat "
        f"{cfg.remat}, AdamW f32 masters: {len(losses)} steps, median "
        f"{ms:.1f} ms/step after step 2 = {tokens / ms * 1e3:.0f} tokens/s; "
        f"steps {[round(1e3 * t, 1) for t in run.step_seconds]} ms; peak "
        f"{gib(peak)}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"train_loop {wall:.1f}s (steps {sum(run.step_seconds):.1f}s, the "
        f"rest init and the {gib(ck_bytes)} checkpoint)")
    log(f"[13a mfu] {card}: model FLOPs = 6 x {n_params} parameters x "
        f"{tokens} tokens = {flops / 1e12:.2f} TFLOP a step; "
        f"{100 * flops / (ms * 1e-3) / PEAK_FLOPS['bfloat16']:.2f}% of "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s dense bf16; floor "
        f"{floor:.2f} ms a step ({by}: {state_bytes / 1e9:.1f} GB of "
        f"weights and optimizer state)")
    ocfg = AdamWConfig(master_weights=True)
    step_fn = make_train_step(cfg, ocfg)
    batch = to_device(SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ)
                      .batch_at(TRAIN_STEPS), "cuda")
    log(f"[profile] {card}: 13a train step {TRAIN_STEPS + 1}: "
        + train_profile(torch, step_fn, run.model, run.opt_state, batch,
                        TRAIN_STEPS))
    return {"ms": ms, "peak": peak}


def phase_mapping(torch, card):
    """13b: the reference's learnable mapping at full width and depth ->
    (the trained model, its config)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step, named_params
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig, adamw_init
    free_card(torch)
    cfg = get_config(TRAIN_ARCH).replace(grad_accum=1)
    model = init_model(cfg, seed=1, device="cuda")
    ocfg = AdamWConfig(master_weights=cfg.dtype == "bfloat16")
    opt = adamw_init(named_params(model), ocfg)
    step_fn = make_train_step(cfg, ocfg, base_lr=3e-3, warmup=5)
    rng = np.random.default_rng(0)
    losses = []
    t0 = time.perf_counter()
    for i in range(MAP_STEPS):
        toks = torch.from_numpy(rng.integers(0, MAP_IDS, (MAP_BATCH, MAP_SEQ))
                                .astype(np.int32)).cuda()
        model, opt, m = step_fn(model, opt, {"tokens": toks,
                                             "labels": (toks + 1) % cfg.vocab},
                                i)
        losses.append(float(m["loss"]))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    # knowing only that the labels lie in [1, MAP_IDS] gives ln MAP_IDS:
    # below it by 1.0, the model has learnt which label follows which token
    floor = float(np.log(MAP_IDS)) - 1.0
    log(f"[13b mapping] {card}: {cfg.name} {cfg.n_layers}L {cfg.dtype}, "
        f"label = token + 1 over ids < {MAP_IDS}, batch {MAP_BATCH} x "
        f"{MAP_SEQ}, {MAP_STEPS} steps at base_lr 3e-3, warmup 5 in "
        f"{time.perf_counter() - t0:.1f}s: mean of the first five losses "
        f"{first:.4f}, of the last five {last:.4f} (drop {first - last:.4f}, "
        f"gate 1.0; mapping gate: below ln {MAP_IDS} - 1.0 = {floor:.4f}); "
        f"losses {[round(x, 3) for x in losses]}")
    if not (last < first - 1.0 and last < floor):
        raise SystemExit(f"phase 13b: the mapping was not learnt: the last "
                         f"five losses average {last:.4f}, gates "
                         f"{first - 1.0:.4f} and {floor:.4f}")
    del opt
    free_card(torch)
    return model, cfg


def _max_diff(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def phase_resume(torch, card):
    """13c: kill-and-resume against the uninterrupted run, full width,
    ``RESUME_LAYERS`` layers."""
    import tempfile
    from repro_torch.launch.train import train_loop
    free_card(torch)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=100, device="cuda",
              n_layers=RESUME_LAYERS)
    t0 = time.perf_counter()
    full = train_loop(TRAIN_ARCH, False, 6, ckpt_dir="", **kw)
    with tempfile.TemporaryDirectory(prefix="train_13c_") as ck:
        train_loop(TRAIN_ARCH, False, 3, ckpt_dir=ck, ckpt_every=3, **kw)
        free_card(torch)
        resumed = train_loop(TRAIN_ARCH, False, 6, ckpt_dir=ck,
                             ckpt_every=100, **kw)
    pairs = list(zip(full.model.named_parameters(),
                     resumed.model.named_parameters()))
    worst = max(_max_diff(a, b) for (_, a), (_, b) in pairs)
    same = all(torch.equal(a, b) for (_, a), (_, b) in pairs)
    log(f"[13c resume] {card}: {RESUME_LAYERS} layers, 6 steps straight "
        f"{[round(x, 6) for x in full.losses[3:]]} against 3 + resume + 3 "
        f"{[round(x, 6) for x in resumed.losses]}; largest parameter "
        f"difference {worst:.3e}, bit-equal {same}; "
        f"{time.perf_counter() - t0:.1f}s")
    ok = len(resumed.losses) == 3 and all(
        abs(a - b) <= RESUME_TOL["atol"] + RESUME_TOL["rtol"] * abs(a)
        for a, b in zip(full.losses[3:], resumed.losses))
    if not ok:
        raise SystemExit(f"phase 13c: resumed losses {resumed.losses} != "
                         f"{full.losses[3:]}")
    if not same:
        # is the step itself deterministic? a second straight run says
        again = train_loop(TRAIN_ARCH, False, 6, ckpt_dir="", **kw)
        worst = max(_max_diff(a, b) for (_, a), (_, b) in zip(
            full.model.named_parameters(), again.model.named_parameters()))
        log(f"[13c resume] a second straight run: largest parameter "
            f"difference to the first {worst:.3e}")
        del again
    del full, resumed
    free_card(torch)


def phase_card_vs_cpu(torch, card):
    """13d: one f32 step on the card and on the CPU from the same weights
    and batch: loss, every gradient and every updated parameter."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch.steps import loss_and_grads, named_params
    from repro_torch.models import init_model
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   warmup_cosine)
    free_card(torch)
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).replace(n_layers=CARD_CPU_LAYERS,
                                         dtype="float32", grad_accum=1)
    ocfg = AdamWConfig(master_weights=False)
    batch = SyntheticLMData(cfg, 2, 64, seed=4).batch_at(0)
    lr = warmup_cosine(100, 3e-4, 100, 10000)
    cpu = init_model(cfg, seed=2, device="cpu")
    out, secs = [], []
    for where, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).cuda())):
        ts = time.perf_counter()
        params = named_params(model)
        opt = adamw_init(params, ocfg)
        loss, grads = loss_and_grads(model, cfg, to_device(batch, where))
        adamw_update(grads, opt, params, lr, ocfg)
        out.append((float(loss), {k: g.cpu() for k, g in grads.items()},
                    {k: p.detach().cpu() for k, p in params.items()}))
        secs.append(time.perf_counter() - ts)
    (lc, gc_, pc), (lg, gg, pg) = out
    rel = abs(lg - lc) / abs(lc)
    gerr = max(_max_diff(gg[k], gc_[k]) for k in gc_)
    perr = max(_max_diff(pg[k], pc[k]) for k in pc)
    log(f"[13d f32 grads] {card}: {CARD_CPU_LAYERS} layers f32 (TF32 off), "
        f"batch 2 x 64: loss card {lg:.7f} CPU {lc:.7f} (relative "
        f"{rel:.2e}, tol 1e-5); largest gradient difference {gerr:.3e}, "
        f"updated parameter {perr:.3e} (tol {GRAD_TOL}); the step "
        f"{secs[0]:.1f}s on the CPU, {secs[1]:.1f}s on the card; "
        f"{time.perf_counter() - t0:.1f}s")
    if not (rel <= 1e-5 and gerr <= GRAD_TOL and perr <= GRAD_TOL):
        raise SystemExit("phase 13d: the card's f32 step disagrees with the "
                         "CPU's")
    del out, cpu
    check_head_backward(torch, card, cfg)
    free_card(torch)


def check_head_backward(torch, card, cfg):
    """13d, bf16: the tied LM head at 13a's shape (one microbatch of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` / grad_accum 4 tokens, d 2048, vocab
    128256), its hand-written backward on the card (``_HeadMM``: f32
    cotangent, f32 products, each result rounded to bf16) against autograd
    of the f32 product (the CPU branch's and the reference's formula) on
    the same inputs; each gradient within one bf16 rounding step of its
    largest value."""
    from repro_torch.models.common import _HeadMM
    n, d, v = TRAIN_BATCH * TRAIN_SEQ // 4, cfg.d_model, cfg.vocab
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(n, d, generator=g, device="cuda").to(torch.bfloat16)
    emb = (torch.randn(v, d, generator=g, device="cuda")
           * d ** -0.5).to(torch.bfloat16)
    ct = torch.randn(n, v, generator=g, device="cuda") / n
    xa, ea = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    got = _HeadMM.apply(xa, ea)
    got.backward(ct)
    xb, eb = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    want = xb.float() @ eb.float().t()
    want.backward(ct)
    lerr = _max_diff(got, want)
    errs = {}
    for name, a, b in (("dx", xa.grad, xb.grad), ("demb", ea.grad, eb.grad)):
        scale = float(b.float().abs().max())
        errs[name] = (_max_diff(a, b), 2 ** -7 * scale)
    log(f"[13d bf16 head] {card}: _HeadMM at [{n}, {d}] x [{v}, {d}] "
        f"against f32 autograd: logits {lerr:.3e} (tol 1e-4); " + ", ".join(
            f"{k} {e:.3e} (tol {t:.3e})" for k, (e, t) in errs.items()))
    if lerr > 1e-4 or any(e > t for e, t in errs.values()):
        raise SystemExit("phase 13d: the LM head's bf16 backward disagrees "
                         "with f32 autograd")


def forward_greedy(torch, model, cfg, reqs):
    """Greedy continuation of equal-length prompts by full-sequence
    ``forward`` (no cache): {rid: tokens}."""
    import numpy as np
    from repro_torch.models import forward
    toks = torch.from_numpy(np.stack([r.inputs["tokens"] for r in reqs])
                            ).cuda()
    gen = []
    with torch.no_grad():
        for _ in range(max(r.max_new_tokens for r in reqs)):
            logits, _ = forward(model, cfg, {"tokens": toks})
            nxt = logits[:, -1].argmax(-1).to(toks.dtype)
            gen.append(nxt)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    gen = torch.stack(gen, dim=1).cpu().numpy()
    return {r.rid: gen[i, :r.max_new_tokens] for i, r in enumerate(reqs)}


def phase_train_serve(torch, card, mapped, mapped_cfg):
    """13e: train -> compress -> serve.  f32 at 4 layers through the graphed
    paged fused engine against greedy ``forward`` of the trained srste
    model, then 13b's model compressed in bf16 on the same engine.
    Returns the launches of both runs."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.layers import SparseLinear
    from repro_torch.core.sparsity import nm_mask
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch.steps import make_train_step, named_params
    from repro_torch.models import convert_to_compressed, init_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve import ServeEngine, synthetic_trace
    free_card(torch)
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS,
                                         dtype="float32", grad_accum=1)
    model = init_model(cfg, seed=3, device="cuda")
    probe = model.layers[0].attn.wq
    mask0 = nm_mask(probe.w, cfg.sparsity.n, cfg.sparsity.m)
    ocfg = AdamWConfig(master_weights=False)
    opt = adamw_init(named_params(model), ocfg)
    step_fn = make_train_step(cfg, ocfg, base_lr=3e-3, warmup=1)
    data = SyntheticLMData(cfg, 4, TRAIN_SEQ, seed=5)
    losses = []
    for i in range(3):
        model, opt, m = step_fn(model, opt, to_device(next(data), "cuda"),
                                i + 1)
        losses.append(float(m["loss"]))
    del opt
    moved = int((nm_mask(probe.w, cfg.sparsity.n, cfg.sparsity.m)
                 != mask0).sum())
    reqs = synthetic_trace(cfg, n_requests=16, prompt_len=128,
                           gen_lens=[16, 32], seed=0)
    kw = graphed(dict(n_slots=8, max_len=128 + 32, kv="paged", attn="fused",
                      block_size=16, device="cuda"))
    runs = []
    for what, trained, tcfg in (("f32 4L", model, cfg),
                                ("bf16 13b", mapped, mapped_cfg)):
        ccfg = tcfg.replace(sparsity=dataclasses.replace(tcfg.sparsity,
                                                         mode="compressed"))
        served = convert_to_compressed(trained, ccfg)
        if not all(m.compressed for m in served.modules()
                   if isinstance(m, SparseLinear)):
            raise SystemExit(f"phase 13e: {what}: a linear stayed dense")
        runs.append((what, ServeEngine(served, ccfg, **kw), tcfg))
    kernels.reset_launch_counts()
    results, walls = [], []
    for what, eng, _ in runs:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        results.append(eng.run(reqs))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - ts)
    launches = {k.name: k.launches for k in kernels.all_kernels()}
    want = {"nm_spmv": 0, "nm_xwt": 0, "paged_gqa_decode": 0}
    for (what, eng, tcfg), wall in zip(runs, walls):
        st = eng.stats()
        want["nm_spmv"] += eng.decode_steps * tcfg.n_layers * LINEARS_PER_LAYER
        want["paged_gqa_decode"] += eng.decode_steps * tcfg.n_layers
        want["nm_xwt"] += eng.prefill_calls * tcfg.n_layers * LINEARS_PER_LAYER
        log(f"[13e serve] {card}: {what} ({tcfg.n_layers}L) compressed after "
            f"training, graphed paged fused, 8 slots: {int(st['tokens'])} "
            f"tokens in {wall:.3f}s = {st['tokens'] / wall:.1f} tokens/s, "
            f"{eng.decode_steps} decode steps, {eng.prefill_calls} prefills")
        if (not eng.graphs or st["mid_serve_compiles"]
                or st["tokens"] != sum(r.max_new_tokens for r in reqs)):
            raise SystemExit(f"phase 13e: {what}: the engine did not serve "
                             f"every token from its prewarmed graphs")
    ref = forward_greedy(torch, model, cfg, reqs)
    bad = [r.rid for r in reqs
           if not np.array_equal(results[0][r.rid].tokens, ref[r.rid])]
    log(f"[13e exact] {card}: f32 {TRAIN_LAYERS}L trained 3 steps (losses "
        f"{[round(x, 4) for x in losses]}; layer 0 wq's mask moved in "
        f"{moved} of {mask0.numel()} entries): served tokens equal greedy "
        f"forward of the srste model in {len(reqs) - len(bad)}/{len(reqs)} "
        f"requests; {time.perf_counter() - t0:.1f}s")
    if bad:
        raise SystemExit(f"phase 13e: served tokens differ from the trained "
                         f"model's forward in requests {bad}")
    log(f"[13e serve] kernel launches over both runs: {launches} (expected "
        f"{want})")
    if any(launches[k] != n for k, n in want.items()):
        raise SystemExit(f"phase 13e: launches {launches} != {want}")
    return launches


def phase_train(torch, card):
    """Phase 13: training on the card (13a-13e).  Returns the launches of
    the train -> serve path."""
    t0 = time.perf_counter()
    phase_train_full(torch, card)
    mapped, mapped_cfg = phase_mapping(torch, card)
    phase_resume(torch, card)
    phase_card_vs_cpu(torch, card)
    launches = phase_train_serve(torch, card, mapped, mapped_cfg)
    del mapped
    free_card(torch)
    log(f"[time] phase 13 {time.perf_counter() - t0:.1f}s")
    return {"train_serve": launches}


# ----------------------------------------------------------- phase 14

FAMILY_ARCHS = ("deepseek-v2-lite-16b", "gemma2-9b", "falcon-mamba-7b",
                "zamba2-7b", "whisper-small", "qwen2-vl-7b")
# 14a: full width, depth cut as ``cut_depth`` allows (deepseek its dense
# layer and one MoE layer of 64 experts, gemma2 one local / global pair,
# zamba2 one group of 6 and the shared block; whisper whole, 12 + 12)
FAMILY_TRAIN_LAYERS = {"deepseek-v2-lite-16b": 2, "gemma2-9b": 2,
                       "falcon-mamba-7b": 4, "zamba2-7b": 6,
                       "whisper-small": None, "qwen2-vl-7b": 2}
FAMILY_STEPS = 6
FAMILY_PROFILE = ("deepseek-v2-lite-16b", "falcon-mamba-7b")
# 14c: f32 at full width; zamba2 needs a whole group (6) for its shared
# block, whisper keeps 2 encoder and 2 decoder blocks
SERVE_TRAIN_LAYERS = {"deepseek-v2-lite-16b": 2, "gemma2-9b": 2,
                      "falcon-mamba-7b": 4, "zamba2-7b": 6,
                      "whisper-small": 2, "qwen2-vl-7b": 2}
SERVE_TRAIN_ENC = {"whisper-small": 2}
SERVE_TRAIN_PROMPT, SERVE_TRAIN_GEN, SERVE_TRAIN_REQS = 64, 8, 4


def train_flops(cfg, tokens: int, frames: int) -> tuple:
    """(model FLOPs of one training step: 6 x the parameters a token uses x
    tokens, and that count of parameters).  MoE counts the active
    parameters (top-k routed + shared experts); the audio family's encoder
    parameters see ``frames`` encoder frames, the rest ``tokens``."""
    from repro_torch.models import param_count
    active = param_count(cfg, active_only=bool(cfg.n_experts))
    if cfg.family != "audio":
        return 6 * active * tokens, active
    enc = active - param_count(cfg.replace(enc_layers=0))
    return 6 * ((active - enc) * tokens + enc * frames), active


def phase_train_family(torch, card, arch):
    """14a: ``make_train_step`` at full width and cut depth, bf16, srste
    2:4, batch 8 x 128, the config's grad_accum / remat / remat_group,
    AdamW with f32 masters, ``FAMILY_STEPS`` steps from step 1 (the
    warmup's lr is 0 at step 0).  Gates: finite losses; every parameter's
    master moves at every step.  A ``[profile]`` of one more step for the
    ``FAMILY_PROFILE`` archs.  Returns the median step ms."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch.steps import make_train_step, named_params
    from repro_torch.launch.train import cut_depth
    from repro_torch.models import init_model, param_count
    from repro_torch.optim import AdamWConfig, adamw_init
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = cut_depth(get_config(arch), FAMILY_TRAIN_LAYERS[arch])
    model = init_model(cfg, seed=0, device="cuda")
    ocfg = AdamWConfig(master_weights=True)
    opt = adamw_init(named_params(model), ocfg)
    step_fn = make_train_step(cfg, ocfg)
    data = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    init_s = time.perf_counter() - t0
    losses, secs, frozen = [], [], set()
    for step in range(1, FAMILY_STEPS + 1):
        probe = {k: v.view(-1)[:4096].clone()
                 for k, v in opt["master"].items()}
        batch = to_device(next(data), "cuda")
        torch.cuda.synchronize()
        ts = time.perf_counter()
        model, opt, m = step_fn(model, opt, batch, step)
        losses.append(float(m["loss"]))         # the read-back syncs
        secs.append(time.perf_counter() - ts)
        frozen |= {k for k, v in probe.items()
                   if torch.equal(opt["master"][k].view(-1)[:4096], v)}
    peak = torch.cuda.max_memory_allocated()
    ms = _median(secs[2:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    frames = TRAIN_BATCH * cfg.enc_seq if cfg.family == "audio" else 0
    flops, active = train_flops(cfg, tokens, frames)
    n_params = param_count(cfg)
    # as 13a: each parameter's bf16 weight read and written, its f32
    # master / mu / nu read and written, the f32 gradient sum
    state_bytes = n_params * (2 * 2 + 3 * 8 + 8)
    floor, by = bound_ms(state_bytes, flops, "bfloat16")
    depth = (f"{cfg.enc_layers} + {cfg.n_layers}L" if cfg.family == "audio"
             else f"{cfg.n_layers}L")
    log(f"[14a {arch}] {card}: {depth} d{cfg.d_model} {cfg.dtype} srste "
        f"{cfg.sparsity.n}:{cfg.sparsity.m}, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, grad_accum {cfg.grad_accum}, remat {cfg.remat} "
        f"(group {cfg.remat_group}), AdamW f32 masters: {n_params / 1e9:.3f} "
        f"B parameters; median {ms:.1f} ms/step after step 2 = "
        f"{tokens / ms * 1e3:.0f} tokens/s; steps "
        f"{[round(1e3 * t, 1) for t in secs]} ms; model FLOPs 6 x "
        f"{active / 1e9:.3f} B {'active ' if cfg.n_experts else ''}"
        f"parameters x {tokens} tokens"
        + (f" (the encoder's x {frames} frames)" if frames else "")
        + f" = {flops / 1e12:.2f} TFLOP, "
        f"{100 * flops / (ms * 1e-3) / PEAK_FLOPS['bfloat16']:.2f}% of "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s; floor {floor:.2f} ms "
        f"({by}: {state_bytes / 1e9:.1f} GB of weights and optimizer "
        f"state); peak {gib(peak)}; losses {[round(x, 4) for x in losses]}; "
        f"init {init_s:.1f}s")
    if not all(abs(x) < 1e3 for x in losses) or frozen:
        raise SystemExit(f"phase 14a {arch}: losses {losses}; parameters "
                         f"that did not move in a step: {sorted(frozen)}")
    if arch in FAMILY_PROFILE:
        batch = to_device(data.batch_at(FAMILY_STEPS), "cuda")
        log(f"[profile] {card}: 14a {arch} train step {FAMILY_STEPS + 1}: "
            + train_profile(torch, step_fn, model, opt, batch,
                            FAMILY_STEPS + 1))
    del model, opt
    free_card(torch)
    return ms


def phase_family_card_vs_cpu(torch, card, arch):
    """14b: the reduced f32 config, two steps, each run on the card and on
    the CPU from the CPU's weights and optimizer state: the loss within
    1e-5 relative; each gradient and each updated parameter within
    ``GRAD_TOL`` of its leaf's scale, max(1, the leaf's largest CPU
    value): an f32 gradient element is a sum whose rounding follows the
    terms' size, not its own (zamba2's reduced model carries gradients of
    up to 2.8, and its CPU f32 gradients are 2.7e-5 from an f64
    evaluation at the first step).  A parameter whose Adam update is
    ill-conditioned (sqrt(nu-hat) under 1e-6: u = m-hat / (sqrt(nu-hat)
    + 1e-8) turns on gradient digits beneath the tolerance there) is held
    to 2 lr.  Prints the largest absolute differences and the largest
    share of the tolerance used."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch.steps import loss_and_grads, named_params
    from repro_torch.models import init_model
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   warmup_cosine)
    cfg = get_config(arch, smoke=True).replace(grad_accum=1)
    ocfg = AdamWConfig(master_weights=False)
    data = SyntheticLMData(cfg, 2, 32, seed=4)
    cpu = init_model(cfg, seed=2, device="cpu")
    opt = adamw_init(named_params(cpu), ocfg)
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    used = {"grad": 0.0, "param": 0.0}
    ill = 0

    def share(got, want):
        scale = max(1.0, float(want.abs().max()))
        return float((got - want).abs().max()) / (GRAD_TOL * scale)
    for step in (1, 2):
        card_model = copy.deepcopy(cpu).cuda()
        card_opt = {k: ({n: t.cuda() for n, t in v.items()}
                        if isinstance(v, dict) else v.cuda())
                    for k, v in copy.deepcopy(opt).items()}
        lr = warmup_cosine(step, 1e-3, 2, 10000)
        out = []
        for model, st, where in ((cpu, opt, "cpu"),
                                 (card_model, card_opt, "cuda")):
            params = named_params(model)
            loss, grads = loss_and_grads(model, cfg,
                                         to_device(data.batch_at(step),
                                                   where))
            adamw_update(grads, st, params, lr, ocfg)
            out.append((float(loss), {k: g.cpu() for k, g in grads.items()},
                        {k: p.detach().cpu() for k, p in params.items()}))
        (lc, gc, pc), (lg, gg, pg) = out
        worst["loss"] = max(worst["loss"], abs(lg - lc) / abs(lc))
        worst["grad"] = max(worst["grad"],
                            max(_max_diff(gg[k], gc[k]) for k in gc))
        used["grad"] = max(used["grad"],
                           max(share(gg[k], gc[k]) for k in gc))
        for k in pc:
            vhat = opt["nu"][k] / (1 - ocfg.b2 ** step)
            bad = vhat.sqrt() < 1e-6
            diff = (pg[k] - pc[k]).abs()
            ill += int(bad.sum())
            if (~bad).any():
                worst["param"] = max(worst["param"], float(diff[~bad].max()))
                used["param"] = max(used["param"],
                                    share(pg[k][~bad], pc[k][~bad]))
            if bad.any() and float(diff[bad].max()) > 2 * float(lr) + 1e-6:
                raise SystemExit(f"phase 14b {arch}: {k} moved "
                                 f"{float(diff[bad].max()):.3e} where its "
                                 f"update is ill-conditioned")
        del card_model, card_opt
    log(f"[14b {arch}] {card}: reduced f32 config ({cfg.n_layers}L d"
        f"{cfg.d_model}), 2 steps, each from the CPU's state: loss "
        f"relative {worst['loss']:.2e} (tol 1e-5), gradients "
        f"{worst['grad']:.3e}, parameters {worst['param']:.3e} (tol "
        f"{GRAD_TOL} x max(1, the leaf's largest value): {used['grad']:.2f}"
        f" / {used['param']:.2f} of it used; {ill} ill-conditioned "
        f"elements within 2 lr)")
    if not (worst["loss"] <= 1e-5 and used["grad"] <= 1.0
            and used["param"] <= 1.0):
        raise SystemExit(f"phase 14b {arch}: the card's f32 steps disagree "
                         f"with the CPU's: {worst}, {used} of the "
                         f"tolerance")


def serve_linears(model, cfg):
    """(N:M linears a decode tick runs, linears a prefill runs) of a
    compressed model (at full width every linear is compressed): every
    linear but the expert stacks (their dense views are batched products,
    not kernels); MLA decode reads ``wuk`` / ``wuv`` decompressed; the
    hybrid runs its shared block once per group; the audio family's tick
    skips the cross ``wk`` / ``wv``."""
    from repro_torch.core.layers import SparseLinear, StackedLinear
    lins = [m for m in model.modules() if isinstance(m, SparseLinear)
            and not isinstance(m, StackedLinear)]
    if cfg.family == "hybrid":
        n = ssm_linears_per_tick(model)
        return n, n
    if cfg.family == "audio":
        return len(tick_linears(model)), len(lins)
    return len(lins) - (2 * cfg.n_layers if cfg.mla else 0), len(lins)


def phase_family_train_serve(torch, card, arch):
    """14c: train -> compress -> serve.  f32 at full width and
    ``SERVE_TRAIN_LAYERS`` depth, 3 srste steps, ``convert_to_compressed``,
    4 requests through the graphed paged fused engine (prewarmed, strict):
    the tokens equal greedy decode by the trained model's ``forward``;
    each kernel's launches equal the ticks' and prefills' counts.  deepseek
    runs at a capacity factor of E, so that no route drops in the engine's
    batches or in ``forward``'s.  Returns the launches."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.layers import SparseLinear
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch.steps import make_train_step, named_params
    from repro_torch.launch.train import cut_depth
    from repro_torch.models import (convert_to_compressed, forward,
                                    init_model)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve import ServeEngine, synthetic_trace
    free_card(torch)
    t0 = time.perf_counter()
    cfg = cut_depth(get_config(arch).replace(dtype="float32", grad_accum=1),
                    SERVE_TRAIN_LAYERS[arch], SERVE_TRAIN_ENC.get(arch))
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    model = init_model(cfg, seed=3, device="cuda")
    ocfg = AdamWConfig(master_weights=False)
    opt = adamw_init(named_params(model), ocfg)
    step_fn = make_train_step(cfg, ocfg, base_lr=3e-3, warmup=1)
    data = SyntheticLMData(cfg, 2, SERVE_TRAIN_PROMPT, seed=5)
    losses = []
    for i in range(3):
        model, opt, m = step_fn(model, opt, to_device(next(data), "cuda"),
                                i + 1)
        losses.append(float(m["loss"]))
    del opt
    ccfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                    mode="compressed"))
    served = convert_to_compressed(model, ccfg)
    if any(not m.compressed and ccfg.sparsity.applies(*m.w.shape[:-3:-1])
           for m in served.modules() if isinstance(m, SparseLinear)):
        raise SystemExit(f"phase 14c {arch}: a linear stayed dense")
    reqs = synthetic_trace(cfg, n_requests=SERVE_TRAIN_REQS,
                           prompt_len=SERVE_TRAIN_PROMPT,
                           gen_lens=[SERVE_TRAIN_GEN], seed=0)
    eng = ServeEngine(served, ccfg, **graphed(dict(
        n_slots=SERVE_TRAIN_REQS, max_len=SERVE_TRAIN_PROMPT + 16,
        kv="paged", attn="fused", block_size=16, device="cuda")))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    ts = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    launches = {k.name: k.launches for k in kernels.all_kernels()}
    st = eng.stats()
    if (not eng.graphs or st["mid_serve_compiles"]
            or st["tokens"] != SERVE_TRAIN_REQS * SERVE_TRAIN_GEN):
        raise SystemExit(f"phase 14c {arch}: the engine did not serve every "
                         f"token from its prewarmed graphs")
    tick, pre = serve_linears(served, ccfg)
    attn_layers = (len(served.groups) if cfg.family == "hybrid"
                   else 0 if cfg.family == "ssm" else cfg.n_layers)
    want = {"nm_spmv": eng.decode_steps * tick,
            "nm_xwt": eng.prefill_calls * pre,
            "paged_mla_decode" if cfg.mla else "paged_gqa_decode":
            eng.decode_steps * attn_layers}
    with torch.no_grad():
        ref = {}
        for r in reqs:
            gen = []
            for _ in range(r.max_new_tokens):
                logits, _ = forward(model, cfg,
                                    prompt_batch(torch, model, r.inputs, gen))
                gen.append(int(logits[0, -1].argmax()))
            ref[r.rid] = gen
    bad = [r.rid for r in reqs
           if not np.array_equal(results[r.rid].tokens, ref[r.rid])]
    log(f"[14c {arch}] {card}: f32 {cfg.n_layers}L"
        + (f" (+ {cfg.enc_layers} encoder)" if cfg.family == "audio" else "")
        + f" d{cfg.d_model} trained 3 srste steps (losses "
        f"{[round(x, 4) for x in losses]}), compressed, {SERVE_TRAIN_REQS} "
        f"requests of {SERVE_TRAIN_PROMPT} + {SERVE_TRAIN_GEN} through the "
        f"graphed paged fused engine in {wall:.3f}s: {eng.decode_steps} "
        f"ticks, {eng.prefill_calls} prefills; served tokens equal greedy "
        f"forward in {len(reqs) - len(bad)}/{len(reqs)} requests; launches "
        f"{ {k: v for k, v in launches.items() if v} } (expected {want}); "
        f"{time.perf_counter() - t0:.1f}s")
    if bad:
        raise SystemExit(f"phase 14c {arch}: served tokens differ from the "
                         f"trained model's forward in requests {bad}")
    if any(launches[k] != n for k, n in want.items()) or sum(
            launches.values()) != sum(want.values()):
        raise SystemExit(f"phase 14c {arch}: launches {launches} != {want}")
    del eng, served, model
    free_card(torch)
    return launches


def phase_train_families(torch, card):
    """Phase 14: training of the other families (14a-14c).  Returns the
    launches of each family's train -> serve path."""
    t0 = time.perf_counter()
    for arch in FAMILY_ARCHS:
        phase_train_family(torch, card, arch)
    log(f"[time] phase 14a {time.perf_counter() - t0:.1f}s")
    t1 = time.perf_counter()
    for arch in FAMILY_ARCHS:
        phase_family_card_vs_cpu(torch, card, arch)
    log(f"[time] phase 14b {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    paths = {f"train_serve_{arch}": phase_family_train_serve(torch, card,
                                                              arch)
             for arch in FAMILY_ARCHS}
    log(f"[time] phase 14c {time.perf_counter() - t1:.1f}s")
    log(f"[time] phase 14 {time.perf_counter() - t0:.1f}s")
    return paths


# ----------------------------------------------------------- phase 15

TP_TRACE = dict(n_requests=4, prompt_len=64, gen_lens=[8], seed=0)
TP_KW = dict(n_slots=4, max_len=72, compressed=True, kv="paged",
             attn="fused", block_size=16)
TP_PATH = ("nm_spmv", "nm_xwt", "paged_gqa_decode")
TP_F32_LAYERS = {"llama3.2-1b": 4, "deepseek-v2-lite-16b": 2}
TP_LABEL = ("one card, two processes, gloo through host memory: not a "
            "multi-card figure")


def _tp_cfg(arch, dtype, layers=None):
    """``arch`` at full width (``layers``: cut depth), compressed."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.replace(dtype=dtype, sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed"))
    return cfg if layers is None else cfg.replace(n_layers=layers)


def _tp_model(torch, arch, dtype, layers=None, store=None):
    """``_tp_cfg``'s model, compressed at init, from seed 0 on the card
    (the same weights in every process); ``store="cpu"`` keeps it on the
    host, as a rank of ``launch.serve --tp`` does."""
    from repro_torch.models import init_model
    cfg = _tp_cfg(arch, dtype, layers)
    return init_model(cfg, seed=0, device="cuda", store=store), cfg


def _model_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + list(model.buffers()))


def _tp_margin(torch, model, cfg, req, base, got) -> str:
    """The single-rank model's top-2 logit margin at the first token where
    ``got`` leaves ``base`` (teacher-forced prefill)."""
    import numpy as np
    from repro_torch.models import prefill
    i = int(np.argmin(np.asarray(base) == np.asarray(got)))
    logits, _ = prefill(model, cfg, prompt_batch(torch, model, req.inputs,
                                                 base[:i]))
    top = torch.topk(logits[0].float(), 2).values
    return (f"rid {req.rid} token {i} ({base[i]} single, {got[i]} TP): "
            f"margin {float(top[0] - top[1]):.4g}")


def _tp_rank(rank: int, n: int, port: int, out: str, jobs) -> None:
    """One rank of 15b / 15c (a child process on cuda:0, gloo): each job
    serves its trace over the mesh under each of its collectives from a
    model kept on the host (only the rank's shard goes to the card; the
    card's peak allocation over engine init and serve is recorded), counts
    zeroed before each run; rank 0 then serves the same trace on one rank
    (the whole model on the card, no mesh, eager) and compares.  Writes
    its results as JSON to ``out.<rank>``."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist.api import make_serve_mesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        res = _tp_jobs(torch, make_serve_mesh(n, backend="gloo",
                                              device="cuda"), jobs)
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
        dist.barrier()          # no rank tears down while a peer still talks
    finally:
        dist.destroy_process_group()


def _tp_jobs(torch, mesh, jobs):
    """``_tp_rank``'s jobs on this rank (see there)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine, synthetic_trace
    rank = mesh.rank
    res = []
    for job in jobs:
        host, cfg = _tp_model(torch, job["arch"], job["dtype"],
                              job.get("layers"), store="cpu")
        reqs = synthetic_trace(cfg, **job["trace"])
        runs = {}
        for coll in job["collectives"]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            eng = ServeEngine(host, cfg, mesh=mesh, tp_collective=coll,
                              device="cuda", **TP_KW)
            mesh.reset_stats()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run([dataclasses.replace(r) for r in reqs])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.stats()
            runs[coll] = dict(
                tokens={str(k): v.tokens.tolist()
                        for k, v in eng.results.items()},
                launches={k.name: k.launches for k in kernels.all_kernels()},
                wall=wall, graphs=eng.graphs,
                whole_bytes=_model_bytes(host),
                shard_bytes=_model_bytes(eng.model),
                peak_bytes=torch.cuda.max_memory_allocated() - base,
                stats={k: st[k] for k in (
                    "tokens", "decode_steps", "prefill_calls",
                    "steady_tick_s", "first_tick_s", "ring_bytes_per_step",
                    "ring_dense_bytes_per_step", "ring_traffic_ratio",
                    "ring_linears", "local_linears", "ring_sent_bytes",
                    "gather_sent_bytes", "staged_bytes",
                    "weight_stream_bytes")})
            del eng
        del host
        one = {}
        if rank == 0:
            model, _ = _tp_model(torch, job["arch"], job["dtype"],
                                 job.get("layers"))
            eng = ServeEngine(model, cfg, device="cuda", graphs=False,
                              **TP_KW)
            eng.run([dataclasses.replace(r) for r in reqs])
            one["tokens"] = {str(k): v.tokens.tolist()
                             for k, v in eng.results.items()}
            one["margins"] = [
                _tp_margin(torch, eng.model, eng.cfg, r,
                           one["tokens"][str(r.rid)],
                           run["tokens"][str(r.rid)])
                for run in runs.values() for r in reqs
                if not np.array_equal(one["tokens"][str(r.rid)],
                                      run["tokens"][str(r.rid)])]
            del eng, model
        res.append(dict(job=job, runs=runs, single=one))
        torch.cuda.empty_cache()
    return res


def phase_tp_nccl(torch, card, base=None):
    """15a: NCCL at world size 1, graphed and prewarmed, on phase 3's trace,
    held to ``base``, phase 3's token streams (served here without a mesh
    when not given)."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.dist.api import make_serve_mesh
    from repro_torch.serve import ServeEngine, synthetic_trace
    model, cfg = _tp_model(torch, "llama3.2-1b", "bfloat16")
    kw = graphed(dict(n_slots=8, max_len=128 + 32, compressed=True,
                      kv="paged", attn="fused", block_size=16,
                      device="cuda"))
    reqs = synthetic_trace(cfg, n_requests=16, prompt_len=128,
                           gen_lens=[16, 32], seed=0)
    if not base:
        eng = ServeEngine(model, cfg, **kw)
        eng.run(reqs)
        base = {rid: r.tokens for rid, r in eng.results.items()}
        del eng
    mesh = make_serve_mesh(1, backend="nccl", device="cuda")
    try:
        eng = ServeEngine(model, cfg, mesh=mesh, **kw)
        kernels.reset_launch_counts()
        mesh.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.all_kernels()}
        st = eng.stats()
    finally:
        dist.destroy_process_group()
    same = sum(np.array_equal(base[r.rid], eng.results[r.rid].tokens)
               for r in reqs)
    ticks = int(st["decode_steps"])
    lin = cfg.n_layers * LINEARS_PER_LAYER
    want = dict(nm_spmv=ticks * lin, paged_gqa_decode=ticks * cfg.n_layers,
                nm_xwt=int(st["prefill_calls"]) * lin)
    log(f"[15a nccl] {cfg.name} at world size 1 ({mesh.backend}, "
        f"{eng.tp_collective}), graphed {eng.graphs}, "
        f"{int(st['prewarmed_executables'])} graphs prewarmed, "
        f"{int(st['mid_serve_compiles'])} mid-serve: {same}/{len(reqs)} "
        f"requests equal phase 3's; {st['tokens'] / wall:.1f} tokens/s, tick "
        f"steady {st['steady_tick_s'] * 1e3:.2f} ms; all-gathers sent "
        f"{int(st['gather_sent_bytes'])} B (a group of one); launches "
        f"{launches} (card {card})")
    if (same != len(reqs) or not eng.graphs or st["mid_serve_compiles"]
            or st["prewarmed_executables"] != st["executables_expected"]):
        raise SystemExit(f"phase 15a: NCCL world-size-1 serving gave "
                         f"{same}/{len(reqs)} requests equal to phase 3's, "
                         f"or did not serve from its prewarmed graphs")
    check_path(launches, TP_PATH, "phase 15a", **want)
    del eng, model
    torch.cuda.empty_cache()
    return {"tp_nccl": launches}


def phase_tp_gloo(torch, card):
    """15b and 15c: two child processes on the one card, gloo."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.dist.api import free_port
    jobs = [dict(arch="llama3.2-1b", dtype="bfloat16", trace=TP_TRACE,
                 collectives=["ring", "gspmd"])]
    for arch, layers in TP_F32_LAYERS.items():
        jobs.append(dict(arch=arch, dtype="float32", layers=layers,
                         trace=dict(TP_TRACE, prompt_len=4 if "deepseek"
                                    in arch else 32),
                         collectives=["ring"]))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tp")
        mp.start_processes(_tp_rank, args=(2, free_port(), out, jobs),
                           nprocs=2, start_method="spawn")
        ranks = []
        for r in range(2):
            with open(f"{out}.{r}") as f:
                ranks.append(json.load(f))
    log(f"[time] phase 15b/c children {time.perf_counter() - t0:.1f}s")
    paths = {}
    for j, res in enumerate(ranks[0]):
        job, single = res["job"], res["single"]
        cfg = _tp_cfg(job["arch"], job["dtype"], job.get("layers"))
        what = (f"{job['arch']} {job['dtype']}"
                + (f" {job['layers']}L" if job.get("layers") else ""))
        for coll, run in res["runs"].items():
            other = ranks[1][j]["runs"][coll]
            st = run["stats"]
            ticks, prefills = int(st["decode_steps"]), int(st["prefill_calls"])
            lin = cfg.n_layers * LINEARS_PER_LAYER if cfg.n_experts == 0 \
                else None
            same = sum(single["tokens"][rid] == toks
                       for rid, toks in run["tokens"].items())
            ranks_agree = run["tokens"] == other["tokens"]
            sent = st["ring_sent_bytes"] + other["stats"]["ring_sent_bytes"]
            log(f"[15 tp] {what} {coll}: {same}/{len(run['tokens'])} requests "
                f"equal the single-rank engine's, ranks agree {ranks_agree}; "
                f"{ticks} ticks, {prefills} prefills; ring sent "
                f"{sent / max(ticks, 1):.0f} B a tick over both ranks against the model's "
                f"{st['ring_bytes_per_step']:.0f} (ratio to the dense ring "
                f"{st['ring_traffic_ratio']:.4f}, {int(st['ring_linears'])} "
                f"ring / {int(st['local_linears'])} local linears); gathers "
                f"sent {int(st['gather_sent_bytes'])} B, staged through the "
                f"host {int(st['staged_bytes'])} B (rank 0); weight stream "
                f"{st['weight_stream_bytes'] / 1e9:.3f} GB a rank; tick steady "
                f"{st['steady_tick_s'] * 1e3:.1f} ms, first "
                f"{st['first_tick_s'] * 1e3:.1f} ms, "
                f"{st['tokens'] / run['wall']:.1f} tokens/s ({TP_LABEL}); "
                f"card memory rank 0: whole model {run['whole_bytes']} B "
                f"on the host, shard {run['shard_bytes']} B, peak "
                f"allocated over init and serve {run['peak_bytes']} B; "
                f"launches rank 0 {run['launches']}")
            for m in single["margins"]:
                log(f"[15 tp]   {m}")
            if same != len(run["tokens"]) or not ranks_agree or run["graphs"]:
                raise SystemExit(f"phase 15: {what} {coll}: TP tokens differ "
                                 f"from the single-rank engine's "
                                 f"({same}/{len(run['tokens'])}) or between "
                                 f"ranks, or the gloo engine captured graphs")
            want = {"nm_xwt": prefills * lin,
                    "paged_gqa_decode": ticks * cfg.n_layers} if lin else {}
            if lin:
                want["nm_spmv"] = ticks * lin * (2 if coll == "ring" else 1)
            path = TP_PATH if lin else DEEPSEEK_PATH
            check_path(run["launches"], path, f"phase 15 {what} {coll}",
                       **want)
            if job["dtype"] == "bfloat16":
                peaks = (run["peak_bytes"], other["peak_bytes"])
                if max(peaks) >= run["whole_bytes"]:
                    raise SystemExit(f"phase 15b {coll}: a rank's card peak "
                                     f"{peaks} B reaches the whole model's "
                                     f"{run['whole_bytes']} B")
                want_sent = st["ring_bytes_per_step"] * ticks \
                    if coll == "ring" else 0
                if sent != want_sent:
                    raise SystemExit(f"phase 15b {coll}: the ring sent {sent}"
                                     f" B over {ticks} ticks, the model "
                                     f"says {want_sent}")
                paths[f"tp_{coll}"] = run["launches"]
            else:
                prev = paths.get("tp_f32")
                paths["tp_f32"] = run["launches"] if prev is None else {
                    k: prev[k] + v for k, v in run["launches"].items()}
    return paths


def phase_tp(torch, card, llama_tokens=None):
    """Phase 15; ``llama_tokens``: phase 3's token streams, for 15a."""
    t0 = time.perf_counter()
    paths = phase_tp_nccl(torch, card, llama_tokens)
    log(f"[time] phase 15a {time.perf_counter() - t0:.1f}s")
    paths.update(phase_tp_gloo(torch, card))
    log(f"[time] phase 15 {time.perf_counter() - t0:.1f}s")
    return paths


# ------------------------------------------------------------------ main

KERNEL_META = {
    "nm_spmv": ("src/repro_torch/csrc/nm_spmv.cu",
                "src/repro/kernels/nm_spmv.py:67"),
    "nm_spmv_onehot": ("src/repro_torch/csrc/nm_spmv.cu",
                       "src/repro/kernels/nm_spmv.py:43"),
    "nm_xwt": ("src/repro_torch/csrc/nm_xwt.cu",
               "src/repro/kernels/nm_spmm.py:160"),
    "nm_xwt_packed": ("src/repro_torch/csrc/nm_xwt.cu",
                      "src/repro/kernels/nm_spmm.py:36"),
    "nm_spmm": ("src/repro_torch/csrc/nm_xwt.cu",
                "src/repro/kernels/nm_spmm.py:128"),
    "paged_gqa_decode": ("src/repro_torch/csrc/paged_gqa_verify.cu",
                         "src/repro/kernels/flash_attention.py:199"),
    "paged_mla_decode": ("src/repro_torch/csrc/paged_mla_verify.cu",
                         "src/repro/kernels/flash_attention.py:291"),
    "paged_gqa_verify": ("src/repro_torch/csrc/paged_gqa_verify.cu",
                         "src/repro/kernels/flash_attention.py:338"),
    "paged_mla_verify": ("src/repro_torch/csrc/paged_mla_verify.cu",
                         "src/repro/kernels/flash_attention.py:362"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:94"),
}
TIMING_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 plain products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_build(torch)
    rows = phase_matmuls(torch, F, "llama3.2-1b", CHECK_SHAPES, LAYER_SHAPES,
                         LAYER_SHAPES, seed=0)
    ds_rows = phase_matmuls(torch, F, "deepseek-v2-lite MoE", DS_CHECK_SHAPES,
                            DS_DECODE_SHAPES, DS_PREFILL_SHAPES, seed=3)
    for name, row in ds_rows.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        row["max_abs_err"])
        rows[name]["at_deepseek_layer"] = {k: row[k] for k in TIMING_KEYS}
    draft_rows = phase_matmuls(torch, F, "llama3.2-1b", CHECK_SHAPES,
                               LAYER_SHAPES, LAYER_SHAPES, seed=7, n=1)
    for name, row in draft_rows.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        row["max_abs_err"])
        rows[name]["at_1of4_llama_layer"] = {k: row[k] for k in TIMING_KEYS}
    gemma_rows = phase_matmuls(torch, F, "gemma2-9b", GEMMA_CHECK_SHAPES,
                               GEMMA_LAYER_SHAPES, GEMMA_LAYER_SHAPES, seed=9)
    for name, row in gemma_rows.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        row["max_abs_err"])
        rows[name]["at_gemma2_layer"] = {k: row[k] for k in TIMING_KEYS}
    for model, check, layer, seed in (
            ("falcon-mamba-7b", FALCON_LAYER_SHAPES, FALCON_LAYER_SHAPES, 13),
            ("zamba2-7b", ZAMBA_CHECK_SHAPES, ZAMBA_LAYER_SHAPES, 15)):
        for name, row in phase_matmuls(torch, F, model, check, layer, layer,
                                       seed=seed).items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            row["max_abs_err"])
            rows[name][f"at_{model.split('-')[0]}_layer"] = {
                k: row[k] for k in TIMING_KEYS}
    for model, check, spmv_layer, xwt_layer, seed, frames in (
            ("whisper-small", WHISPER_CHECK_SHAPES, WHISPER_DEC_SHAPES,
             WHISPER_ENC_SHAPES, 17, ENC_FRAMES),
            ("qwen2-vl-7b", QWEN_CHECK_SHAPES, QWEN_LAYER_SHAPES,
             QWEN_LAYER_SHAPES, 19, 128)):
        for name, row in phase_matmuls(torch, F, model, check, spmv_layer,
                                       xwt_layer, seed=seed,
                                       xwt_rows=frames).items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            row["max_abs_err"])
            rows[name][f"at_{model.split('-')[0]}_layer"] = {
                k: row[k] for k in TIMING_KEYS}
        check_biased_linears(torch, model, check[:1] if model ==
                             "whisper-small" else check[:2], frames)
    rows["nm_xwt"]["at_verify_span"] = time_verify_linears(torch, F)
    rows.update(phase_packed_and_onehot(torch, F))
    spmm_err = phase_spmm_check(torch)
    rows["paged_gqa_decode"] = phase_attention(torch, F)
    rows["paged_mla_decode"] = phase_mla_attention(torch, F)
    rows["paged_gqa_verify"] = phase_verify_attention(torch, F)
    rows["paged_mla_verify"] = phase_mla_verify_attention(torch, F)
    for model in ATTN_SHAPES:
        for name, row in phase_window_attention(torch, F, model).items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            row["max_abs_err"])
            rows[name][f"at_{model.split('-')[0]}"] = row
    log(f"[time] phases 1-2 {time.perf_counter() - t_start:.1f}s")
    t0 = time.perf_counter()
    rows["flash_attention"], flash_path = phase_flash(torch, F)
    log(f"[time] flash phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    cnn_rows, cnn_path = phase_cnn(torch, F)
    log(f"[time] CNN phase {time.perf_counter() - t0:.1f}s")
    rows["nm_spmm"] = cnn_rows["nm_spmm"]
    rows["nm_spmm"]["max_abs_err"] = max(rows["nm_spmm"]["max_abs_err"],
                                         spmm_err)
    rows["nm_xwt"]["at_cnn"] = cnn_rows["nm_xwt"]
    by_path = {**flash_path, **cnn_path}
    llama_tokens = {}
    for name, phase in (("llama phases 3-9",
                         lambda torch, card: phase_serve(torch, card,
                                                         llama_tokens)),
                        ("deepseek phases 4, 6",
                         lambda torch, card: phase_serve_deepseek(torch)),
                        ("gemma2 phase 10", phase_gemma2)):
        t0 = time.perf_counter()
        by_path.update(phase(torch, card))
        log(f"[time] {name} {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    check_other_configs(torch)
    log(f"[time] other configs {time.perf_counter() - t0:.1f}s")
    by_path.update(phase_ssm(torch, card))
    by_path.update(phase_encdec_vlm(torch, card))
    by_path.update(phase_train(torch, card))
    by_path.update(phase_train_families(torch, card))
    by_path.update(phase_tp(torch, card, llama_tokens))
    # the packed variant serves no path of its own: its launches are those
    # of the CNN phase, where it runs on every layer the reference can pack
    kernels_line = []
    for name, (src, rep) in KERNEL_META.items():
        per_path = {p: counts[name] for p, counts in by_path.items()
                    if counts[name]}
        kernels_line.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=sum(per_path.values()), launches_by_path=per_path,
            **rows[name]))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s "
        f"on {card}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
