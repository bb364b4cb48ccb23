#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100
is the target: the kernels build for sm_90a). Phases, in order; any
failure exits non-zero before the result line:

  1. device   — CUDA present; the card's name and power limit
                (nvidia-smi);
  2. build    — nvcc builds every kernel in incubator_mxnet_tpu_torch/
                csrc/ (in parallel), timed; each ragged and flash
                kernel's ptxas registers, shared memory and spills, and
                its SASS counts of HMMA / LDSM / LDGSTS / UTMALDG /
                STS.U16 (cuobjdump): the ragged tensor-core bodies
                (prefill_mma, verify_mma, decode_mma) must issue HMMA,
                LDSM and LDGSTS; the flash TMA bodies (forward, dq,
                dk/dv) HMMA, LDSM and TMA loads (UTMALDG), and no STS.U16
                (no transposed copy, stored 2 bytes at a time); the
                forward's no spills;
  3. kernels  — each of the six ragged kernels (decode, prefill, verify,
                and their int8 / fp8_e4m3 code-pool variants) against its
                plain PyTorch version on the card at the serving path's
                shapes, f32 and bf16 queries (prefill: the chunk as a
                device span at starts 0, 64, 200 and 960), plus the
                contract cases:
                NaN past the bound (length, start + n_real, length +
                draft_len), NaN inside it, length 0, page permutation,
                and a NaN page scale on a masked and on a live page
                (decode, prefill and verify: on both bodies, f32 and
                bf16, raw and code pools, with two launches bitwise
                equal); the decode tensor-core body (bf16, D=64) at
                lengths 0-65 and the capacity, capacities of 1, 4 and 64
                pages; the verify tensor-core body at W = 1, 2, 5, 16, 17
                and capacities of 1024 and 2048 keys, raw / int8 / fp8;
                torch.profiler shows one bf16 decode call running one
                device kernel;
  4. flash    — the three flash-attention kernels (forward, dq, dk/dv)
                against their plain versions, f32 and bf16, at BERT's
                shapes (B=4, H=12, T=512, D=64, lengths 0 / 1 / 200 /
                512), at T=2048 causal and not, D=128 with Tq != Tk, and
                D=64 at lengths that straddle the 64-row tiles; each
                gradient within a fraction of the largest |gradient| of
                its own (batch, head) slice, and the Δ the dq launch
                writes within f32 summation error of attn_delta; bf16
                causal at tile counts and B x H awkward for the
                heaviest-first work order (T = 576 with B x H = 15, 65,
                511, 2048); two launches bitwise equal (causal and not);
                NaN in the K/V rows past valid_len changes no output
                (bf16, T = 37 / 200 / 512, causal and not);
  5. serving  — gpt_small (GPT-2 small widths, bf16, seeded random
                weights) through InferenceEngine with chunked prefill and
                the prefix cache, 16 requests per run, every decode /
                verify step a replay of its width's CUDA graph and every
                prefill chunk a replay of its bucket's (each width and
                each (kind, bucket) that ran captured once: printed with
                its capture ms, and checked): plain decode;
                spec_k=4 with the n-gram drafter (raw pools); spec_k=4
                drafting by replay of the plain run's streams (a
                controlled accept rate) on raw pools, on int8 pools, and
                (4 requests) on fp8_e4m3 pools; then a short monolithic
                run (chunk_pages=None: the dense prompt programs, one per
                page bucket) on raw and int8 pools, with a request that
                repeats the first 250 tokens of an earlier prompt (a
                prefix hit through the COW copy program and a suffix
                chunk). Each run reads its kernels' launch counts
                (decode = non-speculative steps x layers, verify =
                speculative steps x layers, prefill = chunk replays x
                layers: no launch outside a graph) and prints tokens/s,
                TTFT p50, decode ms/step, accept rate and tokens per
                step; 10 steps of the plain and the speculative engine
                run under torch.profiler (device-busy share), and 10
                graphed chunk steps of one 960-token prompt (the ragged
                prefill kernels' share); the graphed decode step's and
                chunk step's host time (staging, launch, readback) and
                the device time of the draw and of the whole
                acceptance;
  5b. surface — the serving engine's remaining surface on gpt_small bf16
                (seed 0): KV cache tiers on raw bf16, int8 and fp8_e4m3
                pools (18 requests: 6 prefixes of 512 tokens, 3 requests
                each with a 64-token tail and 32 new greedy tokens, on 4
                slots and a pool just above their reservation, DRAM
                holding two prefixes and a disk tier under a temporary
                directory): demotions, spills, promotions from DRAM and
                from disk, no crc fallback, one gather and one promotion
                capture, the audit clean before every step, greedy
                streams bitwise an engine's that never evicts, ragged
                launches from replays only; prints the tier counters,
                the gather and promotion host ms per page and the bytes
                a page. Page transport between two engines (raw bf16 and
                int8 pools; 8 requests of 64-768 prompt tokens, 64 new,
                greedy and seeded T=0.8): each slot captured off A at 16
                tokens, installed on B, finished there; streams bitwise
                those of A alone, B prefilling nothing (its decode step
                takes each slot on from its last token), custody
                released, audits clean, one promotion build on B; prints
                capture / install ms per slot and MB moved.
                Brownout: one overloaded run (16 requests of three tiers
                on 4 slots, spec_k=4, a 50 ms delay reference): the level
                timeline, every request terminal, audits clean. Warm
                start: an engine on the seed-0 model serves 4 requests,
                takes the seed-1 model's weights, serves 4 more: no new
                capture, streams bitwise a fresh seed-1 engine's;
  5c. fleet   — one row with top-p 0.9 / top-k 40 in each of 8 slots of
                an (8, W, 50257) batch draws the same (`[sampling]`);
                then 3 gpt_small bf16 replicas behind a Router
                (build_fleet: one weight copy each), the serving phase's
                mixed workload in two waves: fault-free (the prefix's
                requests on the prefix's replica; streams bitwise one
                engine's under the router-pinned seeds); a replica
                killed mid-decode, and on a spec_k=4 fleet whose drafter
                always drafts, mid-verify (one terminal each, emitted
                prefixes kept, survivors bitwise the fault-free run's);
                remove_replica (decode-ready slots moved by capsule,
                streams bitwise); upgrade_replica(0) to the seed-1
                weights while 1-2 serve (then replica 0 serves seed-1
                streams, 1-2 seed 0's); a ServeFrontend on 127.0.0.1 over
                a plain fleet (4 SSE + 1 blocking, tokens equal the
                direct router's, /metrics and /healthz) and over a spec
                fleet (one stream a replica while the front end's thread
                captures their verify programs). Every run: page audits
                after every step, one capture per program met, summed
                ragged launches = steps x 12, and no breaker transition
                but the injected ones; a `[fleet]` line each (tokens/s,
                TTFT p50 direct or over HTTP, requeue-to-first-token ms,
                ms a slot migrated, transitions, captures per replica);
  6. parity   — at f32, the engine's greedy tokens, without and with
                spec_k=4, equal the port's dense-cache cached_generate
                (which runs no kernel), through the step and chunk graphs
                (the prefill kernel's CUDA-core body); then the graphs'
                cuda tests (tests/test_torch_serve_graphs.py,
                tests/test_torch_page_graphs.py,
                tests/test_torch_train_graphs.py,
                tests/test_torch_gpt_graphs.py and
                tests/test_torch_symbol_graphs.py, pytest without the
                conftest, so no JAX): replay == body bitwise (steps and
                chunks; train steps with dropout from a registered
                generator, two signatures alternating), a build touches
                no live page, launches per replay, one capture per width
                through stalls and a quarantine, one per (kind, bucket)
                through a COW hit, one per batch signature, a NaN batch
                through a replay, a failed capture raising; the page
                gather and promotion captured once over tiered traffic,
                a gather after a decode replay seeing its row, bf16 /
                fp8 payloads bitwise through DRAM and disk, a promotion
                on the card writing the CPU path's bytes, a warm start
                seen by the next replays;
  6b. ops     — every registered op (the port's 279: the JAX registry less
                the contrib, vision, quantization and RNN ops that wait)
                on the card against the port on the CPU, every case of
                tests/test_torch_op_cases.py (f32 within 1e-5 of the
                output's largest |entry| or the case's rtol if larger,
                bf16 within 2e-2; gesvd / syevd / gelqf by reconstruction
                and orthogonality), the samplers by their moments on the
                card (that file's `cuda` test, pytest without the
                conftest: no JAX);
  7. training — bert_base bf16 (flash, dropout 0.1) + BERTForPretraining
                through SPMDTrainer with LAMB (lr 1e-4, f32 masters), the
                bench's batch (B=32, T=512, M=76; lengths in [256, 512]):
                3 warm-up and 10 timed steps on one repeating batch
                (dropout masks included); the first step runs eagerly and
                the step graph is captured after it, inside the warm-up
                (one build: step_trace_count 1), every timed step a
                replay; every loss finite, the last below the first, each
                flash kernel launched 12 times a step. Prints tokens/s,
                ms/step, MFU against the card's peak, peak memory, a
                `[capture]` line (the eager first step's ms, the
                capture's), a `[host]` line (a replayed step's staging /
                launch / readback ms), the guarded LAMB apply run
                eagerly (what the graph took off the host), and from one
                profiled step the device-busy share and the attention
                kernels' share; then bert_base at T=1024 (B=4, 2 steps:
                the shapes the JAX package sends to its streaming
                kernels; the second a replay), and bert_tiny: 5 LAMB
                steps on the card (kernels; steps 2-5 replays) against
                the port on the CPU (plain versions), the losses within
                rtol 1e-4 in f32 (CUDA-core bodies) and 2e-3 in bf16
                (the mma.sync bodies bert_base runs), and in bf16 every
                parameter's first-step gradient within 5e-2 of its
                largest |gradient|;
  7b. gluon   — the verify drive on the card, bert_base bf16 through
                autograd.record() / gluon.Trainer("lamb");
  7c. vision  — convolutional image classification, which runs no kernel
                of the port's own (cuDNN convolutions, torch pooling):
                (1) Convolution (1-3-d, stride, dilation, groups,
                depthwise, a 256-channel 3x3), Deconvolution (adj),
                Pooling (max / avg / sum, valid and full at odd padded
                sizes, count_include_pad off) and AdaptiveAvgPooling2D on
                the card against the port on the CPU, f32 within 1e-4 of
                the output's largest |entry| (forward, and the input and
                weight gradients), bf16 within 2e-2, with cuDNN's f32
                convolutions left at torch's TF32 default: the ops set
                IEEE f32 per call (a direct F.conv2d is timed against it
                as the control); (2) resnet50_v1 bf16, B=64, 224x224, as
                bench.py builds it (one forward, cast, SPMDTrainer SGD lr
                0.1 momentum 0.9 multi_precision), 3 warm-up and 10 timed
                steps on one batch: one capture, every timed step a
                replay, finite losses, the last below the first, the
                BatchNorm running statistics moved and finite; img/s, ms
                a step, MFU (3 x 4.1 GFLOP an image over the card's
                peak), peak memory, the eager first step's and the
                capture's ms, and from one profiled step the busy share,
                the top device operations and the shares of the layout
                transposes, of PyTorch's elementwise and reduction
                kernels and of cuDNN / cuBLAS; (3) resnet18_v1(thumbnail=True, classes=10) f32,
                B=32, 32x32, 3 SGD steps (lr 1e-3, momentum 0.9) on the
                card against the port on the CPU from the same weights:
                losses within rtol 1e-4, every parameter and running
                statistic within 1e-3 of its largest |entry| + 1e-5; (4)
                LeNet through
                DataLoader(MNIST(synthetic=True).transform_first(
                ToTensor())), split_and_load, autograd.record(),
                gluon.Trainer("sgd") and metric.Accuracy for 3 epochs
                (282 batches): the loss falls; accuracy and batches/s.
                One `[vision]` JSON line with the card's name and limit;
  7c2. amp    — the MXNet 1.x mixed-precision front end: under
                amp.init("bfloat16") Convolution, FullyConnected, dot,
                batch_dot and interleaved_matmul_selfatt_qk on f32 inputs
                are bitwise the unwrapped op on bf16-cast inputs cast back
                to f32, softmax and BatchNorm on bf16 inputs bitwise the
                f32 computation cast back to bf16; resnet50_v1 (f32
                parameters, B=64, 224x224, one seeded batch) through
                autograd.record() -> amp.scale_loss -> backward ->
                gluon.Trainer("sgd", momentum 0.9).step(64), 3 warm-up and
                10 timed steps, beside the same loop without amp (ms a
                step, img/s, busy share; every loss and every f32
                gradient finite); the first amp bf16 loss of resnet18_v1
                at B=8 on the card within 2e-2 of the port on the CPU;
                then amp.init("float16") (scale from 2^16): resnet18_v1
                B=32, 20 steps, each skipped step keeping the parameters
                and momenta bitwise and halving the scale, at least one
                applied, a batch with an inf skipped bitwise; after
                _deinit_for_tests() no OpSpec.fn stays wrapped. One `[amp]`
                JSON line with the card's name and limit;
  7c3. symbolic — MXNet 1.x's train_imagenet.py flow on resnet50_v1 f32,
                B=64, 224x224: the gluon block hybridized and exported,
                the -symbol.json loaded back (its "[..]" __shape__
                strings parsed) under SoftmaxOutput(normalization=
                "batch"), mx.mod.Module on gpu(0) bound at (64, 3, 224,
                224), set_params from the exported .params, SGD (lr 1e-3,
                momentum 0.9) over seeded batches of an NDArrayIter: 3
                warm-up and 10 timed forward_backward + update steps, the
                train program captured once (its eager first call and
                capture ms), every later step a replay; its first 3 losses
                against the same weights and batches through
                gluon.Trainer on the card (the first loss within 1e-5,
                the parameters after the first update within 1e-4 of
                each tensor's largest |entry|, losses 2-3 within 4x the
                gap a 1e-7 weight perturbation opens between two
                gluon.Trainer runs: a random ResNet-50 is chaotic); a
                replay against the Executor's body run eagerly from the
                same state (outputs within 1e-5, gradients and running
                statistics within 5e-4 of each tensor's largest |entry|:
                cuDNN's backward is not deterministic by default); the
                eager body's step timed
                beside the replayed one; score on the same iterator adds
                the eval program (one capture); SymbolBlock.imports of the
                files against the block at rtol 1e-5. One `[symbolic]`
                JSON line with the card's name and limit (ms a step,
                img/s, busy share, captures and their ms);
  7c4. detection — bench.py `_run_ssd`'s configuration:
                ssd_300(num_classes=20) f32, B=32, 300x300 (7424 anchors),
                two boxes an image from RandomState(0), through
                SPMDTrainer(forward_loss=...) with SGD (lr 0.05, momentum
                0.9, wd 5e-4): MultiBoxTarget (bipartite matching, hard
                negative mining) and the joint loss inside the one
                captured step; 3 warm-up steps (the first eager, then the
                capture) and 10 timed replays; the 3 warm-up losses
                against a second trainer's step body run eagerly from the
                same weights (within 1e-4), finite losses that fall,
                step_trace_count 1; ms a step, img/s, the busy share and
                leading device ops of one profiled step, peak memory.
                SSD.detect (nms_topk 400) on 8 images on the card (the
                initial random weights, where rows survive), timed
                and profiled, against MultiBoxDetection on the CPU from
                the card's probabilities (class ids bitwise, scores and
                boxes within 1e-5; the softmax card vs CPU within 1e-5).
                faster_rcnn_small(num_classes=20) f32, B=2, 600x800: the
                forward and the toy loss of tests/test_contrib_det.py on
                the card against the CPU at the same weights (the RoI
                half of the CPU run from the card's RPN probabilities:
                rois within 1e-2 px with the same batch column and empty
                rows; scores, deltas, RPN outputs, loss and the first
                backbone weight's gradient within 1e-4 of each largest
                |entry|), then net(x, im_info), the toy loss and one
                gluon.Trainer("sgd") step. One `[detection]` JSON line
                with the card's name and limit;
  7d. gpt_training — bench.py `_run_gpt`'s configuration: gpt_small
                bf16 (flash, dropout 0.1, built by `gpt_small(...)` +
                `initialize()`) through SPMDTrainer(forward_loss=lm_loss)
                with AdamW (lr 1e-4, f32 masters), B=16, T=512, one
                repeating batch: 3 warm-up steps (one capture) and 10
                timed replays, each launching the causal flash forward,
                dq and dk/dv 12 times (counts set to 0 just before the
                timed steps); finite losses that fall; ms a step,
                tokens/s, MFU (`utils/flops.gpt_train_flops`, 6.30e12
                FLOP a step, over the card's peak), peak memory, the
                eager first step and capture ms, the busy and attention
                shares of a profiled step; a trainer each with remat=True
                and "dots" (first loss within 1e-2 relative of the
                no-remat one, one capture, peak memory); gpt_mini f32 on
                the card against the CPU from one set of weights (3 AdamW
                steps within 1e-5 relative; greedy_generate's tokens
                equal);
  7e. nmt     — bench.py `_run_nmt`'s configuration: transformer_base
                (max_length=256) f32, B=16, Ts=64, Tgen=48, K=4:
                beam_search_translate_cached once to warm up, 3 timed
                runs (tokens/s, busy share); the cached search's tokens
                equal the uncached search's, scores within 1e-4
                relative, with and without src_valid_length; a small
                flash Transformer (units 256, 4 heads of 64) whose logits
                are within 1e-4 of the largest |logit| of flash=False,
                and 2 SPMDTrainer Adam steps launching the flash kernels
                3 times a layer (encoder, decoder causal, cross);
  7f. checkpoint — gpt_small bf16 (flash, dropout 0.1, AdamW with f32
                masters) through SPMDTrainer at B=16, T=512, 8 steps on
                8 batches with the dropout masks drawn on (not reseeded):
                two uninterrupted runs first (bitwise equal, or their
                spread); `save_checkpoint` at step 2 (its write drained)
                and at step 4, which returns before steps 5-8 run while
                the write is in flight: the committed step 4 bitwise a
                synchronous host copy taken at step 4; a restore of step
                4 into the same trainer (no new capture) reruns 5-8, the
                losses bitwise or within the spread (12 launches of each
                causal flash kernel a replay), a restore into a fresh
                trainer from another seed gives the saved parameters,
                optimizer leaves, counters and generator state bitwise,
                then one capture; a live gpt_small engine
                `warm_start(manager=)` from the training capsule keeps its
                captures and serves the greedy streams of a `params=`
                warm start from the same arrays (ragged decode / prefill
                launched); `train.Supervisor` runs `train.example_target`
                on the card killed at two steps, its per-step losses equal
                an uninterrupted run's. One `[checkpoint]` JSON line: the
                gather (cold and warm), background write and restore ms
                beside the card's name and power limit (the supervised
                runs go on beside the engine part);
  8. times    — the flash kernels held against their plain versions
                once more on the training batch's own shapes and lengths
                (B=32, T=512, bf16), and causal at gpt_small's (B=16,
                T=512, every length 512; the `_causal` rows of the
                kernels line, with their launches from 7d); each kernel's device time (CUDA events around it, the
                host held ahead by a sleep kernel, cold L2, median), its
                plain version's, a library call's (on the gathered, and
                dequantized, window for the ragged kernels; the same
                boolean mask, forward or backward, for the flash ones),
                and the bound from bytes / operations; each decode and
                prefill case with its split plan; the port's whole flash
                backward as autograd runs it beside the library's whole
                backward, and the eager Δ (attn_delta) for the record.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989.4e12}

DEC = dict(S=8, H=12, D=64, ps=16, maxp=64,
           lengths=[0, 1, 17, 100, 255, 512, 777, 1024])
PRE = dict(C=64, H=12, D=64, ps=16, maxp=64,          # (start, n_real)
           cases=[(0, 64), (64, 64), (200, 37), (960, 64)])
VER = dict(S=8, W=5, H=12, D=64, ps=16, maxp=64,
           lengths=[0, 1, 17, 100, 255, 512, 777, 1019],
           draft_len=[0, 4, 1, 3, 4, 0, 2, 4])
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-2)}   # atol, rtol
QUANTS = ("int8", "fp8_e4m3")
RA = "incubator_mxnet_tpu/ops/ragged_attention.py"
REPLACES = {                 # the TPU kernel: function that reaches the
    "ragged_decode": f"{RA}:75",            # pallas_call (file:line)
    "ragged_decode_q": f"{RA}:199",
    "ragged_prefill": f"{RA}:348",
    "ragged_prefill_q": f"{RA}:471",
    "ragged_verify": f"{RA}:586",
    "ragged_verify_q": f"{RA}:734",
}
PA = "incubator_mxnet_tpu/ops/pallas_attention.py"
REPLACES.update({            # each flash kernel serves both Pallas arms
    "flash_fwd": f"{PA}:115 (_flash_kernel); {PA}:305 (_dense_fwd_kernel)",
    "flash_bwd_dq": f"{PA}:465 (_flash_bwd_dq_kernel); {PA}:334 "
                    f"(_dense_bwd_kernel, dq)",
    "flash_bwd_dkv": f"{PA}:501 (_flash_bwd_dkv_kernel); {PA}:334 "
                     f"(_dense_bwd_kernel, dk and dv)",
})
KERNELS = tuple(REPLACES)
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_CASES = [          # (B, H, Tq, Tk, D, lengths, causal)
    (4, 12, 512, 512, 64, [0, 1, 200, 512], False),
    (2, 12, 2048, 2048, 64, [2048, 1500], True),
    (2, 12, 2048, 2048, 64, [2048, 1500], False),
    (2, 12, 384, 512, 128, [512, 300], False),
    # the tensor-core bodies (bf16, D=64) at tile-straddling lengths
    (2, 12, 200, 200, 64, [200, 150], True),
    (2, 12, 96, 160, 64, [160, 33], False),
    # ... and below one 64-row tile (TMA boxes larger than the tensor)
    *[(3, 12, T, T, 64, [T, (T + 1) // 2, 0], causal)
      for T in (1, 16, 37) for causal in (False, True)],
    (3, 12, 40, 24, 64, [24, 9, 0], False),
    (3, 12, 24, 40, 64, [40, 23, 0], False),
]
# bf16 D=64 causal cases (the tensor-core bodies) whose tile count and
# B x H are awkward for the heaviest-first work order (flash_common.cuh
# `flash_unit`) and the forward's diagonal by warp: 9 tiles with an odd
# B x H, one tile and a row, a row short of 8 tiles, and 32 tiles
FLASH_CAUSAL_BF16 = [
    (3, 5, 576, 576, 64, [576, 300, 1], True),
    (1, 12, 65, 65, 64, [65], True),
    (2, 12, 511, 511, 64, [511, 64], True),
    (4, 12, 2048, 2048, 64, [2048] * 4, True),
]
# out and lse: |err| <= atol + rtol |plain|; gradients: |err| <= frac x
# the largest |plain gradient| of the same (batch, head) slice, that
# largest value taken as at least `floor` (a slice whose true gradient
# is ~0, e.g. length 1, holds only summation noise)
FLASH_TOL = {                # atol, rtol, frac, floor
    "float32": (2e-5, 2e-5, 2e-5, 1.0),
    "bfloat16": (1e-2, 1e-2, 2e-2, 1e-2),
}
# Δ = rowsum(dO ⊙ O) from the dq launch against attn_delta: |err| <=
# DELTA_ULPS x D x 2^-24 x sum |dO ⊙ O| (two f32 summations of D terms)
DELTA_ULPS = 2
BERT = dict(B=32, T=512, M=76, steps=10, warmup=3)
GPT = dict(B=16, T=512, steps=10, warmup=3)
NMT = dict(B=16, Ts=64, Tgen=48, K=4, reps=3)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------- #

def make_pools(torch, gen, P, H, ps, D, dtype, quant):
    """(k_pool, v_pool, k_scale, v_scale): raw pools of ``dtype``, or
    int8 / fp8_e4m3 code pools with per-page scales in [0.005, 0.025)."""
    shape, dev = (P, H, ps, D), "cuda"
    if quant is None:
        mk = lambda: torch.randn(shape, generator=gen, device=dev).to(dtype)
        return mk(), mk(), None, None
    if quant == "int8":
        mk = lambda: torch.randint(-127, 128, shape, generator=gen,
                                   device=dev).to(torch.int8)
    else:
        mk = lambda: (torch.randn(shape, generator=gen, device=dev) *
                      64).clamp(-448, 448).to(torch.float8_e4m3fn)
    sc = lambda: torch.rand(P, generator=gen, device=dev) * 0.02 + 0.005
    return mk(), mk(), sc(), sc()


def slot_table(torch, gen, n_map, P, maxp):
    """A page table mapping n_map[s] distinct shuffled pages per slot."""
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros(len(n_map), maxp, dtype=torch.int32, device="cuda")
    used = 0
    for s, n in enumerate(n_map):
        pt[s, :n] = perm[used:used + n].int()
        used += n
    return pt


def decode_case(torch, gen, dtype, quant=None, extra=0):
    """Decode inputs at DEC's lengths; ``extra`` maps pages for that many
    positions past each live slot's length (wholly masked pages)."""
    S, H, D, ps, maxp = (DEC[k] for k in ("S", "H", "D", "ps", "maxp"))
    n_map = [min(maxp, -(-(L + extra) // ps)) if L else 0
             for L in DEC["lengths"]]
    P = 1 + sum(n_map) + 3
    q = torch.randn(S, H, D, generator=gen, device="cuda").to(dtype)
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, dtype, quant)
    pt = slot_table(torch, gen, n_map, P, maxp)
    ln = torch.tensor(DEC["lengths"], dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln, ks, vs


def prefill_case(torch, gen, dtype, start, n_real, quant=None):
    """Prefill inputs and the chunk's span [start, n_real] on the card
    (what the kernel reads)."""
    C, H, D, ps, maxp = (PRE[k] for k in ("C", "H", "D", "ps", "maxp"))
    n_live = -(-(start + C) // ps)
    P = 1 + maxp + 3
    q = torch.randn(C, H, D, generator=gen, device="cuda").to(dtype)
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, dtype, quant)
    row = slot_table(torch, gen, [n_live], P, maxp)[0]
    span = torch.tensor([start, n_real], dtype=torch.int32, device="cuda")
    return q, kp, vp, row, ks, vs, span


def verify_case(torch, gen, dtype, quant=None):
    """Verify inputs: each live slot maps the pages of its whole window
    (length + W - 1 positions)."""
    S, W, H, D, ps, maxp = (VER[k] for k in ("S", "W", "H", "D", "ps",
                                             "maxp"))
    n_map = [-(-(L + W - 1) // ps) if L else 0 for L in VER["lengths"]]
    P = 1 + sum(n_map) + 3
    q = torch.randn(S, W, H, D, generator=gen, device="cuda").to(dtype)
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, dtype, quant)
    pt = slot_table(torch, gen, n_map, P, maxp)
    ln = torch.tensor(VER["lengths"], dtype=torch.int32, device="cuda")
    dl = torch.tensor(VER["draft_len"], dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln, dl, ks, vs


def consumed_rows(torch):
    """(S, W) mask of the verify rows a caller consumes (r <= draft_len);
    later rows are garbage by contract."""
    W = VER["W"]
    dl = torch.tensor(VER["draft_len"], device="cuda")
    return torch.arange(W, device="cuda")[None, :] <= dl[:, None]


# the verify tensor-core body's shapes: W, and (maxp, ps) capacities of
# 1024 and 2048 keys
VER_TC = dict(H=12, W=(1, 2, 5, 16, 17), caps=((64, 16), (128, 16)))


def verify_tc_case(torch, gen, W, maxp, ps, quant):
    """bf16 verify inputs at VER_TC's head count: lengths 0, 1, around a
    page and a split, deep and at the capacity; draft_len cycling through
    0 .. W - 1; each live slot maps its whole window (at most the row)."""
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    H, D, cap = VER_TC["H"], 64, maxp * ps
    split = ra.verify_plan(1, W, H, D, ps, maxp, True).split_keys
    lengths = [0, 1, ps - 1, ps, ps + 1, split - 1, split, split + 1,
               cap // 2 + 5, cap - W, cap]
    S = len(lengths)
    n_map = [min(maxp, -(-(L + W - 1) // ps)) if L else 0 for L in lengths]
    P = 1 + sum(n_map) + 2
    q = torch.randn(S, W, H, D, generator=gen, device="cuda").bfloat16()
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, torch.bfloat16,
                                quant)
    pt = slot_table(torch, gen, n_map, P, maxp)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    dl = torch.tensor([i % W for i in range(S)], dtype=torch.int32,
                      device="cuda")
    return q, kp, vp, pt, ln, dl, ks, vs


def poisoned(torch, pool, cells):
    """A copy of ``pool`` with each (page, position) of ``cells`` made
    non-finite (NaN; the e4m3 NaN code; -128 in an int8 pool, a code the
    writers never emit), written through a byte view."""
    out = pool.view(torch.uint8).clone().view(pool.dtype)
    for pg, pos in cells:
        if pool.dtype in (torch.float32, torch.bfloat16):
            out[pg, :, pos] = float("nan")
        else:
            out.view(torch.uint8)[pg, :, pos] = \
                0x7F if pool.dtype == torch.float8_e4m3fn else 0x80
    return out


def permutation(torch, gen, P, table):
    """A random relabelling of pages 1 .. P - 1 (the null page 0 stays)
    and the page table under it."""
    remap = torch.zeros(P, dtype=torch.long, device="cuda")
    remap[1:] = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    t = table.clone()
    live = table > 0
    t[live] = remap[table[live].long()].int()
    return remap, t


def moved(torch, x, remap):
    """Page p of ``x`` (a pool or a per-page scale) moved to remap[p]."""
    if x is None:
        return None
    b = x.view(torch.uint8).reshape(x.shape[0], -1)
    out = b.clone()
    out[remap[1:]] = b[1:]
    return out.view(x.dtype).reshape(x.shape)


def verify_contract(torch, ra, gen, dt, quant, sc, rows, nan_scale):
    """The verify contract at VER's shapes on one body and pool."""
    q, kp, vp, pt, ln, dl, ks, vs = verify_case(torch, gen, dt, quant)
    ps, S = VER["ps"], VER["S"]
    tag = f"verify {str(dt).removeprefix('torch.')} {quant or 'raw'}"
    run = lambda kp_, vp_, pt_=pt, ln_=ln, ks_=ks, vs_=vs: \
        ra._ragged_verify_cuda(q, kp_, vp_, pt_, ln_, dl, sc, ks_, vs_)
    clean = run(kp, vp)
    check(bool(torch.equal(clean, run(kp, vp))),
          f"{tag}: two launches differ")
    past = [(int(pt[s, pos // ps]), pos % ps)
            for s, (L, d) in enumerate(zip(VER["lengths"], VER["draft_len"]))
            if L for pos in range(L + d, int((pt[s] > 0).sum()) * ps)]
    past += [(0, pos) for pos in range(ps)]               # the null page
    got = run(poisoned(torch, kp, past), poisoned(torch, vp, past))
    check(bool(torch.isfinite(got[rows].float()).all()) and
          bool(torch.equal(got, clean)),
          f"{tag}: NaN past length + draft_len reached the output")
    others = [i for i in range(S) if i != 5]
    if quant != "int8":                   # an int8 code cannot be NaN
        got = run(kp, poisoned(torch, vp, [(int(pt[5, 0]), 0)]))
        check(bool(torch.isnan(got[5][rows[5]].float()).all()),
              f"{tag}: NaN inside the length did not propagate")
        check(bool(torch.equal(got[others], clean[others])),
              f"{tag}: NaN in one slot changed another")
    z = run(kp, vp, ln_=torch.zeros_like(ln))
    check(bool((z == 0).all()), f"{tag}: length-0 slots not exactly zero")
    remap, perm_pt = permutation(torch, gen, kp.shape[0], pt)
    got = run(moved(torch, kp, remap), moved(torch, vp, remap), perm_pt,
              ks_=moved(torch, ks, remap), vs_=moved(torch, vs, remap))
    check(bool(torch.equal(got, clean)),
          f"{tag}: page permutation changed the output")
    if quant is None:
        return
    s5 = VER["lengths"].index(512)        # slot 5: length 512, no draft
    masked = int(pt[s5, 512 // ps])       # a mapped page wholly past it
    got = run(kp, vp, ks_=nan_scale(nan_scale(ks, 0), masked),
              vs_=nan_scale(nan_scale(vs, 0), masked))
    check(bool(torch.equal(got, clean)),
          f"{tag}: NaN scale on a masked page leaked")
    others = [i for i in range(S) if i != 3]
    for bad_k in (True, False):
        got = run(kp, vp,
                  ks_=nan_scale(ks, int(pt[3, 0])) if bad_k else ks,
                  vs_=vs if bad_k else nan_scale(vs, int(pt[3, 0])))
        check(bool(torch.isnan(got[3][rows[3]].float()).all()) and
              bool(torch.equal(got[others], clean[others])),
              f"{tag}: NaN {'k' if bad_k else 'v'} scale on a live page "
              f"did not stay in its slot")


# the decode tensor-core body's shapes: (maxp, ps) capacities of 1, 4 and
# 64 pages, and lengths around a page and a 64-key tile
DEC_TC = dict(H=12, caps=((1, 16), (4, 16), (64, 16)),
              lengths=(0, 1, 15, 16, 17, 63, 64, 65))


def decode_tc_case(torch, gen, maxp, ps, quant):
    """bf16 decode inputs at DEC_TC's head count: its lengths (at most the
    capacity) and the capacity itself, each live slot mapping its pages."""
    H, D, cap = DEC_TC["H"], 64, maxp * ps
    lengths = [min(L, cap) for L in DEC_TC["lengths"]] + [cap]
    n_map = [-(-L // ps) for L in lengths]
    P = 1 + sum(n_map) + 2
    q = torch.randn(len(lengths), H, D, generator=gen,
                    device="cuda").bfloat16()
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, torch.bfloat16,
                                quant)
    pt = slot_table(torch, gen, n_map, P, maxp)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln, ks, vs


def decode_contract(torch, ra, gen, dt, quant, sc, nan_scale):
    """The decode contract at DEC's shapes on one body and pool, each live
    slot mapping one page past its length (a wholly masked page)."""
    ps, S = DEC["ps"], DEC["S"]
    q, kp, vp, pt, ln, ks, vs = decode_case(torch, gen, dt, quant, extra=ps)
    tag = f"decode {str(dt).removeprefix('torch.')} {quant or 'raw'}"
    run = lambda kp_, vp_, pt_=pt, ln_=ln, ks_=ks, vs_=vs: \
        ra._ragged_decode_cuda(q, kp_, vp_, pt_, ln_, sc, ks_, vs_)
    clean = run(kp, vp)
    check(bool(torch.equal(clean, run(kp, vp))),
          f"{tag}: two launches differ")
    past = [(int(pt[s, pos // ps]), pos % ps)
            for s, L in enumerate(DEC["lengths"])
            if L for pos in range(L, int((pt[s] > 0).sum()) * ps)]
    past += [(0, pos) for pos in range(ps)]               # the null page
    got = run(poisoned(torch, kp, past), poisoned(torch, vp, past))
    check(bool(torch.isfinite(got.float()).all()) and
          bool(torch.equal(got, clean)),
          f"{tag}: NaN past the length (or in the null page) leaked")
    others = [i for i in range(S) if i != 5]
    if quant != "int8":                   # an int8 code cannot be NaN
        got = run(kp, poisoned(torch, vp, [(int(pt[5, 0]), 0)]))
        check(bool(torch.isnan(got[5].float()).all()),
              f"{tag}: NaN inside the length did not propagate")
        check(bool(torch.equal(got[others], clean[others])),
              f"{tag}: NaN in one slot changed another")
    z = run(kp, vp, ln_=torch.zeros_like(ln))
    check(bool((z == 0).all()), f"{tag}: length-0 slots not exactly zero")
    remap, perm_pt = permutation(torch, gen, kp.shape[0], pt)
    got = run(moved(torch, kp, remap), moved(torch, vp, remap), perm_pt,
              ks_=moved(torch, ks, remap), vs_=moved(torch, vs, remap))
    check(bool(torch.equal(got, clean)),
          f"{tag}: page permutation changed the output")
    if quant is None:
        return
    s5 = DEC["lengths"].index(512)        # slot 5: its page 32 is wholly
    masked = int(pt[s5, 512 // ps])       # past its length
    got = run(kp, vp, ks_=nan_scale(nan_scale(ks, 0), masked),
              vs_=nan_scale(nan_scale(vs, 0), masked))
    check(bool(torch.equal(got, clean)),
          f"{tag}: NaN scale on a masked page leaked")
    others = [i for i in range(S) if i != 3]
    for bad_k in (True, False):
        got = run(kp, vp,
                  ks_=nan_scale(ks, int(pt[3, 0])) if bad_k else ks,
                  vs_=vs if bad_k else nan_scale(vs, int(pt[3, 0])))
        check(bool(torch.isnan(got[3].float()).all()) and
              bool(torch.equal(got[others], clean[others])),
              f"{tag}: NaN {'k' if bad_k else 'v'} scale on a live page "
              f"did not stay in its slot")


def decode_one_kernel(torch, ra, gen, sc, n=4):
    """torch.profiler over ``n`` bf16 decode calls on each pool at DEC's
    shapes: one device kernel a call, the tensor-core body (no combine
    launch, no scratch fill). The tracer can miss kernels at the start of
    a process's first sessions, so a throwaway session runs first, and a
    session that recorded fewer than ``n`` kernels is taken again (at
    most 3 times): a call launches at least one kernel or raises, so
    fewer than ``n`` is a lost record, while more fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(fn):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            if len(names) >= n:
                break
        return names

    one = torch.zeros(1, device="cuda")
    kernels(lambda: one.add_(1))
    for quant in (None,) + QUANTS:
        q, kp, vp, pt, ln, ks, vs = decode_case(torch, gen, torch.bfloat16,
                                                quant)
        fn = lambda: ra._ragged_decode_cuda(q, kp, vp, pt, ln, sc, ks, vs)
        fn()
        torch.cuda.synchronize()
        names = kernels(fn)
        print(f"[kernels] {n} bf16 decode calls, pools {quant or 'raw'}: "
              f"{len(names)} device kernel(s) "
              f"{sorted({x[:40] for x in names})}", flush=True)
        check(len(names) == n and all("decode_mma" in x for x in names),
              f"{n} bf16 decode calls ran {len(names)} device kernels "
              f"({sorted(set(names))}), not one tensor-core launch each")


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_bytes_flops(lengths, H, D, kv_elem, q_elem, ps, quant):
    live = sum(lengths)
    S = len(lengths)
    nbytes = 2 * live * H * D * kv_elem + 2 * S * H * D * q_elem + \
        S * DEC["maxp"] * 4 + S * 4
    if quant:                            # one K and one V scale per page
        nbytes += 2 * 4 * sum(-(-L // ps) for L in lengths)
    return nbytes, 4 * live * H * D


def prefill_bytes_flops(start, n_real, C, H, D, kv_elem, q_elem, ps,
                        quant):
    keys = start + n_real
    nbytes = 2 * keys * H * D * kv_elem + 2 * C * H * D * q_elem + \
        PRE["maxp"] * 4
    if quant:
        nbytes += 2 * 4 * -(-keys // ps)
    flops = sum(4 * (start + i + 1) * D * H for i in range(n_real))
    return nbytes, flops


def verify_bytes_flops(H, D, kv_elem, q_elem, ps, quant):
    """Live K/V = the keys the consumed rows see (length + draft_len per
    slot); operations of the consumed rows only."""
    S, W = VER["S"], VER["W"]
    keys = [L + d if L else 0
            for L, d in zip(VER["lengths"], VER["draft_len"])]
    nbytes = 2 * sum(keys) * H * D * kv_elem + 2 * S * W * H * D * q_elem + \
        S * VER["maxp"] * 4 + 2 * S * 4
    if quant:
        nbytes += 2 * 4 * sum(-(-k // ps) for k in keys)
    flops = sum(4 * (L + r) * H * D
                for L, d in zip(VER["lengths"], VER["draft_len"]) if L
                for r in range(d + 1))
    return nbytes, flops


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #

def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(line, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from incubator_mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    for name, (t, log) in built.items():
        info = sorted({ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln})
        print(f"[build] {name}: {t:.1f} s  " + " | ".join(info[:6]),
              flush=True)
    print(f"[build] all kernels in {secs:.1f} s "
          f"({_build.build_dir()})", flush=True)
    spills = {}
    for name in ("ragged_decode", "ragged_prefill", "ragged_verify",
                 "flash_fwd", "flash_bwd"):
        log = _build.build_dir() / f"{name}.log"
        if log.is_file():
            for fn, regs, spill in ptxas_entries(log.read_text()):
                print(f"[build] {name} {fn}: {regs}; {spill}", flush=True)
                spills[fn] = spill
        sass_counts(_build.build_dir() / f"lib{name}.so")
    for fn, spill in spills.items():
        if "flash_fwd_tma" in fn:
            check(re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                            spill) is not None,
                  f"{fn} spills registers ({spill})")


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        got = out.stdout.splitlines()
        if out.returncode == 0 and len(got) == len(names):
            return [g.split("(")[0] for g in got]
    except (OSError, subprocess.SubprocessError):
        pass
    return list(names)


def ptxas_entries(log):
    """(kernel, 'Used ... registers, ... smem', 'spill stores / loads')
    for every entry function of one nvcc -Xptxas -v log."""
    rows, fn, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn, spill = m.group(1), ""
        elif fn and "spill" in ln:
            spill = ln.strip()
        elif fn and "Used" in ln and "registers" in ln:
            rows.append((fn, ln.split(":", 1)[-1].strip(), spill))
            fn = None
    names = _demangle([r[0] for r in rows])
    return [(n, r[1], r[2]) for n, r in zip(names, rows)]


# the tensor-core bodies each kernel library must hold (SASS checks)
TC_BODIES = {"ragged_decode": ("decode_mma",),
             "ragged_prefill": ("prefill_mma",),
             "ragged_verify": ("verify_mma",),
             "flash_fwd": ("flash_fwd_tma",),
             "flash_bwd": ("flash_bwd_dq_tma", "flash_bwd_dkv_tma")}


def sass_counts(lib):
    """Tensor-core (HMMA), ldmatrix (LDSM), cp.async (LDGSTS), TMA load
    (UTMALDG) and 2-byte shared-store (STS.U16) instructions in each
    ragged and flash kernel's SASS, from cuobjdump. The ragged
    tensor-core bodies (decode_mma, prefill_mma, verify_mma) must issue
    HMMA, LDSM and LDGSTS; each flash TMA body (forward, dq, dk/dv) HMMA,
    LDSM and UTMALDG, and no STS.U16 (no transposed copy, stored 2 bytes
    at a time)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        print("[build] cuobjdump not found: SASS not inspected", flush=True)
        return
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            funcs[cur] = {"HMMA": 0, "LDSM": 0, "LDGSTS": 0, "UTMALDG": 0,
                          "STS.U16": 0}
        elif cur:
            for op in funcs[cur]:
                if re.search(rf"\b{re.escape(op)}\b", ln):
                    funcs[cur][op] += 1
    lib_name = re.sub(r"^lib|\.so$", "", os.path.basename(str(lib)))
    seen = set()
    for name, c in zip(_demangle(list(funcs)), funcs.values()):
        print(f"[build] sass {name}: " + ", ".join(
            f"{op} x{n}" for op, n in c.items()), flush=True)
        for body in TC_BODIES.get(lib_name, ()):
            if body not in name:
                continue
            seen.add(body)
            check(c["HMMA"] > 0 and c["LDSM"] > 0,
                  f"{name}: a tensor-core body must issue HMMA and LDSM "
                  f"({c})")
            if body.startswith("flash"):
                check(c["UTMALDG"] > 0, f"{name}: no TMA load ({c})")
                check(c["STS.U16"] == 0, f"{name} stores 2-byte elements "
                                         f"to shared memory (a transposed "
                                         f"copy)")
            else:
                check(c["LDGSTS"] > 0, f"{name}: no cp.async ({c})")
    for body in TC_BODIES.get(lib_name, ()):
        check(body in seen, f"no {body} kernel in the SASS of {lib}")


def phase_kernels(torch):
    """Kernel vs plain version on identical inputs; returns the largest
    |difference| per kernel over every compared case."""
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = {k: 0.0 for k in KERNELS if k not in FLASH}
    rows = consumed_rows(torch)
    nan = float("nan")

    def cmp(name, got, ref, dtype_name, keep=None, what=""):
        torch.cuda.synchronize()
        g, r = got.float(), ref.float()
        if keep is not None:
            g, r = g[keep], r[keep]
        atol, rtol = TOL[dtype_name]
        d = (g - r).abs()
        ok = bool(torch.isfinite(g).all()) and \
            bool((d <= atol + rtol * r.abs()).all())
        e = float(d.max())
        err[name] = max(err[name], e)
        print(f"[kernels] {name} {dtype_name} {what}: max|err| {e:.3e} "
              f"(atol {atol}, rtol {rtol})", flush=True)
        check(ok, f"{name} {dtype_name} {what} disagrees with its plain "
                  f"version (max |err| {e:.3e})")

    sc = DEC["D"] ** -0.5
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        for quant in (None,) + QUANTS:
            sfx = "_q" if quant else ""
            tag = quant or "raw"
            q, kp, vp, pt, ln, ks, vs = decode_case(torch, gen, dt, quant)
            got = ra._ragged_decode_cuda(q, kp, vp, pt, ln, sc, ks, vs)
            ref = ra.ragged_attention_reference(q, kp, vp, pt, ln, sc, ks,
                                                vs)
            cmp("ragged_decode" + sfx, got, ref, dt_name,
                what=f"{tag} mixed lengths")
            check(bool((got[0] == 0).all()), "decode: length-0 slot not "
                                             "zero")
            for start, n_real in PRE["cases"]:
                q, kp, vp, row, ks, vs, span = prefill_case(
                    torch, gen, dt, start, n_real, quant)
                got = ra._ragged_prefill_cuda(q, kp, vp, row, span, sc, ks,
                                              vs)
                ref = ra.ragged_prefill_reference(q, kp, vp, row, start, sc,
                                                  n_real, ks, vs)
                cmp("ragged_prefill" + sfx, got, ref, dt_name,
                    keep=slice(0, n_real),
                    what=f"{tag} device span start={start} "
                         f"n_real={n_real}")
                check(bool((got[n_real:] == 0).all()),
                      "prefill: rows past n_real not zero")
            q, kp, vp, pt, ln, dl, ks, vs = verify_case(torch, gen, dt,
                                                        quant)
            got = ra._ragged_verify_cuda(q, kp, vp, pt, ln, dl, sc, ks, vs)
            ref = ra.ragged_verify_reference(q, kp, vp, pt, ln, sc, ks, vs)
            cmp("ragged_verify" + sfx, got, ref, dt_name, keep=rows,
                what=f"{tag} W={VER['W']} mixed lengths/drafts")
            check(bool((got[0] == 0).all()), "verify: length-0 slot not "
                                             "zero")

    # a NaN page scale: on a masked page it must not leak, on a live page
    # it must propagate to the slots that read it
    def nan_scale(scale, page):
        bad = scale.clone()
        bad[page] = nan
        return bad

    # decode on both bodies (f32: CUDA cores; bf16 at D=64: tensor cores)
    # and every pool: NaN past the length and in the null page, NaN inside,
    # length 0, page permutation, two launches bitwise equal; on code pools
    # a NaN page scale on a masked and on a live page
    f32 = torch.float32
    ps = DEC["ps"]
    for dt in (f32, torch.bfloat16):
        for quant in (None,) + QUANTS:
            decode_contract(torch, ra, gen, dt, quant, sc, nan_scale)
    # the tensor-core body at lengths around a page and a tile, and at the
    # capacity, for capacities of 1, 4 and 64 pages
    for maxp, ps_ in DEC_TC["caps"]:
        for quant in (None,) + QUANTS:
            q, kp, vp, pt, ln, ks, vs = decode_tc_case(torch, gen, maxp, ps_,
                                                       quant)
            got = ra._ragged_decode_cuda(q, kp, vp, pt, ln, sc, ks, vs)
            ref = ra.ragged_attention_reference(q, kp, vp, pt, ln, sc, ks,
                                                vs)
            cmp("ragged_decode" + ("_q" if quant else ""), got, ref,
                "bfloat16", what=f"{quant or 'raw'} tensor cores capacity "
                                 f"{maxp * ps_} lengths {ln.tolist()}")
            check(bool((got[ln == 0] == 0).all()),
                  "decode: length-0 slot not exactly zero")
    decode_one_kernel(torch, ra, gen, sc)

    # prefill: a partial chunk's unwritten tail holding NaN, and the null
    # page, on both bodies (f32: CUDA cores; bf16 at D=64: tensor cores);
    # two launches bitwise equal
    start, n_real = PRE["cases"][2]
    for dt in (f32, torch.bfloat16):
        q, kp, vp, row, _, _, span = prefill_case(torch, gen, dt, start,
                                                  n_real)
        clean = ra._ragged_prefill_cuda(q, kp, vp, row, span, sc)
        end = start + n_real
        kp2, vp2 = kp.clone(), vp.clone()
        for pos in range(end, start + PRE["C"]):
            pg = int(row[pos // ps])
            kp2[pg, :, pos % ps] = nan
            vp2[pg, :, pos % ps] = nan
        kp2[0], vp2[0] = nan, nan
        got = ra._ragged_prefill_cuda(q, kp2, vp2, row, span, sc)
        check(bool(torch.isfinite(got[:n_real]).all()) and
              bool(torch.equal(got[:n_real], clean[:n_real])),
              f"prefill {dt}: unwritten-tail NaN poisoned live rows")
        check(bool(torch.equal(clean, ra._ragged_prefill_cuda(
            q, kp, vp, row, span, sc))),
            f"prefill {dt}: two launches differ")
        vp3 = vp.clone()
        vp3[int(row[0]), :, 0] = nan                  # seen by every row
        got = ra._ragged_prefill_cuda(q, kp, vp3, row, span, sc)
        check(bool(torch.isnan(got[:n_real].float()).all()),
              f"prefill {dt}: NaN inside the live keys did not propagate")

    start, n_real = PRE["cases"][2]           # live keys end at 237
    for dt in (f32, torch.bfloat16):
        for quant in QUANTS:
            q, kp, vp, row, ks, vs, span = prefill_case(torch, gen, dt,
                                                        start, n_real, quant)
            clean = ra._ragged_prefill_cuda(q, kp, vp, row, span, sc, ks, vs)
            masked = int(row[(start + n_real) // ps + 1])   # past 237
            got = ra._ragged_prefill_cuda(q, kp, vp, row, span, sc,
                                          nan_scale(nan_scale(ks, 0), masked),
                                          nan_scale(nan_scale(vs, 0), masked))
            check(bool(torch.equal(got[:n_real], clean[:n_real])),
                  f"prefill_q {dt} {quant}: NaN scale on a masked page "
                  f"leaked")
            for bad_k in (True, False):
                live = int(row[0])
                got = ra._ragged_prefill_cuda(
                    q, kp, vp, row, span, sc,
                    nan_scale(ks, live) if bad_k else ks,
                    vs if bad_k else nan_scale(vs, live))
                check(bool(torch.isnan(got[:n_real].float()).all()),
                      f"prefill_q {dt} {quant}: NaN "
                      f"{'k' if bad_k else 'v'} scale on a live page did "
                      f"not propagate")

    # verify on both bodies (f32: CUDA cores; bf16 at D=64: tensor cores)
    # and every pool: NaN past length + draft_len and in the null page, NaN
    # inside, length 0, page permutation, two launches bitwise equal; on
    # code pools a NaN page scale on a masked and on a live page
    for dt in (f32, torch.bfloat16):
        for quant in (None,) + QUANTS:
            verify_contract(torch, ra, gen, dt, quant, sc, rows, nan_scale)
    # the tensor-core body across its shapes: W = 1 .. 17, capacities of
    # 1024 and 2048 keys (16 splits of 64 or of 128)
    for maxp, ps_ in VER_TC["caps"]:
        for W in VER_TC["W"]:
            for quant in (None,) + QUANTS:
                q, kp, vp, pt, ln, dl, ks, vs = verify_tc_case(
                    torch, gen, W, maxp, ps_, quant)
                got = ra._ragged_verify_cuda(q, kp, vp, pt, ln, dl, sc, ks,
                                             vs)
                ref = ra.ragged_verify_reference(q, kp, vp, pt, ln, sc, ks,
                                                 vs)
                keep = torch.arange(W, device="cuda")[None, :] <= \
                    dl.long()[:, None]
                cmp("ragged_verify" + ("_q" if quant else ""), got, ref,
                    "bfloat16", keep=keep,
                    what=f"{quant or 'raw'} tensor cores W={W} capacity "
                         f"{maxp * ps_} (ps={ps_})")
                check(bool((got[~keep] == 0).all()),
                      f"verify W={W}: rows past draft_len not zero")
    torch.cuda.synchronize()
    print("[kernels] contract cases: NaN past length / start + n_real / "
          "length + draft_len, NaN inside, length 0, page permutation, "
          "NaN scale on a masked and on a live page, bitwise reruns "
          "(verify: both bodies, every pool): ok", flush=True)
    return err


def _time_ms(torch, fn, flush, iters=30):
    """Median device time of ``fn`` (ms) with a cold L2. A sleep kernel
    holds the stream while the host enqueues the events and ``fn``, so
    the events bracket device work, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()                    # cold L2, as a real step sees
        torch.cuda._sleep(2_000_000)     # ~1 ms: the host runs ahead
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_times(torch):
    """Times at the serving path's shapes and dtype (bf16 queries; int8
    code pools for the _q kernels, fp8_e4m3 printed beside them)."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    dt, dt_name = torch.bfloat16, "bfloat16"
    H, D, ps, maxp = DEC["H"], DEC["D"], DEC["ps"], DEC["maxp"]
    sc = D ** -0.5
    K = maxp * ps
    ar = torch.arange(K, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}

    def window(pool, table, scale):
        return ra._gather_window(pool, table, scale).to(dt)

    def record(name, shape, ms, plain_ms, library_ms, nbytes, flops):
        bms, by = bound(nbytes, flops, dt_name)
        r = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bms, bound_by=by, shape=shape)
        print(f"[times] {name} {shape}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"library {library_ms:.4f}, bound {bms:.5f} by {by})",
              flush=True)
        return r

    for quant in (None,) + QUANTS:
        sfx, kv_elem = ("_q", 1) if quant else ("", 2)
        tag = quant or "bf16"
        q, kp, vp, pt, ln, ks, vs = decode_case(torch, gen, dt, quant)
        kw, vw = window(kp, pt, ks), window(vp, pt, vs)
        mask = (ar[None, :] < ln.long()[:, None])[:, None, None, :]
        plan = ra.decode_plan(DEC["S"], H, D, ps, maxp, True, sms)
        r = record(
            "ragged_decode" + sfx,
            f"S={DEC['S']} H={H} D={D} ps={ps} maxp={maxp} "
            f"lengths={DEC['lengths']} q bf16, pools {tag}; plan "
            f"{plan.nsplit} x {plan.split_keys} keys, {plan.blocks} blocks",
            _time_ms(torch, lambda: ra._ragged_decode_cuda(
                q, kp, vp, pt, ln, sc, ks, vs), flush),
            _time_ms(torch, lambda: ra.ragged_attention_reference(
                q, kp, vp, pt, ln, sc, ks, vs), flush),
            _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kw, vw, attn_mask=mask), flush),
            *decode_bytes_flops(DEC["lengths"], H, D, kv_elem, 2, ps,
                                quant))
        out.setdefault("ragged_decode" + sfx, r)

        C = PRE["C"]
        rows = []
        for start, n_real in PRE["cases"]:
            q, kp, vp, row, ks, vs, span = prefill_case(torch, gen, dt,
                                                        start, n_real, quant)
            kw = window(kp, row[None], ks)[0]            # (H, K, D)
            vw = window(vp, row[None], vs)[0]
            pos_q = start + torch.arange(C, device="cuda")[:, None]
            mask = ar[None, :] <= pos_q
            plan = ra.prefill_plan(C, H, D, ps, row.shape[0], True, sms)
            rows.append(record(
                "ragged_prefill" + sfx,
                f"C={C} H={H} D={D} ps={ps} start={start} n_real={n_real} "
                f"(device span) q bf16, pools {tag}; plan {plan.nsplit} x "
                f"{plan.split_keys} keys, {plan.blocks} blocks, scratch "
                f"{4 * plan.scratch_floats} B",
                _time_ms(torch, lambda: ra._ragged_prefill_cuda(
                    q, kp, vp, row, span, sc, ks, vs), flush),
                _time_ms(torch, lambda: ra.ragged_prefill_reference(
                    q, kp, vp, row, span, sc, None, ks, vs), flush),
                _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q.transpose(0, 1)[None], kw[None], vw[None],
                    attn_mask=mask), flush),
                *prefill_bytes_flops(start, n_real, C, H, D, kv_elem, 2, ps,
                                     quant)))
        out.setdefault("ragged_prefill" + sfx, rows[-1])  # deepest chunk
        for (start, _), r in ((PRE["cases"][0], rows[0]),
                              (PRE["cases"][-1], rows[-1])):
            print(f"[times] ragged_prefill{sfx} {tag} at start {start}: "
                  f"kernel {r['ms']:.4f} ms vs library "
                  f"{r['library_ms']:.4f} ms "
                  f"({r['library_ms'] / r['ms']:.2f}x)", flush=True)

        q, kp, vp, pt, ln, dl, ks, vs = verify_case(torch, gen, dt, quant)
        kw, vw = window(kp, pt, ks), window(vp, pt, vs)
        W = VER["W"]
        see = ln.long()[:, None] + torch.arange(W, device="cuda")[None, :]
        mask = (ar[None, None, :] < see[:, :, None])[:, None]   # S,1,W,K
        r = record(
            "ragged_verify" + sfx,
            f"S={VER['S']} W={W} H={H} D={D} ps={ps} maxp={maxp} "
            f"lengths={VER['lengths']} draft_len={VER['draft_len']} "
            f"q bf16, pools {tag}",
            _time_ms(torch, lambda: ra._ragged_verify_cuda(
                q, kp, vp, pt, ln, dl, sc, ks, vs), flush),
            _time_ms(torch, lambda: ra.ragged_verify_reference(
                q, kp, vp, pt, ln, sc, ks, vs), flush),
            _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kw, vw, attn_mask=mask), flush),
            *verify_bytes_flops(H, D, kv_elem, 2, ps, quant))
        out.setdefault("ragged_verify" + sfx, r)
    del flush
    return out


def _prompts(np, rng, vocab):
    """16 prompts of 64-768 tokens; 8 share a 512-token prefix. One
    shared-prefix request leads the first wave so the second wave's
    shared requests find the prefix cached."""
    prefix = rng.randint(0, vocab, size=512).astype(np.int32)
    shared = [np.concatenate([prefix, rng.randint(
        0, vocab, size=int(n)).astype(np.int32)])
        for n in rng.randint(16, 257, size=8)]
    other = [rng.randint(0, vocab, size=int(n)).astype(np.int32)
             for n in rng.randint(64, 769, size=8)]
    return [shared[0]] + other[:7] + shared[1:] + other[7:]


def replay_drafter(np, streams):
    """A drafter that proposes what an earlier run emitted after the same
    history (its prompt plus the tokens so far), and nothing once the
    history has left that run's stream: a controlled, high accept rate
    for the greedy requests (the ceiling of speculation's gain)."""
    table = [(np.asarray(p, np.int32), np.asarray(t, np.int32))
             for p, t in streams]

    def draft(history, k):
        h = np.asarray(history, np.int32)
        for prompt, toks in table:
            t0 = prompt.size
            e = h.size - t0
            if 0 <= e < toks.size and np.array_equal(h[:t0], prompt) and \
                    np.array_equal(h[t0:], toks[:e]):
                return toks[e:e + k]
        return np.zeros((0,), np.int32)

    return draft


def serve_run(torch, np, model, label, spec_k=0, kv_quant=None,
              n_req=16, profile=False, draft_fn=None, need_accept=True,
              decode_bound=False):
    """One serving run on a fresh engine; returns its stats with the
    launch counts read around it, and the requests' (prompt, tokens)
    streams. The phase-4 workload (``_prompts``: long prompts, mixed
    greedy / temperature), or with ``decode_bound`` 8 greedy requests of
    32 prompt and 96 new tokens, where the run is all decode steps."""
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import (InferenceEngine, Outcome,
                                                 Request)
    from incubator_mxnet_tpu_torch.events import EventType

    eng = InferenceEngine(model, num_slots=8, page_size=16, max_len=1024,
                          chunk_pages=4, prefix_cache=True, spec_k=spec_k,
                          kv_quant=kv_quant, draft_fn=draft_fn)
    rng = np.random.RandomState(0)
    # warm-up: one short request (cuBLAS handles, allocator)
    eng.run([Request(rng.randint(0, model.vocab_size, size=40),
                     max_new_tokens=4)])
    check(eng.health[Outcome.MAX_TOKENS.value] == 1, "warm-up failed")
    if decode_bound:
        reqs = [Request(rng.randint(0, model.vocab_size, size=32),
                        max_new_tokens=96) for _ in range(8)]
    else:
        prompts = _prompts(np, rng, model.vocab_size)[:n_req]
        reqs = [Request(p, max_new_tokens=64, eos_id=50256,
                        temperature=0.0 if i % 2 == 0 else 0.8,
                        seed=100 + i)
                for i, p in enumerate(prompts)]
    steps0, spec0, hits0 = eng.decode_steps, eng.spec_steps, eng.prefix_hits
    drafted0, accepted0 = eng.drafted_tokens, eng.accepted_tokens
    n_ev0 = len(eng.flight.events(etype=EventType.DECODE_STEP))
    replays0 = chunk_replays(eng)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    steps = eng.decode_steps - steps0
    spec_steps = eng.spec_steps - spec0
    drafted = eng.drafted_tokens - drafted0
    accepted = eng.accepted_tokens - accepted0

    bad = [(r.request_id, r.outcome, r.detail) for r in reqs
           if r.outcome not in (Outcome.EOS, Outcome.MAX_TOKENS)]
    check(not bad, f"{label}: requests ended badly: {bad}")
    eng.audit_pages()
    check(eng.prefix_hits > hits0 or n_req < 9 or decode_bound,
          f"{label}: no prefix-cache hit")
    chunks = chunk_replays(eng) - replays0
    check_ragged_launches(eng, launches, label, steps, chunks, spec_steps)
    check(chunks > 0, f"{label}: prefill kernel never launched")
    if spec_k:
        check(drafted > 0 and (accepted > 0 or not need_accept),
              f"{label}: drafted {drafted}, accepted {accepted}")
    for r in reqs:
        check(all(0 <= t < model.vocab_size for t in r.token_ids),
              f"{label}: token out of vocab")
    check_captures(eng, label)
    n_tok = sum(len(r.token_ids) for r in reqs)
    ttft = [r.token_stamps[0] - r.submit_time for r in reqs]
    ev = eng.flight.events(etype=EventType.DECODE_STEP)[n_ev0:]
    slot_steps = sum(e.data["live"] for e in ev)
    stats = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                 tokens_per_s=n_tok / wall,
                 ttft_p50_ms=statistics.median(ttft) * 1e3,
                 decode_ms_per_step=statistics.median(
                     e.data["dur_s"] for e in ev) * 1e3,
                 decode_steps=steps, spec_steps=spec_steps,
                 drafted=drafted, accepted=accepted,
                 accept_rate=accepted / drafted if drafted else 0.0,
                 tokens_per_step=(n_tok - len(reqs)) / steps,
                 tokens_per_slot_step=(n_tok - len(reqs)) / slot_steps,
                 prefix_hits=eng.prefix_hits - hits0,
                 kv_pool_bytes=eng.health_snapshot()["kv_pool_bytes"],
                 launches={k: v for k, v in launches.items() if v})
    print(f"[serving] {label}: {json.dumps(stats)}", flush=True)
    if profile:
        profile_decode(torch, np, eng, rng, Request, label)
        if not spec_k:
            profile_prefill(torch, eng, rng, Request, label)
    if not spec_k and not decode_bound:
        host_costs(torch, np, eng, Request)
        chunk_host_costs(torch, np, eng, Request)
    del eng
    torch.cuda.empty_cache()
    return stats, [(r.prompt_ids, r.token_ids) for r in reqs]


def chunk_replays(eng):
    """Replays of the engine's prefill chunk programs so far."""
    return sum(p.replays for (kind, _), p in eng._prefill_programs.items()
               if kind == "chunk")


def check_captures(eng, label):
    """One step program per width that ran (warm-up included) and one
    prefill program per (kind, bucket), each captured once, and at most
    one COW copy program; prints the counts and each capture's ms."""
    counts = captures_once(eng, label)
    progs = [(f"W={w}", p) for w, p in sorted(eng._programs.items())]
    progs += [(f"{k} {t}", p) for (k, t), p in
              sorted(eng._prefill_programs.items())]
    if eng._copy_prog is not None:
        progs.append(("copy", eng._copy_prog))
    print(f"[capture] {label}: decode_trace_count "
          f"{eng.decode_trace_count}, verify_trace_count "
          f"{eng.verify_trace_count}, prefill_trace_count "
          f"{eng.prefill_trace_count}, prefill_trace_counts "
          f"{ {f'{k} {t}': n for (k, t), n in sorted(counts.items())} }, "
          f"copy_trace_count {eng.copy_trace_count}; capture ms: " +
          ", ".join(f"{name} {p.build_ms:.1f}" for name, p in progs),
          flush=True)


def captures_once(eng, label):
    """The checks of ``check_captures``, without the print; returns the
    prefill program counts."""
    for what, ran, built in (
            ("decode", eng.decode_steps > eng.spec_steps,
             eng.decode_trace_count),
            ("verify", eng.spec_steps > 0, eng.verify_trace_count)):
        check(built == int(ran), f"{label}: {what} program built {built} "
                                 f"times (steps ran: {ran})")
    counts = eng.prefill_trace_counts
    check(set(counts.values()) == {1} and
          eng.prefill_trace_count == len(counts) ==
          len(eng._prefill_programs),
          f"{label}: prefill programs built {eng.prefill_trace_count} "
          f"times for {counts}")
    check(eng.copy_trace_count == int(eng._copy_prog is not None),
          f"{label}: COW copy program built {eng.copy_trace_count} times")
    return counts


def serve_monolithic(torch, np, model, label, kv_quant=None):
    """A short monolithic run (chunk_pages=None): 6 prompts of 40-700
    tokens prefilled whole by the dense program of their page bucket
    (4-64 pages), and a 7th repeating the first 250 tokens of the
    300-token one, admitted after it: 15 shared pages, the boundary page
    through the COW copy program, the 1-token suffix through a chunk
    program. Half greedy, half T=0.8, 16 new tokens each."""
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    eng = InferenceEngine(model, num_slots=8, page_size=16, max_len=1024,
                          chunk_pages=None, prefix_cache=True,
                          kv_quant=kv_quant)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, model.vocab_size, size=n).astype(np.int32)
               for n in (40, 100, 200, 300, 520, 700)]
    prompts.append(prompts[3][:250].copy())
    reqs = [Request(p, max_new_tokens=16, eos_id=50256,
                    temperature=0.0 if i % 2 == 0 else 0.8, seed=200 + i)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    eng.audit_pages()
    check(all(r.outcome is not None and r.outcome.ok for r in reqs),
          f"{label}: requests ended badly")
    check(eng.prefix_hits == 1 and eng.copy_trace_count == 1,
          f"{label}: prefix hits {eng.prefix_hits}, copy_trace_count "
          f"{eng.copy_trace_count} (want 1 and 1)")
    want = {("dense", 16 * b) for b in (4, 8, 16, 32, 64)} | {("chunk", 16)}
    check(set(eng.prefill_trace_counts) == want,
          f"{label}: prefill programs {sorted(eng.prefill_trace_counts)} "
          f"!= {sorted(want)}")
    check_captures(eng, label)
    sfx = "_q" if kv_quant else ""
    L = model.num_layers
    check(launches["ragged_prefill" + sfx] == chunk_replays(eng) * L == L,
          f"{label}: ragged_prefill{sfx} launches "
          f"{launches['ragged_prefill' + sfx]} (one chunk replay x {L})")
    n_tok = sum(len(r.token_ids) for r in reqs)
    stats = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                 prefix_hits=eng.prefix_hits,
                 launches={k: v for k, v in launches.items() if v})
    print(f"[serving] {label}: {json.dumps(stats)}", flush=True)
    del eng
    torch.cuda.empty_cache()


def bench_gpt(seed, dtype="bfloat16", **kw):
    """GPT-2 small as bench.py builds it: ``mx.random.seed``,
    ``gpt_small(dtype=, ...)``, ``initialize()`` (on the card)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.models.gpt import gpt_small
    mx.random.seed(seed)
    model = gpt_small(dtype=dtype, **kw)
    model.initialize(ctx=mx.gpu(0))
    return model


def phase_serving(torch):
    import numpy as np
    model = bench_gpt(0)
    runs = {}
    runs["plain"], streams = serve_run(
        torch, np, model, "gpt_small bf16, 8 slots, chunk_pages=4",
        profile=True)
    # the n-gram drafter on random weights: the accept rate it finds
    runs["spec_ngram"], _ = serve_run(
        torch, np, model, "spec_k=4, n-gram drafter, raw bf16 pools",
        spec_k=4, profile=True, need_accept=False)
    # a replay of the plain run's streams: a controlled accept rate
    replay = replay_drafter(np, streams)
    runs["spec"], _ = serve_run(
        torch, np, model, "spec_k=4, replay drafter, raw bf16 pools",
        spec_k=4, draft_fn=replay)
    runs["spec_int8"], _ = serve_run(
        torch, np, model, "spec_k=4, replay drafter, int8 pools", spec_k=4,
        kv_quant="int8", draft_fn=replay)
    runs["spec_fp8"], _ = serve_run(
        torch, np, model, "spec_k=4, replay drafter, fp8_e4m3 pools, 4 "
        "requests", spec_k=4, kv_quant="fp8_e4m3", n_req=4,
        draft_fn=replay)
    # decode-bound pair: does a higher tokens-per-step show in tokens/s?
    runs["decode_plain"], streams = serve_run(
        torch, np, model, "decode-bound, 8 greedy x 96 tokens, plain",
        decode_bound=True)
    runs["decode_spec"], _ = serve_run(
        torch, np, model, "decode-bound, spec_k=4, replay drafter",
        spec_k=4, draft_fn=replay_drafter(np, streams), decode_bound=True)
    for quant in (None, "int8"):
        serve_monolithic(torch, np, model, f"monolithic (chunk_pages=None) "
                         f"with a COW prefix hit, {quant or 'raw bf16'} "
                         f"pools", kv_quant=quant)
    del model
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------------- #
# the serving engine's remaining surface: cache tiers, page transport,
# warm restart, brownout
# --------------------------------------------------------------------- #

def _timed(fn, into):
    """``fn`` with each call's host wall ms appended to ``into``."""
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        into.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def _median(xs):
    return round(statistics.median(xs), 4) if xs else None


def check_ragged_launches(eng, launches, label, steps, chunks,
                          spec_steps=0):
    """Every ragged launch of a run came from a graph replay: decode =
    non-speculative steps x layers, verify = speculative steps x layers,
    prefill = chunk replays x layers, on the engine's pool kind only."""
    L = eng.model.num_layers
    sfx, other = ("_q", "") if eng.kv_quant else ("", "_q")
    want = {"ragged_decode" + sfx: (steps - spec_steps) * L,
            "ragged_verify" + sfx: spec_steps * L,
            "ragged_prefill" + sfx: chunks * L,
            "ragged_decode" + other: 0, "ragged_verify" + other: 0,
            "ragged_prefill" + other: 0}
    for k, n in want.items():
        check(launches[k] == n, f"{label}: {k} launches {launches[k]} != "
                                f"{n} ({steps} steps, {spec_steps} "
                                f"speculative, {chunks} chunk replays, "
                                f"{L} layers)")


def tier_workload(np, vocab):
    """6 prefixes of 512 tokens, each shared by 3 requests with a
    64-token tail of their own and 32 new greedy tokens, round-robin over
    the prefixes: on 4 slots a prefix's pages are evicted from HBM by
    the 5 others before it recurs (with 4 prefixes on 4 slots every
    recurrence still finds its prefix in HBM)."""
    rng = np.random.RandomState(5)
    prefixes = [rng.randint(0, vocab, size=512).astype(np.int32)
                for _ in range(6)]
    return [np.concatenate([prefixes[i % 6], rng.randint(
        0, vocab, size=64).astype(np.int32)]) for i in range(18)]


def tier_run(torch, np, model, quant, tiered, disk_dir):
    """The tier workload on one engine (4 slots, chunk_pages=4). Tiered:
    a pool just above four slots' reservation (1 + 4 x 38 + 8 pages), so
    each recurring prefix was evicted from HBM into the tiers (DRAM holds
    two prefixes, the rest spills to disk); untiered: a pool large
    enough that no prefix page is reclaimed (512 pages). Returns the
    engine, the streams, the wall seconds and the gather / promote host
    ms per page."""
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    elem = 1 if quant else torch.empty((), dtype=model.dtype).element_size()
    page_bytes = 2 * model.num_layers * 16 * model.units * elem
    kw = dict(num_pages=1 + 4 * 38 + 8,
              kv_tiers={"dram_bytes": 2 * 32 * page_bytes,
                        "disk_dir": disk_dir}) if tiered \
        else dict(num_pages=512)
    eng = InferenceEngine(model, num_slots=4, page_size=16, max_len=1024,
                          chunk_pages=4, prefix_cache=True, kv_quant=quant,
                          **kw)
    gather_ms, promote_ms = [], []
    eng.gather_page = _timed(eng.gather_page, gather_ms)
    eng._promote_page = _timed(eng._promote_page, promote_ms)
    reqs = [Request(p, max_new_tokens=32) for p in
            tier_workload(np, model.vocab_size)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs, before_step=lambda e, _i: e.audit_pages())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    eng.audit_pages()
    bad = [(r.request_id, r.outcome) for r in reqs
           if r.outcome is None or not r.outcome.ok]
    check(not bad, f"tiers {quant or 'bf16'}: requests ended badly: {bad}")
    check_ragged_launches(eng, launches, f"tiers {quant or 'bf16'}",
                          eng.decode_steps, chunk_replays(eng))
    return eng, [r.token_ids for r in reqs], wall, gather_ms, promote_ms


def phase_tiers(torch, np, model):
    """KV cache tiers on raw bf16, int8 and fp8_e4m3 pools: demotions to
    DRAM, spills to disk, promotions from both, no crc fallback, one
    gather and one promotion capture, clean audits before every step,
    and greedy streams bitwise those of an engine that never evicts."""
    import tempfile
    from incubator_mxnet_tpu_torch.events import EventType
    for quant in (None, "int8", "fp8_e4m3"):
        label = f"tiers {quant or 'raw bf16'}"
        disk = tempfile.mkdtemp(prefix="mx_tiers_")
        try:
            eng, got, wall, g_ms, p_ms = tier_run(torch, np, model, quant,
                                                  True, disk)
            ref, want, _, _, _ = tier_run(torch, np, model, quant, False,
                                          None)
        finally:
            shutil.rmtree(disk, ignore_errors=True)
        snap = eng.health_snapshot()
        proms = eng.flight.events(etype=EventType.CACHE_PROMOTE)
        from_dram = sum(e.data["tier"] == "dram" for e in proms)
        from_disk = sum(e.data["tier"] == "disk" for e in proms)
        check(ref.prefix_reclaimed_pages == 0 and ref.tier_demotions == 0,
              f"{label}: the reference engine reclaimed prefix pages")
        check(snap["tier_demotions"] > 0 and snap["tier_disk_demotions"] > 0
              and from_dram > 0 and from_disk > 0,
              f"{label}: demotions {snap['tier_demotions']}, spills "
              f"{snap['tier_disk_demotions']}, promotions from DRAM "
              f"{from_dram} / disk {from_disk} (each must be > 0)")
        check(snap["tier_crc_fallbacks"] == 0 and
              eng._tiers.crc_failures == 0,
              f"{label}: crc fallbacks {snap['tier_crc_fallbacks']}")
        check(eng.promote_trace_count == eng.demote_trace_count == 1,
              f"{label}: promote / demote built "
              f"{eng.promote_trace_count} / {eng.demote_trace_count} "
              f"times")
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        check(not diff, f"{label}: streams {diff} differ from the "
                        f"untiered engine's")
        page_bytes = next((e.nbytes for _k, e in eng._tiers.entries()),
                          None)
        stats = dict(wall_s=round(wall, 3), demoted=snap["tier_demotions"],
                     spilled=snap["tier_disk_demotions"],
                     promoted=snap["tier_promotions"],
                     promoted_from_dram=from_dram,
                     promoted_from_disk=from_disk,
                     tier_hits=snap["tier_hits"],
                     tier_hit_tokens=snap["tier_hit_tokens"],
                     dropped=snap["tier_dropped"],
                     gather_ms_per_page=_median(g_ms),
                     promote_ms_per_page=_median(p_ms),
                     bytes_per_page=page_bytes,
                     capture_ms=dict(gather=eng._gather_prog.build_ms,
                                     promote=eng._promote_prog.build_ms))
        print(f"[tiers] {label}: {json.dumps(stats)}", flush=True)
        del eng, ref
        torch.cuda.empty_cache()


def transport_requests(np, Request, vocab):
    """8 requests of 64-768 prompt tokens, 64 new tokens each, greedy and
    seeded T=0.8 alternating."""
    rng = np.random.RandomState(7)
    return [Request(rng.randint(0, vocab, size=int(n)), max_new_tokens=64,
                    temperature=0.0 if i % 2 == 0 else 0.8, seed=300 + i)
            for i, n in enumerate(rng.randint(64, 769, size=8))]


def phase_transport(torch, np, model):
    """Page transport between two engines on the same model, raw bf16
    and int8 pools: each slot captured off A once it has 16 tokens,
    installed on B and finished there; the streams equal the same
    requests run on A alone, bitwise; B prefills nothing for them (its
    decode step takes each slot on from its last token); the custody is
    released and both audits are clean; B builds one promotion
    program."""
    from incubator_mxnet_tpu_torch.events import EventType
    from incubator_mxnet_tpu_torch.serve import (InferenceEngine,
                                                 PageTransport, Request)
    kw = dict(num_slots=8, page_size=16, max_len=1024, chunk_pages=4,
              prefix_cache=True)
    for quant in (None, "int8"):
        label = f"transport {quant or 'raw bf16'}"
        solo = InferenceEngine(model, kv_quant=quant, **kw)
        ref = transport_requests(np, Request, model.vocab_size)
        solo.run(ref)
        a = InferenceEngine(model, kv_quant=quant, **kw)
        b = InferenceEngine(model, kv_quant=quant, **kw)
        reqs = transport_requests(np, Request, model.vocab_size)
        for r in reqs:
            a.submit(r)
        tr = PageTransport()
        moved, cap_ms, inst_ms, nbytes = {}, [], [], 0
        for _ in range(5000):
            if all(r.request_id in moved for r in reqs) and \
                    all(t.outcome is not None for t in moved.values()):
                break
            a.step()
            for r in reqs:
                if r.request_id in moved or len(r.token_ids) < 16 or \
                        not a.decode_ready(r.request_id):
                    continue
                t0 = time.perf_counter()
                cap = tr.capture(a, r.request_id)
                cap_ms.append((time.perf_counter() - t0) * 1e3)
                check(cap is not None, f"{label}: capture refused")
                att = cap.make_resume_request()
                t0 = time.perf_counter()
                ok = tr.install(b, cap, att)
                inst_ms.append((time.perf_counter() - t0) * 1e3)
                check(ok, f"{label}: install refused")
                check(a.release_capsule(r.request_id) == cap.num_pages,
                      f"{label}: custody release")
                nbytes += cap.nbytes
                moved[r.request_id] = att
            b.step()
            a.audit_pages()
            b.audit_pages()
        check(len(moved) == 8 and all(t.outcome is not None and t.outcome.ok
                                      for t in moved.values()),
              f"{label}: {len(moved)} of 8 moved, not all finished")
        diff = []
        for r, want in zip(reqs, ref):
            got = r.token_ids + moved[r.request_id].token_ids
            if got != want.token_ids:
                first = next((i for i, (x, y) in enumerate(
                    zip(got, want.token_ids)) if x != y), None)
                diff.append((r.request_id, r.temperature, first))
        check(not diff, f"{label}: migrated streams differ from A alone "
                        f"(request, temperature, first differing token): "
                        f"{diff}")
        ids = {t.request_id for t in moved.values()}
        chunks = [e.data["n"] for e in b.flight.events(
            etype=EventType.PREFILL_CHUNK) if e.request_id in ids]
        check(chunks == [], f"{label}: B prefilled {chunks} tokens for "
                            f"the installed slots (want none)")
        check(b.promote_trace_count == 1 and a.demote_trace_count == 1 and
              not a._capsule_pages and not b._capsule_pages,
              f"{label}: promote / demote builds "
              f"{b.promote_trace_count} / {a.demote_trace_count}, custody "
              f"{a._capsule_pages}")
        stats = dict(slots=len(moved), pages=b.migrated_in_pages,
                     mb_moved=round(nbytes / 1e6, 3),
                     capture_ms_per_slot=_median(cap_ms),
                     install_ms_per_slot=_median(inst_ms),
                     pages_per_slot=b.migrated_in_pages / len(moved))
        print(f"[transport] {label}: {json.dumps(stats)}", flush=True)
        del solo, a, b
        torch.cuda.empty_cache()


def phase_warm_start(torch, np):
    """An engine on the seed-0 model serves 4 requests (its decode and
    prefill graphs captured), then takes the seed-1 model's weights by
    ``warm_start`` and serves 4 more: no new capture, the streams those
    of a fresh engine on the seed-1 model, the prefix index flushed."""
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    kw = dict(num_slots=4, page_size=16, max_len=1024, chunk_pages=4,
              prefix_cache=True)
    live = bench_gpt(0)
    other = bench_gpt(1)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, live.vocab_size, size=int(n)).astype(np.int32)
               for n in (80, 200, 333, 500)]
    mk = lambda: [Request(p, max_new_tokens=32) for p in prompts]
    eng = InferenceEngine(live, **kw)
    first = mk()
    eng.run(first)
    builds = (eng.decode_trace_count, dict(eng.prefill_trace_counts))
    flushes = eng.prefix_flushes
    t0 = time.perf_counter()
    eng.warm_start(params=other.state_dict())
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    second = mk()
    eng.run(second)
    eng.audit_pages()
    fresh = mk()
    InferenceEngine(other, **kw).run(fresh)
    check((eng.decode_trace_count, dict(eng.prefill_trace_counts)) ==
          builds, f"warm start: builds moved from {builds}")
    check(eng.prefix_flushes == flushes + 1, "warm start: no flush")
    check([r.token_ids for r in second] == [r.token_ids for r in fresh],
          "warm start: streams differ from a fresh engine on the new "
          "weights")
    check([r.token_ids for r in second] != [r.token_ids for r in first],
          "warm start: the new weights changed nothing")
    stats = dict(swap_ms=round(swap_ms, 3), decode_builds=builds[0],
                 prefill_builds=builds[1],
                 decode_replays=eng._programs[1].replays)
    print(f"[warm_start] gpt_small bf16 seed 0 -> seed 1, streams equal a "
          f"fresh engine's: {stats}", flush=True)
    del eng, live, other
    torch.cuda.empty_cache()


def phase_brownout(torch, np, model):
    """One overloaded run under the brownout controller (16 requests of
    three tiers on 4 slots, spec_k=4, a 50 ms delay reference): the level
    timeline; every request terminal and the audit clean."""
    from incubator_mxnet_tpu_torch.serve import (BrownoutController,
                                                 InferenceEngine, Request,
                                                 Tier)
    bo = BrownoutController(up_steps=1, down_steps=2, delay_ref=0.05)
    eng = InferenceEngine(model, num_slots=4, page_size=16, max_len=1024,
                          chunk_pages=4, prefix_cache=True, spec_k=4,
                          brownout=bo)
    rng = np.random.RandomState(11)
    tiers = (Tier.LATENCY, Tier.STANDARD, Tier.BATCH)
    reqs = [Request(rng.randint(0, model.vocab_size, size=int(n)),
                    max_new_tokens=32, tier=tiers[i % 3])
            for i, n in enumerate(rng.randint(64, 257, size=16))]
    eng.run(reqs, before_step=lambda e, _i: e.audit_pages())
    eng.audit_pages()
    check(all(r.outcome is not None for r in reqs),
          "brownout: a request never ended")
    outcomes = {}
    for r in reqs:
        outcomes[r.outcome.value] = outcomes.get(r.outcome.value, 0) + 1
    stats = dict(escalations=bo.escalations, deescalations=bo.deescalations,
                 final_level=bo.level, timeline=bo.timeline,
                 outcomes=outcomes, spec_steps=eng.spec_steps,
                 decode_steps=eng.decode_steps)
    print(f"[brownout] {json.dumps(stats)}", flush=True)


def phase_surface(torch):
    import numpy as np
    model = bench_gpt(0)
    phase_tiers(torch, np, model)
    phase_transport(torch, np, model)
    phase_brownout(torch, np, model)
    del model
    torch.cuda.empty_cache()
    phase_warm_start(torch, np)


# --------------------------------------------------------------------- #
# the serving fleet: a Router over gpt_small replicas on one card, slot
# migration, the rolling upgrade, the chaos kill and the HTTP front end
# --------------------------------------------------------------------- #

FLEET = dict(replicas=3, router_seed=5, max_new=64,
             engine=dict(num_slots=8, page_size=16, max_len=1024,
                         chunk_pages=4, prefix_cache=True))


def fleet_model(seed):
    return bench_gpt(seed)


def fleet_requests(np, Request, vocab, seeds=None, n=16):
    """The serving phase's mixed workload (``_prompts``: 8 of 16 share a
    512-token prefix), 64 new tokens, greedy and T=0.8 alternating; the
    seeds left to the router to pin unless ``seeds`` gives them."""
    prompts = _prompts(np, np.random.RandomState(0), vocab)[:n]
    return [Request(p, max_new_tokens=FLEET["max_new"], eos_id=vocab - 1,
                    temperature=0.0 if i % 2 == 0 else 0.8,
                    seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]


def always_drafter(np, streams):
    """``replay_drafter`` over an earlier run's streams, and where it has
    nothing, the last token repeated: with ``spec_patience=0`` every
    decode-ready slot with more than one token to go drafts every step,
    so a speculative replica runs the verify program whoever shares it
    (a slot's logits then depend on its own row only) — except in a step
    where every decode-ready slot is at its last token, which runs the
    W = 1 decode program."""
    replay = replay_drafter(np, streams)

    def draft(history, k):
        d = replay(history, k)
        return d if d.size else np.full((k,), history[-1], np.int32)

    return draft


def fleet_audit(rt):
    for rep in rt.replicas:
        if rep.state.value != "DEAD" and rep.killed is None:
            rep.engine.audit_pages()


def fleet_drive(torch, rt, reqs, before=None, waves=True, limit_s=300.0):
    """Wave 1 (the first 8: the prefix's first request and 7 others), then
    — once request 0 has its first token, its prefix pages published —
    wave 2; steps until every request is terminal, auditing every live
    replica's pages after each step (a pass that advanced nothing sleeps
    1 ms, as ``Router.run`` does). Returns the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, rest = (reqs[:8], reqs[8:]) if waves else (reqs, [])
    for r in first:
        check(rt.submit(r), f"fleet refused request {r.request_id}")
    i = 0
    while rest or any(r.outcome is None for r in reqs):
        if rest and rt.live_tokens(reqs[0]):
            for r in rest:
                check(rt.submit(r), f"fleet refused {r.request_id}")
            rest = []
        if before is not None:
            before(rt, i)
        if not rt.step():
            time.sleep(1e-3)
        fleet_audit(rt)
        i += 1
        check(time.perf_counter() - t0 < limit_s,
              f"fleet wedged: {i} steps in {limit_s} s")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fleet_launches(rt, launches, label):
    """The process-wide ragged launch counts of a fleet run equal the sum
    over its replicas (the dead one included) of steps x layers: decode =
    non-speculative steps, verify = speculative steps, prefill = chunk
    replays."""
    engs = [rep.engine for rep in rt.replicas]
    check_ragged_launches(
        engs[0], launches, label,
        sum(e.decode_steps for e in engs),
        sum(chunk_replays(e) for e in engs),
        sum(e.spec_steps for e in engs))


def fleet_captures(rt, label):
    """Each replica captured one program per width and (kind, bucket) it
    met, at most one COW copy, gather and promotion; a replica that met
    nothing captured nothing. Returns (decode, verify, prefill, copy,
    promote, gather) per replica."""
    out = []
    for rep in rt.replicas:
        e = rep.engine
        if e.prefill_trace_count:
            captures_once(e, f"{label} replica {rep.idx}")
        else:
            check(e.decode_trace_count == e.verify_trace_count ==
                  e.copy_trace_count == 0,
                  f"{label}: idle replica {rep.idx} captured programs")
        check(e.promote_trace_count <= 1 and e.demote_trace_count <= 1,
              f"{label}: replica {rep.idx} page programs captured "
              f"{e.promote_trace_count} / {e.demote_trace_count} times")
        out.append((e.decode_trace_count, e.verify_trace_count,
                    e.prefill_trace_count, e.copy_trace_count,
                    e.promote_trace_count, e.demote_trace_count))
    return out


def fleet_transitions(rt, label, want):
    """The router's replica-health transitions, (replica, from, to), must
    be exactly the ones the run injected: anything else (a breaker that
    opened) is a failure to explain."""
    got = [(e.data["replica"], e.data["from_state"], e.data["to_state"])
           for e in rt.flight.events("router")
           if e.etype.value == "REPLICA_HEALTH"]
    check(got == want, f"{label}: replica transitions {got}, want {want}")
    return [f"{i}:{a}->{b}" for i, a, b in got]


def fleet_dispatches(rt, reqs):
    """Per request, the replicas its (re)dispatches chose, in order."""
    idx = {r.request_id: i for i, r in enumerate(reqs)}
    out = [[] for _ in reqs]
    for e in rt.flight.events("router"):
        if e.etype.value == "DISPATCH" and e.request_id in idx:
            out[idx[e.request_id]].append(e.data["replica"])
    return out


def fleet_ttft_ms(reqs):
    return _median([(r.token_stamps[0] - r.submit_time) * 1e3
                    for r in reqs if r.token_stamps])


def fleet_ok(reqs, label):
    bad = [(i, r.outcome, r.detail[:80]) for i, r in enumerate(reqs)
           if r.outcome is None or not r.outcome.ok]
    check(not bad, f"{label}: requests ended badly: {bad}")


def first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def fleet_line(label, rt, wall, captures, transitions, reqs=(),
               **extra):
    """One ``[fleet]`` line: the run's tokens/s and TTFT p50 (over
    ``reqs``, the router's clients), its routing, re-queue and migration
    tallies, breaker transitions and captures per replica."""
    n_tok = sum(len(r.token_ids) for r in reqs)
    stats = dict(requests=len(reqs), tokens=n_tok,
                 wall_s=round(wall, 3),
                 tokens_per_s=round(n_tok / wall, 1) if reqs else None,
                 ttft_p50_ms=fleet_ttft_ms(reqs) if reqs else None,
                 steps=rt.steps, affinity_routed=rt.affinity_routed,
                 spill_routed=rt.spill_routed, requeues=rt.requeues,
                 migrations=rt.migrations,
                 breaker_transitions=transitions,
                 captures_per_replica=captures, **extra)
    print(f"[fleet] {label}: {json.dumps(stats)}", flush=True)


def check_top_p_slots(torch):
    """One row with top-p 0.9 and top-k 40 (T = 0.8) placed in each of 8
    slots of an (8, W, 50257) batch: the constrained row and the
    inverse-CDF draw from it bitwise the same in every slot (the top-p
    normalizer and cumsum run over row-aligned rows)."""
    from incubator_mxnet_tpu_torch.serve.sampling import (
        constrain_logits, sample_inverse_cdf)
    V, S, dev = 50257, 8, "cuda"
    for W in (1, 5):
        gen = torch.Generator(device=dev).manual_seed(1)
        row = torch.randn(V, device=dev, generator=gen) * 2.0
        u = torch.rand(32, device=dev, generator=gen)
        full = lambda v, dt=torch.float32: torch.full(  # noqa: E731
            (S, W), v, dtype=dt, device=dev)
        menu = dict(
            counts=torch.zeros(S, W, V, dtype=torch.int32, device=dev),
            bias=torch.zeros(S, W, V, device=dev),
            mask=torch.ones(S, W, V, dtype=torch.bool, device=dev),
            top_k=full(40, torch.int32), top_p=full(0.9),
            rep_pen=full(1.0), pres_pen=full(0.0))
        rows, draws = [], []
        for s in range(S):
            x = torch.randn(S, W, V, device=dev, generator=gen)
            x[s, 0] = row
            c = constrain_logits(x, full(0.8), **menu)
            rows.append(c[s, 0].clone())
            draws.append(torch.stack([sample_inverse_cdf(
                c / 0.8, torch.full((S, W), float(v), device=dev))[s, 0]
                for v in u]))
        same = sum(torch.equal(r, rows[0]) and torch.equal(d, draws[0])
                   for r, d in zip(rows, draws))
        kept = int((rows[0] > -1e29).sum())
        check(same == S and 1 < kept <= 40,
              f"top-p W={W}: {same} of {S} slots drew as slot 0 "
              f"({kept} tokens kept)")
        print(f"[sampling] top-p 0.9 / top-k 40 row, W={W}: the same "
              f"constrained row and {u.numel()} draws in {same} of {S} "
              f"slots ({kept} tokens kept)", flush=True)


def phase_fleet(torch):
    """The serving fleet on one card: 3 gpt_small bf16 replicas, each on
    its own copy of the weights, behind a Router (``build_fleet``)."""
    import numpy as np
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import (InferenceEngine, Request,
                                                 build_fleet)
    from incubator_mxnet_tpu_torch.serve.chaos import (
        KillReplica, assert_fleet_health_consistent)
    check_top_p_slots(torch)
    model = fleet_model(0)
    V = model.vocab_size
    KW, N, RS = FLEET["engine"], FLEET["replicas"], FLEET["router_seed"]

    def fleet(**kw):
        return build_fleet(model, N, engine_kw=dict(KW, **kw), seed=RS)

    def run(label, rt, reqs, before=None, waves=True):
        torch.cuda.synchronize()
        reset_launch_counts()
        wall = fleet_drive(torch, rt, reqs, before=before, waves=waves)
        fleet_launches(rt, dict(LAUNCHES), label)
        assert_fleet_health_consistent(rt, reqs)
        return wall

    # 1. fault-free: affinity, streams == one engine under the pinned seeds
    label = "fault-free, 3 replicas"
    rt = fleet()
    reqs = fleet_requests(np, Request, V)
    wall = run(label, rt, reqs)
    fleet_ok(reqs, label)
    seeds = [r.seed for r in reqs]
    base = [list(r.token_ids) for r in reqs]
    streams = [(r.prompt_ids, r.token_ids) for r in reqs]
    routes = fleet_dispatches(rt, reqs)
    holder = routes[0][0]
    shared = routes[8:15]
    check(all(d == [holder] for d in shared) and
          rt.replicas[holder].engine.prefix_hits >= len(shared) and
          rt.affinity_routed >= len(shared),
          f"{label}: the prefix's requests went to {shared}, its pages "
          f"are on replica {holder} (prefix hits "
          f"{rt.replicas[holder].engine.prefix_hits}, affinity "
          f"{rt.affinity_routed})")
    caps = fleet_captures(rt, label)
    trans = fleet_transitions(rt, label, [])
    solo = InferenceEngine(model, **KW)
    ref = fleet_requests(np, Request, V, seeds=seeds)
    solo.run(ref)
    diff = [(i, first_diff(a, r.token_ids)) for i, (a, r) in
            enumerate(zip(base, ref)) if a != r.token_ids]
    check(not diff, f"{label}: streams differ from one engine's "
                    f"(request, first token): {diff}")
    fleet_line(label, rt, wall, caps, trans, reqs, holder=holder,
               prefix_hits=[rep.engine.prefix_hits
                            for rep in rt.replicas],
               routes=[d[0] for d in routes])
    del rt, solo
    gc.collect()
    torch.cuda.empty_cache()
    victim = (holder + 1) % N

    def kill_run(label, rt, reqs, inj, want):
        wall = run(label, rt, reqs, before=inj.on_step)
        check(inj.fired and rt.replica_deaths == 1,
              f"{label}: the kill never fired")
        fleet_ok(reqs, label)
        moved = {id(c): pre for c, pre in inj.inflight_at_kill}
        check(moved, f"{label}: nothing was in flight on the victim")
        for r in reqs:
            pre = moved.get(id(r))
            check(pre is None or r.token_ids[:len(pre)] == pre,
                  f"{label}: request {r.request_id} lost its emitted "
                  f"prefix")
        surv = [i for i, r in enumerate(reqs) if id(r) not in moved]
        bad = [(i, first_diff(reqs[i].token_ids, want[i])) for i in surv
               if reqs[i].token_ids != want[i]]
        check(not bad, f"{label}: survivors differ from the fault-free "
                       f"run (request, first token): {bad}")
        replay = [i for i, r in enumerate(reqs) if id(r) in moved]
        requeue_at = {e.request_id: e.ts for e in rt.flight.events("router")
                      if e.etype.value == "REQUEUE"}
        gap = [(next(t for t in reqs[i].token_stamps
                     if t > requeue_at[reqs[i].request_id]) -
                requeue_at[reqs[i].request_id]) * 1e3
               for i in replay if reqs[i].request_id in requeue_at and
               any(t > requeue_at[reqs[i].request_id]
                   for t in reqs[i].token_stamps)]
        caps = fleet_captures(rt, label)
        trans = fleet_transitions(rt, label, [(victim, "SERVING", "DEAD")])
        fleet_line(label, rt, wall, caps, trans, reqs, victim=victim,
                   requeued=len(replay), survivors=len(surv),
                   requeued_equal=sum(reqs[i].token_ids == want[i]
                                      for i in replay),
                   requeued_first_diff=[first_diff(reqs[i].token_ids,
                                                   want[i])
                                        for i in replay],
                   requeue_to_first_token_ms=_median(gap))

    # 2a. a kill mid-decode
    kill_run("KillReplica mid-decode", fleet(),
             fleet_requests(np, Request, V),
             KillReplica(replica=victim, at_step=12, phase="decode"), base)
    gc.collect()
    torch.cuda.empty_cache()

    # 2b. spec_k=4, every step a verify step: fault-free, then a kill
    # mid-verify
    spec = dict(spec_k=4, spec_patience=0,
                draft_fn=always_drafter(np, streams))
    label = "spec_k=4 fault-free, 3 replicas"
    rt = fleet(**spec)
    reqs = fleet_requests(np, Request, V)
    wall = run(label, rt, reqs)
    fleet_ok(reqs, label)
    spec_base = [list(r.token_ids) for r in reqs]
    check(all(rep.engine.spec_steps for rep in rt.replicas),
          f"{label}: a replica never ran a verify step")
    caps = fleet_captures(rt, label)
    trans = fleet_transitions(rt, label, [])
    fleet_line(label, rt, wall, caps, trans, reqs,
               equal_to_plain=sum(a == b for a, b in zip(spec_base, base)),
               w1_steps=[rep.engine.decode_steps - rep.engine.spec_steps
                         for rep in rt.replicas],
               accept_rate=round(sum(rep.engine.accepted_tokens for rep in
                                     rt.replicas) /
                                 max(1, sum(rep.engine.drafted_tokens
                                            for rep in rt.replicas)), 3))
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    kill_run("spec_k=4, KillReplica mid-verify", fleet(**spec),
             fleet_requests(np, Request, V),
             KillReplica(replica=victim, at_step=12, phase="verify"),
             spec_base)
    gc.collect()
    torch.cuda.empty_cache()

    # 3. remove_replica with live decode-ready slots: page capsules
    label = "remove_replica, slots moved by capsule"
    rt = fleet()
    gone = (holder + 2) % N
    mig_ms = []
    rt.migrate = _timed(rt.migrate, mig_ms)
    removed = []

    def remove(router, _i):
        rep = router.replicas[gone]
        if removed:
            return
        for t in router._inflight:
            if t.replica == gone and t.attempt.token_ids and \
                    rep.engine.decode_ready(t.attempt.request_id):
                router.remove_replica(gone)
                removed.append(_i)
                return

    reqs = fleet_requests(np, Request, V)
    wall = run(label, rt, reqs, before=remove)
    for _ in range(50):
        if rt.replicas[gone].state.value == "RETIRED":
            break
        rt.step()
    fleet_ok(reqs, label)
    check(removed and rt.migrations > 0 and rt.migrations_failed == 0 and
          rt.migrated_pages > 0 and rt.migrated_bytes > 0,
          f"{label}: migrations {rt.migrations} (failed "
          f"{rt.migrations_failed}, pages {rt.migrated_pages})")
    diff = [(i, first_diff(r.token_ids, b)) for i, (r, b) in
            enumerate(zip(reqs, base)) if r.token_ids != b]
    check(not diff, f"{label}: streams differ from the fault-free run "
                    f"(request, first token): {diff}")
    caps = fleet_captures(rt, label)
    trans = fleet_transitions(rt, label, [(gone, "SERVING", "DRAINING"),
                                          (gone, "DRAINING", "RETIRED")])
    fleet_line(label, rt, wall, caps, trans, reqs, removed=gone,
               at_step=removed[0], migrated_pages=rt.migrated_pages,
               migrated_mb=round(rt.migrated_bytes / 1e6, 3),
               migrate_ms_per_slot=_median(mig_ms))
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    # 4. upgrade_replica(0) to the seed-1 weights while 1-2 serve
    label = "upgrade_replica(0) to seed-1 weights"
    other = fleet_model(1)
    rt = fleet()
    reqs = fleet_requests(np, Request, V)[:8]
    t_swap = []

    def upgrade(router, i):
        if i == 1:
            router.upgrade_replica(0, params=other.state_dict())
        if router.upgrades and not t_swap:
            t_swap.append(i)

    wall = run(label, rt, reqs, before=upgrade, waves=False)
    for _ in range(200):
        if rt.replicas[0].state.value == "SERVING" and rt.upgrades:
            break
        rt.step()
    fleet_ok(reqs, label)
    check(rt.upgrades == 1 and rt.replicas[0].state.value == "SERVING",
          f"{label}: replica 0 is {rt.replicas[0].state} after "
          f"{rt.upgrades} upgrades")
    diff = [i for i, r in enumerate(reqs) if r.token_ids != base[i]]
    check(not diff, f"{label}: streams {diff} differ from the fault-free "
                    f"run (all served on seed-0 weights)")
    caps = fleet_captures(rt, label)
    trans = fleet_transitions(rt, label, [(0, "SERVING", "DRAINING"),
                                          (0, "DRAINING", "WARMING"),
                                          (0, "WARMING", "SERVING")])
    rng = np.random.RandomState(9)
    probe = [rng.randint(0, V, size=int(n)).astype(np.int32)
             for n in (80, 300)]
    mk = lambda: [Request(p, max_new_tokens=32) for p in probe]  # noqa
    got = []
    for rep in rt.replicas:
        rs = mk()
        rep.engine.run(rs)
        got.append([r.token_ids for r in rs])
    want = []
    for m in (other, model):
        rs = mk()
        InferenceEngine(m, **KW).run(rs)
        want.append([r.token_ids for r in rs])
    check(got[0] == want[0] and got[1] == got[2] == want[1] and
          want[0] != want[1],
          f"{label}: replica 0 serves seed-1 streams: "
          f"{got[0] == want[0]}; replicas 1, 2 seed-0 streams: "
          f"{got[1] == want[1]}, {got[2] == want[1]}")
    fleet_audit(rt)
    fleet_line(label, rt, wall, caps, trans, reqs,
               swapped_at_step=t_swap[:1], replica0_seed1=True,
               replicas12_seed0=True)
    del rt, other
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the HTTP front end: over a plain fleet, 4 SSE + 1 blocking
    # against the direct router's streams; over a speculative fleet, one
    # stream a replica while the front end's thread captures their verify
    # programs, against the same requests driven directly
    picks = [fleet_requests(np, Request, V)[i] for i in range(5)]
    payloads = [dict(prompt=[int(t) for t in r.prompt_ids],
                     max_new_tokens=FLEET["max_new"], eos_id=V - 1,
                     temperature=r.temperature, seed=seeds[i],
                     stream=i != 4) for i, r in enumerate(picks)]
    fleet_http(torch, fleet(), payloads, base,
               "ServeFrontend over the plain fleet, 4 SSE + 1 blocking")
    label = "spec_k=4 fleet driven directly, one request a replica"
    rt = fleet(**spec)
    reqs = fleet_requests(np, Request, V)[:N]
    wall = run(label, rt, reqs, waves=False)
    fleet_ok(reqs, label)
    alone = [list(r.token_ids) for r in reqs]
    check(sorted(d[0] for d in fleet_dispatches(rt, reqs)) ==
          list(range(N)), f"{label}: not one request a replica")
    fleet_line(label, rt, wall, fleet_captures(rt, label),
               fleet_transitions(rt, label, []), reqs)
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    rt = fleet_http(torch, fleet(**spec),
                    [dict(p, stream=True) for p in payloads[:N]], alone,
                    "ServeFrontend over the spec_k=4 fleet, one stream a "
                    "replica, verify captured while they are open")
    check(all(rep.engine.verify_trace_count == 1 for rep in rt.replicas),
          f"verify captures on the front end's thread: "
          f"{[rep.engine.verify_trace_count for rep in rt.replicas]}")
    del rt, model
    gc.collect()
    torch.cuda.empty_cache()


def fleet_http(torch, rt, payloads, want, label):
    """``payloads`` sent at once to a ``ServeFrontend`` over ``rt`` on
    127.0.0.1 (port 0), each from its own client thread (SSE, or a
    blocking completion where ``stream`` is False); every completion
    must come back 200 with the tokens of ``want``, /healthz and
    /metrics must answer, and the ragged launches equal the replicas'
    steps x layers. Returns the router."""
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import (ServeFrontend,
                                                 stream_completion)
    from incubator_mxnet_tpu_torch.serve.frontend import http_request
    host = "127.0.0.1"
    out = [None] * len(payloads)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with ServeFrontend(rt, host=host, port=0) as fe:
        def client(j):
            t = time.perf_counter()
            if payloads[j]["stream"]:
                r = stream_completion(host, fe.bound_port, payloads[j],
                                      timeout=300)
                out[j] = (r["status"], r["tokens"],
                          r["final"]["outcome"] if r["final"] else None,
                          (r["stamps"][0] - t) * 1e3 if r["stamps"]
                          else None)
            else:
                status, _, body = http_request(
                    host, fe.bound_port, "POST", "/v1/completions",
                    payloads[j], timeout=300)
                out[j] = (status, body["tokens"], body["outcome"], None)

        threads = [threading.Thread(target=client, args=(j,), daemon=True)
                   for j in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads),
              f"{label}: a client never finished")
        hs, _, health = http_request(host, fe.bound_port, "GET",
                                     "/healthz")
        ms, _, metrics = http_request(host, fe.bound_port, "GET",
                                      "/metrics")
        fe_stats = fe.stats_snapshot()
    wall = time.perf_counter() - t0
    n = len(rt.replicas)
    metrics = metrics.decode() if isinstance(metrics, bytes) else metrics
    check(hs == 200 and health["status"] == "ok" and
          health["replicas"].get("SERVING") == n,
          f"{label}: /healthz {hs} {health}")
    check(ms == 200 and f"mxtpu_serve_fleet_size {n}" in metrics and
          "mxtpu_serve_http_requests_total" in metrics,
          f"{label}: /metrics {ms}")
    bad = [(j, o[0], o[2], first_diff(o[1], want[j]))
           for j, o in enumerate(out) if o[0] != 200 or o[1] != want[j]]
    check(not bad, f"{label}: (request, status, outcome, first differing "
                   f"token) vs the direct router: {bad}")
    check(rt.health["MAX_TOKENS"] + rt.health["EOS"] == len(payloads),
          f"{label}: router outcomes {rt.health}")
    fleet_launches(rt, dict(LAUNCHES), label)
    n_tok = sum(len(o[1]) for o in out)
    fleet_line(label, rt, wall, fleet_captures(rt, label),
               fleet_transitions(rt, label, []),
               http_requests=fe_stats["http_requests"],
               sse_tokens=fe_stats["sse_tokens"], http_tokens=n_tok,
               tokens_per_s_http=round(n_tok / wall, 1),
               ttft_http_p50_ms=_median([o[3] for o in out
                                         if o[3] is not None]))
    return rt


def profile_decode(torch, np, eng, rng, Request, label):
    """Where a full decode step's time goes: 8 slots at ~200 tokens of
    context, 10 steps under torch.profiler — device-busy time per step
    (kernel and copy time on the card) against the step's wall time,
    and the kernels that take it. Profiling adds host time, so the busy
    share printed is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [Request(rng.randint(0, eng.model.vocab_size, size=200),
                    max_new_tokens=40) for _ in range(eng.num_slots)]
    for r in reqs:
        eng.submit(r)
    while any(sl is None or sl.prefilling for sl in eng._slots):
        eng.step()
    torch.cuda.synchronize()
    n = 10
    spec0 = eng.spec_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    wide = eng.spec_steps - spec0
    eng.run([])
    eng.audit_pages()
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        print("[profile] device time not measured: the profiler recorded "
              "no kernel", flush=True)
        return
    busy_ms = sum(t for _, t in kern) / 1e3 / n
    top = sorted(kern, key=lambda kt: -kt[1])[:6]
    print(f"[profile] {label}: decode, 8 slots, ~200-240 context, "
          f"{wide}/{n} steps speculative: wall {wall_ms:.3f} ms/step "
          f"(profiled), device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%); top: " + "; ".join(
              f"{k[:48]} {t / 1e3 / n:.3f} ms" for k, t in top), flush=True)


def profile_prefill(torch, eng, rng, Request, label):
    """Where a prefill chunk step's time goes: one 960-token prompt, its
    chunk steps 2-11 (64 tokens each at depths 64-703, each one replay of
    the 64-token bucket's graph) under torch.profiler — wall and
    device-busy ms per step, and the ragged prefill kernels' device ms
    (their share of busy and of wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.submit(Request(rng.randint(0, eng.model.vocab_size, size=960),
                       max_new_tokens=2))
    eng.step()                                   # admission, first chunk
    torch.cuda.synchronize()

    def prefilling():
        return any(sl is not None and sl.prefilling for sl in eng._slots)

    n = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while n < 10 and prefilling():
            eng.step()
            n += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / max(n, 1)
    eng.run([])
    eng.audit_pages()
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    check(n > 0, f"{label}: no chunk step to profile")
    if not kern:
        print("[profile] device time not measured: the profiler recorded "
              "no kernel", flush=True)
        return
    busy_ms = sum(t for _, t in kern) / 1e3 / n
    pre_ms = sum(t for k, t in kern if "prefill" in k) / 1e3 / n
    print(f"[profile] {label}: graphed prefill chunk steps, 1 slot, 64 "
          f"tokens at depths 64-703, {n} steps: wall {wall_ms:.3f} ms/step "
          f"(profiled), device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), ragged prefill kernels "
          f"{pre_ms:.3f} ms/step ({100 * pre_ms / busy_ms:.1f}% of busy, "
          f"{100 * pre_ms / wall_ms:.1f}% of wall)", flush=True)


def host_costs(torch, np, eng, Request):
    """Host time of the graphed decode step's own work at 8 live slots
    (~100-160 tokens of context, half at T=0.8) and gpt_small's
    vocabulary: staging the step into the pinned inputs (with the menu
    sync, nothing to copy here), the launch (one copy in, one replay)
    and the readback (which waits for the device); and the device time
    of sampling: the draw alone (``draw_uniform`` + ``sample_inverse_cdf``)
    and the whole of ``_accept_emit`` (menu, acceptance, draw, guard) at
    W = 1 and 5, each captured into a CUDA graph as the step runs it (an
    eager call's events would time the host's launches). Host: medians
    of 20 repeats of the same step; device: CUDA events over 20 replays.
    Plus n-gram drafting over a 1024-token history."""
    from incubator_mxnet_tpu_torch.serve import ngram_propose
    from incubator_mxnet_tpu_torch.serve.sampling import (
        DRAW_STREAM, draw_uniform, sample_inverse_cdf)
    rng = np.random.RandomState(4)
    S, V = eng.num_slots, eng.model.vocab_size
    for i in range(S):
        eng.submit(Request(rng.randint(0, V, size=100), max_new_tokens=60,
                           temperature=0.8 if i % 2 else 0.0, seed=i))
    while any(sl is None or sl.prefilling for sl in eng._slots):
        eng.step()
    live = list(range(S))
    prog = eng._program(1)
    toks = np.zeros((S, 1), np.int64)
    toks[:, 0] = [sl.request.token_ids[-1] for sl in eng._slots]
    dl = np.zeros((S,), np.int32)

    def stage():
        eng._sync_menu(1, {}, live)
        eng._stage_step(prog, toks, dl, [])

    def host_ms(fn, n=20):
        times = []
        for _ in range(n):
            stage()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            prog.read()
        return statistics.median(times)

    def dev_ms(fn, n=20):
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph)
        side = capture.capture_stream        # the process-wide one
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.synchronize()
        with capture:
            fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def launch_then_read():
        prog.launch()
        t0 = time.perf_counter()
        prog.read()
        return (time.perf_counter() - t0) * 1e3

    out = dict(stage_ms=host_ms(stage), launch_ms=host_ms(prog.launch))
    stage()
    out["readback_ms"] = statistics.median(
        launch_then_read() for _ in range(20))
    dev = eng.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for W in (1, 5):
        logits = torch.randn(S, W, V, generator=gen, device=dev) * 3
        keys = torch.arange(S, device=dev)
        pos = torch.arange(100, 100 + W, device=dev)[None, :].expand(S, W)
        temps = torch.full((S,), 0.8, device=dev)
        tok = torch.randint(0, V, (S, W), generator=gen, device=dev)
        dlen = torch.full((S,), W - 1, dtype=torch.int32, device=dev)
        mask = torch.ones((S, W, V), dtype=torch.bool, device=dev)
        menu = (eng._menu_counts, eng._menu_bias, mask,
                torch.zeros(S, dtype=torch.int32, device=dev),
                torch.ones(S, device=dev), torch.ones(S, device=dev),
                torch.zeros(S, device=dev))
        out[f"draw_w{W}_device_ms"] = dev_ms(lambda: sample_inverse_cdf(
            logits, draw_uniform(keys[:, None], pos, DRAW_STREAM)))
        out[f"accept_emit_w{W}_device_ms"] = dev_ms(
            lambda: eng._accept_emit(logits, tok, dlen, temps, keys, pos,
                                     menu))
    hist = np.random.RandomState(3).randint(0, 64, size=1024)
    t0 = time.perf_counter()
    for _ in range(20):
        [ngram_propose(hist, 4) for _ in range(S)]
    out["ngram_draft_8_slots_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    eng.run([])
    eng.audit_pages()
    print(f"[host] graphed decode step, 8 live slots, V={V}: "
          f"{json.dumps(out)}", flush=True)


def chunk_host_costs(torch, np, eng, Request):
    """Host time of the graphed prefill chunk step's own work: one
    960-token prompt past its first chunk, its second chunk (64 tokens at
    depth 64) staged into the 64-token bucket's pinned inputs, the launch
    (one copy in, one replay) and the readback (which waits for the
    device); medians of 20 repeats of the same chunk."""
    rng = np.random.RandomState(6)
    eng.submit(Request(rng.randint(0, eng.model.vocab_size, size=960),
                       max_new_tokens=2))
    eng.step()                                   # admission, first chunk
    s = next(i for i, sl in enumerate(eng._slots)
             if sl is not None and sl.prefilling)
    start = eng._slots[s].prefill_pos
    prog = eng._stage_chunk(s, start, 64)

    def host_ms(fn, n=20):
        times = []
        for _ in range(n):
            eng._stage_chunk(s, start, 64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            prog.read()
        return statistics.median(times)

    def launch_then_read():
        eng._stage_chunk(s, start, 64)
        prog.launch()
        t0 = time.perf_counter()
        prog.read()
        return (time.perf_counter() - t0) * 1e3

    out = dict(stage_ms=host_ms(lambda: eng._stage_chunk(s, start, 64)),
               launch_ms=host_ms(prog.launch),
               readback_ms=statistics.median(
                   launch_then_read() for _ in range(20)))
    eng.run([])
    eng.audit_pages()
    print(f"[host] graphed prefill chunk step, 64 tokens at depth {start}: "
          f"{json.dumps(out)}", flush=True)


def phase_parity(torch):
    import numpy as np
    from incubator_mxnet_tpu_torch.models.gpt import cached_generate
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    model = bench_gpt(1, dtype="float32")
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, model.vocab_size, size=150).astype(np.int32)
    ref = cached_generate(model, torch.tensor(prompt[None], device="cuda"),
                          max_new_tokens=32)[0, prompt.size:].tolist()
    for spec_k in (0, 4):
        eng = InferenceEngine(model, num_slots=2, page_size=16, max_len=256,
                              chunk_pages=2, prefix_cache=True,
                              spec_k=spec_k)
        req = Request(prompt, max_new_tokens=32)
        eng.run([req])
        eng.audit_pages()
        check(req.token_ids == ref,
              f"spec_k={spec_k}: engine tokens {req.token_ids} != "
              f"cached_generate {ref}")
        check(spec_k == 0 or eng.spec_steps > 0,
              "spec_k=4 parity run never verified a draft")
        counts = (eng.decode_trace_count, eng.verify_trace_count)
        check(counts == (int(eng.decode_steps > eng.spec_steps),
                         int(eng.spec_steps > 0)),
              f"spec_k={spec_k}: programs built {counts}")
        check({k for k, _ in eng.prefill_trace_counts} == {"chunk"} and
              set(eng.prefill_trace_counts.values()) == {1},
              f"spec_k={spec_k}: prefill programs built "
              f"{eng.prefill_trace_counts}")
        print(f"[parity] f32 gpt_small spec_k={spec_k}: engine == "
              f"cached_generate over {len(ref)} greedy tokens "
              f"({eng.decode_steps} steps, {eng.spec_steps} speculative, "
              f"accept rate {eng.accept_rate:.3f}; through the step "
              f"graphs: decode / verify captured {counts}; through the "
              f"chunk graphs: {eng.prefill_trace_counts})", flush=True)
        del eng
    del model
    torch.cuda.empty_cache()


def phase_graph_tests():
    """The step programs' ``cuda`` tests in a pytest subprocess without
    the repository's conftest, so it imports no JAX (the subprocess fails
    if JAX or the JAX package was imported): the serving engine's
    (tests/test_torch_serve_graphs.py: replay == body bitwise, builds
    touch no live page, launch accounting, one capture per width through
    stalls and a quarantine; tests/test_torch_page_graphs.py: the page
    gather and promotion programs and warm start) and the train step's
    (tests/test_torch_train_graphs.py: replay == eager body bitwise with
    dropout from a registered generator, two alternating signatures, flash
    launches per replay, a NaN batch through a replay, a failed capture
    raising; tests/test_torch_gpt_graphs.py: a GPT causal step's replay
    == its eager body, and remat replays equal to no remat's bitwise) and
    the symbolic Executor's (tests/test_torch_symbol_graphs.py: a train
    replay == its eager body bitwise, one capture per signature, outputs
    that later replays leave alone, grad_req add, dropout from the
    registered generator, a host-reading op failing its capture)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    run = ("import sys, pytest\n"
           "rc = int(pytest.main(sys.argv[1:]))\n"
           "jax = {'jax', 'incubator_mxnet_tpu'} & set(sys.modules)\n"
           "print('imported', sorted(jax)) if jax else None\n"
           "sys.exit(rc or (3 if jax else 0))\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", run, "-q", "--noconftest", "-m", "cuda",
         "-p", "no:cacheprovider", "-W",
         "ignore::pytest.PytestUnknownMarkWarning",
         "tests/test_torch_serve_graphs.py",
         "tests/test_torch_page_graphs.py",
         "tests/test_torch_train_graphs.py",
         "tests/test_torch_gpt_graphs.py",
         "tests/test_torch_symbol_graphs.py",
         "tests/test_torch_detection_graphs.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    print(f"[graphs] cuda tests: {tail[0]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(proc.returncode == 0 and "skipped" not in tail[0],
          f"step-graph cuda tests failed:\n{proc.stdout[-6000:]}"
          f"{proc.stderr[-3000:]}")


# --------------------------------------------------------------------- #
# flash attention and BERT pretraining
# --------------------------------------------------------------------- #

def flash_inputs(torch, gen, B, H, Tq, Tk, D, lens, dtype):
    mk = lambda T: torch.randn(B, H, T, D, generator=gen,
                               device="cuda").to(dtype)
    q, k, v, do = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, do, vl


def flash_run(torch, fa, q, k, v, do, vl, causal):
    """The forward, dq (which writes Δ) and dk/dv launches on these
    inputs: (out, lse, dq, delta, dk, dv), synchronized."""
    out, lse = fa._flash_fwd_cuda(q, k, v, vl, causal, None)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, vl, do, out, lse, causal,
                                      None)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, vl, do, lse, delta, causal,
                                    None)
    torch.cuda.synchronize()
    return out, lse, dq, delta, dk, dv


FLASH_OUTPUTS = ("out", "lse", "dq", "delta", "dk", "dv")


def compare_flash(torch, fa, q, k, v, do, vl, causal, what, err):
    """Run the three flash kernels and their plain versions on the same
    inputs and hold them together (FLASH_TOL); folds each kernel's
    largest |difference| into ``err``."""
    dt_name = str(q.dtype).removeprefix("torch.")
    atol, rtol, gfrac, gfloor = FLASH_TOL[dt_name]
    what = f"{dt_name} {what}"
    out, lse, dq, delta, dk, dv = flash_run(torch, fa, q, k, v, do, vl,
                                            causal)
    ro, rl = fa.dense_attn_lse(q, k, v, vl, causal)
    grads = fa.dense_attn_bwd(q, k, v, vl, ro, rl, do, causal)
    torch.cuda.synchronize()
    # the dq launch's Δ against attn_delta on the same out: f32 sums of D
    # terms in two orders (bf16 products exact in f32; f32 products
    # rounded once each), so within 2 D 2^-24 sum |dO O| of each other
    ref_delta = fa.attn_delta(out, do)
    dtol = DELTA_ULPS * q.shape[-1] * 2.0 ** -24 * \
        (do.float().abs() * out.float().abs()).sum(dim=-1)
    dd = (delta - ref_delta).abs()
    worst = float((dd / dtol.clamp(min=1e-30)).max()) if dd.numel() else 0.0
    print(f"[flash] flash_bwd_dq delta {what}: max|err| "
          f"{float(dd.max()) if dd.numel() else 0.0:.3e}, worst |err| / "
          f"tolerance {worst:.3f}", flush=True)
    check(bool((dd <= dtol).all()), f"flash_bwd_dq {what}: the delta it "
                                    f"writes disagrees with attn_delta "
                                    f"({worst:.2f} x its tolerance)")
    live = rl > -1e29
    check(bool((lse[~live] == -1e30).all()) and
          bool((out.float()[~live] == 0).all()),
          f"flash_fwd {what}: a fully masked row is not zero with lse -1e30")
    diffs = [("flash_fwd", "out", out, ro,
              atol + rtol * ro.float().abs()),
             ("flash_fwd", "lse", lse[live], rl[live],
              atol + rtol * rl[live].abs())]
    for name, part, g, r in (("flash_bwd_dq", "dq", dq, grads[0]),
                             ("flash_bwd_dkv", "dk", dk, grads[1]),
                             ("flash_bwd_dkv", "dv", dv, grads[2])):
        scale = r.float().abs().amax(dim=(2, 3), keepdim=True)
        diffs.append((name, part, g, r, gfrac * scale.clamp(min=gfloor)))
    for name, part, g, r, tol in diffs:
        check(bool(torch.isfinite(g).all()),
              f"{name} {what}: non-finite {part}")
        d = (g.float() - r.float()).abs()
        e = float(d.max()) if d.numel() else 0.0
        worst = float((d / tol).max()) if d.numel() else 0.0
        err[name] = max(err[name], e)
        print(f"[flash] {name} {part} {what}: max|err| {e:.3e}, worst "
              f"|err| / tolerance {worst:.3f}", flush=True)
        check(worst <= 1.0, f"{name} {what}: {part} disagrees with its "
                            f"plain version (max |err| {e:.3e}, "
                            f"{worst:.2f} x its tolerance)")
    del out, lse, dq, dk, dv, ro, rl, grads, delta, ref_delta
    torch.cuda.empty_cache()


def phase_flash_kernels(torch):
    """The three flash kernels against their plain versions on identical
    inputs; returns the largest |difference| per kernel."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    err = {k: 0.0 for k in FLASH}
    cases = [(dt, c) for dt in (torch.float32, torch.bfloat16)
             for c in FLASH_CASES]
    cases += [(torch.bfloat16, c) for c in FLASH_CAUSAL_BF16]
    for dt, (B, H, Tq, Tk, D, lens, causal) in cases:
        q, k, v, do, vl = flash_inputs(torch, gen, B, H, Tq, Tk, D, lens,
                                       dt)
        compare_flash(torch, fa, q, k, v, do, vl, causal,
                      f"B={B} H={H} Tq={Tq} Tk={Tk} D={D} "
                      f"lengths={lens} causal={causal}", err)
        del q, k, v, do, vl
    # two launches of each kernel bitwise equal (every output element is
    # owned by one block: no atomics), causal and not
    for causal in (False, True):
        args = flash_inputs(torch, gen, 3, 5, 576, 576, 64, [576, 300, 1],
                            torch.bfloat16)
        runs = [flash_run(torch, fa, *args, causal) for _ in range(2)]
        for name, a, b in zip(FLASH_OUTPUTS, *runs):
            check(bool(torch.equal(a, b)),
                  f"flash bf16 B=3 H=5 T=576 causal={causal}: two launches "
                  f"give different {name}")
        del args, runs
    print("[flash] two launches bitwise equal (bf16, D=64, B=3 H=5 T=576, "
          "causal and not): out, lse, dq, delta, dk, dv", flush=True)
    # NaN in the K and V rows at or past valid_len (not only past Tk, where
    # TMA zero-fills): bf16 D=64, every output bitwise as with finite rows
    for T in (37, 200, 512):
        for causal in (False, True):
            lens = [T, T // 2 + 3, 1, 0]
            q, k, v, do, vl = flash_inputs(torch, gen, len(lens), 12, T, T,
                                           64, lens, torch.bfloat16)
            dead = (torch.arange(T, device="cuda")[None, :] >=
                    vl.long()[:, None])[:, None, :, None].expand_as(k)
            nan = torch.full_like(k, float("nan"))
            runs = [flash_run(torch, fa, q, kk, vv, do, vl, causal)
                    for kk, vv in ((k, v), (torch.where(dead, nan, k),
                                            torch.where(dead, nan, v)))]
            for name, a, b in zip(FLASH_OUTPUTS, *runs):
                check(bool(torch.equal(a, b)),
                      f"flash bf16 T={T} causal={causal}: NaN past "
                      f"valid_len changed {name}")
            del q, k, v, do, vl, runs
    print("[flash] NaN in K/V past valid_len (bf16, D=64, T=37/200/512, "
          "causal and not): out, lse, dq, delta, dk, dv unchanged",
          flush=True)
    return err


def bert_batch(torch, np, rng, B, T, M, vocab, min_len, ctx=None):
    """The bench's batch tuple as ``nd.array``s (int32 indices, f32
    weights; on ``ctx``, the card by default): valid lengths drawn in
    [min_len, T] and M distinct masked positions inside each length."""
    from incubator_mxnet_tpu_torch import nd
    lens = rng.randint(min_len, T + 1, size=B)
    pos = np.stack([rng.choice(n, size=M, replace=False) for n in lens])
    arrays = (rng.randint(0, vocab, (B, T)), rng.randint(0, 2, (B, T)),
              lens, pos, rng.randint(0, vocab, (B, M)),
              np.ones((B, M), np.float32), rng.randint(0, 2, (B,)))
    return [nd.array(a, ctx=ctx, dtype="float32" if a.dtype == np.float32
                     else "int32") for a in arrays]


def tensors(batch):
    """The tensors of a batch of ``NDArray``s (what a step program
    stages)."""
    return [b._data for b in batch]


def bench_bert(seed, T, dtype="bfloat16", size="base", ctx=None,
               dropout=0.1):
    """bench.py's ``_run_bert`` model, through the same calls:
    ``mx.random.seed``, ``bert_base(dtype=, max_length=, flash=,
    remat=, dropout=)``, ``initialize()``, ``BERTForPretraining``,
    ``initialize()`` (on ``ctx``: the card by default)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    mx.random.seed(seed)
    ctor = bert_mod.bert_base if size == "base" else bert_mod.bert_tiny
    model = ctor(dtype=dtype, max_length=T, flash=True, remat=False,
                 dropout=dropout)
    model.initialize(ctx=ctx)
    pre = bert_mod.BERTForPretraining(model)
    pre.initialize(ctx=ctx)
    return pre


def bert_trainer(torch, T, seed, dtype="bfloat16", size="base", ctx=None,
                 dropout=0.1, lr=1e-4):
    from incubator_mxnet_tpu_torch import models, parallel
    pre = bench_bert(seed, T, dtype=dtype, size=size, ctx=ctx,
                     dropout=dropout)
    tr = parallel.SPMDTrainer(
        pre, forward_loss=models.pretraining_loss, optimizer="lamb",
        optimizer_params={"learning_rate": lr,
                          "multi_precision": dtype != "float32"},
        sharding="replicated")
    return pre, tr


def phase_training(torch, device_name):
    """The bench configuration: bert_base bf16 through SPMDTrainer with
    LAMB; returns its stats (with the flash launch counts of its run)
    and the batch's valid lengths."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.utils import flops
    import incubator_mxnet_tpu_torch as mx
    B, T, M = BERT["B"], BERT["T"], BERT["M"]
    pre, tr = bert_trainer(torch, T, 0)
    bert = pre.bert
    batch = bert_batch(torch, np, np.random.RandomState(0), B, T, M,
                       bert.vocab_size, 256)

    def step():
        mx.random.seed(1)         # a repeating batch: its dropout masks too
        return tr.step(*batch)

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    losses = [float(step()) for _ in range(BERT["warmup"])]
    # the step graph was built inside the warm-up: the timed steps replay
    check(tr.step_trace_count == 1 and len(tr._programs) == 1,
          f"training: {tr.step_trace_count} step programs built in the "
          f"warm-up")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(BERT["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    losses += [float(x) for x in timed]
    n_steps = BERT["warmup"] + BERT["steps"]
    check(all(np.isfinite(losses)), f"training: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"training: loss did not fall over {n_steps} steps: {losses}")
    check(tr.step_count == n_steps, f"training: {tr.step_count} of "
                                    f"{n_steps} steps applied")
    check(tr.step_trace_count == 1 and
          prog.replays - replays == BERT["steps"],
          f"training: {prog.replays - replays} of {BERT['steps']} timed "
          f"steps replayed, {tr.step_trace_count} builds")
    for name in FLASH:
        check(launches[name] == bert.num_layers * n_steps,
              f"training: {name} launches {launches[name]} != "
              f"{bert.num_layers} layers x {n_steps} steps")
    print(f"[capture] training: step_trace_count {tr.step_trace_count}, "
          f"eager first step {prog.first_ms:.1f} ms, capture "
          f"{prog.build_ms:.1f} ms, replays {prog.replays}", flush=True)
    step_flops = flops.bert_train_flops(B, T, M, bert.num_layers,
                                        bert.units, bert.hidden_size,
                                        bert.vocab_size)
    ms_step = dt * 1e3 / BERT["steps"]
    lens = batch[2].asnumpy().tolist()
    stats = dict(config=f"bert_base bf16 flash dropout=0.1 LAMB lr=1e-4 "
                        f"multi_precision B={B} T={T} M={M}",
                 losses=losses, ms_per_step=ms_step,
                 tokens_per_s=B * T / (ms_step / 1e3),
                 live_tokens_per_s=sum(lens) / (ms_step / 1e3),
                 flops_per_step=step_flops,
                 mfu=step_flops / (ms_step / 1e3) /
                 flops.peak_flops(device_name),
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                 peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                 step_trace_count=tr.step_trace_count,
                 first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
                 launches=launches)
    train_host_costs(torch, tr, prog, tensors(batch))
    # what the graph removed: the guarded LAMB apply over every parameter
    # run eagerly, op by op (host clock around it, synchronised)
    params = [tr._params[i] for i in tr._train_idx]
    zeros = [torch.zeros_like(p) for p in params]
    one = torch.ones((), device="cuda")
    lr = torch.full((), 1e-4, device="cuda")
    opt_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr._apply(zeros, one, lr, one)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t1) * 1e3)
    stats["eager_apply_ms"] = statistics.median(opt_ms)
    stats["n_params"] = len(params)
    # one profiled step: device-busy share and the attention kernels' part
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if kern:
        busy = sum(t for _, t in kern) / 1e3
        attn = {n: sum(t for k, t in kern
                       if re.search(rf"mxt::{n}_([mt]ma_)?kernel", k)) / 1e3
                for n in FLASH}
        stats.update(profiled_wall_ms=wall_ms, device_busy_ms=busy,
                     device_busy_share=busy / wall_ms,
                     attention_ms=attn,
                     attention_share_of_busy=sum(attn.values()) / busy,
                     top=[(k[:60], t / 1e3) for k, t in
                          sorted(kern, key=lambda kt: -kt[1])[:8]])
    else:
        stats["device_busy_share"] = "not measured (no kernel traced)"
    print(f"[training] {json.dumps(stats)}", flush=True)
    del tr, pre, bert, batch, params, zeros, prog
    torch.cuda.empty_cache()
    return stats, lens


def train_host_costs(torch, tr, prog, batch):
    """Host time of a replayed train step's own work (medians of 10, the
    device idle before each): staging the batch (device to device) and
    t / lr / scale (one copy), the launch (one replay), and the readback
    of loss and flag (one 8-byte transfer), once with the device idle and
    once right after the launch (then it waits for the step). Each replay
    applies an update, outside the step count."""
    def host_ms(before, fn, n=10):
        times = []
        for _ in range(n):
            before()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(times)

    import incubator_mxnet_tpu_torch as mx

    def stage():
        mx.random.seed(1)
        prog.stage(batch, tr.step_count + 1, tr.learning_rate, 1.0)

    def staged_replay():
        stage()
        prog.replay()

    out = dict(stage_ms=host_ms(lambda: None, stage),
               launch_ms=host_ms(stage, prog.replay),
               readback_idle_ms=host_ms(staged_replay, prog.read),
               readback_after_launch_ms=host_ms(stage, lambda: (
                   prog.replay(), prog.read())))
    print(f"[host] graphed train step (bert_base bf16 B={BERT['B']} "
          f"T={BERT['T']}): {json.dumps(out)}", flush=True)


def phase_long_sequence(torch):
    """bert_base at T=1024 (B=4, 2 steps): the lengths the JAX package
    sends to its streaming kernels; the same three kernels here."""
    import numpy as np
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    T = 1024
    pre, tr = bert_trainer(torch, T, 5)
    batch = bert_batch(torch, np, np.random.RandomState(5), 4, T,
                       BERT["M"], pre.bert.vocab_size, 512)
    fa.reset_launch_counts()
    losses = [float(tr.step(*batch)) for _ in range(2)]
    launches = dict(fa.LAUNCHES)
    check(all(np.isfinite(losses)), f"T=1024: non-finite loss {losses}")
    for name in FLASH:
        check(launches[name] == 2 * pre.bert.num_layers,
              f"T=1024: {name} launches {launches[name]}")
    replays = [p.replays for p in tr._programs.values()]
    check(tr.step_trace_count == 1 and replays == [1],
          f"T=1024: {tr.step_trace_count} builds, replays {replays}")
    print(f"[long] bert_base bf16 T=1024 B=4 lengths "
          f"{batch[2].asnumpy().tolist()}: losses {losses} (the second a replay of "
          f"the step graph), launches {launches}", flush=True)
    del tr, pre, batch
    torch.cuda.empty_cache()


# bert_tiny on the card against the port on the CPU: loss-sequence rtol;
# bf16 also each parameter's first-step gradient, |err| <= frac x that
# parameter's largest |CPU gradient|
BERT_PARITY_TOL = {"float32": (1e-4, None), "bfloat16": (2e-3, 5e-2)}


def phase_bert_parity(torch):
    """bert_tiny, 5 LAMB steps: the card (the flash kernels) against the
    port on the CPU (their plain versions), the same weights and batch,
    dropout 0. In f32 the kernels run their CUDA-core bodies; in bf16
    (D=64) the mma.sync bodies that bert_base trains on, so bf16 also
    holds every parameter's gradient of the first step."""
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    T, B, M, steps = 128, 8, 20, 5
    for dtype in ("float32", "bfloat16"):
        rtol, gfrac = BERT_PARITY_TOL[dtype]
        cpu_pre, cpu_tr = bert_trainer(
            torch, T, 7, dtype=dtype, size="tiny", ctx=mx.cpu(),
            dropout=0.0, lr=1e-3)
        gpu_pre, gpu_tr = bert_trainer(torch, T, 7, dtype=dtype,
                                       size="tiny", dropout=0.0, lr=1e-3)
        gpu_pre.load_state_dict(cpu_pre.state_dict())
        batch = bert_batch(torch, np, np.random.RandomState(7), B, T, M,
                           cpu_pre.bert.vocab_size, 32)
        cpu_batch = [b.as_in_context(mx.cpu()) for b in batch]
        if gfrac is not None:
            one = torch.ones((), device="cuda")
            _, g_card = gpu_tr._forward_backward(tensors(batch), one)
            _, g_cpu = cpu_tr._forward_backward(tensors(cpu_batch),
                                                one.cpu())
            worst = (0.0, "")
            for i, a, b in zip(cpu_tr._train_idx, g_card, g_cpu):
                name = cpu_tr._names[i]
                check(a.dtype == b.dtype and bool(torch.isfinite(a).all()),
                      f"bert_tiny {dtype}: gradient of {name} is "
                      f"{a.dtype}, finite {bool(torch.isfinite(a).all())}")
                d = float((a.cpu().float() - b.float()).abs().max())
                scale = float(b.float().abs().max())
                r = d / (gfrac * scale) if scale > 0 else \
                    (0.0 if d == 0 else float("inf"))
                worst = max(worst, (r, name))
            print(f"[bert-parity] bert_tiny {dtype} first-step gradients, "
                  f"{len(g_cpu)} parameters: worst |err| / tolerance "
                  f"{worst[0]:.3f} ({worst[1]}; tolerance {gfrac} x the "
                  f"parameter's largest |gradient|)", flush=True)
            check(worst[0] <= 1.0, f"bert_tiny {dtype}: the card's gradient "
                                   f"of {worst[1]} disagrees with the CPU's "
                                   f"({worst[0]:.2f} x its tolerance)")
            del g_card, g_cpu
        fa.reset_launch_counts()
        on_card = [float(gpu_tr.step(*batch)) for _ in range(steps)]
        launches = dict(fa.LAUNCHES)
        replays = [p.replays for p in gpu_tr._programs.values()]
        check(gpu_tr.step_trace_count == 1 and replays == [steps - 1],
              f"bert_tiny {dtype}: {gpu_tr.step_trace_count} builds, "
              f"replays {replays}")
        on_cpu = [float(cpu_tr.step(*cpu_batch)) for _ in range(steps)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
        print(f"[bert-parity] bert_tiny {dtype} LAMB: card {on_card} "
              f"(steps 2-{steps} replays of the step graph) vs cpu "
              f"{on_cpu}: max rel diff {rel:.3e} (rtol {rtol}), launches "
              f"{launches}", flush=True)
        check(rel <= rtol,
              f"bert_tiny {dtype} parity: card {on_card} vs cpu {on_cpu}")
        check(all(launches[n] == gpu_pre.bert.num_layers * steps
                  for n in FLASH),
              f"bert_tiny {dtype} parity: launches {launches}")
        check(all(np.isfinite(on_card)) and on_card[-1] < on_card[0],
              f"bert_tiny {dtype}: loss did not fall on the card {on_card}")
        del cpu_pre, cpu_tr, gpu_pre, gpu_tr, batch, cpu_batch
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# the MXNet front end on the card
# --------------------------------------------------------------------- #

GLUON = dict(B=32, T=512, M=76, steps=10, warmup=3)
# the gluon Trainer's first step against SPMDTrainer's, dropout off: the
# loss at rtol, every updated weight within this fraction of its tensor's
# largest |entry| (one bf16 rounding is 2^-8 of it)
GLUON_PARITY = dict(loss_rtol=2e-4, weight_frac=2 ** -7)


def gluon_drive(torch, np):
    """The verify drive (``.claude/skills/verify/SKILL.md`` steps 1-5)
    with ``incubator_mxnet_tpu_torch as mx`` on the card: nd arithmetic,
    a hand-computed gradient, HybridSequential(Dense, Activation, Dense)
    + SoftmaxCrossEntropyLoss + gluon.Trainer("sgd") for 30 steps eager
    and hybridized, and save / load_parameters in both formats."""
    import tempfile
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    a = nd.array([[1, 2], [3, 4]])
    check(a.context == mx.gpu(0) and a._data.is_cuda,
          f"gluon drive: nd.array on {a.context}, not the card")
    b = (a * 2 + 1) / 2 - a
    check(np.array_equal(b.asnumpy(), np.full((2, 2), 0.5, np.float32)),
          f"gluon drive: arithmetic gave {b.asnumpy()}")
    x = nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x * x).sum()
    y.backward()
    check(np.allclose(x.grad.asnumpy(), [3.0, 12.0, 27.0], rtol=1e-6),
          f"gluon drive: d(x^3)/dx = {x.grad.asnumpy()}")
    rng = np.random.RandomState(0)
    X = rng.randn(256, 20).astype(np.float32)
    Y = (X @ rng.randn(20, 4)).argmax(1).astype(np.float32)
    Xn, Yn = nd.array(X), nd.array(Y)
    runs = {}
    for hybrid in (False, True):
        mx.random.seed(0)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64), gluon.nn.Activation("relu"),
                gluon.nn.Dense(4))
        net.initialize(mx.init.Xavier())
        if hybrid:
            net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5}, kvstore="device")
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for _ in range(30):
            with autograd.record():
                L = loss_fn(net(Xn), Yn)
            L.backward()
            tr.step(X.shape[0])
            losses.append(float(L.mean().asscalar()))
        progs = list(tr._fused._programs.values())
        check(losses[-1] < 0.7 * losses[0],
              f"gluon drive (hybridize={hybrid}): loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, not below 0.7x")
        check(tr._fused.trace_count == 1 and tr._fused.call_count == 30 and
              all(p.graph is not None for p in progs),
              f"gluon drive: {tr._fused.trace_count} applier captures, "
              f"{tr._fused.call_count} calls")
        if hybrid:
            check(len(net._cached_op._cache) == 1,
                  f"gluon drive: {len(net._cached_op._cache)} cached "
                  f"signatures")
        runs[hybrid] = (net, losses)
    net, losses = runs[True]
    rel = max(abs(a - b) / b for a, b in zip(losses, runs[False][1]))
    out = net(Xn).asnumpy()
    same = {}
    with tempfile.TemporaryDirectory() as d:
        for fmt in ("mxtpu", "mxnet"):
            path = os.path.join(d, f"net.{fmt}")
            net.save_parameters(path, format=fmt)
            net2 = gluon.nn.HybridSequential()
            net2.add(gluon.nn.Dense(64), gluon.nn.Activation("relu"),
                     gluon.nn.Dense(4))
            net2.load_parameters(path, ctx=mx.gpu(0))
            same[fmt] = bool(np.array_equal(net2(Xn).asnumpy(), out))
    check(all(same.values()), f"gluon drive: outputs after the save / load "
                              f"round trip bitwise {same}")
    print(f"[gluon] verify drive on the card: x^3 gradient ok; 30 SGD "
          f"steps eager {runs[False][1][0]:.4f} -> {runs[False][1][-1]:.4f},"
          f" hybridized {losses[0]:.4f} -> {losses[-1]:.4f} (max rel diff "
          f"{rel:.2e}), one applier capture each; save/load bitwise "
          f"{same}", flush=True)


def gluon_state(trainer, pre):
    """Copies of every parameter and optimizer-state tensor of a gluon
    Trainer."""
    from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
    return [p.detach().clone() for p in pre.parameters()] + [
        x.clone() for s in trainer._updaters[0].states.values()
        for x in tree_leaves(s)]


def phase_gluon(torch, device_name):
    """bert_base bf16 trained through MXNet user code on the card
    (``autograd.record()``, ``loss.backward()``, ``gluon.Trainer`` with
    LAMB and f32 masters, its update two captured group programs and one
    all-finite program), then its first step against SPMDTrainer's with
    dropout off, and a skipped step."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
    from incubator_mxnet_tpu_torch.train import StepOutcome
    from incubator_mxnet_tpu_torch.utils import flops
    t_phase = time.perf_counter()
    gluon_drive(torch, np)
    B, T, M = GLUON["B"], GLUON["T"], GLUON["M"]
    opt = {"learning_rate": 1e-4, "multi_precision": True}
    pre = bench_bert(0, T)
    bert = pre.bert
    batch = bert_batch(torch, np, np.random.RandomState(0), B, T, M,
                       bert.vocab_size, 256)
    trainer = gluon.Trainer(pre.collect_params(), "lamb", dict(opt))
    app = trainer._fused
    issue = {"forward": [], "backward": []}

    def step():
        mx.random.seed(1)         # a repeating batch: its dropout masks too
        t0 = time.perf_counter()
        with autograd.record():
            L = bert_mod.pretraining_loss(pre, *batch)
        t1 = time.perf_counter()
        L.backward()
        t2 = time.perf_counter()
        trainer.step(1)
        issue["forward"].append((t1 - t0) * 1e3)
        issue["backward"].append((t2 - t1) * 1e3)
        return L

    def counts():
        return (app.trace_count, app.guard_trace_count,
                app.accum_trace_count)

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    losses = [float(step().asscalar())]
    first = counts()
    losses += [float(step().asscalar()) for _ in range(GLUON["warmup"] - 1)]
    check(first == (2, 1, 0) and counts() == first,
          f"gluon: applier captures {first} after the first step, "
          f"{counts()} after the warm-up (want 2 groups and one guard, as "
          f"the JAX Trainer traces for bert_base)")
    issue = {"forward": [], "backward": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(GLUON["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    losses += [float(x.asscalar()) for x in timed]
    n_steps = GLUON["warmup"] + GLUON["steps"]
    check(all(np.isfinite(losses)), f"gluon: non-finite loss {losses}")
    check(counts() == first, f"gluon: applier captures moved to "
                             f"{counts()} in the timed steps")
    check(trainer.last_outcome is StepOutcome.APPLIED and
          trainer.health[StepOutcome.APPLIED.value] == n_steps,
          f"gluon: outcomes {trainer.health}")
    for name in FLASH:
        check(launches[name] == bert.num_layers * n_steps,
              f"gluon: {name} launches {launches[name]} != "
              f"{bert.num_layers} layers x {n_steps} steps")
    ms_step = dt * 1e3 / GLUON["steps"]
    step_flops = flops.bert_train_flops(B, T, M, bert.num_layers,
                                        bert.units, bert.hidden_size,
                                        bert.vocab_size)
    host_ms = statistics.median(issue["forward"]) + \
        statistics.median(issue["backward"])
    stats = dict(config=f"bert_base bf16 flash dropout=0.1 gluon.Trainer "
                        f"LAMB lr=1e-4 multi_precision B={B} T={T} M={M}",
                 losses=losses, ms_per_step=ms_step,
                 tokens_per_s=B * T / (ms_step / 1e3),
                 mfu=step_flops / (ms_step / 1e3) /
                 flops.peak_flops(device_name),
                 forward_issue_ms=statistics.median(issue["forward"]),
                 backward_issue_ms=statistics.median(issue["backward"]),
                 host_share=host_ms / ms_step,
                 applier_captures=dict(zip(
                     ("trace_count", "guard_trace_count",
                      "accum_trace_count"), first)),
                 applier_calls=app.call_count, launches=launches,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if kern:
        busy = sum(kern) / 1e3
        stats.update(profiled_wall_ms=wall_ms, device_busy_ms=busy,
                     device_busy_share=busy / wall_ms)
    else:
        stats["device_busy_share"] = "not measured (no kernel traced)"
    print(f"[gluon] {json.dumps(stats)}", flush=True)

    # a skipped step: one poisoned gradient; weights and optimizer state
    # bitwise, no capture count moves
    before = gluon_state(trainer, pre)
    at = counts()
    mx.random.seed(1)
    with autograd.record():
        L = bert_mod.pretraining_loss(pre, *batch)
    L.backward()
    poisoned = pre.bert.layer3.ffn_in.weight.grad()
    poisoned._data.view(-1)[7] = float("nan")
    trainer.step(1)
    after = gluon_state(trainer, pre)
    changed = sum(not torch.equal(x, y) for x, y in zip(before, after))
    check(trainer.last_outcome is StepOutcome.SKIPPED_NONFINITE and
          changed == 0 and counts() == at and app.skipped_steps == 1,
          f"gluon skipped step: outcome {trainer.last_outcome}, "
          f"{changed} tensors changed, captures {at} -> {counts()}")
    print(f"[gluon] skipped step: SKIPPED_NONFINITE, {len(after)} weight "
          f"and state tensors bitwise, captures {counts()}", flush=True)
    del trainer, pre, bert, timed, before, after
    torch.cuda.empty_cache()

    # dropout off: the gluon Trainer's first step against SPMDTrainer's
    pre_a = bench_bert(3, T, dropout=0.0)
    pre_b = bench_bert(3, T, dropout=0.0)
    pre_b.load_state_dict(pre_a.state_dict())
    gt = gluon.Trainer(pre_a.collect_params(), "lamb", dict(opt))
    st = SPMDTrainer(pre_b, forward_loss=bert_mod.pretraining_loss,
                     optimizer="lamb", optimizer_params=dict(opt),
                     sharding="replicated")
    with autograd.record():
        La = bert_mod.pretraining_loss(pre_a, *batch)
    La.backward()
    gt.step(1)
    Lb = st.step(*batch)
    la, lb = float(La.asscalar()), float(Lb.asscalar())
    worst = (0.0, "")
    want = pre_b.state_dict()
    for name, got in pre_a.state_dict().items():
        ref = want[name].float()
        d = float((got.float() - ref).abs().max())
        scale = float(ref.abs().max())
        worst = max(worst, (d / (GLUON_PARITY["weight_frac"] * scale)
                            if scale > 0 else float(d > 0), name))
    print(f"[gluon] first step, dropout 0: gluon.Trainer loss {la!r} vs "
          f"SPMDTrainer {lb!r} (rel {abs(la - lb) / abs(lb):.2e}, rtol "
          f"{GLUON_PARITY['loss_rtol']}); updated weights: worst |diff| / "
          f"tolerance {worst[0]:.3f} ({worst[1]}; tolerance "
          f"{GLUON_PARITY['weight_frac']} x the tensor's largest |entry|)",
          flush=True)
    check(abs(la - lb) <= GLUON_PARITY["loss_rtol"] * abs(lb),
          f"gluon vs SPMDTrainer first-step loss {la} vs {lb}")
    check(worst[0] <= 1.0, f"gluon vs SPMDTrainer: updated {worst[1]} "
                           f"differs ({worst[0]:.2f} x the tolerance)")
    del gt, st, pre_a, pre_b, batch, want
    torch.cuda.empty_cache()
    print(f"[gluon] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return stats


# --------------------------------------------------------------------- #
# convolutional vision training
# --------------------------------------------------------------------- #

VISION = dict(B=64, side=224, steps=10, warmup=3, classes=1000,
              gflop_per_image=4.1)
VISION_PARITY = dict(B=32, side=32, steps=3, loss_rtol=1e-4, scale=1e-3,
                     floor=1e-5)
VISION_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of the largest |ref|
# (name, op, input shapes, keywords)
VISION_OPS = [
    ("conv1d", "Convolution", [(4, 8, 37), (16, 8, 5), (16,)],
     dict(kernel=(5,), stride=(2,), pad=(2,), num_filter=16)),
    ("conv2d-dilate", "Convolution", [(4, 16, 29, 31), (32, 16, 3, 3),
                                      (32,)],
     dict(kernel=(3, 3), stride=(2, 1), dilate=(2, 2), pad=(2, 1),
          num_filter=32)),
    ("conv2d-256", "Convolution", [(8, 256, 14, 14), (256, 256, 3, 3)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=256, no_bias=True)),
    ("conv2d-groups", "Convolution", [(4, 32, 15, 15), (64, 8, 3, 3)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=64, num_group=4,
          no_bias=True)),
    ("conv2d-depthwise", "Convolution", [(4, 64, 28, 28), (64, 1, 3, 3)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=64,
          num_group=64, no_bias=True)),
    ("conv3d", "Convolution", [(2, 4, 9, 10, 11), (8, 4, 3, 3, 3), (8,)],
     dict(kernel=(3, 3, 3), stride=(1, 2, 2), pad=(1, 1, 1),
          num_filter=8)),
    ("deconv2d-adj", "Deconvolution", [(4, 16, 13, 13), (16, 8, 4, 4),
                                       (8,)],
     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=8, no_bias=False)),
    ("max-valid-pad", "Pooling", [(8, 64, 112, 112)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")),
    ("max-full", "Pooling", [(4, 32, 7, 7)],
     dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
          pooling_convention="full")),
    ("max-full-pad", "Pooling", [(4, 32, 7, 6)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
          pooling_convention="full")),
    ("avg-full-pad", "Pooling", [(4, 32, 7, 7)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full")),
    ("avg-full-exclude", "Pooling", [(4, 32, 7, 7)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full", count_include_pad=False)),
    ("avg-valid-exclude", "Pooling", [(4, 32, 7, 7)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          count_include_pad=False)),
    ("sum-full", "Pooling", [(4, 32, 9, 9)],
     dict(kernel=(2, 2), stride=(2, 2), pool_type="sum",
          pooling_convention="full")),
    ("global-avg", "Pooling", [(8, 2048, 7, 7)],
     dict(global_pool=True, pool_type="avg")),
    ("adaptive", "AdaptiveAvgPooling2D", [(4, 32, 13, 11)],
     dict(output_size=(3, 4))),
]


def _rel_err(torch, got, want):
    """max |got - want| over max |want|, in f64 on the host."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def vision_ops(torch, np):
    """Each VISION_OPS case on the card against the port on the CPU: f32
    forward and gradients, bf16 forward (its reference: the CPU on the
    bf16-rounded inputs in f32). cuDNN's f32 convolutions are left at
    torch's TF32 default here, so only the ops' own per-call setting
    keeps them IEEE f32; a direct F.conv2d on conv2d-256 is the
    control."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, nd
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    conv.fp32_precision = "tf32"
    worst = {}
    try:
        rng = np.random.RandomState(0)
        for name, op, shapes, kw in VISION_OPS:
            arrays = [rng.randn(*sh).astype(np.float32) for sh in shapes]
            fn = getattr(nd, op)
            res = {}
            for ctx in (mx.cpu(), mx.gpu(0)):
                xs = [nd.array(a, ctx=ctx) for a in arrays]
                for x in xs:
                    x.attach_grad()
                with autograd.record():
                    out = fn(*xs, **kw)
                    r = nd.array(np.random.RandomState(1).randn(
                        *out.shape).astype(np.float32), ctx=ctx)
                    (out * r).sum().backward()
                res[ctx.device_type] = [out._data] + [x.grad._data
                                                      for x in xs]
            errs = [_rel_err(torch, g, c)
                    for g, c in zip(res["gpu"], res["cpu"])]
            bf = [nd.array(a, ctx=mx.gpu(0)).astype("bfloat16")
                  for a in arrays]
            ref = fn(*[nd.array(b._data.float().cpu(), ctx=mx.cpu())
                       for b in bf], **kw)
            got = fn(*bf, **kw)
            check(str(got.dtype) == "bfloat16",
                  f"vision op {name}: bf16 in, {got.dtype} out")
            bf_err = _rel_err(torch, got._data, ref._data)
            check(max(errs) <= VISION_TOL["float32"],
                  f"vision op {name}: f32 card vs CPU (output, gradients) "
                  f"{errs} > {VISION_TOL['float32']}")
            check(bf_err <= VISION_TOL["bfloat16"],
                  f"vision op {name}: bf16 card vs CPU {bf_err:.2e} > "
                  f"{VISION_TOL['bfloat16']}")
            worst[name] = dict(f32=max(errs), bf16=bf_err)
        x = torch.tensor(rng.randn(8, 256, 14, 14).astype(np.float32))
        w = torch.tensor(rng.randn(256, 256, 3, 3).astype(np.float32))
        want = torch.nn.functional.conv2d(x, w, padding=1)
        control = _rel_err(torch, torch.nn.functional.conv2d(
            x.cuda(), w.cuda(), padding=1), want)
        port = _rel_err(torch, nd.Convolution(
            nd.array(x.numpy(), ctx=mx.gpu(0)),
            nd.array(w.numpy(), ctx=mx.gpu(0)), kernel=(3, 3), pad=(1, 1),
            num_filter=256, no_bias=True)._data, want)
    finally:
        conv.fp32_precision = old
    print(f"[vision] ops: {len(VISION_OPS)} cases card vs CPU, worst f32 "
          f"{max(v['f32'] for v in worst.values()):.2e}, bf16 "
          f"{max(v['bf16'] for v in worst.values()):.2e}; TF32 control: "
          f"F.conv2d {control:.2e}, nd.Convolution {port:.2e}", flush=True)
    return dict(worst=worst, tf32_control=control, port_under_tf32=port)


def vision_resnet50(torch, np, device_name):
    """bench.py's _run_resnet on the card: resnet50_v1 bf16 through
    SPMDTrainer with SGD, one CUDA graph."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, parallel
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.utils import flops
    B, side = VISION["B"], VISION["side"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(0)
    net = resnet50_v1()
    net.initialize()
    rng0 = np.random.RandomState(0)
    net(nd.array(rng0.rand(1, 3, side, side).astype("float32")))
    net.cast("bfloat16")
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(B, 3, side, side).astype("float32")) \
        .astype("bfloat16")
    y = nd.array(rng.randint(0, VISION["classes"], (B,)), dtype="int32")
    tr = parallel.SPMDTrainer(
        net, loss=gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                          "multi_precision": True},
        sharding="replicated")
    stats = {k: p for k, p in net._collect_params_with_prefix().items()
             if "running_" in k}
    before = {k: p.data()._data.clone() for k, p in stats.items()}
    losses = [float(tr.step(x, y).asnumpy())
              for _ in range(VISION["warmup"])]
    check(tr.step_trace_count == 1 and len(tr._programs) == 1,
          f"resnet50: {tr.step_trace_count} step programs built in the "
          f"warm-up")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [tr.step(x, y) for _ in range(VISION["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [float(v.asnumpy()) for v in timed]
    n_steps = VISION["warmup"] + VISION["steps"]
    check(all(np.isfinite(losses)), f"resnet50: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"resnet50: loss did not fall over {n_steps} steps: {losses}")
    check(tr.step_count == n_steps and tr.step_trace_count == 1 and
          prog.replays - replays == VISION["steps"],
          f"resnet50: {tr.step_count} steps applied, "
          f"{prog.replays - replays} of {VISION['steps']} timed steps "
          f"replayed, {tr.step_trace_count} builds")
    moved = sum(not torch.equal(p.data()._data, before[k])
                for k, p in stats.items())
    finite = all(bool(torch.isfinite(p.data()._data).all())
                 for p in stats.values())
    check(moved == len(stats) and finite and len(stats) == 106,
          f"resnet50: {moved} of {len(stats)} running statistics moved, "
          f"finite {finite}")
    ms = dt * 1e3 / VISION["steps"]
    img_s = B / (ms / 1e3)
    out = dict(config=f"resnet50_v1 bf16 B={B} {side}x{side} SGD lr 0.1 "
                      f"momentum 0.9 multi_precision",
               losses=losses, ms_per_step=ms, img_per_s=img_s,
               mfu=img_s * 3 * VISION["gflop_per_image"] * 1e9
               / flops.peak_flops(device_name),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
               step_trace_count=tr.step_trace_count,
               replays=prog.replays)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        tr.step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if kern:
        busy = sum(t for _, t, _ in kern) / 1e3
        layout = sum(t for k, t, _ in kern if re.search(
            r"nchwToNhwc|nhwcToNchw|[Tt]ranspose", k)) / 1e3
        # PyTorch's own kernels: BatchNorm's passes, casts, ReLU, the
        # residual adds, the SGD apply; the rest is cuDNN / cuBLAS
        aten = sum(t for k, t, _ in kern if "at::native" in k) / 1e3
        out.update(profiled_wall_ms=wall_ms, device_busy_ms=busy,
                   device_busy_share=busy / wall_ms,
                   layout_transpose_ms=layout,
                   layout_transpose_share_of_busy=layout / busy,
                   aten_elementwise_reduce_ms=aten,
                   aten_share_of_busy=aten / busy,
                   cudnn_cublas_ms=busy - aten - layout,
                   cudnn_cublas_share_of_busy=(busy - aten - layout)
                   / busy,
                   top=[(k[:90], round(t / 1e3, 3), n) for k, t, n in
                        sorted(kern, key=lambda e: -e[1])[:14]])
    else:
        out["device_busy_share"] = "not measured (no kernel traced)"
    print(f"[capture] resnet50: step_trace_count {tr.step_trace_count}, "
          f"eager first step {prog.first_ms:.1f} ms, capture "
          f"{prog.build_ms:.1f} ms, replays {prog.replays}", flush=True)
    del tr, net, x, y, prog, stats, before
    torch.cuda.empty_cache()
    return out


def vision_parity(torch, np):
    """resnet18_v1(thumbnail=True, classes=10) f32: SGD steps on the card
    against the port on the CPU from the same weights, cuDNN's f32
    convolutions left at torch's TF32 default (the ops set IEEE)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
    P = VISION_PARITY
    rng = np.random.RandomState(0)
    x = rng.rand(P["B"], 3, P["side"], P["side"]).astype(np.float32)
    y = rng.randint(0, 10, (P["B"],)).astype(np.int32)
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    conv.fp32_precision = "tf32"
    runs = {}
    try:
        state = None
        for ctx in (mx.cpu(), mx.gpu(0)):
            mx.random.seed(0)
            net = resnet18_v1(thumbnail=True, classes=10)
            net.initialize(ctx=ctx)
            net(nd.array(x, ctx=ctx))
            if state is None:
                state = {k: v.clone() for k, v in net.state_dict().items()}
            net.load_state_dict(state)
            tr = SPMDTrainer(net, loss=gloss.SoftmaxCrossEntropyLoss(),
                             optimizer="sgd",
                             optimizer_params={"learning_rate": 1e-3,
                                               "momentum": 0.9})
            xs, ys = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx,
                                                    dtype="int32")
            losses = [float(tr.step(xs, ys).asnumpy())
                      for _ in range(P["steps"])]
            runs[ctx.device_type] = (losses, {
                k: p.data()._data.detach().cpu() for k, p in
                net._collect_params_with_prefix().items()}, tr)
    finally:
        conv.fp32_precision = old
    (lc, pc, _), (lg, pg, trg) = runs["cpu"], runs["gpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    check(loss_err <= P["loss_rtol"],
          f"resnet18 card vs CPU: losses {lg} vs {lc}")
    check(trg.step_trace_count == 1 and
          next(iter(trg._programs.values())).replays == P["steps"] - 1,
          "resnet18 on the card: not one capture and replays")
    # a tensor within scale x its largest |entry| (a weight near 0 has no
    # relative precision of its own), or floor: a BatchNorm beta is a
    # sum with cancellation; after 3 steps one of 3.3e-4 is 6.7e-6 off
    # float64 in f32 (tools/torch_vision_conditioning.py float64)
    errs = {k: float((pg[k] - pc[k]).abs().max()) for k in pc}
    bad = {k: (e, float(pc[k].abs().max())) for k, e in errs.items()
           if e > P["scale"] * float(pc[k].abs().max()) + P["floor"]}
    check(not bad, f"resnet18 card vs CPU: {len(bad)} tensors past "
                   f"{P['scale']} x max + {P['floor']}: "
                   f"{sorted(bad.items())[:6]}")
    worst = max(errs[k] / float(pc[k].abs().max().clamp_min(1e-30))
                for k in pc)
    print(f"[vision] resnet18_v1 thumbnail f32 B={P['B']} card vs CPU: "
          f"losses {lg} vs {lc} (max rel {loss_err:.2e}); {len(pc)} "
          f"parameters and running statistics within {P['scale']} x "
          f"their largest |entry| + {P['floor']} (worst {worst:.2e} of "
          f"the largest)", flush=True)
    return dict(losses_card=lg, losses_cpu=lc, loss_rel_err=loss_err,
                worst_param_rel=worst)


def vision_lenet(torch, np):
    """BASELINE.md config #1 as users write it, on the card."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, metric
    from incubator_mxnet_tpu_torch.gluon.data.vision import (MNIST,
                                                             transforms)
    mx.random.seed(0)
    data = gluon.data.DataLoader(
        MNIST(synthetic=True).transform_first(transforms.ToTensor()),
        batch_size=64)
    net = mx.models.LeNet()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(3):
        acc.reset()
        for x, y in data:
            x = gluon.utils.split_and_load(x, [mx.gpu(0)])[0]
            y = gluon.utils.split_and_load(y, [mx.gpu(0)])[0]
            with autograd.record():
                out = net(x)
                L = loss_fn(out, y)
            L.backward()
            trainer.step(x.shape[0])
            acc.update(y, out)
            losses.append(L.mean())
    accuracy = acc.get()[1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v.asnumpy()) for v in losses]
    check(acc.sum_metric.is_cuda and out.context == mx.gpu(0),
          "lenet: the metric or the net is not on the card")
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    check(np.isfinite(losses).all() and last < 0.5 * first,
          f"lenet: loss {first:.4f} -> {last:.4f}, not below half")
    out = dict(batches=len(losses), batches_per_s=len(losses) / wall,
               loss_first20=first, loss_last20=last,
               last_epoch_accuracy=accuracy)
    print(f"[vision] lenet: {len(losses)} batches, loss {first:.4f} -> "
          f"{last:.4f}, accuracy {accuracy:.4f}, "
          f"{len(losses) / wall:.1f} batches/s", flush=True)
    return out


def phase_vision(torch, smi):
    """The vision slice on the card (module docstring, phase 7c)."""
    import numpy as np
    t0 = time.perf_counter()
    out = dict(card=smi, ops=vision_ops(torch, np),
               resnet50=vision_resnet50(torch, np,
                                        torch.cuda.get_device_name(0)),
               parity=vision_parity(torch, np), lenet=vision_lenet(torch, np))
    out["phase_s"] = time.perf_counter() - t0
    print(f"[vision] {json.dumps(out)}", flush=True)


# --------------------------------------------------------------------- #
# GPT causal-LM training and the WMT Transformer's beam search
# --------------------------------------------------------------------- #

def gpt_trainer(model, lr=1e-4):
    """bench.py ``_run_gpt``'s trainer: ``SPMDTrainer(forward_loss=
    lm_loss)``, AdamW, f32 masters for a bf16 model."""
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.models import gpt as gpt_mod
    return parallel.SPMDTrainer(
        model, forward_loss=gpt_mod.lm_loss, optimizer="adamw",
        optimizer_params={"learning_rate": lr,
                          "multi_precision": model._dtype != "float32"},
        sharding="replicated")


def busy_share(torch, fn, pattern=None):
    """One profiled call of ``fn``: wall ms, device-busy ms and share, the
    top device operations and (with ``pattern``, a regex over kernel
    names) that group's share of busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        return dict(device_busy_share="not measured (no kernel traced)")
    busy = sum(t for _, t in kern) / 1e3
    out = dict(profiled_wall_ms=wall_ms, device_busy_ms=busy,
               device_busy_share=busy / wall_ms,
               top=[(k[:60], t / 1e3) for k, t in
                    sorted(kern, key=lambda kt: -kt[1])[:8]])
    if pattern is not None:
        group = sum(t for k, t in kern if re.search(pattern, k)) / 1e3
        out.update(group_ms=group, group_share_of_busy=group / busy)
    return out


def gpt_mini_parity(torch, np):
    """gpt_mini f32 (dropout 0, flash: the f32 kernel bodies on the card)
    from one set of weights on the card and on the CPU: 3 AdamW steps,
    the losses within 1e-5 relative; greedy_generate's tokens equal."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.models import gpt as gpt_mod

    def build(ctx, like=None):
        mx.random.seed(2)
        m = gpt_mod.gpt_mini(vocab_size=512, max_length=128, flash=True)
        m.initialize(ctx=ctx)
        if like is not None:
            m.load_state_dict(like.state_dict())
        return m

    rng = np.random.RandomState(3)
    X = rng.randint(0, 512, (8, 65))
    prompt = rng.randint(0, 512, (2, 16))
    cpu = build(mx.cpu())
    card = build(mx.gpu(0), like=cpu)
    gen_cpu = gpt_mod.greedy_generate(cpu, prompt, max_new_tokens=16)
    gen_card = gpt_mod.greedy_generate(card, prompt, max_new_tokens=16)
    losses = {}
    for name, m, ctx in (("card", card, mx.gpu(0)), ("cpu", cpu, mx.cpu())):
        tr = gpt_trainer(m, lr=1e-3)
        batch = [nd.array(a, ctx=ctx, dtype="int32")
                 for a in (X[:, :-1], X[:, 1:])]
        losses[name] = [float(tr.step(*batch).asnumpy()) for _ in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["cpu"]))
    same = bool((gen_cpu.asnumpy() == gen_card.asnumpy()).all())
    print(f"[gpt_training] gpt_mini f32 card vs CPU: losses {losses}, max "
          f"relative difference {rel:.3e}; greedy_generate tokens equal "
          f"{same}", flush=True)
    check(rel <= 1e-5, f"gpt_mini f32: card losses {losses['card']} vs "
                       f"CPU {losses['cpu']} (rel {rel:.2e} > 1e-5)")
    check(same, f"gpt_mini greedy_generate: card {gen_card.asnumpy()} != "
                f"CPU {gen_cpu.asnumpy()}")
    return dict(losses=losses, max_rel=rel, greedy_equal=same)


def phase_gpt_training(torch, smi):
    """bench.py ``_run_gpt``'s configuration: gpt_small bf16 (flash,
    dropout 0.1) through SPMDTrainer(forward_loss=lm_loss) with AdamW (lr
    1e-4, f32 masters), B=16, T=512, one repeating batch (its dropout
    masks too): 3 warm-up steps (the first eager, the capture after it)
    and 10 timed replays, each launching the causal flash forward, dq and
    dk/dv once a layer; beside it a trainer each with remat=True and
    "dots" (first-step loss, one capture, peak memory), and gpt_mini f32
    on the card against the CPU. Returns the run's stats, with the
    flash launch counts of the timed replays (counts set to 0 just
    before them)."""
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.utils import flops
    t_phase = time.perf_counter()
    B, T = GPT["B"], GPT["T"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = bench_gpt(0, flash=True, dropout=0.1)
    L, V = model.num_layers, model.vocab_size
    rng = np.random.RandomState(0)
    batch = [nd.array(rng.randint(0, V, (B, T)), ctx=mx.gpu(0),
                      dtype="int32") for _ in range(2)]
    tr = gpt_trainer(model)

    def step(trainer):
        mx.random.seed(1)         # a repeating batch: its dropout masks too
        return trainer.step(*batch)

    losses = [float(step(tr).asnumpy()) for _ in range(GPT["warmup"])]
    check(tr.step_trace_count == 1 and len(tr._programs) == 1,
          f"gpt_training: {tr.step_trace_count} step programs built in "
          f"the warm-up")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    timed = [step(tr) for _ in range(GPT["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES, **fa.CAUSAL_LAUNCHES)
    losses += [float(x.asnumpy()) for x in timed]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = GPT["warmup"] + GPT["steps"]
    check(all(np.isfinite(losses)), f"gpt_training: non-finite loss "
                                    f"{losses}")
    check(losses[-1] < losses[0],
          f"gpt_training: loss did not fall over {n_steps} steps: {losses}")
    check(tr.step_count == n_steps, f"gpt_training: {tr.step_count} of "
                                    f"{n_steps} steps applied")
    check(tr.step_trace_count == 1 and
          prog.replays - replays == GPT["steps"],
          f"gpt_training: {prog.replays - replays} of {GPT['steps']} "
          f"timed steps replayed, {tr.step_trace_count} builds")
    for name in FLASH:
        want = L * GPT["steps"]
        check(launches[name + "_causal"] == want == launches[name],
              f"gpt_training: {name} launches {launches[name]} (causal "
              f"{launches[name + '_causal']}) over {GPT['steps']} replays "
              f"!= {L} layers a replay")
    print(f"[capture] gpt_training: step_trace_count "
          f"{tr.step_trace_count}, eager first step {prog.first_ms:.1f} "
          f"ms, capture {prog.build_ms:.1f} ms, replays {prog.replays}",
          flush=True)
    step_flops = flops.gpt_train_flops(B, T, L, model.units,
                                       model.hidden_size, V)
    ms_step = dt * 1e3 / GPT["steps"]
    stats = dict(card=smi,
                 config=f"gpt_small bf16 flash dropout=0.1 AdamW lr=1e-4 "
                        f"multi_precision B={B} T={T}",
                 losses=losses, ms_per_step=ms_step,
                 tokens_per_s=B * T / (ms_step / 1e3),
                 flops_per_step=step_flops,
                 mfu=step_flops / (ms_step / 1e3) /
                 flops.peak_flops(torch.cuda.get_device_name(0)),
                 peak_memory_gb=peak_gb,
                 step_trace_count=tr.step_trace_count,
                 first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
                 launches=launches)
    prof = busy_share(torch, lambda: step(tr),
                      r"mxt::flash_(fwd|bwd_dq|bwd_dkv)_([mt]ma_)?kernel")
    if "group_ms" in prof:
        prof["attention_ms"] = prof.pop("group_ms")
        prof["attention_share_of_busy"] = prof.pop("group_share_of_busy")
    stats.update(prof)
    first = losses[0]
    del tr, model, prog, timed
    gc.collect()
    torch.cuda.empty_cache()
    remat = {}
    for mode in (True, "dots"):
        torch.cuda.reset_peak_memory_stats()
        m = bench_gpt(0, flash=True, dropout=0.1, remat=mode)
        rt = gpt_trainer(m)
        rl = [float(step(rt).asnumpy()) for _ in range(3)]
        torch.cuda.synchronize()
        rprog = next(iter(rt._programs.values()))
        diff = abs(rl[0] - first)
        remat[str(mode)] = dict(
            losses=rl, first_loss_diff=diff,
            loss_diffs=[abs(a - b) for a, b in zip(rl, losses)],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            step_trace_count=rt.step_trace_count,
            capture_ms=rprog.build_ms, replays=rprog.replays)
        check(rt.step_trace_count == 1 and rprog.replays == 2,
              f"gpt_training remat={mode!r}: {rt.step_trace_count} builds, "
              f"{rprog.replays} replays")
        check(all(np.isfinite(rl)) and diff <= 1e-2 * abs(first),
              f"gpt_training remat={mode!r}: first loss {rl[0]} vs "
              f"{first} without remat")
        del rt, m, rprog
        gc.collect()
        torch.cuda.empty_cache()
    stats["remat"] = remat
    print(f"[gpt_training] peak memory (GB): remat False {peak_gb:.2f}, "
          f"True {remat['True']['peak_memory_gb']:.2f}, dots "
          f"{remat['dots']['peak_memory_gb']:.2f}", flush=True)
    stats["parity"] = gpt_mini_parity(torch, np)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"[gpt_training] {json.dumps(stats)}", flush=True)
    return stats


def host_state(torch, tr):
    """A synchronous host copy of an SPMDTrainer's parameters and
    optimizer leaves (and the card's generator state), in capsule
    order."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
    torch.cuda.synchronize()
    out = {f"param/{i}": p.detach().to("cpu", copy=True)
           for i, p in enumerate(tr._params)}
    for i, st in enumerate(tr._opt_state):
        for j, leaf in enumerate(tree_leaves(st)):
            out[f"opt/{i}/{j}"] = leaf.to("cpu", copy=True)
    out["generator"] = mx.random.generator(tr.device).get_state()
    return out


def same_state(torch, want, tr):
    """Every parameter, optimizer leaf and the generator state of ``tr``
    bitwise ``want`` (a ``host_state``)."""
    got = host_state(torch, tr)
    return sorted(got) == sorted(want) and all(
        torch.equal(got[k], want[k]) for k in want)


def committed_equals(torch, np, arrays, want):
    """A committed step's ``param/`` and ``opt/`` entries bitwise the host
    copy ``want``."""
    from incubator_mxnet_tpu_torch.checkpoint.capsule import host_leaf
    keys = {k for k in want if k != "generator"}
    stored = {k for k in arrays if k.startswith(("param/", "opt/"))}
    return stored == keys and all(
        np.array_equal(arrays[k], host_leaf(want[k])[1]) for k in keys)


def target_run(tmp, tag, env_extra):
    """``train.example_target`` on the card under a ``train.Supervisor``;
    returns the report and the per-step loss map."""
    from incubator_mxnet_tpu_torch.train import Supervisor
    ckpt_dir = os.path.join(tmp, f"target_{tag}")
    results = os.path.join(tmp, f"target_{tag}.jsonl")
    os.makedirs(ckpt_dir)
    env = {"PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
           "MXTPU_TGT_CKPT_DIR": ckpt_dir, "MXTPU_TGT_RESULTS": results,
           "MXTPU_TGT_STEPS": "14", "MXTPU_TGT_SAVE_EVERY": "2"}
    env.update(env_extra)
    sup = Supervisor(
        [sys.executable, "-m",
         "incubator_mxnet_tpu_torch.train.example_target"],
        ckpt_dir=ckpt_dir, progress_file=results, max_restarts=4,
        backoff_s=0.05, env=env)
    report = sup.run(raise_on_failure=False)
    losses = {}
    if os.path.exists(results):
        with open(results) as f:
            for line in f:
                rec = json.loads(line)
                losses[rec["step"]] = rec["loss"]
    return report, losses


def checkpoint_supervisor(tmp):
    """The clean target run (in a thread) beside the one killed at steps
    5 and 9: two restarts, the per-step losses equal."""
    clean = {}
    th = threading.Thread(target=lambda: clean.update(
        zip(("report", "losses"), target_run(tmp, "clean", {}))))
    th.start()
    report, killed = target_run(tmp, "killed", {"MXTPU_TGT_KILL_AT": "5,9"})
    th.join(timeout=600)
    check(not th.is_alive() and "report" in clean and
          clean["report"].completed,
          f"checkpoint: the clean example_target run did not complete: "
          f"{clean.get('report') and clean['report'].summary()}")
    check(report.completed and report.restarts == 2,
          f"checkpoint: the killed example_target run: {report.summary()}")
    check(killed == clean["losses"] and sorted(killed) == list(range(14)),
          f"checkpoint: supervised losses {killed} != uninterrupted "
          f"{clean['losses']}")
    return dict(restarts=report.restarts,
                attempts=[a.reason for a in report.attempts],
                wall_s=report.total_wall_s, steps=len(killed))


def phase_checkpoint(torch, smi):
    """Checkpointing on gpt_small (see the module's docstring, 7f)."""
    import tempfile
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.checkpoint import CheckpointManager
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    t_phase = time.perf_counter()
    B, T = GPT["B"], GPT["T"]
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mxt_ckpt_")
    sup_thread = None
    try:
        def trainer(seed):
            return gpt_trainer(bench_gpt(seed, flash=True, dropout=0.1))

        def steps(tr, idx):
            return [float(tr.step(*batches[i]).asnumpy()) for i in idx]

        # two uninterrupted runs: what "the same steps" give on this card
        ref_tr = trainer(0)
        V = ref_tr.block.vocab_size
        rng = np.random.RandomState(0)
        batches = [[nd.array(rng.randint(0, V, (B, T)), ctx=mx.gpu(0),
                             dtype="int32") for _ in range(2)]
                   for _ in range(8)]
        mx.random.seed(1)
        ref = steps(ref_tr, range(8))
        del ref_tr
        gc.collect()
        tr = trainer(0)
        mx.random.seed(1)
        losses = steps(tr, range(2))
        mgr = CheckpointManager(tmp + "/run", keep=3)
        tr.save_checkpoint(mgr, step=2)
        gather_cold_ms = mgr.last_gather_ms
        mgr.wait()
        losses += steps(tr, range(2, 4))
        at4 = host_state(torch, tr)
        saved = tr.save_checkpoint(mgr, step=4)
        gather_ms = mgr.last_gather_ms
        in_flight = 0
        for i in range(4, 8):
            losses += steps(tr, [i])
            in_flight += mgr._pending is not None
        mgr.wait()
        write_ms = mgr.last_write_ms
        print(f"[checkpoint] gather ms cold {gather_cold_ms:.1f}, warm "
              f"{gather_ms:.1f}; write ms {write_ms:.1f}; steps 5-8 "
              f"finished during the write: {in_flight}; losses {losses}, "
              f"uninterrupted {ref}", flush=True)
        check(saved == 4 and mgr.all_steps() == [2, 4],
              f"checkpoint: committed steps {mgr.all_steps()}")
        check(in_flight >= 1, "checkpoint: the step-4 write had finished "
                              "before step 5 did")
        arrays, meta = mgr.restore(4)
        check(committed_equals(torch, np, arrays, at4),
              "checkpoint: the committed step 4 differs from the host copy "
              "taken at step 4")
        del arrays
        bitwise = losses == ref
        spread = max(abs(a - b) for a, b in zip(losses, ref))

        def held(got, want):
            if bitwise:
                return got == want
            return all(abs(a - b) <= spread for a, b in zip(got, want))

        check(held(losses, ref), f"checkpoint: {losses} vs {ref}")

        # restore into the same trainer: no new capture
        prog = next(iter(tr._programs.values()))
        builds = tr.step_trace_count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.restore_checkpoint(mgr, step=4)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(same_state(torch, at4, tr) and tr.step_count == 4,
              "checkpoint: the restored state differs from step 4's")
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = steps(tr, range(4, 8))
        ms_step = (time.perf_counter() - t0) * 1e3 / 4
        launches = dict(fa.CAUSAL_LAUNCHES)
        print(f"[checkpoint] restore ms {restore_ms:.1f}; resumed "
              f"{resumed}; causal launches {launches}; "
              f"{tr.step_trace_count} step programs", flush=True)
        check(tr.step_trace_count == builds == 1 and
              len(tr._programs) == 1,
              f"checkpoint: {tr.step_trace_count} step programs after the "
              f"restore")
        check(all(n == 12 * 4 for n in launches.values()),
              f"checkpoint: causal flash launches {launches} over 4 "
              f"replays != 12 a replay")
        check(held(resumed, losses[4:]),
              f"checkpoint: resumed losses {resumed} vs {losses[4:]} "
              f"({'bitwise' if bitwise else f'spread {spread:g}'})")
        replays = prog.replays
        num_update = tr._optimizer.num_update
        del tr, prog
        gc.collect()
        torch.cuda.empty_cache()

        # restore into a fresh trainer from another seed
        fresh = trainer(5)
        t0 = time.perf_counter()
        fresh.restore_checkpoint(mgr, step=4)
        torch.cuda.synchronize()
        fresh_restore_ms = (time.perf_counter() - t0) * 1e3
        check(same_state(torch, at4, fresh) and fresh.step_count == 4 and
              fresh._optimizer.num_update == meta["num_update"],
              "checkpoint: the fresh trainer's restored state differs")
        fresh_loss = steps(fresh, [4])
        print(f"[checkpoint] fresh trainer: restore ms "
              f"{fresh_restore_ms:.1f}, step-5 loss {fresh_loss[0]!r}",
              flush=True)
        check(fresh.step_trace_count == 1 and np.isfinite(fresh_loss[0]),
              f"checkpoint: fresh trainer {fresh.step_trace_count} "
              f"captures, loss {fresh_loss}")
        del fresh
        gc.collect()
        torch.cuda.empty_cache()

        # the supervised example_target runs (child processes, a few MB
        # of the card) go on beside the train-to-serve part
        box = {}

        def supervise():
            try:
                box["stats"] = checkpoint_supervisor(tmp)
            except PhaseError as e:          # raised on the phase's thread
                box["error"] = e

        sup_thread = threading.Thread(target=supervise)
        sup_thread.start()

        # train to serve
        kw = dict(num_slots=4, page_size=16, max_len=1024, chunk_pages=4,
                  prefix_cache=True)
        prng = np.random.RandomState(9)
        prompts = [prng.randint(0, V, size=int(n)).astype(np.int32)
                   for n in (80, 200, 333, 500)]
        mk = lambda: [Request(p, max_new_tokens=32) for p in prompts]
        live = InferenceEngine(bench_gpt(2), **kw)
        live.run(mk())
        engine_builds = (live.decode_trace_count,
                         dict(live.prefill_trace_counts))
        t0 = time.perf_counter()
        live.warm_start(manager=mgr)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        ra.reset_launch_counts()
        served = mk()
        live.run(served)
        serve_launches = {k: ra.LAUNCHES[k]
                          for k in ("ragged_decode", "ragged_prefill")}
        live.audit_pages()
        print(f"[checkpoint] warm_start(manager=) ms {warm_ms:.1f}, "
              f"launches {serve_launches}", flush=True)
        check((live.decode_trace_count, dict(live.prefill_trace_counts))
              == engine_builds,
              f"checkpoint: warm_start(manager=) moved the engine's "
              f"captures from {engine_builds}")
        check(all(n > 0 for n in serve_launches.values()),
              f"checkpoint: the warm-started engine's ragged launches "
              f"{serve_launches}")
        arrays, _ = mgr.restore()
        other = InferenceEngine(bench_gpt(3), **kw)
        other.warm_start(params=arrays)
        ref_served = mk()
        other.run(ref_served)
        check([r.token_ids for r in served] ==
              [r.token_ids for r in ref_served],
              "checkpoint: warm_start(manager=) streams differ from a "
              "params= warm start's")
        mgr.close()
        del live, other, arrays
        gc.collect()
        torch.cuda.empty_cache()

        sup_thread.join(timeout=600)
        if "error" in box:
            raise box["error"]
        check("stats" in box, "checkpoint: the supervised runs did not end")
        supervised = box["stats"]
    finally:
        if sup_thread is not None:
            sup_thread.join(timeout=600)
        shutil.rmtree(tmp, ignore_errors=True)
    stats = dict(
        card=smi, config=f"gpt_small bf16 flash dropout=0.1 AdamW "
                         f"multi_precision B={B} T={T}",
        capsule_gb=sum(a.numel() * a.element_size()
                       for k, a in at4.items() if k != "generator") / 1e9,
        gather_cold_ms=gather_cold_ms, gather_ms=gather_ms,
        write_ms=write_ms, restore_ms=restore_ms,
        fresh_restore_ms=fresh_restore_ms, ms_per_step=ms_step,
        gather_share_of_step=gather_ms / ms_step,
        steps_during_write=in_flight,
        losses_held="bitwise" if bitwise else f"within spread {spread!r}",
        uninterrupted=ref, losses=losses, resumed=resumed,
        fresh_step5_loss=fresh_loss[0], replays=replays,
        num_update=num_update, causal_launches=launches,
        warm_start_ms=warm_ms, serve_launches=serve_launches,
        supervisor=supervised, phase_s=time.perf_counter() - t_phase)
    print(f"[checkpoint] {json.dumps(stats)}", flush=True)
    return stats


def nmt_loss(model, src, tgt_in, tgt_out, src_valid_length):
    """Teacher-forced token cross entropy of the Transformer."""
    logits = model(src, tgt_in, src_valid_length)
    return -logits.log_softmax(axis=-1).pick(tgt_out, axis=-1).mean()


def nmt_flash_step(torch, np):
    """A small Transformer (units 256, 4 heads of 64, 2 layers, f32) with
    flash=True: its logits against flash=False on the same weights
    (within 1e-4 of the largest |logit|), then 2 Adam steps through
    SPMDTrainer (an eager first step, then a replay), each launching the
    flash kernels for encoder self-attention, decoder causal
    self-attention and cross-attention (3 a layer, 1 of them causal)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, nd, parallel
    from incubator_mxnet_tpu_torch.models import transformer as tm
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    cfg = dict(src_vocab=1000, tgt_vocab=1000, units=256, hidden_size=1024,
               num_heads=4, num_layers=2, max_length=128, dropout=0.0)
    mx.random.seed(3)
    dense = tm.TransformerModel(**cfg)
    dense.initialize(ctx=mx.gpu(0))
    flash = tm.TransformerModel(flash=True, **cfg)
    flash.initialize(ctx=mx.gpu(0))
    flash.load_state_dict(dense.state_dict())
    rng = np.random.RandomState(5)
    B, S, T = 8, 48, 40
    arr = lambda a: nd.array(a, ctx=mx.gpu(0), dtype="int32")
    src = arr(rng.randint(3, 1000, (B, S)))
    tgt = rng.randint(3, 1000, (B, T + 1))
    vl = arr(rng.randint(S // 2, S + 1, B))
    tgt_in, tgt_out = arr(tgt[:, :-1]), arr(tgt[:, 1:])
    with autograd.predict_mode():
        want = dense(src, tgt_in, vl)._data
        got = flash(src, tgt_in, vl)._data
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= 1e-4 * scale, f"nmt flash logits: max |err| {err:.3e} > "
                               f"1e-4 x {scale:.3e}")
    tr = parallel.SPMDTrainer(flash, forward_loss=nmt_loss, optimizer="adam",
                              optimizer_params={"learning_rate": 1e-3})
    L = cfg["num_layers"]
    per_step = []
    losses = []
    for _ in range(2):
        fa.reset_launch_counts()
        losses.append(float(tr.step(src, tgt_in, tgt_out, vl).asnumpy()))
        torch.cuda.synchronize()
        per_step.append(dict(fa.LAUNCHES, **fa.CAUSAL_LAUNCHES))
    check(tr.step_trace_count == 1 and all(np.isfinite(losses)),
          f"nmt flash training: {tr.step_trace_count} builds, losses "
          f"{losses}")
    for n, launches in enumerate(per_step):
        for name in FLASH:
            check(launches[name] == 3 * L and
                  launches[name + "_causal"] == L,
                  f"nmt flash step {n}: {name} launches {launches[name]} "
                  f"(causal {launches[name + '_causal']}), want {3 * L} "
                  f"({L} causal)")
    out = dict(logits_max_err=err, logits_max=scale, losses=losses,
               launches_per_step=per_step[-1])
    del tr, flash, dense
    return out


def phase_nmt(torch, smi):
    """bench.py ``_run_nmt``'s configuration: transformer_base
    (max_length=256) f32, B=16, Ts=64, Tgen=48, K=4,
    beam_search_translate_cached once to warm up and 3 timed runs
    (tokens/s = B Tgen reps / s, the busy share of a profiled run); the
    cached search's tokens equal the uncached search's on the card with
    scores within 1e-4 relative, with and without src_valid_length; and
    a flash Transformer's training step (``nmt_flash_step``)."""
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.models import transformer as tm
    t_phase = time.perf_counter()
    B, Ts, Tgen, K, reps = (NMT[k] for k in ("B", "Ts", "Tgen", "K",
                                             "reps"))
    mx.random.seed(0)
    model = tm.transformer_base(max_length=256)
    model.initialize(ctx=mx.gpu(0))
    rng = np.random.RandomState(0)
    src = nd.array(rng.randint(3, 1000, (B, Ts)), ctx=mx.gpu(0),
                   dtype="int32")

    def run(cached=True, vl=None):
        search = tm.beam_search_translate_cached if cached else \
            tm.beam_search_translate
        return search(model, src, beam_size=K, max_length=Tgen,
                      src_valid_length=vl)

    t0 = time.perf_counter()
    run()[1].asnumpy()
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, scores = run()
    scores.asnumpy()
    dt = time.perf_counter() - t0
    stats = dict(card=smi,
                 config=f"transformer_base(max_length=256) f32 B={B} "
                        f"Ts={Ts} Tgen={Tgen} K={K}",
                 tokens_per_s=B * Tgen * reps / dt, ms_per_search=dt * 1e3 /
                 reps, warmup_s=warm_s)
    stats.update(busy_share(torch, lambda: run()[1].asnumpy()))
    vl = nd.array(rng.randint(Ts // 2, Ts + 1, B), ctx=mx.gpu(0),
                  dtype="int32")
    parity = {}
    for label, v in (("full", None), ("valid_length", vl)):
        (ct, cs), (ut, us) = run(True, v), run(False, v)
        ct, cs, ut, us = (x.asnumpy() for x in (ct, cs, ut, us))
        rows = int((ct != ut).any(axis=-1).sum())
        rel = float(np.max(np.abs(cs - us) / np.abs(us)))
        parity[label] = dict(rows_differing=rows, score_rel=rel)
        check(rows == 0, f"nmt {label}: {rows} of {B * K} beams of the "
                         f"cached search differ from the uncached")
        check(rel <= 1e-4, f"nmt {label}: scores differ by {rel:.2e} "
                           f"relative")
    stats["parity"] = parity
    del model
    gc.collect()
    torch.cuda.empty_cache()
    stats["flash_step"] = nmt_flash_step(torch, np)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"[nmt] {json.dumps(stats)}", flush=True)


def flash_work(B, H, T, D, lens, elem, causal=False):
    """(bytes, flops) each flash kernel needs at these lengths: K/V rows
    of live keys, every q / dO / out row, f32 lse and delta; operations
    over the (query, key) pairs the mask keeps: 4, 6 and 8 x pairs x D.
    Not causal, every row sees the live keys (H T live pairs a batch
    row); causal, row i sees min(i + 1, length) keys (H T (T + 1) / 2 at
    full length): half the operations, the same bytes. dq reads out and
    writes delta (it computes delta); dk/dv reads delta."""
    live = sum(min(n, T) for n in lens)
    if causal:
        pairs = H * sum(min(n, T) * (min(n, T) + 1) // 2 +
                        (T - min(n, T)) * min(n, T) for n in lens)
    else:
        pairs = H * T * live
    rows = B * H * T * D * elem           # one (B, H, T, D) tensor
    kv = H * live * D * elem              # K or V, live rows
    vec = B * H * T * 4                   # one f32 (B, H, T) vector
    return {"flash_fwd": (rows + 2 * kv + rows + vec + 4 * B,
                          4 * pairs * D),
            "flash_bwd_dq": (3 * rows + 2 * kv + 2 * vec + rows + 4 * B,
                             6 * pairs * D),
            "flash_bwd_dkv": (2 * rows + 2 * kv + 2 * vec + 2 * kv + 4 * B,
                              8 * pairs * D)}


def flash_times(torch, B, T, lens, causal, err):
    """The three flash kernels at (B, H=12, T, D=64) bf16 with these
    lengths, held against their plain versions on these inputs (folded
    into ``err``), then timed: kernel, plain version (the dq and dk/dv
    rows share the one plain backward), and the library call on the same
    mask (forward; for both backward rows the library's whole backward:
    a boolean key mask, or ``is_causal=True`` at full length). Beside
    them: the port's whole backward as ``_FlashAttention.backward`` runs
    it (autograd, dq with Δ then dk/dv) against the library's, and the
    eager ``attn_delta``. Returns each kernel's times and bound."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    H, D = 12, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    q, k, v, do, vl = flash_inputs(torch, gen, B, H, T, T, D, lens,
                                   torch.bfloat16)
    label = (f"B={B} H={H} T={T} D={D} bf16 causal={causal} lengths in "
             f"[{min(lens)}, {max(lens)}]")
    compare_flash(torch, fa, q, k, v, do, vl, causal, label, err)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    out, lse = fa._flash_fwd_cuda(q, k, v, vl, causal, None)
    _, delta = fa._flash_bwd_dq_cuda(q, k, v, vl, do, out, lse, causal,
                                     None)
    if causal:
        check(min(lens) == T, "the causal library call needs full lengths")
        lib_kw = dict(is_causal=True)
    else:
        lib_kw = dict(attn_mask=(torch.arange(T, device="cuda")[None, :] <
                                 vl.long()[:, None])[:, None, None, :])
    ql, kl, vlib = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vlib, **lib_kw)
    qp, kp, vp = (x.detach().clone().requires_grad_() for x in (q, k, v))
    port_out = fa.flash_attention_bhtd(qp, kp, vp, vl, causal)
    ms = {
        "flash_fwd": (
            _time_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, vl, causal,
                                                       None), flush),
            _time_ms(torch, lambda: fa.dense_attn_lse(q, k, v, vl, causal),
                     flush),
            _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, **lib_kw), flush)),
        "flash_bwd_dq": (
            _time_ms(torch, lambda: fa._flash_bwd_dq_cuda(
                q, k, v, vl, do, out, lse, causal, None), flush),),
        "flash_bwd_dkv": (
            _time_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
                q, k, v, vl, do, lse, delta, causal, None), flush),),
    }
    plain_bwd = _time_ms(torch, lambda: fa.dense_attn_bwd(
        q, k, v, vl, out, lse, do, causal), flush)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (ql, kl, vlib), do, retain_graph=True), flush)
    port_bwd = _time_ms(torch, lambda: torch.autograd.grad(
        port_out, (qp, kp, vp), do, retain_graph=True), flush)
    delta_ms = _time_ms(torch, lambda: fa.attn_delta(out, do), flush)
    pair = ms["flash_bwd_dq"][0] + ms["flash_bwd_dkv"][0]
    print(f"[times] flash backward {label}: dq + dk/dv {pair:.4f} ms; the "
          f"port's whole backward (autograd, Δ inside dq) {port_bwd:.4f} "
          f"ms; the library's whole backward {lib_bwd:.4f} ms "
          f"({lib_bwd / pair:.2f}x dq + dk/dv, {lib_bwd / port_bwd:.2f}x "
          f"the port's whole); the eager attn_delta {delta_ms:.4f} ms",
          flush=True)
    work = flash_work(B, H, T, D, lens, 2, causal)
    out_times = {}
    for name in FLASH:
        t = ms[name]
        kernel_ms = t[0]
        plain_ms = t[1] if len(t) > 1 else plain_bwd
        library_ms = t[2] if len(t) > 2 else lib_bwd
        bms, by = bound(*work[name], "bfloat16")
        out_times[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=bms,
                               bound_by=by)
        print(f"[times] {name} {label}: {kernel_ms:.4f} ms (plain "
              f"{plain_ms:.4f}, library {library_ms:.4f}, bound "
              f"{bms:.5f} by {by})", flush=True)
    del flush, q, k, v, do, out, lse, lib_out, port_out, delta
    torch.cuda.empty_cache()
    return out_times


def phase_flash_times(torch, lens, err):
    """The flash kernels timed at both training runs' shapes: bert_base's
    (B=32, T=512, its batch's lengths, not causal) and gpt_small's
    (B=16, T=512, every length 512, causal: the ``_causal`` rows, their
    errors folded into ``err`` under those names)."""
    out = flash_times(torch, BERT["B"], BERT["T"], lens, False, err)
    cerr = {k: 0.0 for k in FLASH}
    causal = flash_times(torch, GPT["B"], GPT["T"], [GPT["T"]] * GPT["B"],
                         True, cerr)
    for name in FLASH:
        out[name + "_causal"] = causal[name]
        err[name + "_causal"] = cerr[name]
    return out


# --------------------------------------------------------------------- #
# the operator surface and the amp front end
# --------------------------------------------------------------------- #

def phase_ops():
    """Every registered op on the card against the port on the CPU
    (tests/test_torch_op_cases.py's ``cuda`` test in a pytest subprocess
    without the conftest: no JAX; the subprocess fails if JAX or the JAX
    package was imported), the samplers by their moments on the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    run = ("import sys, pytest\n"
           "rc = int(pytest.main(sys.argv[1:]))\n"
           "jax = {'jax', 'incubator_mxnet_tpu'} & set(sys.modules)\n"
           "print('imported', sorted(jax)) if jax else None\n"
           "sys.exit(rc or (3 if jax else 0))\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", run, "-q", "--noconftest", "-m", "cuda",
         "-p", "no:cacheprovider", "-W",
         "ignore::pytest.PytestUnknownMarkWarning",
         "tests/test_torch_op_cases.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    sys.path.insert(0, os.path.join(root, "tests"))
    try:
        import test_torch_op_cases as cases
        n_ops, n_cases = len(cases.CASES), len(cases.CASE_IDS)
    finally:
        sys.path.pop(0)
    print(f"[ops] {n_ops} registered ops, {n_cases} cases on the card "
          f"against the CPU: {tail[0]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(proc.returncode == 0 and "1 passed" in tail[0],
          f"op cuda test failed:\n{proc.stdout[-6000:]}"
          f"{proc.stderr[-3000:]}")


AMP = dict(B=64, side=224, warmup=3, steps=10, classes=1000,
           f16_B=32, f16_side=224, f16_steps=20, parity_B=8,
           parity_side=224, parity_rtol=2e-2)


def amp_casts(torch, np):
    """Under amp.init("bfloat16"), on the card: the target ops on f32
    inputs equal the unwrapped op on bf16-cast inputs, cast back to f32;
    softmax and BatchNorm on bf16 inputs equal the f32 computation cast
    back to bf16; bitwise."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.ops import registry
    gen = torch.Generator(device="cuda").manual_seed(3)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    target = [("Convolution", [r(8, 16, 14, 14), r(32, 16, 3, 3), r(32)],
               dict(kernel=(3, 3), num_filter=32, pad=(1, 1))),
              ("FullyConnected", [r(64, 256), r(128, 256), r(128)],
               dict(num_hidden=128)),
              ("dot", [r(64, 96), r(96, 80)], {}),
              ("batch_dot", [r(4, 64, 32), r(4, 32, 48)], {}),
              ("interleaved_matmul_selfatt_qk", [r(32, 4, 8 * 3 * 64)],
               dict(heads=8))]
    pinned = [("softmax", [r(16, 1000).bfloat16()], {}),
              ("BatchNorm", [r(8, 64, 7, 7).bfloat16(), r(64).bfloat16(),
                             r(64).bfloat16(), r(64).bfloat16(),
                             r(64).abs().bfloat16() + 0.5],
               dict(fix_gamma=False, training=False))]
    cast_in = {n for n, _, _ in target}
    done = []
    for name, ins, kw in target + pinned:
        spec = registry.get(name)
        raw = spec.fn.__wrapped__
        got = getattr(nd, name)(*[nd.NDArray(t) for t in ins], **kw)
        if name in cast_in:
            want = raw(*[t.bfloat16() for t in ins], **kw).float()
        else:
            want = raw(*[t.float() for t in ins], **kw)
            want = [w.bfloat16() for w in want] \
                if isinstance(want, (tuple, list)) else want.bfloat16()
        gots = got if isinstance(got, list) else [got]
        wants = want if isinstance(want, (list, tuple)) else [want]
        for g, w in zip(gots, wants):
            check(g._data.dtype == w.dtype and torch.equal(g._data, w),
                  f"amp: {name} is not the unwrapped op on cast inputs "
                  f"({g._data.dtype} vs {w.dtype})")
        done.append(name)
    print(f"[amp] casts bitwise on the card: {', '.join(done)}", flush=True)
    return done


def amp_resnet50(torch, np, use_amp):
    """resnet50_v1 with f32 parameters, B=64 224^2, one fixed batch, the
    MXNet 1.x loop: record -> amp.scale_loss -> backward ->
    gluon.Trainer("sgd", momentum 0.9).step(64); 3 warm-up and 10 timed
    steps."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import amp, autograd, gluon, nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    B, side = AMP["B"], AMP["side"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(0)
    net = resnet50_v1()
    net.initialize()
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(B, 3, side, side).astype("float32"))
    y = nd.array(rng.randint(0, AMP["classes"], (B,)), dtype="int32")
    net(x[:1])
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    if use_amp:
        amp.init_trainer(tr)
    lossf = gloss.SoftmaxCrossEntropyLoss()
    losses = []

    def step():
        with autograd.record():
            loss = lossf(net(x), y).mean()
            if use_amp:
                with amp.scale_loss(loss, tr) as scaled:
                    scaled.backward()
            else:
                loss.backward()
        tr.step(B)
        return loss

    losses += [float(step().asnumpy()) for _ in range(AMP["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(AMP["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [float(v.asnumpy()) for v in timed]
    label = "amp bf16" if use_amp else "f32"
    check(all(np.isfinite(losses)), f"resnet50 {label}: loss {losses}")
    grads = [p.grad()._data for p in net.collect_params().values()
             if p.grad_req != "null"]
    check(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
              for g in grads),
          f"resnet50 {label}: a parameter gradient is not f32 or finite")
    ms = dt * 1e3 / AMP["steps"]
    out = dict(losses=losses, ms_per_step=ms, img_per_s=B / (ms / 1e3),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               outcomes=tr.last_outcome.value)
    out.update(busy_share(torch, step))
    out.pop("top", None)
    del tr, net, x, y
    torch.cuda.empty_cache()
    return out


def amp_float16(torch, np):
    """resnet18_v1 under amp.init("float16") (scale from 2^16), B=32: up
    to 20 steps; every skipped step keeps the parameters and the momentum
    bitwise and halves the scale; at least one step applies; a batch
    holding an inf is skipped bitwise."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import amp, autograd, gluon, nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    from incubator_mxnet_tpu_torch.train import StepOutcome
    B, side = AMP["f16_B"], AMP["f16_side"]
    mx.random.seed(0)
    net = resnet18_v1()
    net.initialize()
    rng = np.random.RandomState(1)
    x = nd.array(rng.rand(B, 3, side, side).astype("float32"))
    y = nd.array(rng.randint(0, AMP["classes"], (B,)), dtype="int32")
    net(x[:1])
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.01, "momentum": 0.9})
    amp.init_trainer(tr)
    check(tr.loss_scaler.loss_scale == 2.0 ** 16,
          f"float16: initial scale {tr.loss_scaler.loss_scale}")
    lossf = gloss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]

    def snapshot():
        w = [p.data()._data.clone() for p in params]
        m = [s.clone() for s in tr._updaters[0].states.values()]
        return w, m

    def same(a, b):
        """Parameters and momenta bitwise (momenta the step created:
        zero)."""
        if len(a[1]) != len(b[1]):
            moms = not a[1] and all(not bool(v.any()) for v in b[1])
        else:
            moms = all(torch.equal(u, v) for u, v in zip(a[1], b[1]))
        return moms and all(torch.equal(u, v) for u, v in zip(a[0], b[0]))

    def step(batch):
        before, scale = snapshot(), tr.loss_scaler.loss_scale
        with autograd.record():
            loss = lossf(net(batch), y).mean()
            with amp.scale_loss(loss, tr) as scaled:
                scaled.backward()
        tr.step(B)
        outcome = tr.last_outcome
        after = snapshot()
        if outcome is StepOutcome.SKIPPED_NONFINITE:
            check(same(before, after) and
                  tr.loss_scaler.loss_scale == scale / 2,
                  f"float16: a skipped step changed the state or the "
                  f"scale went {scale} -> {tr.loss_scaler.loss_scale}")
        else:
            check(outcome is StepOutcome.APPLIED and
                  not same(before, after),
                  f"float16: step {outcome} left the parameters alone")
        return outcome, scale

    runs = [step(x) for _ in range(AMP["f16_steps"])]
    applied = sum(o is StepOutcome.APPLIED for o, _ in runs)
    check(applied >= 1, f"float16: no step applied in {len(runs)}")
    bad = x.copy()
    bad[0, 0, 0, 0] = float("inf")
    outcome, scale = step(bad)
    check(outcome is StepOutcome.SKIPPED_NONFINITE,
          f"float16: a batch with an inf was not skipped ({outcome})")
    skipped = sum(o is StepOutcome.SKIPPED_NONFINITE for o, _ in runs)
    out = dict(steps=len(runs), applied=applied, skipped=skipped,
               scales=[s for _, s in runs] + [scale],
               final_scale=tr.loss_scaler.loss_scale)
    print(f"[amp] float16 resnet18_v1 B={B}: {skipped} skipped / "
          f"{applied} applied, scale {out['scales'][0]:.0f} -> "
          f"{out['final_scale']:.0f}; the inf batch skipped bitwise",
          flush=True)
    del tr, net
    torch.cuda.empty_cache()
    return out


def amp_parity(torch, np):
    """The first amp bf16 loss of resnet18_v1 at B=8 on the card against
    the port on the CPU, from the same weights."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    B, side = AMP["parity_B"], AMP["parity_side"]
    rng = np.random.RandomState(2)
    x = rng.rand(B, 3, side, side).astype(np.float32)
    y = rng.randint(0, AMP["classes"], (B,)).astype(np.int32)
    state, vals = None, []
    for ctx in (mx.cpu(), mx.gpu(0)):
        mx.random.seed(0)
        net = resnet18_v1()
        net.initialize(ctx=ctx)
        net(nd.array(x[:1], ctx=ctx))
        if state is None:
            state = {k: v.clone() for k, v in net.state_dict().items()}
        net.load_state_dict(state)
        loss = gloss.SoftmaxCrossEntropyLoss()(
            net(nd.array(x, ctx=ctx)), nd.array(y, ctx=ctx, dtype="int32"))
        vals.append(float(loss.mean().asnumpy()))
    losses = dict(cpu=vals[0], gpu=vals[1])
    rel = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    check(rel <= AMP["parity_rtol"],
          f"amp bf16 resnet18 card vs CPU: {losses} (rel {rel:.3e})")
    print(f"[amp] bf16 resnet18_v1 B={B} first loss card {losses['gpu']} "
          f"vs CPU {losses['cpu']} (rel {rel:.2e} <= "
          f"{AMP['parity_rtol']})", flush=True)
    return dict(card=losses["gpu"], cpu=losses["cpu"], rel_err=rel)


def phase_amp(torch, smi):
    """The amp front end on the card (module docstring, phase 7c2)."""
    import numpy as np
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch.ops import registry
    t0 = time.perf_counter()
    fns = {n: registry.get(n).fn for n in registry.list_all_ops()}
    out = dict(card=smi)
    try:
        out["resnet50_f32"] = amp_resnet50(torch, np, use_amp=False)
        amp.init("bfloat16")
        out["casts"] = amp_casts(torch, np)
        out["resnet50_amp_bf16"] = amp_resnet50(torch, np, use_amp=True)
        out["parity"] = amp_parity(torch, np)
        amp._deinit_for_tests()
        amp.init("float16")
        out["float16"] = amp_float16(torch, np)
    finally:
        amp._deinit_for_tests()
    wrapped = [n for n in fns if registry.get(n).fn is not fns[n]]
    check(not wrapped, f"amp: ops still wrapped after _deinit_for_tests: "
                       f"{wrapped}")
    a, f = out["resnet50_amp_bf16"], out["resnet50_f32"]
    print(f"[amp] resnet50_v1 B={AMP['B']} {AMP['side']}x{AMP['side']} "
          f"gluon.Trainer sgd: amp bf16 {a['ms_per_step']:.1f} ms/step "
          f"{a['img_per_s']:.0f} img/s busy {a.get('device_busy_share')}; "
          f"f32 {f['ms_per_step']:.1f} ms/step {f['img_per_s']:.0f} img/s "
          f"busy {f.get('device_busy_share')}", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[amp] {json.dumps(out)}", flush=True)


# Module against gluon.Trainer from the same weights and batches: the
# first loss (a forward) within loss_rtol, the parameters after the first
# update within param_frac of each tensor's largest |entry|, and losses 2
# and 3 within spread_k times the gap between two gluon.Trainer runs, one
# from weights perturbed by perturb (relative). A randomly initialized
# ResNet-50 in training mode is chaotic: on the CPU (B=16, 64x64) such a
# perturbation moves the second loss by 1.6e-2 and some BatchNorm betas
# by 6% of their largest entry after one update. A replay against the
# Executor's eager body: outputs within out_tol of their largest |entry|,
# each gradient and running statistic within state_frac of its own
# (cuDNN's default backward algorithms sum with atomics; two runs on an
# H100 showed 6.2e-5 and 8.0e-5).
SYMBOLIC = dict(B=64, side=224, classes=1000, batches=4, warmup=3,
                steps=10, eager_steps=3, lr=1e-3, momentum=0.9,
                loss_rtol=1e-5, param_frac=1e-4, perturb=1e-7,
                spread_k=4.0, out_tol=1e-5, state_frac=5e-4,
                block_B=8, block_rtol=1e-5)


def _nll(torch, probs, labels):
    """Mean -log p[label] of a batch's softmax outputs."""
    p = probs._data.float()
    lab = labels._data.to(p.device).long()
    return float(-torch.log(p.gather(1, lab[:, None])).mean())


def _bound_state(exe):
    return {f"{k}:{n}": v._data.clone() for k, d in
            (("grad", exe.grad_dict), ("aux", exe.aux_dict))
            for n, v in d.items()}


def symbolic_replay_vs_eager(torch, mod, key, batch):
    """One step replayed, then the same step from the same state with the
    Executor's body run eagerly: the largest output error over the
    largest output, and the largest gradient / running-statistic error
    over each tensor's largest |entry|."""
    exe = mod._exec
    aux0 = {n: v._data.clone() for n, v in exe.aux_dict.items()}
    mod.forward(batch, is_train=True)
    exe.backward()
    replay_out = exe.outputs[0]._data.clone()
    replayed = _bound_state(exe)
    with torch.no_grad():
        for n, v in exe.aux_dict.items():
            v._data.copy_(aux0[n])
    mod.forward(batch, is_train=True)
    eager_out = exe._body(key)[0]
    exe._pending = None
    torch.cuda.synchronize()
    out_err = _rel_err(torch, eager_out, replay_out)
    state_err = max((_rel_err(torch, v, replayed[k]), k)
                    for k, v in _bound_state(exe).items())
    return out_err, state_err


def symbolic_gluon_run(torch, np, net, x, y, perturb):
    """3 gluon.Trainer SGD steps of ``net`` from its current weights
    (multiplied by 1 + perturb x N(0, 1) when perturb), on the phase's
    first 3 batches; the weights are put back after. Returns the losses
    and each parameter (and running statistic) after the first step, by
    name."""
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    S = SYMBOLIC
    B = S["B"]
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    params = list(net.collect_params().values())
    if perturb:
        gen = torch.Generator(device=params[0].data()._data.device)
        gen.manual_seed(1)
        with torch.no_grad():
            for p in params:
                if p.grad_req != "null":
                    t = p.data()._data
                    t.mul_(1 + perturb * torch.randn(
                        t.shape, generator=gen, device=t.device))
    tr = gluon.Trainer(params, "sgd", {"learning_rate": S["lr"],
                                       "momentum": S["momentum"]})
    lossf = gloss.SoftmaxCrossEntropyLoss()
    losses, after1 = [], None
    for i in range(S["warmup"]):
        with autograd.record():
            L = lossf(net(nd.array(x[i * B:(i + 1) * B])),
                      nd.array(y[i * B:(i + 1) * B]))
        L.backward()
        tr.step(B)
        losses.append(float(L.mean().asnumpy()))
        if after1 is None:
            after1 = {p.name: p.data()._data.clone() for p in params}
    net.load_state_dict(saved)
    return losses, after1


def phase_symbolic(torch, smi):
    """The symbolic front end on the card (module docstring, phase
    7c3)."""
    import tempfile

    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, nd
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    S = SYMBOLIC
    B, side = S["B"], S["side"]
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(0)
    n = B * S["batches"]
    x = rng.rand(n, 3, side, side).astype(np.float32)
    y = rng.randint(0, S["classes"], (n,)).astype(np.float32)
    mx.random.seed(0)
    net = resnet50_v1(classes=S["classes"])
    net.initialize()
    net(nd.array(x[:1]))
    net.hybridize()
    out = dict(card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50_v1")
        t1 = time.perf_counter()
        net.export(prefix)
        out["export_s"] = time.perf_counter() - t1
        xb = nd.array(x[:S["block_B"]])
        blk = gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                        prefix + "-0000.params")
        out["symbolblock_rel_err"] = _rel_err(torch, blk(xb)._data,
                                              net(xb)._data)
        check(out["symbolblock_rel_err"] <= S["block_rtol"],
              f"symbolic: SymbolBlock.imports vs the block "
              f"{out['symbolblock_rel_err']:.3e}")
        del blk
        sym = mx.sym.load(prefix + "-symbol.json")
        params = nd.load(prefix + "-0000.params", ctx=mx.cpu())
    arg = {k[4:]: v for k, v in params.items() if k.startswith("arg:")}
    aux = {k[4:]: v for k, v in params.items() if k.startswith("aux:")}
    ref, after1 = symbolic_gluon_run(torch, np, net, x, y, 0.0)
    spread = symbolic_gluon_run(torch, np, net, x, y, S["perturb"])[0]
    it = mx.io.NDArrayIter(x, y, batch_size=B)
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(
        sym, mx.sym.Variable("softmax_label"), normalization="batch"),
        context=mx.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.set_params(arg, aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": S["lr"], "momentum": S["momentum"]})
    exe = mod._exec

    def next_batch():
        try:
            return it.next()
        except StopIteration:
            it.reset()
            return it.next()

    def step():
        batch = next_batch()
        mod.forward_backward(batch)
        mod.update()
        return batch

    losses, param_err = [], None
    for _ in range(S["warmup"]):
        batch = step()
        losses.append(_nll(torch, mod.get_outputs()[0], batch.label[0]))
        if param_err is None:
            got = {**mod.get_params()[0], **mod.get_params()[1]}
            param_err = max(_rel_err(torch, got[n]._data, v)
                            for n, v in after1.items())
    check(len(exe._programs) == 1, f"symbolic: programs "
                                   f"{list(exe._programs)} after warm-up")
    key = next(iter(exe._programs))
    train = exe._programs[key]
    prog = next(iter(train.values()))
    check(len(train) == 1 and prog.graph is not None,
          f"symbolic: {len(train)} train signatures, graph {prog.graph}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(S["steps"]):
        batch = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / S["steps"]
    check(prog.replays == S["warmup"] - 1 + S["steps"],
          f"symbolic: {prog.replays} replays")
    last = _nll(torch, mod.get_outputs()[0], batch.label[0])
    check(all(np.isfinite(losses + [last])), f"symbolic: losses {losses}")
    module = dict(ms_per_step=ms, img_per_s=B / (ms / 1e3), losses=losses,
                  first_call_ms=prog.first_ms, capture_ms=prog.capture_ms,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    module.update(busy_share(torch, step))
    module["replays"] = prog.replays
    out["module"] = module
    out_err, state_err = symbolic_replay_vs_eager(torch, mod, key,
                                                  next_batch())
    out["replay_vs_eager"] = dict(output=out_err, state=state_err[0],
                                  worst=state_err[1])
    check(out_err <= S["out_tol"] and state_err[0] <= S["state_frac"],
          f"symbolic: replay vs eager body: outputs {out_err:.3e}, "
          f"gradients / statistics {state_err}")

    def eager_step():
        mod.forward(next_batch(), is_train=True)
        exe._body(key)
        exe._pending = None
        mod.update()

    eager_step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(S["eager_steps"]):
        eager_step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) * 1e3 / S["eager_steps"]
    out["eager_body"] = dict(ms_per_step=eager_ms,
                             img_per_s=B / (eager_ms / 1e3))
    score = dict(mod.score(it, "acc"))
    evals = exe._programs.get(False, {})
    check(len(evals) == 1 and all(p.graph is not None
                                  for p in evals.values()),
          f"symbolic: {len(evals)} eval signatures after score")
    ev = next(iter(evals.values()))
    check(ev.replays == S["batches"] - 1, f"symbolic: eval replays "
                                          f"{ev.replays}")
    out["captures"] = dict(train=len(train), eval=len(evals),
                           train_capture_ms=prog.capture_ms,
                           eval_capture_ms=ev.capture_ms,
                           eval_first_call_ms=ev.first_ms,
                           accuracy=score["accuracy"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(spread, ref)]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    out["vs_gluon"] = dict(module_losses=losses, gluon_losses=ref,
                           perturbed_gluon_losses=spread, loss_rel=rels,
                           perturbed_rel=gaps, param_err_step1=param_err)
    check(rels[0] <= S["loss_rtol"] and param_err <= S["param_frac"] and
          all(r <= max(S["loss_rtol"], S["spread_k"] * g)
              for r, g in zip(rels[1:], gaps[1:])),
          f"symbolic: Module vs gluon.Trainer: losses {losses} vs {ref} "
          f"(rel {rels}, perturbed gluon rel {gaps}), parameters after "
          f"the first update {param_err:.3e}")
    del mod, exe, net, params, arg, aux
    gc.collect()
    torch.cuda.empty_cache()
    m = out["module"]
    print(f"[symbolic] resnet50_v1 f32 B={B} {side}x{side} Module "
          f"sgd: {m['ms_per_step']:.1f} ms/step {m['img_per_s']:.0f} img/s "
          f"busy {m.get('device_busy_share')}; eager body "
          f"{eager_ms:.1f} ms/step; captures train "
          f"{prog.capture_ms:.0f} ms eval {ev.capture_ms:.0f} ms; losses "
          f"rel {rels} vs gluon.Trainer ({gaps} perturbed)", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[symbolic] {json.dumps(out)}", flush=True)


# --------------------------------------------------------------------- #
# object detection: SSD-300 training and detection, Faster R-CNN
# --------------------------------------------------------------------- #

DETECTION = dict(B=32, side=300, classes=20, boxes=2, warmup=3, steps=10,
                 lr=0.05, momentum=0.9, wd=5e-4, loss_rtol=1e-4,
                 detect_B=8, prob_rtol=1e-5, box_atol=1e-5,
                 rcnn_B=2, rcnn_h=600, rcnn_w=800, rcnn_lr=0.01,
                 rcnn_frac=1e-4, roi_atol=1e-2)


def ssd_batch(np, B, side, classes):
    """bench.py ``_run_ssd``'s batch: uniform pixels, two boxes an image
    from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, side, side).astype(np.float32)
    labels = np.full((B, 2, 5), -1.0, np.float32)
    for b in range(B):
        for o in range(2):
            x1, y1 = rng.uniform(0.0, 0.6, 2)
            w, h = rng.uniform(0.2, 0.35, 2)
            labels[b, o] = (rng.randint(0, classes), x1, y1,
                            min(x1 + w, 1.0), min(y1 + h, 1.0))
    return x, labels


def ssd_forward_loss(model, xb, yb):
    """bench.py ``_run_ssd``'s objective: MultiBoxTarget (hard negative
    mining) and the joint loss, inside the captured step."""
    anchors, cls_preds, box_preds = model(xb)
    bt, bm, ct = model.training_targets(anchors, cls_preds, yb)
    return model.loss(cls_preds, box_preds, bt, bm, ct)


def detection_ssd(torch, np):
    """bench.py ``_run_ssd`` on the card: ssd_300(num_classes=20) f32
    through SPMDTrainer(forward_loss=...) with SGD; a second trainer from
    the same weights runs the step body eagerly, the reference of the
    first steps' losses. Then SSD.detect on the card against the CPU."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, parallel
    from incubator_mxnet_tpu_torch.models.ssd import ssd_300
    D = DETECTION
    B, side = D["B"], D["side"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, labels = ssd_batch(np, B, side, D["classes"])
    xs, ys = nd.array(x), nd.array(labels)
    nets = []
    for _ in range(2):
        mx.random.seed(0)
        net = ssd_300(num_classes=D["classes"])
        net.initialize()
        net(xs[:1])
        nets.append(net)
    net, ref = nets
    ref.load_state_dict(net.state_dict())
    # detection from the random weights (13 steps on one batch teach the
    # network background everywhere: no row would survive)
    detect = detection_detect(torch, np, net, xs[:D["detect_B"]])
    opt = {"learning_rate": D["lr"], "momentum": D["momentum"],
           "wd": D["wd"]}
    tr, ref_tr = (parallel.SPMDTrainer(n, forward_loss=ssd_forward_loss,
                                       optimizer="sgd",
                                       optimizer_params=dict(opt),
                                       sharding="replicated")
                  for n in (net, ref))
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    try:
        # the step body run eagerly outside any graph: a replay's reference
        from test_torch_train_graphs import _eager_step
    finally:
        sys.path.pop(0)
    losses, eager = [], []
    for _ in range(D["warmup"]):
        losses.append(float(tr.step(xs, ys).asnumpy()))
        eager.append(float(_eager_step(ref_tr, [xs._data, ys._data])))
    check(tr.step_trace_count == 1 and len(tr._programs) == 1,
          f"ssd: {tr.step_trace_count} step programs built in the warm-up")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [tr.step(xs, ys) for _ in range(D["steps"])]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / D["steps"]
    losses += [float(v.asnumpy()) for v in timed]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, eager)]
    check(all(np.isfinite(losses)), f"ssd: non-finite loss {losses}")
    check(max(rels) <= D["loss_rtol"],
          f"ssd: the first losses {losses[:len(eager)]} against the eager "
          f"body's {eager} (rel {rels}) > {D['loss_rtol']}")
    check(losses[-1] < losses[0], f"ssd: loss did not fall: {losses}")
    check(tr.step_trace_count == 1 and
          prog.replays - replays == D["steps"],
          f"ssd: {prog.replays - replays} of {D['steps']} timed steps "
          f"replayed, {tr.step_trace_count} builds")
    out = dict(config=f"ssd_300(num_classes={D['classes']}) f32 B={B} "
                      f"{side}x{side}, SGD lr {D['lr']} momentum "
                      f"{D['momentum']} wd {D['wd']}",
               losses=losses, eager_body_losses=eager, loss_rel=rels,
               ms_per_step=ms, img_per_s=B / (ms / 1e3),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
               step_trace_count=tr.step_trace_count)
    out.update(busy_share(torch, lambda: tr.step(xs, ys)))
    out["replays"] = prog.replays
    del ref_tr, ref, nets
    out["detect"] = detect
    del tr, net, xs, ys, prog
    gc.collect()
    torch.cuda.empty_cache()
    return out


def detection_detect(torch, np, net, xs):
    """SSD.detect on the card (timed and profiled) against the port on
    the CPU from the card's class probabilities: the detection is a
    selection by score, and scores an ulp apart (softmax on two devices)
    would order rows differently, so the CPU decodes and suppresses the
    card's probabilities (``detect`` is that softmax, then
    MultiBoxDetection); the softmax itself is held to ``prob_rtol``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    D = DETECTION
    anchors, cls_preds, box_preds = net(xs)
    kw = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)
    dets = net.detect(cls_preds, box_preds, anchors, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.detect(cls_preds, box_preds, anchors, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    prof = busy_share(torch, lambda: net.detect(cls_preds, box_preds,
                                                anchors, **kw))
    probs = nd.softmax(cls_preds, axis=1)
    cpu = [nd.array(a._data.cpu(), ctx=mx.cpu())
           for a in (cls_preds, box_preds, anchors, probs)]
    with mx.cpu():
        prob_err = _rel_err(torch, probs._data,
                            nd.softmax(cpu[0], axis=1)._data)
        want = nd.MultiBoxDetection(cpu[3], cpu[1], cpu[2], **kw)._data
    got = dets._data.cpu()
    valid = int((want[..., 0] >= 0).sum())
    ids_equal = bool(torch.equal(got[..., :2] >= 0, want[..., :2] >= 0) and
                     torch.equal(got[..., 0], want[..., 0]))
    score_err = float((got[..., 1] - want[..., 1]).abs().max())
    box_err = float((got[..., 2:] - want[..., 2:]).abs().max())
    check(prob_err <= D["prob_rtol"],
          f"ssd detect: softmax card vs CPU {prob_err:.2e}")
    check(ids_equal and valid > 0 and score_err <= D["box_atol"] and
          box_err <= D["box_atol"],
          f"ssd detect: card vs CPU rows: ids equal {ids_equal}, {valid} "
          f"valid, scores {score_err:.2e}, boxes {box_err:.2e}")
    return dict(B=int(xs.shape[0]), anchors=int(anchors.shape[1]),
                valid_rows=valid, ms=ms, softmax_rel_err=prob_err,
                score_max_abs_err=score_err, box_max_abs_err=box_err,
                **{f"profile_{k}": v for k, v in prof.items()})


def rcnn_toy_loss(s, d):
    """tests/test_contrib_det.py's toy loss over the head's outputs."""
    return (s.log_softmax(axis=-1)[:, :, 0]).mean() * -1 + (d * d).mean()


def rcnn_staged(mx, nd, autograd, net, x, info, probs=None):
    """The model's forward (``rpn_forward`` then ``roi_forward``), its toy
    loss and the backward; the RoI half reads ``probs`` when given (the
    other device's RPN probabilities). Returns the outputs by name and
    the first backbone weight's gradient."""
    with autograd.record():
        feat, rpn_cls, rpn_box, own = net.rpn_forward(nd, x)
        rois, s, d = net.roi_forward(nd, feat, own if probs is None
                                     else probs, rpn_box, info)
        loss = rcnn_toy_loss(s, d)
    loss.backward()
    outs = dict(rois=rois, scores=s, deltas=d, rpn_cls=rpn_cls,
                rpn_box=rpn_box, probs=own, loss=loss)
    return outs, net.backbone.body[0].weight.grad()._data.clone()


def detection_rcnn(torch, np):
    """faster_rcnn_small(num_classes=20) f32 at its defaults, B=2 at 600 x
    800: the forward and the toy loss on the card against the port on
    the CPU at the same weights (the RoI half of the CPU run reads the
    card's RPN probabilities: proposals are a selection by score), then
    one gluon.Trainer("sgd") step on the card through ``net(x, im_info)``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    from incubator_mxnet_tpu_torch.models.faster_rcnn import \
        faster_rcnn_small
    D = DETECTION
    B, H, W = D["rcnn_B"], D["rcnn_h"], D["rcnn_w"]
    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, H, W).astype(np.float32)
    info = np.tile([H, W, 1.0], (B, 1)).astype(np.float32)
    mx.random.seed(0)
    net = faster_rcnn_small(num_classes=D["classes"])
    net.initialize()
    xg, ig = nd.array(x), nd.array(info)
    net(xg, ig)
    with mx.cpu():
        cpu_net = faster_rcnn_small(num_classes=D["classes"])
        cpu_net.initialize()
        cpu_net(nd.array(x[:, :, :64, :64]), nd.array(info))
        cpu_net.load_state_dict({k: v.cpu() for k, v in
                                 net.state_dict().items()})
    card, g_card = rcnn_staged(mx, nd, autograd, net, xg, ig)
    with mx.cpu():
        probs = nd.array(card["probs"]._data.cpu())
        ref, g_cpu = rcnn_staged(mx, nd, autograd, cpu_net, nd.array(x),
                                 nd.array(info), probs)
    errs = {k: _rel_err(torch, card[k]._data, ref[k]._data)
            for k in ("scores", "deltas", "rpn_cls", "rpn_box", "probs",
                      "loss")}
    errs["backbone_grad"] = _rel_err(torch, g_card, g_cpu)
    rg, rc = card["rois"]._data.detach().cpu(), ref["rois"]._data.detach()
    roi_err = float((rg[..., 1:] - rc[..., 1:]).abs().max())
    live = int((rc[..., 1:] != 0).any(dim=-1).sum())
    check(torch.equal(rg[..., 0], rc[..., 0]) and
          torch.equal(rg[..., 1:] == 0, rc[..., 1:] == 0) and
          roi_err <= D["roi_atol"] and live > 0,
          f"faster_rcnn: rois card vs CPU: {roi_err:.2e} px, {live} live")
    check(max(errs.values()) <= D["rcnn_frac"],
          f"faster_rcnn: card vs CPU (of each largest |entry|) {errs}")
    # the user's path: net(x, im_info), the toy loss, one SGD step
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": D["rcnn_lr"]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with autograd.record():
        rois, s, d, _, _ = net(xg, ig)
        loss = rcnn_toy_loss(s, d)
    loss.backward()
    tr.step(1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    # the toy loss is a mean over the rois: the staged forward's, whatever
    # the order of proposals an ulp apart
    loss_rel = _rel_err(torch, loss._data, card["loss"]._data)
    finite = all(bool(torch.isfinite(p.data()._data).all())
                 for p in net.collect_params().values())
    check(loss_rel <= D["rcnn_frac"] and finite,
          f"faster_rcnn: net(x)'s loss vs the staged forward's {loss_rel:.2e}"
          f", parameters finite after the step {finite}")
    prof = busy_share(torch, lambda: net(xg, ig))
    return dict(config=f"faster_rcnn_small(num_classes={D['classes']}) f32 "
                       f"B={B} {H}x{W}, rpn_post_nms_top_n=64",
                rois_max_abs_err_px=roi_err, live_rois=live, rel_err=errs,
                sgd_step_ms=step_ms, loss=float(loss.asnumpy()),
                loss_vs_staged=loss_rel,
                **{f"forward_{k}": v for k, v in prof.items()})


def phase_detection(torch, smi):
    """Object detection on the card (module docstring, phase 7c4)."""
    import numpy as np
    t0 = time.perf_counter()
    out = dict(card=smi, ssd=detection_ssd(torch, np),
               faster_rcnn=detection_rcnn(torch, np))
    s, det = out["ssd"], out["ssd"]["detect"]
    print(f"[detection] ssd_300 f32 B={DETECTION['B']} 300x300 SPMDTrainer "
          f"sgd: {s['ms_per_step']:.2f} ms/step {s['img_per_s']:.0f} img/s "
          f"busy {s.get('device_busy_share')}; capture "
          f"{s['capture_ms']:.0f} ms; peak {s['peak_memory_gb']:.2f} GB; "
          f"detect B={det['B']} {det['ms']:.1f} ms ({det['valid_rows']} "
          f"rows); faster_rcnn card vs CPU {out['faster_rcnn']['rel_err']}",
          flush=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[detection] {json.dumps(out)}", flush=True)


def kernel_record(err, runs, times):
    """The kernels' JSON record; each kernel's launches come from the run
    of its own path (decode / prefill: plain; verify: spec_k=4 on raw
    pools; the _q variants: spec_k=4 on int8 pools; both replaying the
    plain run's streams as drafts; the flash kernels: the bert_base
    training run; their causal rows: the gpt_small training run's timed
    replays)."""
    path_of = {"ragged_decode": "plain", "ragged_prefill": "plain",
               "ragged_verify": "spec", "ragged_decode_q": "spec_int8",
               "ragged_prefill_q": "spec_int8",
               "ragged_verify_q": "spec_int8",
               "flash_fwd": "training", "flash_bwd_dq": "training",
               "flash_bwd_dkv": "training"}
    path_of.update({f"{k}_causal": "gpt_training" for k in FLASH})
    source = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
              "flash_bwd_dkv": "flash_bwd"}
    kernels = []
    for name in KERNELS + tuple(f"{k}_causal" for k in FLASH):
        t = times[name]
        launches = runs[path_of[name]]["launches"].get(name, 0)
        check(launches > 0, f"{name} never launched on its path")
        base = name.removesuffix("_causal")
        src = source.get(base, base.removesuffix("_q"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"incubator_mxnet_tpu_torch/csrc/{src}.cu",
            "replaces": REPLACES[base],
            "launches": launches,
            "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    return kernels


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script needs the GPU",
              file=sys.stderr)
        return 1
    try:
        import incubator_mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        smi = phase_device(torch)
        phase_build()
        err = phase_kernels(torch)
        err.update(phase_flash_kernels(torch))
        runs = phase_serving(torch)
        phase_surface(torch)
        phase_fleet(torch)
        phase_parity(torch)
        phase_graph_tests()
        phase_ops()
        runs["training"], lens = phase_training(
            torch, torch.cuda.get_device_name(0))
        phase_long_sequence(torch)
        phase_bert_parity(torch)
        phase_gluon(torch, torch.cuda.get_device_name(0))
        phase_vision(torch, smi)
        phase_amp(torch, smi)
        phase_symbolic(torch, smi)
        phase_detection(torch, smi)
        runs["gpt_training"] = phase_gpt_training(torch, smi)
        phase_checkpoint(torch, smi)
        phase_nmt(torch, smi)
        times = phase_times(torch)
        times.update(phase_flash_times(torch, lens, err))
        for mod in ("jax", "incubator_mxnet_tpu"):
            check(mod not in sys.modules, f"{mod} was imported")
        kernels = kernel_record(err, runs, times)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
