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
                writes within f32 summation error of attn_delta; NaN in
                the K/V rows past valid_len changes no output (bf16,
                T = 37 / 200 / 512, causal and not);
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
  6. parity   — at f32, the engine's greedy tokens, without and with
                spec_k=4, equal the port's dense-cache cached_generate
                (which runs no kernel), through the step and chunk graphs
                (the prefill kernel's CUDA-core body); then the graphs'
                cuda tests (tests/test_torch_serve_graphs.py,
                tests/test_torch_page_graphs.py and
                tests/test_torch_train_graphs.py, pytest without the
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
  8. times    — the flash kernels held against their plain versions
                once more on the training batch's own shapes and lengths
                (B=32, T=512, bf16); each kernel's device time (CUDA events around it, the
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

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
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
    HMMA, LDSM and LDGSTS; each flash TMA body (forward, dq, dk/dv) HMMA, LDSM
    and a copy into shared memory (LDGSTS or UTMALDG), and no STS.U16 (no
    transposed copy, stored 2 bytes at a time)."""
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
                check(c["LDGSTS"] + c["UTMALDG"] > 0,
                      f"{name}: no cp.async or TMA load ({c})")
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


def phase_serving(torch):
    import numpy as np
    from incubator_mxnet_tpu_torch.models.gpt import gpt_small
    model = gpt_small(dtype="bfloat16", device="cuda", seed=0)
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
    from incubator_mxnet_tpu_torch.models.gpt import gpt_small
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    kw = dict(num_slots=4, page_size=16, max_len=1024, chunk_pages=4,
              prefix_cache=True)
    live = gpt_small(dtype="bfloat16", device="cuda", seed=0)
    other = gpt_small(dtype="bfloat16", device="cuda", seed=1)
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
    from incubator_mxnet_tpu_torch.models.gpt import gpt_small
    model = gpt_small(dtype="bfloat16", device="cuda", seed=0)
    phase_tiers(torch, np, model)
    phase_transport(torch, np, model)
    phase_brownout(torch, np, model)
    del model
    torch.cuda.empty_cache()
    phase_warm_start(torch, np)


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
    from incubator_mxnet_tpu_torch.models.gpt import (cached_generate,
                                                      gpt_small)
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    model = gpt_small(dtype="float32", device="cuda", seed=1)
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
    raising)."""
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
         "tests/test_torch_train_graphs.py"],
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


def compare_flash(torch, fa, q, k, v, do, vl, causal, what, err):
    """Run the three flash kernels and their plain versions on the same
    inputs and hold them together (FLASH_TOL); folds each kernel's
    largest |difference| into ``err``."""
    dt_name = str(q.dtype).removeprefix("torch.")
    atol, rtol, gfrac, gfloor = FLASH_TOL[dt_name]
    what = f"{dt_name} {what}"
    out, lse = fa._flash_fwd_cuda(q, k, v, vl, causal, None)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, vl, do, out, lse, causal,
                                      None)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, vl, do, lse, delta, causal,
                                    None)
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
    for dt in (torch.float32, torch.bfloat16):
        for B, H, Tq, Tk, D, lens, causal in FLASH_CASES:
            q, k, v, do, vl = flash_inputs(torch, gen, B, H, Tq, Tk, D,
                                           lens, dt)
            compare_flash(torch, fa, q, k, v, do, vl, causal,
                          f"B={B} H={H} Tq={Tq} Tk={Tk} D={D} "
                          f"lengths={lens} causal={causal}", err)
            del q, k, v, do, vl
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
            runs = []
            for kk, vv in ((k, v), (torch.where(dead, nan, k),
                                    torch.where(dead, nan, v))):
                out, lse = fa._flash_fwd_cuda(q, kk, vv, vl, causal, None)
                dq, delta = fa._flash_bwd_dq_cuda(q, kk, vv, vl, do, out,
                                                  lse, causal, None)
                dk, dv = fa._flash_bwd_dkv_cuda(q, kk, vv, vl, do, lse,
                                                delta, causal, None)
                runs.append((out, lse, dq, delta, dk, dv))
            torch.cuda.synchronize()
            for name, a, b in zip(("out", "lse", "dq", "delta", "dk", "dv"),
                                  *runs):
                check(bool(torch.equal(a, b)),
                      f"flash bf16 T={T} causal={causal}: NaN past "
                      f"valid_len changed {name}")
            del q, k, v, do, vl, runs
    print("[flash] NaN in K/V past valid_len (bf16, D=64, T=37/200/512, "
          "causal and not): out, lse, dq, delta, dk, dv unchanged",
          flush=True)
    return err


def bert_batch(torch, np, rng, B, T, M, vocab, min_len):
    """The bench's batch tuple: valid lengths drawn in [min_len, T] and
    M distinct masked positions inside each length."""
    lens = rng.randint(min_len, T + 1, size=B)
    pos = np.stack([rng.choice(n, size=M, replace=False) for n in lens])
    arrays = (rng.randint(0, vocab, (B, T)), rng.randint(0, 2, (B, T)),
              lens, pos, rng.randint(0, vocab, (B, M)),
              np.ones((B, M), np.float32), rng.randint(0, 2, (B,)))
    return [torch.tensor(a, device="cuda") for a in arrays]


def bert_trainer(torch, T, generator, dtype="bfloat16", size="base",
                 device="cuda", dropout=0.1, lr=1e-4):
    from incubator_mxnet_tpu_torch import models, parallel
    ctor = models.bert_base if size == "base" else models.bert_tiny
    bert = ctor(dtype=dtype, max_length=T, flash=True, dropout=dropout,
                device=device, generator=generator)
    pre = models.BERTForPretraining(bert)
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
    B, T, M = BERT["B"], BERT["T"], BERT["M"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    pre, tr = bert_trainer(torch, T, gen)
    bert = pre.bert
    batch = bert_batch(torch, np, np.random.RandomState(0), B, T, M,
                       bert.vocab_size, 256)

    def step():
        gen.manual_seed(1)        # a repeating batch: its dropout masks too
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
    lens = batch[2].tolist()
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
    train_host_costs(torch, tr, prog, batch, gen)
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


def train_host_costs(torch, tr, prog, batch, gen):
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

    def stage():
        gen.manual_seed(1)
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    pre, tr = bert_trainer(torch, T, gen)
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
          f"{batch[2].tolist()}: losses {losses} (the second a replay of "
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
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    T, B, M, steps = 128, 8, 20, 5
    for dtype in ("float32", "bfloat16"):
        rtol, gfrac = BERT_PARITY_TOL[dtype]
        cpu_pre, cpu_tr = bert_trainer(
            torch, T, torch.Generator().manual_seed(7), dtype=dtype,
            size="tiny", device="cpu", dropout=0.0, lr=1e-3)
        gen = torch.Generator(device="cuda")
        gpu_pre, gpu_tr = bert_trainer(torch, T, gen, dtype=dtype,
                                       size="tiny", dropout=0.0, lr=1e-3)
        gpu_pre.load_state_dict(cpu_pre.state_dict())
        batch = bert_batch(torch, np, np.random.RandomState(7), B, T, M,
                           cpu_pre.bert.vocab_size, 32)
        cpu_batch = [b.cpu() for b in batch]
        if gfrac is not None:
            one = torch.ones((), device="cuda")
            _, g_card = gpu_tr._forward_backward(batch, one)
            _, g_cpu = cpu_tr._forward_backward(cpu_batch, one.cpu())
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


def flash_work(B, H, T, D, lens, elem):
    """(bytes, flops) each flash kernel needs at these lengths: K/V rows
    of live keys, every q / dO / out row, f32 lse and delta; operations
    over the live keys (non-causal): 4, 6 and 8 x B H Tq keys D. dq reads
    out and writes delta (it computes delta); dk/dv reads delta."""
    live = sum(min(n, T) for n in lens)
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


def phase_flash_times(torch, lens, err):
    """Each flash kernel at the training run's shapes (bert_base, bf16,
    B=32, H=12, T=512, D=64, its batch's lengths), first held against its
    plain version on these inputs (folded into ``err``), then timed:
    kernel, plain version (the dq and dk/dv rows share the one plain
    backward), and the library call with the same boolean mask (forward;
    for both backward rows the library's whole backward). Beside them:
    the port's whole backward as ``_FlashAttention.backward`` runs it
    (autograd, dq with Δ then dk/dv) against the library's, and the
    eager ``attn_delta`` that the backward ran before Δ moved into dq."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    B, H, T, D = BERT["B"], 12, BERT["T"], 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    q, k, v, do, vl = flash_inputs(torch, gen, B, H, T, T, D, lens,
                                   torch.bfloat16)
    compare_flash(torch, fa, q, k, v, do, vl, False,
                  f"B={B} H={H} T={T} D={D} the training batch's lengths "
                  f"in [{min(lens)}, {max(lens)}]", err)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    out, lse = fa._flash_fwd_cuda(q, k, v, vl, False, None)
    _, delta = fa._flash_bwd_dq_cuda(q, k, v, vl, do, out, lse, False, None)
    mask = (torch.arange(T, device="cuda")[None, :] <
            vl.long()[:, None])[:, None, None, :]
    ql, kl, vlib = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vlib, attn_mask=mask)
    qp, kp, vp = (x.detach().clone().requires_grad_() for x in (q, k, v))
    port_out = fa.flash_attention_bhtd(qp, kp, vp, vl)
    ms = {
        "flash_fwd": (
            _time_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, vl, False,
                                                       None), flush),
            _time_ms(torch, lambda: fa.dense_attn_lse(q, k, v, vl), flush),
            _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), flush)),
        "flash_bwd_dq": (
            _time_ms(torch, lambda: fa._flash_bwd_dq_cuda(
                q, k, v, vl, do, out, lse, False, None), flush),),
        "flash_bwd_dkv": (
            _time_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
                q, k, v, vl, do, lse, delta, False, None), flush),),
    }
    plain_bwd = _time_ms(torch, lambda: fa.dense_attn_bwd(
        q, k, v, vl, out, lse, do), flush)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (ql, kl, vlib), do, retain_graph=True), flush)
    port_bwd = _time_ms(torch, lambda: torch.autograd.grad(
        port_out, (qp, kp, vp), do, retain_graph=True), flush)
    delta_ms = _time_ms(torch, lambda: fa.attn_delta(out, do), flush)
    pair = ms["flash_bwd_dq"][0] + ms["flash_bwd_dkv"][0]
    print(f"[times] flash backward B={B} H={H} T={T} D={D} bf16: dq + "
          f"dk/dv {pair:.4f} ms; the port's whole backward (autograd, Δ "
          f"inside dq) {port_bwd:.4f} ms; the library's whole backward "
          f"{lib_bwd:.4f} ms ({lib_bwd / pair:.2f}x dq + dk/dv, "
          f"{lib_bwd / port_bwd:.2f}x the port's whole); the eager "
          f"attn_delta {delta_ms:.4f} ms", flush=True)
    work = flash_work(B, H, T, D, lens, 2)
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
        print(f"[times] {name} B={B} H={H} T={T} D={D} bf16 lengths in "
              f"[{min(lens)}, {max(lens)}]: {kernel_ms:.4f} ms (plain "
              f"{plain_ms:.4f}, library {library_ms:.4f}, bound "
              f"{bms:.5f} by {by})", flush=True)
    del flush, q, k, v, do, out, lse, lib_out, port_out, delta
    torch.cuda.empty_cache()
    return out_times


def kernel_record(err, runs, times):
    """The kernels' JSON record; each kernel's launches come from the run
    of its own path (decode / prefill: plain; verify: spec_k=4 on raw
    pools; the _q variants: spec_k=4 on int8 pools; both replaying the
    plain run's streams as drafts; the flash kernels: the bert_base
    training run)."""
    path_of = {"ragged_decode": "plain", "ragged_prefill": "plain",
               "ragged_verify": "spec", "ragged_decode_q": "spec_int8",
               "ragged_prefill_q": "spec_int8",
               "ragged_verify_q": "spec_int8",
               "flash_fwd": "training", "flash_bwd_dq": "training",
               "flash_bwd_dkv": "training"}
    source = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
              "flash_bwd_dkv": "flash_bwd"}
    kernels = []
    for name in KERNELS:
        t = times[name]
        launches = runs[path_of[name]]["launches"].get(name, 0)
        check(launches > 0, f"{name} never launched on its path")
        src = source.get(name, name.removesuffix("_q"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"incubator_mxnet_tpu_torch/csrc/{src}.cu",
            "replaces": REPLACES[name],
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
        phase_parity(torch)
        phase_graph_tests()
        runs["training"], lens = phase_training(
            torch, torch.cuda.get_device_name(0))
        phase_long_sequence(torch)
        phase_bert_parity(torch)
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
